"""Panoptic-DeepLab's fusion of the semantic map, the center heatmap and
the offsets (counterpart of the JAX package's
``projects/panoptic_deeplab/post_processing.py``), on the tensors' device
with fixed shapes, as there:

- :func:`find_instance_center`: a max-pool NMS, the threshold, then a top
  ``K`` that takes the lower index of two equal scores first (``ops/topk``,
  ``lax.top_k``'s rule), empty slots scored 0;
- :func:`group_pixels`: each pixel, moved by its offset, to the nearest
  valid center: ``dy * dy + dx * dx`` over ``[H * W, K]``, formed in place
  (at 1024x2048 and K = 200 one such matrix is 1.68 GB; the JAX form's
  ``[H * W, K, 2]`` broadcast would add 3.4 GB), the first of equal
  distances taken;
- :func:`get_panoptic_segmentation`: the per-instance majority vote of the
  thing classes and the stuff areas as ``scatter_add`` into a static
  budget of 256 classes, the per-class renumbering in center order.
"""

from typing import Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from detectron2_tpu_torch.ops.topk import top_k as _top_k

__all__ = ["find_instance_center", "group_pixels", "get_panoptic_segmentation", "panoptic_deeplab_postprocess"]

_CLASS_BUDGET = 256  # the static class-id budget of the vote and area scatters


def find_instance_center(center_heatmap: torch.Tensor, threshold: float = 0.1, nms_kernel: int = 7,
                         top_k: int = 200) -> Tuple[torch.Tensor, torch.Tensor]:
    """``center_heatmap`` ``[H, W]`` -> (centers ``[K, 2]`` (y, x) float32,
    scores ``[K]``, 0 where no center)."""
    H, W = center_heatmap.shape
    pad = nms_kernel // 2
    pooled = F.max_pool2d(center_heatmap[None, None], nms_kernel, stride=1, padding=pad)[0, 0]
    is_peak = (center_heatmap == pooled) & (center_heatmap > threshold)
    scores = torch.where(is_peak, center_heatmap, torch.zeros_like(center_heatmap)).reshape(-1)
    vals, idx = _top_k(scores, min(top_k, H * W))
    return torch.stack([(idx // W).float(), (idx % W).float()], dim=-1), vals


def group_pixels(centers: torch.Tensor, center_scores: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The 1-based index of each pixel's nearest valid center after its
    offset (``offsets`` ``[H, W, 2]``, (dy, dx) toward the center): ``[H,
    W]`` int32, all 0 when no center is valid."""
    H, W = offsets.shape[:2]
    ys = (torch.arange(H, dtype=torch.float32, device=offsets.device)[:, None] + offsets[..., 0]).reshape(-1, 1)
    xs = (torch.arange(W, dtype=torch.float32, device=offsets.device)[None, :] + offsets[..., 1]).reshape(-1, 1)
    d = (ys - centers[:, 0]).square_()
    d += (xs - centers[:, 1]).square_()
    d.masked_fill_(~(center_scores > 0)[None, :], float("inf"))
    ins_id = d.argmin(dim=-1).to(torch.int32) + 1
    del d
    any_center = (center_scores > 0).any()
    return torch.where(any_center, ins_id.reshape(H, W), torch.zeros_like(ins_id).reshape(H, W))


def get_panoptic_segmentation(
    sem_seg: torch.Tensor,
    center_heatmap: torch.Tensor,
    offsets: torch.Tensor,
    thing_ids: Iterable[int],
    label_divisor: int = 1000,
    stuff_area: int = 2048,
    threshold: float = 0.1,
    nms_kernel: int = 7,
    top_k: int = 200,
    void_label: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sem_seg`` ``[H, W]`` class ids, ``center_heatmap`` ``[H, W]``,
    ``offsets`` ``[H, W, 2]`` -> (panoptic ``[H, W]`` int64: class *
    ``label_divisor`` + the instance's 1-based id within its class for
    things, class * ``label_divisor`` for stuff, ``void_label`` for a thing
    pixel grouped to no center and for stuff regions under ``stuff_area``;
    the center scores ``[K]``). Each instance takes the most frequent thing
    class among its pixels (the lower class on a tie); instances are
    numbered per class in center order."""
    C = _CLASS_BUDGET
    device = sem_seg.device
    H, W = sem_seg.shape
    is_thing = torch.zeros(C, dtype=torch.bool, device=device)
    is_thing[torch.as_tensor(sorted(int(t) for t in thing_ids), dtype=torch.long, device=device)] = True
    sem = sem_seg.clamp(0, C - 1).long()
    thing_mask = is_thing[sem]
    centers, scores = find_instance_center(center_heatmap, threshold, nms_kernel, top_k)
    ins_id = group_pixels(centers, scores, offsets).long()
    ins_id = torch.where(thing_mask, ins_id, torch.zeros_like(ins_id))
    K = centers.shape[0]
    flat_ins, flat_sem = ins_id.reshape(-1), sem.reshape(-1)
    vote_idx = torch.where(flat_ins > 0, (flat_ins - 1) * C + flat_sem, torch.full_like(flat_ins, K * C))
    votes = torch.zeros(K * C + 1, dtype=torch.int64, device=device).scatter_add_(0, vote_idx, torch.ones_like(vote_idx))
    votes = votes[: K * C].reshape(K, C)
    occupied = votes.sum(-1) > 0
    ins_class = votes.argmax(dim=-1)
    same_class = (ins_class[:, None] == ins_class[None, :]) & occupied[None, :]
    upper = torch.ones(K, K, dtype=torch.bool, device=device).tril()
    new_id = (same_class & upper).sum(-1)
    k = (ins_id - 1).clamp(min=0)
    void = torch.full_like(sem, void_label)
    pan = torch.where(ins_id > 0, ins_class[k] * label_divisor + new_id[k],
                      torch.where(thing_mask, void, sem * label_divisor))
    stuff = (ins_id == 0) & ~thing_mask
    stuff_sem = torch.where(stuff, sem, torch.full_like(sem, C - 1)).reshape(-1)
    areas = torch.zeros(C, dtype=torch.int64, device=device).scatter_add_(0, stuff_sem, torch.ones_like(stuff_sem))
    pan = torch.where(stuff & (areas[sem] < stuff_area), void, pan)
    return pan, scores


def panoptic_deeplab_postprocess(
    sem_logits: torch.Tensor,
    center: torch.Tensor,
    offset: torch.Tensor,
    image_size: Sequence[int],
    thing_ids: Iterable[int],
    label_divisor: int = 1000,
    stuff_area: int = 2048,
    threshold: float = 0.1,
    nms_kernel: int = 7,
    top_k: int = 200,
) -> Tuple[torch.Tensor, List[dict]]:
    """One image's padded-frame outputs (``sem_logits`` ``[Hp, Wp, C]``,
    ``center`` ``[Hp, Wp]`` or ``[Hp, Wp, 1]``, ``offset`` ``[Hp, Wp,
    2]``), cropped to ``image_size`` (h, w), fused by
    :func:`get_panoptic_segmentation` -> (panoptic ``[h, w]`` int32 on the
    outputs' device, ``segments_info``: ``id``, contiguous
    ``category_id``, ``isthing``, ``area`` for each id but the void),
    what ``COCOPanopticEvaluator`` takes."""
    h, w = int(image_size[0]), int(image_size[1])
    sem = sem_logits[:h, :w].argmax(dim=-1)
    if center.dim() == 3:
        center = center[..., 0]
    pan, _ = get_panoptic_segmentation(sem, center[:h, :w].float(), offset[:h, :w].float(), thing_ids, label_divisor,
                                       stuff_area, threshold, nms_kernel, top_k)
    pan = pan.to(torch.int32)
    ids, areas = torch.unique(pan, return_counts=True)
    thing_set = {int(t) for t in thing_ids}
    segments_info = []
    for pid, area in zip(ids.tolist(), areas.tolist()):
        if pid < 0:  # void
            continue
        cat = pid // label_divisor
        segments_info.append({"id": pid, "category_id": cat, "isthing": cat in thing_set, "area": area})
    return pan, segments_info
