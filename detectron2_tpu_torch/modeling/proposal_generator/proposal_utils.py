"""Fixed-shape proposal selection and the training-time append of the
ground truth (counterpart of
``detectron2_tpu/modeling/proposal_generator/proposal_utils.py``: :53, :98).

Selection:

1. per-level top-k (k = min(pre_nms_topk, anchors in the level));
2. clip to each image's true size; tiny or non-finite boxes get score -inf;
3. per-level greedy NMS;
4. one top-k of ``post_nms_topk`` over the union of the levels.
"""

import math
from typing import List, Tuple

import torch

from detectron2_tpu_torch.ops.nms import nms_padded
from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["find_top_rpn_proposals_padded", "add_ground_truth_to_proposals_padded"]


def _clip(boxes: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
    """Clip ``[B, K, 4]`` boxes to per-image ``(h, w)``."""
    h = image_sizes[:, 0].to(boxes.dtype)[:, None]
    w = image_sizes[:, 1].to(boxes.dtype)[:, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _process_level(boxes, logits, image_sizes, nms_thresh, min_box_size):
    """Clip, filter and NMS one level of every image: ``[B, K, 4]``, ``[B, K]``."""
    boxes = _clip(boxes, image_sizes)
    finite = torch.isfinite(boxes).all(dim=-1) & torch.isfinite(logits)
    big_enough = ((boxes[..., 2] - boxes[..., 0]) > min_box_size) & (
        (boxes[..., 3] - boxes[..., 1]) > min_box_size
    )
    valid = finite & big_enough
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    neg_inf = torch.full_like(logits, float("-inf"))
    keep = nms_padded(boxes, torch.where(valid, logits, neg_inf), nms_thresh, valid=valid)
    return boxes, torch.where(keep & valid, logits, neg_inf)


def find_top_rpn_proposals_padded(
    proposals: List[torch.Tensor],
    pred_objectness_logits: List[torch.Tensor],
    image_sizes: torch.Tensor,
    nms_thresh: float,
    pre_nms_topk: int,
    post_nms_topk: int,
    min_box_size: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Args:
        proposals: per level ``[B, Ai, 4]`` decoded boxes.
        pred_objectness_logits: per level ``[B, Ai]``.
        image_sizes: ``[B, 2]`` (h, w).

    Returns:
        boxes ``[B, post_nms_topk, 4]``, logits ``[B, post_nms_topk]`` (-inf
        on padding), valid ``[B, post_nms_topk]``.
    """
    level_boxes, level_logits = [], []
    for boxes_l, logits_l in zip(proposals, pred_objectness_logits):
        k = min(pre_nms_topk, logits_l.shape[1])
        top_logits, idx = top_k(logits_l, k)
        top_boxes = torch.gather(boxes_l, 1, idx[..., None].expand(-1, -1, 4))
        b, l = _process_level(top_boxes, top_logits, image_sizes, nms_thresh, min_box_size)
        level_boxes.append(b)
        level_logits.append(l)
    all_boxes = torch.cat(level_boxes, dim=1)
    all_logits = torch.cat(level_logits, dim=1)

    k = min(post_nms_topk, all_logits.shape[1])
    top_logits, idx = top_k(all_logits, k)
    top_boxes = torch.gather(all_boxes, 1, idx[..., None].expand(-1, -1, 4))
    valid = torch.isfinite(top_logits)
    if k < post_nms_topk:
        pad = post_nms_topk - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_logits = torch.nn.functional.pad(top_logits, (0, pad), value=float("-inf"))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return top_boxes, top_logits, valid


def add_ground_truth_to_proposals_padded(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    proposals: torch.Tensor,
    logits: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Append the padded gt ``[B, G, 4]`` to the proposals ``[B, P, 4]``
    with the objectness logit of probability ``1 - 1e-10`` (-inf on padded
    gt): ``[B, P+G, ...]`` boxes, logits and valid."""
    gt_logit = math.log((1.0 - 1e-10) / (1 - (1.0 - 1e-10)))
    gt_logits = torch.full_like(gt_valid, float("-inf"), dtype=logits.dtype).masked_fill(gt_valid, gt_logit)
    return (
        torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1),
        torch.cat([logits, gt_logits], dim=1),
        torch.cat([valid, gt_valid], dim=1),
    )
