"""Fixed-shape greedy non-maximum suppression (counterpart of
``detectron2_tpu/ops/nms.py``: ``nms_padded`` :117, ``batched_nms_padded`` :161).

Plain PyTorch, batched over leading dims. The result is exact greedy NMS in
score order, with the JAX package's conventions:

- boxes are sorted by score with ties broken by lower index first;
- padded or non-finite-score slots are dead and zeroed, so they never
  suppress anything;
- a zero-area box has IoU 0 with every box, so it neither suppresses nor is
  suppressed, and is kept when valid;
- a box is suppressed when IoU > threshold with a kept box of higher rank.

Greedy NMS is the unique solution of ``alive[k] = valid[k] and not any(j < k:
alive[j] and iou[j, k] > t)``; it is reached by iterating that recurrence
over the whole [K, K] IoU matrix from "all valid alive" until nothing changes
(the JAX package iterates the same recurrence tile by tile). The number of
rounds is the depth of the longest suppression chain. The bool matrix of
"suppresses" edges is built in row blocks of at most ``_IOU_BLOCK_ELEMENTS``
IoU values, so that the float temporaries of a training RPN level (16
images x 12000 boxes, C4) stay a few GB; the blocks give the same bits.
"""

from typing import Optional

import torch

__all__ = ["pairwise_iou", "nms_padded", "batched_nms_padded"]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of XYXY boxes ``[..., N, 4]`` x ``[..., M, 4]`` -> ``[..., N, M]``;
    0 where the intersection is empty. Each step of the plain formula runs in
    place where it can, so that at most three float ``[..., N, M]`` arrays
    are alive at once (an RPN's gt x anchors IoU of 32 LSJ images at
    1024x1024 is 3.1 GiB each); the bits are the plain formula's."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    a, b = a[..., :, None, :], b[..., None, :, :]
    w = torch.minimum(a[..., 2], b[..., 2]).sub_(torch.maximum(a[..., 0], b[..., 0])).clamp_min_(0)
    h = torch.minimum(a[..., 3], b[..., 3]).sub_(torch.maximum(a[..., 1], b[..., 1])).clamp_min_(0)
    inter = w.mul_(h)
    del h
    empty = (inter > 0).logical_not_()
    union = (area_a[..., :, None] + area_b[..., None, :]).sub_(inter)
    iou = inter.div_(union.masked_fill_((union > 0).logical_not_(), 1.0))
    return iou.masked_fill_(empty, 0.0)


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy NMS on ``boxes [..., K, 4]`` with ``scores [..., K]``.

    Returns a bool ``[..., K]`` keep mask in the original box order. Each
    round of the fixpoint loop (one host sync) adds one to
    ``nms_padded.rounds``.
    """
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    valid_sorted = torch.isfinite(sorted_scores)
    boxes_sorted = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    boxes_sorted = boxes_sorted * valid_sorted[..., None].to(boxes_sorted.dtype)

    edge = _suppression_edges(boxes_sorted, iou_threshold)
    alive = valid_sorted
    while True:
        nms_padded.rounds += 1
        suppressed = (edge & alive[..., :, None]).any(dim=-2)
        new_alive = valid_sorted & ~suppressed
        if torch.equal(new_alive, alive):
            break
        alive = new_alive
    return torch.zeros_like(alive).scatter(-1, order, alive)


nms_padded.rounds = 0
_IOU_BLOCK_ELEMENTS = 2**27


def _suppression_edges(boxes_sorted: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``[..., K, K]`` bool: box j ranks before box k and their IoU is over
    the threshold; computed ``rows`` boxes j at a time."""
    K = boxes_sorted.shape[-2]
    batch = boxes_sorted[..., 0, 0].numel()
    rows = max(1, _IOU_BLOCK_ELEMENTS // max(1, batch * K))
    cols = torch.arange(K, device=boxes_sorted.device)
    edge = torch.empty(boxes_sorted.shape[:-1] + (K,), dtype=torch.bool, device=boxes_sorted.device)
    for start in range(0, K, rows):
        stop = min(start + rows, K)
        iou = pairwise_iou(boxes_sorted[..., start:stop, :], boxes_sorted)
        earlier = cols[start:stop, None] < cols[None, :]
        edge[..., start:stop, :] = (iou > iou_threshold) & earlier
    return edge


def batched_nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NMS that never suppresses across groups ``idxs [..., K]``: each group's
    boxes are shifted by ``idx * (max coordinate + 1)``, the max taken over
    valid boxes of each batch entry."""
    coord_src = boxes if valid is None else torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coordinate = coord_src.amax(dim=(-2, -1), keepdim=True)
    shifted = boxes + idxs.to(boxes.dtype)[..., None] * (max_coordinate + 1.0)
    return nms_padded(shifted, scores, iou_threshold, valid=valid)
