"""The losses the R-CNN and dense detectors read (counterpart of
``detectron2_tpu/layers/losses.py``): elementwise or sum-reduced, with the
callers' masks applied as products, as the JAX package computes them."""

import math

import torch
import torch.nn.functional as F

__all__ = [
    "smooth_l1_loss",
    "giou_loss",
    "diou_loss",
    "ciou_loss",
    "IOU_LOSSES",
    "sigmoid_focal_loss",
    "cross_entropy",
    "binary_cross_entropy_with_logits",
]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def smooth_l1_loss(input: torch.Tensor, target: torch.Tensor, beta: float, reduction: str = "none") -> torch.Tensor:
    """Quadratic below ``beta``, linear above; ``beta < 1e-5`` is pure L1
    (the d2 default)."""
    diff = (input - target).abs()
    if beta < 1e-5:
        loss = diff
    else:
        loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    return _reduce(loss, reduction)


def _iou_and_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    # max(., 0) splits the gradient where the overlap is exactly 0, as
    # jnp.clip does (clamp_min passes all of it)
    zero = boxes1.new_zeros(())
    inter = torch.maximum(torch.minimum(x2, x2g) - torch.maximum(x1, x1g), zero) * torch.maximum(
        torch.minimum(y2, y2g) - torch.maximum(y1, y1g), zero
    )
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - inter
    return inter / (union + 1e-7), union


def _enclosing(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Width and height of the smallest box enclosing both."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    return torch.maximum(x2, x2g) - torch.minimum(x1, x1g), torch.maximum(y2, y2g) - torch.minimum(y1, y1g)


def _center_distance_term(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Squared distance of the centres over the squared enclosing diagonal
    (``1e-7`` added to the diagonal)."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    wc, hc = _enclosing(boxes1, boxes2)
    diag_len = wc**2 + hc**2 + 1e-7
    dist = ((x2 + x1) / 2 - (x2g + x1g) / 2) ** 2 + ((y2 + y1) / 2 - (y2g + y1g) / 2) ** 2
    return dist / diag_len


def giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none") -> torch.Tensor:
    """Generalized IoU loss of XYXY boxes ``[..., 4]`` (fvcore's formula, as
    the JAX ``giou_loss``): ``1 - iou + (enclosing - union) / enclosing``
    with ``1e-7`` added to the union and to the enclosing area."""
    iou, union = _iou_and_union(boxes1, boxes2)
    wc, hc = _enclosing(boxes1, boxes2)
    area_c = wc * hc
    miou = iou - (area_c - union) / (area_c + 1e-7)
    return _reduce(1 - miou, reduction)


def diou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none") -> torch.Tensor:
    """Distance IoU loss (d2's ``diou_loss``, as the JAX one):
    ``1 - iou + |centre - centre_gt|^2 / diagonal^2`` of the enclosing box."""
    iou, _ = _iou_and_union(boxes1, boxes2)
    return _reduce(1 - iou + _center_distance_term(boxes1, boxes2), reduction)


def ciou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, reduction: str = "none") -> torch.Tensor:
    """Complete IoU loss (d2's ``ciou_loss``, as the JAX one): DIoU plus
    ``alpha * v``, ``v`` the squared difference of the aspect angles times
    ``4 / pi^2`` (heights clamped at ``1e-7``), ``alpha = v / (1 - iou + v +
    1e-7)`` without gradient."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    iou, _ = _iou_and_union(boxes1, boxes2)
    h_pred = (y2 - y1).clamp_min(1e-7)
    h_gt = (y2g - y1g).clamp_min(1e-7)
    v = (4.0 / (math.pi**2)) * (torch.atan((x2g - x1g) / h_gt) - torch.atan((x2 - x1) / h_pred)) ** 2
    alpha = (v / (1 - iou + v + 1e-7)).detach()
    return _reduce(1 - iou + _center_distance_term(boxes1, boxes2) + alpha * v, reduction)


IOU_LOSSES = {"giou": giou_loss, "diou": diou_loss, "ciou": ciou_loss}
"""The box losses on decoded boxes, by ``BBOX_REG_LOSS_TYPE``."""


def sigmoid_focal_loss(
    inputs: torch.Tensor, targets: torch.Tensor, alpha: float = -1, gamma: float = 2, reduction: str = "none"
) -> torch.Tensor:
    """Focal loss on logits (fvcore's formula): the binary cross entropy
    times ``(1 - p_t) ** gamma``, times ``alpha_t`` unless ``alpha < 0``."""
    p = torch.sigmoid(inputs)
    ce_loss = binary_cross_entropy_with_logits(inputs, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce_loss * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise, numerically stable: ``max(x, 0) - x*t + log1p(exp(-|x|))``."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean", ignore_index: int = -100
) -> torch.Tensor:
    """Softmax cross entropy over the last dim with integer labels; labels
    equal to ``ignore_index`` contribute 0, and ``"mean"`` divides by the
    number of the others (at least 1)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return nll.sum() / valid.sum().clamp_min(1)
    return _reduce(nll, reduction)
