"""The losses the Mask R-CNN FPN config reads (counterpart of
``detectron2_tpu/layers/losses.py``): sum-reduced with explicit masks, as
the JAX package computes them. GIoU, DIoU, CIoU and focal losses come with
the heads that use them."""

import torch
import torch.nn.functional as F

__all__ = ["smooth_l1_loss", "cross_entropy", "binary_cross_entropy_with_logits"]


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
