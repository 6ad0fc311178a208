"""DeepLab's hard-pixel-mining cross entropy (counterpart of the JAX
package's ``projects/deeplab/loss.py``)."""

from typing import Optional, Sequence

import torch

__all__ = ["hard_pixel_mining_ce"]


def hard_pixel_mining_ce(
    logits: torch.Tensor,
    targets: torch.Tensor,
    ignore_index: int = 255,
    top_k_percent: float = 0.2,
    weight: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """The cross entropy of ``logits`` ``[B, H, W, C]`` (float32) against
    ``targets`` ``[B, H, W]``, averaged over each image's hardest
    ``k = int(top_k_percent * H * W)`` pixels of the padded frame, the
    mean taken over the kept pixels of the whole batch. Ignored pixels
    carry -1, so they sort after every real pixel (a loss is >= 0) and are
    never kept. ``top_k_percent`` 1.0 is the plain mean over the valid
    pixels. (d2 takes the top k of the whole batch, zeros included: ROADMAP
    C, known differences.)"""
    valid = targets != ignore_index
    t = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    if weight is not None:
        nll = nll * torch.as_tensor(weight, dtype=nll.dtype, device=nll.device)[t]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if top_k_percent >= 1.0:
        return nll.sum() / valid.sum().clamp(min=1)
    flat = torch.where(valid, nll, torch.full_like(nll, -1.0)).flatten(1)
    k = max(1, int(top_k_percent * flat.shape[1]))
    # only the sum of the kept values is read, so which of two equal values
    # torch.topk keeps (lax.top_k keeps the lower index) changes nothing
    top = torch.topk(flat, k, dim=1).values
    kept = top > -0.5
    return torch.where(kept, top, torch.zeros_like(top)).sum() / kept.sum().clamp(min=1)
