"""Fixed-shape random positive/negative subsampling (counterpart of
``detectron2_tpu/modeling/sampling.py``).

Exactly ``num_samples`` slots per row (indices, validity, is_positive),
chosen by a top-k over random keys, with the reference's counts:

    num_pos = min(#positives, int(num_samples * positive_fraction))
    num_neg = min(#negatives, num_samples - num_pos)

and a uniform choice without replacement within each class.
"""

from typing import Optional, Tuple

import torch

from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["subsample_labels_padded", "uniform_draws"]


def uniform_draws(shape, generator: Optional[torch.Generator], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's two uniform [0, 1) draws of ``shape``: the keys of the
    positive choice and the tie-breaks of the slot order. One function, so
    that a test can supply both."""
    r1 = torch.rand(shape, generator=generator, device=device)
    r2 = torch.rand(shape, generator=generator, device=device)
    return r1, r2


def subsample_labels_padded(
    labels: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    bg_label: int = 0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """
    Args:
        labels: int ``[B, N]``; -1 ignore, ``bg_label`` negative, anything
            else positive.
        num_samples: output slots per row.
        positive_fraction: target fraction of positives.
        generator: the draws' generator (the device's default when None).

    Returns:
        idx ``[B, num_samples]`` int64 into ``labels`` (arbitrary where
        invalid), valid and is_positive ``[B, num_samples]`` bool.
    """
    B, N = labels.shape
    num_pos_target = int(num_samples * positive_fraction)
    positive = (labels != -1) & (labels != bg_label)
    negative = labels == bg_label
    r1, r2 = uniform_draws((B, N), generator, labels.device)

    pos_key = torch.where(positive, r1, torch.full_like(r1, float("-inf")))
    _, pos_top = top_k(pos_key, min(num_pos_target, N))
    keep_pos = torch.zeros_like(positive).scatter_(1, pos_top, True) & positive

    # priority bands: chosen positives 2, negatives 1, the rest 0, with a
    # random tie-break strictly inside each band
    priority = keep_pos.float() * 2.0 + negative.float() * 1.0 + r2 * 0.999
    k = min(num_samples, N)
    top_p, idx = top_k(priority, k)
    valid = top_p >= 1.0
    is_positive = top_p >= 2.0
    if k < num_samples:
        pad = (0, num_samples - k)
        idx = torch.nn.functional.pad(idx, pad)
        valid = torch.nn.functional.pad(valid, pad)
        is_positive = torch.nn.functional.pad(is_positive, pad)
    return idx, valid, is_positive
