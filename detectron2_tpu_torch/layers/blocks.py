"""Building blocks (counterpart of ``detectron2_tpu/layers/blocks.py``)."""

from typing import Optional

import torch
from torch import nn

__all__ = ["DropPath"]


class DropPath(nn.Module):
    """Stochastic depth: when training, drop a residual branch per sample
    with probability ``rate`` and scale the survivors by 1 / keep. Identity
    at inference and for ``rate == 0``. The draws come from the generator
    passed to the call, or from the device's default generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
