"""Building blocks (counterpart of ``detectron2_tpu/layers/blocks.py``)."""

from typing import Callable, Optional

import torch
from torch import nn

from detectron2_tpu_torch.layers.batch_norm import get_norm
from detectron2_tpu_torch.layers.wrappers import Conv2d

__all__ = ["DepthwiseSeparableConv2d", "DropPath"]


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


class DepthwiseSeparableConv2d(nn.Module):
    """A ``kernel_size`` depthwise conv (one group a channel), then a 1x1
    pointwise conv, each with its optional norm and activation; d2's names
    (``depthwise``, ``pointwise``). A conv has a bias only where it has no
    norm: the JAX block's ``use_bias=norm is None``
    (``detectron2_tpu/layers/blocks.py:51``), so with norm ``""`` it has
    none, where d2's has one (ROADMAP C; no config uses ``""``).
    ``forward(x, train)`` takes and returns NCHW."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: int = 1,
        dilation: int = 1,
        *,
        norm1: Optional[str] = None,
        activation1: Optional[Callable] = None,
        norm2: Optional[str] = None,
        activation2: Optional[Callable] = None,
    ):
        super().__init__()
        self.depthwise = Conv2d(
            in_channels, in_channels, kernel_size, padding=padding, dilation=dilation, groups=in_channels,
            bias=norm1 is None, norm=get_norm(norm1, in_channels), activation=activation1,
        )
        self.pointwise = Conv2d(
            in_channels, out_channels, 1, bias=norm2 is None, norm=get_norm(norm2, out_channels), activation=activation2,
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.pointwise(self.depthwise(x, train), train)
