"""Conv2d with optional norm and activation (counterpart of
``detectron2_tpu/layers/wrappers.py:20``).

Parameters keep d2's names and layouts (OIHW weight, ``.norm`` child), and the
conv runs in the input's dtype: float32 weights are cast to it per call, as
the flax module casts its kernel to ``x.dtype``.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "ConvTranspose2d", "Linear", "nchw", "nhwc"]


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view; a contiguous NHWC tensor becomes channels_last."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC, contiguous."""
    return x.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Conv2d):
    """``torch.nn.Conv2d`` plus ``norm`` and ``activation``, computed in the
    input's dtype. ``forward(x, train)`` hands ``train`` to the norm, as the
    JAX ``Conv2d.__call__(x, train)`` does; it has no default, so that a
    caller cannot leave a norm with batch statistics in the wrong mode."""

    def __init__(
        self,
        *args,
        norm: Optional[nn.Module] = None,
        activation: Optional[Callable] = None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.activation = activation

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.dilation, self.groups
        )
        if self.norm is not None:
            x = self.norm(x, train)
        if self.activation is not None:
            x = self.activation(x)
        return x


class ConvTranspose2d(nn.ConvTranspose2d):
    """``torch.nn.ConvTranspose2d`` computed in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation,
        )


class Linear(nn.Linear):
    """``torch.nn.Linear`` computed in the input's dtype, as a flax
    ``Dense(dtype=x.dtype)``: float32 weights are cast to it per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)
