"""The weight-shared multi-dilation convolution (counterpart of the JAX
package's ``projects/tridentnet/trident_conv.py``; d2's ``TridentConv``).

One weight, applied once per branch with that branch's dilation and the
padding ``d * (k - 1) // 2`` that keeps the size; the branches' gradients
add up in the one weight. The conv is cuDNN's (``F.conv2d`` with
``dilation=d``), in the input's dtype. d2's names: ``weight``, ``bias``,
``norm`` (applied to every branch, in branch order: a norm with batch
statistics folds each branch's statistics into its running ones in turn,
as the JAX block's shared ``conv2_norm`` does).
"""

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d

__all__ = ["TridentConv"]

# flax's variance_scaling(..., "truncated_normal"): the std of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


class TridentConv(Conv2d):
    """:class:`Conv2d`'s weight, norm and activation, applied to a list of
    NCHW inputs, one a dilation of ``dilations``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, *,
                 dilations: Sequence[int] = (1, 2, 3), **kwargs):
        self.dilations = tuple(dilations)
        super().__init__(in_channels, out_channels, kernel_size, **kwargs)

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The JAX kernel's initializer, variance_scaling(2, fan_out,
        truncated normal): normal(0, sqrt(2 / fan_out) / 0.8796) truncated
        to two of its standard deviations; a zero bias. (Seeded weights come
        from ``modeling.init_weights``, msra as every ResNet conv.)"""
        fan_out = self.weight.shape[0] * self.weight[0, 0].numel()
        std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, inputs: List[torch.Tensor], train: bool) -> List[torch.Tensor]:
        """One NCHW tensor per branch -> one output per branch."""
        assert len(inputs) == len(self.dilations), (len(inputs), self.dilations)
        k = self.kernel_size[0]
        outs = []
        for x, d in zip(inputs, self.dilations):
            bias = None if self.bias is None else self.bias.to(x.dtype)
            y = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, d * (k - 1) // 2, d, self.groups)
            if self.norm is not None:
                y = self.norm(y, train)
            if self.activation is not None:
                y = self.activation(y)
            outs.append(y)
        return outs

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, dilations={self.dilations}"
