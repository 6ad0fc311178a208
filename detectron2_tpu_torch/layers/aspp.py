"""ASPP: atrous spatial pyramid pooling (counterpart of
``detectron2_tpu/layers/aspp.py``), the DeepLab heads' context module.

d2's names: ``convs.0`` the 1x1 branch, ``convs.1``-``convs.3`` the atrous
branches (3x3 convs, or with ``use_depthwise_separable_conv``
:class:`DepthwiseSeparableConv2d`), ``convs.4`` the image pooling branch
(index 0 the pool, ``convs.4.1`` its 1x1 conv with a bias and the
activation, no norm), and ``project``, the 1x1 conv over the five branches.

The pool is always the global mean over the map: the JAX heads never pass
``pool_kernel_size`` (``detectron2_tpu/layers/aspp.py:76-88``), where d2
sizes an ``AvgPool2d`` from ``INPUT.CROP.SIZE`` when cropping is on
(ROADMAP C, known differences). Dropout after ``project`` draws its mask
from the generator given to the call.
"""

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers.batch_norm import get_norm
from detectron2_tpu_torch.layers.blocks import DepthwiseSeparableConv2d
from detectron2_tpu_torch.layers.wrappers import Conv2d

__all__ = ["ASPP", "generator_dropout"]


def generator_dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``Dropout``: in training each element kept with probability
    ``1 - rate`` (a uniform draw from ``generator``) and scaled by its
    inverse; the identity at inference or for ``rate`` 0."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class _GlobalAvgPool(nn.Module):
    """The image pooling branch's pool, at d2's index 0: the mean over the
    map, accumulated in float32 and returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


class ASPP(nn.Module):
    """Five parallel branches on an NCHW map, concatenated and projected.
    ``forward(x, train, generator)``; a conv has a bias only where it has
    no norm."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dilations: Sequence[int] = (6, 12, 18),
        *,
        norm: str = "",
        activation: Optional[Callable] = F.relu,
        dropout: float = 0.0,
        use_depthwise_separable_conv: bool = False,
    ):
        super().__init__()
        assert len(dilations) == 3, f"ASPP expects 3 dilations, got {len(dilations)}"
        self.dropout = dropout
        bias = not norm
        convs = [Conv2d(in_channels, out_channels, 1, bias=bias, norm=get_norm(norm, out_channels), activation=activation)]
        for d in dilations:
            if use_depthwise_separable_conv:
                convs.append(DepthwiseSeparableConv2d(
                    in_channels, out_channels, 3, padding=d, dilation=d,
                    norm1=norm, activation1=activation, norm2=norm, activation2=activation,
                ))
            else:
                convs.append(Conv2d(
                    in_channels, out_channels, 3, padding=d, dilation=d, bias=bias,
                    norm=get_norm(norm, out_channels), activation=activation,
                ))
        convs.append(nn.ModuleList([_GlobalAvgPool(), Conv2d(in_channels, out_channels, 1, bias=True, activation=activation)]))
        self.convs = nn.ModuleList(convs)
        self.project = Conv2d(5 * out_channels, out_channels, 1, bias=bias, norm=get_norm(norm, out_channels),
                              activation=activation)

    def forward(self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        branches = [conv(x, train) for conv in list(self.convs)[:-1]]
        pool, pool_conv = self.convs[-1]
        branches.append(pool_conv(pool(x), train).expand_as(branches[0]))
        y = self.project(torch.cat(branches, dim=1), train)
        return generator_dropout(y, self.dropout, train, generator)
