"""DeformConv and ModulatedDeformConv (counterpart of
``detectron2_tpu/layers/deform_conv.py:19,66``): modules over
:func:`~detectron2_tpu_torch.ops.deform_conv.deform_conv2d`.

Parameters keep d2's names and layout (``weight`` OIHW ``[Cout, Cin /
groups, k, k]``, ``bias``, a ``norm`` child), so a d2 state dict loads by
name. The weight is cast to the input's dtype per call, as the flax modules
cast theirs. Inputs and outputs are NHWC, as the op's; offsets (and the
modulation mask) come from the caller.
"""

from typing import Optional

import torch
from torch import nn

from detectron2_tpu_torch.layers.wrappers import nchw, nhwc
from detectron2_tpu_torch.ops.deform_conv import deform_conv2d

__all__ = ["DeformConv", "ModulatedDeformConv"]


class DeformConv(nn.Module):
    """Deformable convolution v1 (NHWC): ``forward(x, offset, train)``. A
    ``norm`` runs on the output (``train`` goes to it)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 1,
        dilation: int = 1,
        groups: int = 1,
        deformable_groups: int = 1,
        bias: bool = False,
        norm: Optional[nn.Module] = None,
    ):
        super().__init__()
        assert in_channels % groups == 0 and out_channels % groups == 0, (in_channels, out_channels, groups)
        self.in_channels, self.out_channels, self.kernel_size = in_channels, out_channels, kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.deformable_groups = groups, deformable_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        nn.init.kaiming_uniform_(self.weight, nonlinearity="relu")
        self.norm = norm

    def _deform(self, x: torch.Tensor, offset: torch.Tensor, mask: Optional[torch.Tensor], train: bool) -> torch.Tensor:
        out = deform_conv2d(
            x, offset, self.weight.to(x.dtype).permute(2, 3, 1, 0), mask=mask, stride=self.stride,
            padding=self.padding, dilation=self.dilation, groups=self.groups,
            deformable_groups=self.deformable_groups, bias=self.bias,
        )
        if self.norm is not None:
            out = nhwc(self.norm(nchw(out), train))
        return out

    def forward(self, x: torch.Tensor, offset: torch.Tensor, train: bool) -> torch.Tensor:
        return self._deform(x, offset, None, train)

    def extra_repr(self) -> str:
        return (
            f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, stride={self.stride}, "
            f"padding={self.padding}, dilation={self.dilation}, groups={self.groups}, "
            f"deformable_groups={self.deformable_groups}, bias={self.bias is not None}"
        )


class ModulatedDeformConv(DeformConv):
    """Deformable convolution v2 (NHWC): ``forward(x, offset, mask, train)``
    with the mask already through its sigmoid. A bias by default, as d2's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, *, bias: bool = True, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, bias=bias, **kwargs)

    def forward(self, x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor, train: bool) -> torch.Tensor:
        return self._deform(x, offset, mask, train)
