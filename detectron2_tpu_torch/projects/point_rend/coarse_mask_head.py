"""PointRend's coarse heads (counterpart of the JAX package's
``projects/point_rend/coarse_mask_head.py``): d2's ``ConvFCHead`` over the
point-sampled ``[R, res, res, C]`` pool: a 1x1 conv to ``conv_dim``
channels when the input has more, a 2x2 stride-2 conv, the fc layers on the
CHW flatten (the layout of d2's ``fc1`` weight), then a linear prediction.
``CoarseMaskHead`` reshapes it as d2's ``[R, classes, side, side]`` and
returns it NHWC; ``ImplicitParameterHead`` returns it flat, each instance's
point-head parameters. The input is float32 samples, so the head runs in
float32, as the JAX head does.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, nchw
from detectron2_tpu_torch.modeling.roi_heads.mask_head import ROI_MASK_HEAD_REGISTRY

__all__ = ["ConvFCHead", "CoarseMaskHead", "ImplicitParameterHead"]


class ConvFCHead(nn.Module):
    def __init__(self, in_channels: int, input_resolution: int, conv_dim: int, fc_dims: Sequence[int], output_dim: int):
        super().__init__()
        if in_channels > conv_dim:
            self.reduce_channel_dim_conv = Conv2d(in_channels, conv_dim, kernel_size=1, activation=F.relu)
            in_channels = conv_dim
        else:
            self.reduce_channel_dim_conv = None
        self.reduce_spatial_dim_conv = Conv2d(in_channels, conv_dim, kernel_size=2, stride=2, activation=F.relu)
        self.fc_dims = tuple(fc_dims)
        in_dim = conv_dim * (input_resolution // 2) ** 2
        for k, dim in enumerate(self.fc_dims):
            self.add_module(f"fc{k + 1}", nn.Linear(in_dim, dim))
            in_dim = dim
        self.prediction = nn.Linear(in_dim, output_dim)
        nn.init.normal_(self.prediction.weight, std=0.001)
        nn.init.zeros_(self.prediction.bias)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x: ``[R, res, res, C]`` -> ``[R, output_dim]`` float32."""
        x = nchw(x.float())
        if self.reduce_channel_dim_conv is not None:
            x = self.reduce_channel_dim_conv(x, train)
        x = self.reduce_spatial_dim_conv(x, train).reshape(x.shape[0], -1)
        for k in range(len(self.fc_dims)):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
        return self.prediction(x)


@ROI_MASK_HEAD_REGISTRY.register()
class CoarseMaskHead(ConvFCHead):
    """Coarse mask logits ``[R, side, side, classes]`` float32."""

    def __init__(self, in_channels: int, input_resolution: int, num_classes: int, conv_dim: int = 256,
                 fc_dims: Sequence[int] = (1024, 1024), output_side_resolution: int = 7):
        self.num_classes, self.side = num_classes, output_side_resolution
        super().__init__(in_channels, input_resolution, conv_dim, fc_dims, num_classes * output_side_resolution**2)

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "CoarseMaskHead":
        h = cfg.MODEL.ROI_MASK_HEAD
        return cls(in_channels, h.POOLER_RESOLUTION, cfg.MODEL.ROI_HEADS.NUM_CLASSES, h.CONV_DIM, [h.FC_DIM] * h.NUM_FC,
                   h.OUTPUT_SIDE_RESOLUTION)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = super().forward(x, train)
        return out.reshape(-1, self.num_classes, self.side, self.side).permute(0, 2, 3, 1)


class ImplicitParameterHead(ConvFCHead):
    """Each instance's point-head parameters ``[R, num_params]``."""

    @classmethod
    def from_config(cls, cfg, in_channels: int, num_params: int) -> "ImplicitParameterHead":
        h = cfg.MODEL.ROI_MASK_HEAD
        return cls(in_channels, h.POOLER_RESOLUTION, h.CONV_DIM, [h.FC_DIM] * h.NUM_FC, num_params)
