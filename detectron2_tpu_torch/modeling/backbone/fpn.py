"""Feature Pyramid Network (counterpart of ``detectron2_tpu/modeling/backbone/fpn.py``).

Lateral 1x1 convs, a top-down path with nearest x2 upsampling, 3x3 output
convs, and a top block: LastLevelMaxPool for p6 (R-CNN), or LastLevelP6P7
for p6 and p7 (RetinaNet from ``res5``, FCOS from ``p5``). Takes NHWC
images, returns NHWC ``p*`` maps; convs run on channels_last NCHW inside.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, get_norm, nchw, nhwc
from detectron2_tpu_torch.modeling.backbone.resnet import ResNet, build_resnet_backbone

__all__ = [
    "FPN",
    "LastLevelMaxPool",
    "LastLevelP6P7",
    "build_resnet_fpn_backbone",
    "build_retinanet_resnet_fpn_backbone",
]


class LastLevelMaxPool(nn.Module):
    """p6 = stride-2 subsampling of p5 (1x1 max pool)."""

    num_levels = 1
    in_feature = "p5"

    def forward(self, x: torch.Tensor, train: bool):
        return [F.max_pool2d(x, kernel_size=1, stride=2)]


class LastLevelP6P7(nn.Module):
    """p6 = stride-2 3x3 conv of ``in_feature`` (a bottom-up feature such as
    ``res5``, or an FPN output such as ``p5``), p7 = stride-2 3x3 conv of
    relu(p6)."""

    num_levels = 2

    def __init__(self, in_channels: int, out_channels: int, in_feature: str = "res5"):
        super().__init__()
        self.in_feature = in_feature
        self.p6 = Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.p7 = Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, train: bool):
        p6 = self.p6(x, train)
        return [p6, self.p7(F.relu(p6), train)]


class FPN(nn.Module):
    def __init__(
        self,
        bottom_up: ResNet,
        in_features,
        out_channels: int = 256,
        norm: str = "",
        top_block=None,
        fuse_type: str = "sum",
    ):
        """``top_block`` reads its ``in_feature`` from the bottom-up features
        when it is one of them, else from the FPN's own outputs. Given as a
        constructor (``lazy_modules.last_level_p6p7``), it is called with that
        input's width."""
        super().__init__()
        assert fuse_type in ("sum", "avg"), fuse_type
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        self.top_block = top_block
        shapes = bottom_up.output_shape()
        self.in_strides = [shapes[f].stride for f in self.in_features]
        for s in self.in_strides:
            assert s == 2 ** int(math.log2(s)), f"stride {s} is not a power of 2"
        use_bias = norm == ""
        for f, s in zip(self.in_features, self.in_strides):
            level = int(math.log2(s))
            cin = shapes[f].channels
            self.add_module(
                f"fpn_lateral{level}",
                Conv2d(cin, out_channels, 1, bias=use_bias, norm=get_norm(norm, out_channels)),
            )
            self.add_module(
                f"fpn_output{level}",
                Conv2d(out_channels, out_channels, 3, padding=1, bias=use_bias, norm=get_norm(norm, out_channels)),
            )
        if top_block is not None and not isinstance(top_block, nn.Module):
            src = top_block.in_feature
            self.top_block = top_block = top_block(shapes[src].channels if src in shapes else out_channels)
        strides = list(self.in_strides)
        if top_block is not None:
            for _ in range(top_block.num_levels):
                strides.append(strides[-1] * 2)
        self._out_shapes = {
            f"p{int(math.log2(s))}": ShapeSpec(channels=out_channels, stride=s) for s in strides
        }

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return dict(self._out_shapes)

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC images -> dict of NHWC ``p*`` maps, finest first; ``train``
        goes to the bottom-up network and the lateral and output convs,
        ``generator`` to the bottom-up network."""
        bottom_up = self.bottom_up(x, train, generator)
        results = []
        prev = None
        for f, s in zip(reversed(self.in_features), reversed(self.in_strides)):
            level = int(math.log2(s))
            lateral = getattr(self, f"fpn_lateral{level}")(nchw(bottom_up[f]), train)
            if prev is not None:
                lateral = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
                if self.fuse_type == "avg":
                    lateral = lateral / 2.0
            prev = lateral
            results.insert(0, getattr(self, f"fpn_output{level}")(lateral, train))
        names = list(self._out_shapes)
        if self.top_block is not None:
            src = self.top_block.in_feature
            top_in = nchw(bottom_up[src]) if src in bottom_up else results[names.index(src)]
            results.extend(self.top_block(top_in, train))
        return {n: nhwc(r) for n, r in zip(names, results)}


def build_resnet_fpn_backbone(cfg, input_channels: int = 3) -> FPN:
    """ResNet + FPN with the p6 max pool (Faster/Mask R-CNN FPN)."""
    return FPN(
        bottom_up=build_resnet_backbone(cfg, input_channels),
        in_features=cfg.MODEL.FPN.IN_FEATURES,
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        norm=cfg.MODEL.FPN.NORM,
        top_block=LastLevelMaxPool(),
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )


def build_retinanet_resnet_fpn_backbone(cfg, input_channels: int = 3) -> FPN:
    """ResNet + FPN with p6 and p7 from ``res5`` (RetinaNet)."""
    bottom_up = build_resnet_backbone(cfg, input_channels)
    out_channels = cfg.MODEL.FPN.OUT_CHANNELS
    return FPN(
        bottom_up=bottom_up,
        in_features=cfg.MODEL.FPN.IN_FEATURES,
        out_channels=out_channels,
        norm=cfg.MODEL.FPN.NORM,
        top_block=LastLevelP6P7(bottom_up.output_shape()["res5"].channels, out_channels, "res5"),
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
    )
