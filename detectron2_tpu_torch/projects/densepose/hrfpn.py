"""HRFPN, high-resolution feature pyramids (counterpart of
``detectron2_tpu/projects/densepose/hrfpn.py``: ``HRFPN`` :25,
``build_hrfpn_backbone`` :105).

Turns HRNet's four branches into a pyramid of ``len(ROI_HEADS.IN_FEATURES)``
levels ``p1``.. at strides 4, 8, 16, 32, 64: each branch i is brought to
(about) stride 4 by a learned upsample, a kernel-4 transposed conv at stride
2^i with torch padding 0 (``(in - 1) * 2^i + 4``), BN and ReLU; the four are
cropped to the smallest and concatenated; level i is one conv of kernel and
stride 2^i (with bias), BN and ReLU; every level is cropped to 2^i times the
deepest level's size (at 800x1344: p1 192x320 of the 196x332 concat); then a
3x3 conv per level. Module names are d2's (``interp_conv.i.{0,1}``,
``reduction_pooling_conv.i.{0,1}``, ``fpn_conv.i``, ``bottom_up``).
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import BatchNorm2d, Conv2d, ConvTranspose2d, ShapeSpec, nchw, nhwc
from detectron2_tpu_torch.projects.densepose.hrnet import PoseHigherResolutionNet

__all__ = ["HRFPN", "build_hrfpn_backbone"]


class HRFPN(nn.Module):
    def __init__(
        self, bottom_up: PoseHigherResolutionNet, in_channels: Sequence[int], n_out_features: int = 5,
        out_channels: int = 256,
    ):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_channels = list(in_channels)
        self.n_out_features = n_out_features
        self.out_channels = out_channels
        self.interp_conv = nn.ModuleList(
            nn.Sequential(ConvTranspose2d(c, c, 4, stride=2**i, padding=0, bias=False), BatchNorm2d(c), nn.ReLU())
            for i, c in enumerate(self.in_channels)
        )
        self.reduction_pooling_conv = nn.ModuleList(
            nn.Sequential(Conv2d(sum(self.in_channels), out_channels, 2**i, stride=2**i), BatchNorm2d(out_channels), nn.ReLU())
            for i in range(n_out_features)
        )
        self.fpn_conv = nn.ModuleList(Conv2d(out_channels, out_channels, 3, padding=1) for _ in range(n_out_features))

    @classmethod
    def from_config(cls, cfg) -> "HRFPN":
        return cls(
            PoseHigherResolutionNet.from_config(cfg),
            [int(c) for c in cfg.MODEL.HRNET.STAGE4.NUM_CHANNELS],
            n_out_features=len(cfg.MODEL.ROI_HEADS.IN_FEATURES),
            out_channels=int(cfg.MODEL.HRNET.HRFPN.OUT_CHANNELS),
        )

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {f"p{i + 1}": ShapeSpec(channels=self.out_channels, stride=2 ** (i + 2)) for i in range(self.n_out_features)}

    @property
    def size_divisibility(self) -> int:
        return 32

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC images -> ``p1``.. NHWC maps, finest first."""
        feats = self.bottom_up(x, train)
        outs = []
        for i, seq in enumerate(self.interp_conv):
            z = seq[0](nchw(feats[f"p{i + 1}"]))
            outs.append(F.relu(seq[1](z, train)))
        h = min(o.shape[-2] for o in outs)
        w = min(o.shape[-1] for o in outs)
        out = torch.cat([o[:, :, :h, :w] for o in outs], dim=1)
        levels = [F.relu(seq[1](seq[0](out, train), train)) for seq in self.reduction_pooling_conv]
        # every level 2^i times the deepest one's size
        dh, dw = levels[-1].shape[-2:]
        k = len(levels) - 1
        levels = [z[:, :, : dh * 2 ** (k - i), : dw * 2 ** (k - i)] for i, z in enumerate(levels)]
        return {f"p{i + 1}": nhwc(conv(z, train)) for i, (conv, z) in enumerate(zip(self.fpn_conv, levels))}


def build_hrfpn_backbone(cfg, input_channels: int = 3) -> HRFPN:
    """HRNet + HRFPN, ``len(ROI_HEADS.IN_FEATURES)`` levels."""
    return HRFPN.from_config(cfg)
