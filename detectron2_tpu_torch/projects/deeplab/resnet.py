"""The DeepLab ResNet (counterpart of the JAX package's
``projects/deeplab/resnet.py``): :class:`DeepLabStem`, three 3x3 convs and
a max pool, and :func:`build_resnet_deeplab_backbone`, whose res4 and res5
may dilate instead of striding, res5's blocks at ``RES5_DILATION`` times
``RES5_MULTI_GRID[b % len]``. The blocks are the port's
``BottleneckBlock`` / ``DeformBottleneckBlock``; d2's names
(``stem.conv{1,2,3}``, ``res5.0.conv2``)."""

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, get_norm
from detectron2_tpu_torch.modeling.backbone.resnet import (
    RESNET_STAGES,
    BottleneckBlock,
    DeformBottleneckBlock,
    ResNet,
    build_stages,
)

__all__ = ["DeepLabStem", "build_resnet_deeplab_backbone"]


class DeepLabStem(nn.Module):
    """conv1 (``out_channels // 2``, stride 2), conv2 (``out_channels //
    2``), conv3 (``out_channels``), each 3x3 with norm and ReLU and no bias,
    then a 3x3 max pool at stride 2: stride 4, as ``BasicStem``."""

    stride = 4

    def __init__(self, in_channels: int = 3, out_channels: int = 128, norm: str = "BN"):
        super().__init__()
        self.out_channels = out_channels
        half = out_channels // 2
        for i, (cin, cout, stride) in enumerate(((in_channels, half, 2), (half, half, 1), (half, out_channels, 1)), 1):
            self.add_module(f"conv{i}", Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                                               norm=get_norm(norm, cout), activation=F.relu))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def build_resnet_deeplab_backbone(cfg, input_channels: int = 3) -> ResNet:
    """The ResNet of ``cfg.MODEL.RESNETS`` with ``RES4_DILATION`` (1 or 2),
    ``RES5_DILATION`` (1, 2 or 4; 4 when res4 dilates) and
    ``RES5_MULTI_GRID``: output stride 16 (res5 dilated 2) or 8; a dilated
    stage's first block does not stride. ``STEM_TYPE`` "deeplab" takes
    :class:`DeepLabStem`, else d2's ``BasicStem``. Bottleneck depths only."""
    from detectron2_tpu_torch.modeling.backbone.resnet import BasicStem

    r = cfg.MODEL.RESNETS
    depth, norm = r.DEPTH, r.NORM
    res4_dilation, res5_dilation = r.RES4_DILATION, r.RES5_DILATION
    multi_grid = list(r.RES5_MULTI_GRID)
    assert res4_dilation in {1, 2}, f"res4_dilation cannot be {res4_dilation}."
    assert res5_dilation in {1, 2, 4}, f"res5_dilation cannot be {res5_dilation}."
    if res4_dilation == 2:
        assert res5_dilation == 4, "res5 must dilate 4x when res4 dilates 2x"
    assert depth not in (18, 34), "DeepLab backbone requires bottleneck ResNets"
    bottleneck_channels = r.NUM_GROUPS * r.WIDTH_PER_GROUP
    in_channels, out_channels = r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS
    specs = []
    for idx, stage_idx in enumerate(range(2, 6)):
        dilation = {4: res4_dilation, 5: res5_dilation}.get(stage_idx, 1)
        first_stride = 1 if idx == 0 or dilation > 1 else 2
        blocks = []
        for b in range(RESNET_STAGES[depth][idx]):
            kwargs = {
                "in_channels": in_channels if b == 0 else out_channels,
                "out_channels": out_channels,
                "stride": first_stride if b == 0 else 1,
                "norm": norm,
                "bottleneck_channels": bottleneck_channels,
                "stride_in_1x1": r.STRIDE_IN_1X1,
                "dilation": dilation * multi_grid[b % len(multi_grid)] if stage_idx == 5 else dilation,
                "num_groups": r.NUM_GROUPS,
                "block_class": BottleneckBlock,
            }
            if r.DEFORM_ON_PER_STAGE[idx]:
                kwargs.update(block_class=DeformBottleneckBlock, deform_modulated=r.DEFORM_MODULATED,
                              deform_num_groups=r.DEFORM_NUM_GROUPS)
            blocks.append(kwargs)
        specs.append(blocks)
        in_channels = out_channels
        out_channels *= 2
        bottleneck_channels *= 2
    stem_class = DeepLabStem if r.get("STEM_TYPE", "basic") == "deeplab" else BasicStem
    stem = stem_class(input_channels, r.STEM_OUT_CHANNELS, norm)
    return ResNet(stem, build_stages(specs, r.OUT_FEATURES), r.OUT_FEATURES, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT)
