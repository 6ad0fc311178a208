"""ResNet backbone (counterpart of ``detectron2_tpu/modeling/backbone/resnet.py``).

Module names follow d2 (``stem.conv1``, ``res2.0.conv1``, ``.shortcut``), so
a d2 state dict loads by name. The conv tower runs on channels_last NCHW
tensors; :meth:`ResNet.forward` takes and returns NHWC.
"""

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, DeformConv, ModulatedDeformConv, ShapeSpec, get_norm, nchw, nhwc

__all__ = [
    "BasicStem",
    "BasicBlock",
    "BottleneckBlock",
    "DeformBottleneckBlock",
    "ResNet",
    "build_resnet_backbone",
    "build_stages",
    "make_stage_specs",
]

RESNET_STAGES = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class BasicStem(nn.Module):
    """7x7 conv stride 2 + norm + relu + 3x3 maxpool stride 2."""

    stride = 4

    def __init__(self, in_channels: int = 3, out_channels: int = 64, norm: str = "FrozenBN"):
        super().__init__()
        self.out_channels = out_channels
        self.conv1 = Conv2d(
            in_channels, out_channels, 7, stride=2, padding=3, bias=False,
            norm=get_norm(norm, out_channels), activation=F.relu,
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.max_pool2d(self.conv1(x, train), kernel_size=3, stride=2, padding=1)


def _shortcut(in_channels, out_channels, stride, norm):
    if in_channels == out_channels and stride == 1:
        return None
    return Conv2d(
        in_channels, out_channels, 1, stride=stride, bias=False, norm=get_norm(norm, out_channels)
    )


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual (ResNet-18/34)."""

    def __init__(self, in_channels: int, out_channels: int, *, stride: int = 1, norm: str = "FrozenBN"):
        super().__init__()
        self.stride, self.out_channels = stride, out_channels
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm)
        self.conv1 = Conv2d(
            in_channels, out_channels, 3, stride=stride, padding=1, bias=False,
            norm=get_norm(norm, out_channels), activation=F.relu,
        )
        self.conv2 = Conv2d(
            out_channels, out_channels, 3, padding=1, bias=False, norm=get_norm(norm, out_channels)
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.conv2(self.conv1(x, train), train)
        shortcut = x if self.shortcut is None else self.shortcut(x, train)
        return F.relu(out + shortcut)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 with a residual (ResNet-50 and deeper).
    ``stride_in_1x1`` puts the stride on the first 1x1 (the MSRA/Caffe2 zoo
    weights need it)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        *,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        stride_in_1x1: bool = False,
        dilation: int = 1,
    ):
        super().__init__()
        self.stride, self.out_channels = stride, out_channels
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm)
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, 1, stride=stride_1x1, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
        )
        self.conv2 = Conv2d(
            bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3, padding=dilation,
            dilation=dilation, groups=num_groups, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
        )
        self.conv3 = Conv2d(
            bottleneck_channels, out_channels, 1, bias=False, norm=get_norm(norm, out_channels)
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x, train), train), train)
        shortcut = x if self.shortcut is None else self.shortcut(x, train)
        return F.relu(out + shortcut)


class DeformBottleneckBlock(nn.Module):
    """:class:`BottleneckBlock` whose 3x3 conv is a deformable conv (v2,
    modulated, with ``deform_modulated``), its offsets (and mask) predicted
    by the plain 3x3 ``conv2_offset`` from the block's 1x1 output
    (``detectron2_tpu/modeling/backbone/resnet.py:180``). ``conv2_offset``
    starts at zero, so the block starts as a plain conv. With modulation its
    first ``2 * 9 * deform_num_groups`` channels are the offsets and the rest
    the mask, through a sigmoid. d2's names: ``conv2_offset``, ``conv2``
    (the deformable conv, its norm ``conv2.norm``)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        *,
        bottleneck_channels: int,
        stride: int = 1,
        num_groups: int = 1,
        norm: str = "FrozenBN",
        stride_in_1x1: bool = False,
        dilation: int = 1,
        deform_modulated: bool = False,
        deform_num_groups: int = 1,
    ):
        super().__init__()
        self.stride, self.out_channels = stride, out_channels
        self.deform_modulated = deform_modulated
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm)
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, 1, stride=stride_1x1, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
        )
        offset_channels = (27 if deform_modulated else 18) * deform_num_groups
        self.conv2_offset = Conv2d(
            bottleneck_channels, offset_channels, 3, stride=stride_3x3, padding=dilation, dilation=dilation
        )
        nn.init.zeros_(self.conv2_offset.weight)
        nn.init.zeros_(self.conv2_offset.bias)
        deform = ModulatedDeformConv if deform_modulated else DeformConv
        self.conv2 = deform(
            bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3, padding=dilation, dilation=dilation,
            groups=num_groups, deformable_groups=deform_num_groups, bias=False,
            norm=get_norm(norm, bottleneck_channels),
        )
        self.conv3 = Conv2d(
            bottleneck_channels, out_channels, 1, bias=False, norm=get_norm(norm, out_channels)
        )

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.conv1(x, train)
        offset = nhwc(self.conv2_offset(out, train))
        if self.deform_modulated:
            k2 = offset.shape[-1] * 2 // 3
            out = self.conv2(nhwc(out), offset[..., :k2], torch.sigmoid(offset[..., k2:]), train)
        else:
            out = self.conv2(nhwc(out), offset, train)
        out = self.conv3(F.relu(nchw(out)), train)
        shortcut = x if self.shortcut is None else self.shortcut(x, train)
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    """Stem + stages ``res2``..``res5`` (only up to the deepest output)."""

    def __init__(self, stem: BasicStem, stages: List[List[nn.Module]], out_features, freeze_at: int = 0):
        super().__init__()
        self.stem = stem
        self.out_features = tuple(out_features)
        self.stage_names = []
        self._out_channels = {"stem": stem.out_channels}
        self._out_strides = {"stem": stem.stride}
        stride = stem.stride
        for i, blocks in enumerate(stages):
            name = f"res{i + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            stride *= blocks[0].stride
            self._out_strides[name] = stride
            self._out_channels[name] = blocks[-1].out_channels
        # freezing (reference resnet.py:freeze): no gradient reaches the frozen
        # prefix; FrozenBN statistics are buffers already. A BN there still
        # normalizes with batch statistics in training and updates its running
        # ones, as under the JAX package's stop_gradient (d2 makes it FrozenBN)
        if freeze_at >= 1:
            self.stem.requires_grad_(False)
        for i, name in enumerate(self.stage_names, start=2):
            if freeze_at >= i:
                getattr(self, name).requires_grad_(False)

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC -> dict of NHWC stage outputs. ``train`` selects batch
        statistics in the norms that keep them; ``generator`` is the
        signature every backbone shares (nothing here draws)."""
        outputs = {}
        x = self.stem(nchw(x), train)
        if "stem" in self.out_features:
            outputs["stem"] = nhwc(x)
        for name in self.stage_names:
            for block in getattr(self, name):
                x = block(x, train)
            if name in self.out_features:
                outputs[name] = nhwc(x)
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {
            f: ShapeSpec(channels=self._out_channels[f], stride=self._out_strides[f])
            for f in self.out_features
        }


def make_stage_specs(cfg) -> List[List[Dict[str, Any]]]:
    """Each block's constructor kwargs, stage by stage (res2..res5), with its
    ``block_class``: the geometry of the JAX ``make_stage_specs``
    (``detectron2_tpu/modeling/backbone/resnet.py:286``). Lazy configs call
    it at load time (``configs/common/models/mask_rcnn_fpn.py``)."""
    r = cfg.MODEL.RESNETS
    depth, norm = r.DEPTH, r.NORM
    bottleneck_channels = r.NUM_GROUPS * r.WIDTH_PER_GROUP
    in_channels, out_channels = r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS
    assert r.RES5_DILATION in (1, 2), f"res5_dilation cannot be {r.RES5_DILATION}."
    if depth in (18, 34):
        assert out_channels == 64 and r.RES5_DILATION == 1 and r.NUM_GROUPS == 1
    if depth in (18, 34):
        assert not any(r.DEFORM_ON_PER_STAGE), "MODEL.RESNETS.DEFORM_ON_PER_STAGE unsupported for R18/R34"
    stages = []
    for idx, stage_idx in enumerate(range(2, 6)):
        dilation = r.RES5_DILATION if stage_idx == 5 else 1
        first_stride = 1 if idx == 0 or (stage_idx == 5 and dilation == 2) else 2
        blocks = []
        for b in range(RESNET_STAGES[depth][idx]):
            kwargs: Dict[str, Any] = {
                "in_channels": in_channels if b == 0 else out_channels,
                "out_channels": out_channels,
                "stride": first_stride if b == 0 else 1,
                "norm": norm,
            }
            if depth in (18, 34):
                kwargs["block_class"] = BasicBlock
            else:
                kwargs.update(
                    bottleneck_channels=bottleneck_channels,
                    stride_in_1x1=r.STRIDE_IN_1X1,
                    dilation=dilation,
                    num_groups=r.NUM_GROUPS,
                    block_class=BottleneckBlock,
                )
                if r.DEFORM_ON_PER_STAGE[idx]:
                    kwargs.update(
                        block_class=DeformBottleneckBlock,
                        deform_modulated=r.DEFORM_MODULATED,
                        deform_num_groups=r.DEFORM_NUM_GROUPS,
                    )
            blocks.append(kwargs)
        stages.append(blocks)
        in_channels = out_channels
        out_channels *= 2
        bottleneck_channels *= 2
    return stages


def build_stages(stage_specs, out_features) -> List[List[nn.Module]]:
    """The blocks of :func:`make_stage_specs`, up to the deepest stage in
    ``out_features``."""
    depth = max({"stem": 1, "res2": 2, "res3": 3, "res4": 4, "res5": 5}[f] for f in out_features)
    stages = []
    for specs in list(stage_specs)[: depth - 1]:
        blocks = []
        for spec in specs:
            spec = dict(spec)
            block_class = spec.pop("block_class")
            blocks.append(block_class(spec.pop("in_channels"), spec.pop("out_channels"), **spec))
        stages.append(blocks)
    return stages


def build_resnet_backbone(cfg, input_channels: int = 3) -> ResNet:
    """ResNet from config, with the geometry of :func:`make_stage_specs`."""
    r = cfg.MODEL.RESNETS
    stem = BasicStem(input_channels, r.STEM_OUT_CHANNELS, r.NORM)
    stages = build_stages(make_stage_specs(cfg), r.OUT_FEATURES)
    return ResNet(stem, stages, r.OUT_FEATURES, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT)
