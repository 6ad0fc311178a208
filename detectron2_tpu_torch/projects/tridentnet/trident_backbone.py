"""The Trident ResNet (counterpart of the JAX package's
``projects/tridentnet/trident_backbone.py``).

The stem, res2 and res3 run once; res4 fans out into ``num_branch``
branches that share every weight, each 3x3 conv at its branch's dilation
(:class:`TridentConv`). Each branch is a feature map of its own,
``res4_b{i}`` (stride 16), and ``res4`` is branch ``test_branch_idx``: the
trident RPN trains on the three as levels and the C4 heads read ``res4``.
Every branch is computed in inference too, as the JAX module computes them
(d2 computes the test branch alone there). d2's names: ``res4.{b}.conv2``
is the trident conv and ``res4.{b}.conv2.norm`` its norm.
"""

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, get_norm, nchw, nhwc
from detectron2_tpu_torch.modeling.backbone.resnet import (
    BasicStem,
    BottleneckBlock,
    ResNet,
    _shortcut,
    build_stages,
    make_stage_specs,
)
from detectron2_tpu_torch.projects.tridentnet.trident_conv import TridentConv

__all__ = ["TridentBottleneckBlock", "TridentResNet", "build_trident_resnet_backbone"]


class TridentBottleneckBlock(nn.Module):
    """A bottleneck whose 3x3 conv is a :class:`TridentConv`; it takes and
    returns one NCHW tensor per branch, every parameter shared by the
    branches. Each norm is called once a branch, in branch order."""

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
        dilations: Sequence[int] = (1, 2, 3),
    ):
        super().__init__()
        self.stride, self.out_channels = stride, out_channels
        self.shortcut = _shortcut(in_channels, out_channels, stride, norm)
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, 1, stride=stride_1x1, bias=False,
            norm=get_norm(norm, bottleneck_channels), activation=F.relu,
        )
        self.conv2 = TridentConv(
            bottleneck_channels, bottleneck_channels, 3, stride=stride_3x3, dilations=dilations, groups=num_groups,
            bias=False, norm=get_norm(norm, bottleneck_channels), activation=F.relu,
        )
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False, norm=get_norm(norm, out_channels))

    def forward(self, xs: List[torch.Tensor], train: bool) -> List[torch.Tensor]:
        outs = self.conv2([self.conv1(x, train) for x in xs], train)
        outs = [self.conv3(o, train) for o in outs]
        shorts = xs if self.shortcut is None else [self.shortcut(x, train) for x in xs]
        return [F.relu(o + s) for o, s in zip(outs, shorts)]


class TridentResNet(ResNet):
    """A ResNet-C4 trunk (stem, res2, res3) and a trident res4. Outputs
    ``res4_b{i}`` for every branch, ``res4`` (branch ``test_branch_idx``)
    and ``res2`` / ``res3`` when ``out_features`` names them."""

    def __init__(self, stem: BasicStem, stages: List[List[nn.Module]], out_features, freeze_at: int = 0,
                 test_branch_idx: int = 1):
        super().__init__(stem, stages, out_features, freeze_at=freeze_at)
        assert self.stage_names == ["res2", "res3", "res4"], self.stage_names
        self.num_branch = len(self.res4[0].conv2.dilations)
        self.test_branch_idx = test_branch_idx

    @property
    def size_divisibility(self) -> int:
        return 16

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC -> dict of NHWC outputs (``generator``: the signature
        every backbone shares; nothing here draws)."""
        outputs = {}
        x = self.stem(nchw(x), train)
        for name in ("res2", "res3"):
            for block in getattr(self, name):
                x = block(x, train)
            if name in self.out_features:
                outputs[name] = nhwc(x)
        branches = [x] * self.num_branch
        for block in self.res4:
            branches = block(branches, train)
        for i, feat in enumerate(branches):
            outputs[f"res4_b{i}"] = nhwc(feat)
        outputs["res4"] = outputs[f"res4_b{self.test_branch_idx}"]
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        """Every output the trunk can give, as the JAX module states them."""
        ch, ch2 = self._out_channels["res4"], self._out_channels["res2"]
        shapes = {"res4": ShapeSpec(channels=ch, stride=16)}
        shapes.update({f"res4_b{i}": ShapeSpec(channels=ch, stride=16) for i in range(self.num_branch)})
        shapes["res2"] = ShapeSpec(channels=ch2, stride=4)
        shapes["res3"] = ShapeSpec(channels=ch2 * 2, stride=8)
        return shapes


def build_trident_resnet_backbone(cfg, input_channels: int = 3) -> TridentResNet:
    """The trunk of ``cfg.MODEL.RESNETS`` to res4, whose blocks are
    :class:`TridentBottleneckBlock` at ``MODEL.TRIDENT.BRANCH_DILATIONS``;
    ``TEST_BRANCH_IDX`` -1 is the middle branch."""
    r, tr = cfg.MODEL.RESNETS, cfg.MODEL.TRIDENT
    assert len(tr.BRANCH_DILATIONS) == tr.NUM_BRANCH, (tr.BRANCH_DILATIONS, tr.NUM_BRANCH)
    specs = make_stage_specs(cfg)[:3]
    res4 = []
    for spec in specs[2]:
        assert spec["block_class"] is BottleneckBlock, "the trident stage takes plain bottleneck blocks"
        spec = {k: v for k, v in spec.items() if k != "dilation"}
        res4.append({**spec, "block_class": TridentBottleneckBlock, "dilations": tuple(tr.BRANCH_DILATIONS)})
    test_idx = tr.TEST_BRANCH_IDX if tr.TEST_BRANCH_IDX >= 0 else tr.NUM_BRANCH // 2
    stem = BasicStem(input_channels, r.STEM_OUT_CHANNELS, r.NORM)
    return TridentResNet(stem, build_stages(specs[:2] + [res4], ["res4"]), r.OUT_FEATURES,
                         freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT, test_branch_idx=test_idx)
