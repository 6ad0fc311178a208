"""HRNet, the PoseHigherResolutionNet trunk (counterpart of
``detectron2_tpu/projects/densepose/hrnet.py``: ``_HRBasicBlock`` :28,
``_HRBottleneck`` :52, ``_HighResolutionModule`` :82,
``PoseHigherResolutionNet`` :152, ``build_pose_hrnet_backbone`` :245).

Parallel conv branches at strides 4, 8, 16 and 32 that exchange their
maps through fuse layers: a stem of two stride-2 3x3 convs, ``layer1`` of
four Bottlenecks, then the stages ``MODEL.HRNET.STAGE{2,3,4}``, each a
transition (a 3x3 conv where a branch changes width, a chain of stride-2
convs from the deepest branch for a new one) and HighResolutionModules
(per-branch block towers, then the fuse mesh: a finer branch reaches a
coarser one through stride-2 3x3 convs, a coarser one a finer one through
a 1x1 conv, BN and a nearest upsample by 2^(j - i), each cropped to the
target's size). Outputs the four branches as ``p1``..``p4``.

Every norm is :class:`~detectron2_tpu_torch.layers.BatchNorm2d` (batch
statistics when ``train``). Submodules have d2's names (``layer1.0``,
``transition2.2.0.0``, ``stage3.1.branches.0.0``, ``fuse_layers.0.1.0``)
so a d2 checkpoint loads by name. Convs run on channels_last NCHW maps;
:meth:`PoseHigherResolutionNet.forward` takes and returns NHWC.
"""

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import BatchNorm2d, Conv2d, ShapeSpec, nchw, nhwc

__all__ = ["HRBasicBlock", "HRBottleneck", "HighResolutionModule", "PoseHigherResolutionNet", "build_pose_hrnet_backbone"]


def _conv_bn(seq: nn.Sequential, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A d2 ``Sequential(conv, BN[, ...])``: its conv, then its norm."""
    return seq[1](seq[0](x, train), train)


def _conv_bn_seq(cin: int, cout: int, k: int, stride: int = 1, relu: bool = False) -> nn.Sequential:
    layers = [Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False), BatchNorm2d(cout)]
    return nn.Sequential(*(layers + [nn.ReLU()] if relu else layers))


class HRBasicBlock(nn.Module):
    """Two 3x3 convs with BN, the shortcut projected when ``downsample``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _conv_bn_seq(inplanes, planes, 1, stride) if downsample else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, train), train))
        y = self.bn2(self.conv2(y, train), train)
        res = x if self.downsample is None else _conv_bn(self.downsample, x, train)
        return F.relu(y + res)


class HRBottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``4 * planes``, each with BN."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _conv_bn_seq(inplanes, out, 1, stride) if downsample else None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, train), train))
        y = F.relu(self.bn2(self.conv2(y, train), train))
        y = self.bn3(self.conv3(y, train), train)
        res = x if self.downsample is None else _conv_bn(self.downsample, x, train)
        return F.relu(y + res)


BLOCKS = {"BASIC": HRBasicBlock, "BOTTLENECK": HRBottleneck}


class HighResolutionModule(nn.Module):
    """Per-branch block towers (``branches.b.k``), then the fuse mesh
    (``fuse_layers.i.j``) into every branch (d2's ``multi_scale_output``)."""

    def __init__(self, block: str, num_blocks: Sequence[int], in_channels: Sequence[int], num_channels: Sequence[int]):
        super().__init__()
        block_cls = BLOCKS[block]
        nb = len(num_channels)
        out = [c * block_cls.expansion for c in num_channels]
        self.branches = nn.ModuleList(
            nn.Sequential(*(
                block_cls(in_channels[b] if k == 0 else out[b], num_channels[b],
                          downsample=k == 0 and in_channels[b] != out[b])
                for k in range(num_blocks[b])
            ))
            for b in range(nb)
        )
        self.fuse_layers = None
        if nb > 1:
            self.fuse_layers = nn.ModuleList()
            for i in range(nb):
                row = nn.ModuleList()
                for j in range(nb):
                    if j > i:
                        row.append(_conv_bn_seq(out[j], out[i], 1))
                    elif j == i:
                        row.append(None)
                    else:
                        row.append(nn.Sequential(*(
                            _conv_bn_seq(out[j], out[i] if k == i - j - 1 else out[j], 3, 2, relu=k < i - j - 1)
                            for k in range(i - j)
                        )))
                self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor], train: bool) -> List[torch.Tensor]:
        ys = []
        for branch, x in zip(self.branches, xs):
            for blk in branch:
                x = blk(x, train)
            ys.append(x)
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            th, tw = ys[i].shape[-2:]
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    z = ys[j]
                elif j > i:
                    # nearest by an integer factor: jax.image.resize's and
                    # F.interpolate's nearest agree there
                    z = F.interpolate(_conv_bn(layer, ys[j], train), scale_factor=2 ** (j - i), mode="nearest")
                    z = z[:, :, :th, :tw]
                else:
                    z = ys[j]
                    for k, step in enumerate(layer):
                        z = _conv_bn(step, z, train)
                        if k < len(layer) - 1:
                            z = F.relu(z)
                    z = z[:, :, :th, :tw]
                acc = z if acc is None else acc + z
            fused.append(F.relu(acc))
        return fused


class PoseHigherResolutionNet(nn.Module):
    """The HRNet trunk. ``stage_cfgs``: the (STAGE2, STAGE3, STAGE4) dicts
    of ``num_modules``, ``block``, ``num_blocks``, ``num_channels``."""

    def __init__(self, stage_cfgs: Sequence[dict]):
        super().__init__()
        self.stage_cfgs = [dict(s) for s in stage_cfgs]
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*(HRBottleneck(64 if k == 0 else 256, 64, downsample=k == 0) for k in range(4)))
        prev = [256]
        for si, s in enumerate(self.stage_cfgs):
            cur = [c * BLOCKS[s["block"]].expansion for c in s["num_channels"]]
            transition = nn.ModuleList()
            for i in range(len(cur)):
                if i < len(prev):
                    transition.append(_conv_bn_seq(prev[i], cur[i], 3, relu=True) if cur[i] != prev[i] else None)
                else:
                    n_new = i + 1 - len(prev)
                    transition.append(nn.Sequential(*(
                        _conv_bn_seq(prev[-1], cur[i] if j == n_new - 1 else prev[-1], 3, 2, relu=True)
                        for j in range(n_new)
                    )))
            self.add_module(f"transition{si + 1}", transition)
            self.add_module(f"stage{si + 2}", nn.Sequential(*(
                HighResolutionModule(s["block"], s["num_blocks"], cur, s["num_channels"])
                for _ in range(s["num_modules"])
            )))
            prev = cur

    @classmethod
    def from_config(cls, cfg) -> "PoseHigherResolutionNet":
        return cls(_stage_cfgs(cfg))

    def output_shape(self) -> Dict[str, ShapeSpec]:
        s4 = self.stage_cfgs[2]
        return {
            f"p{i + 1}": ShapeSpec(channels=c * BLOCKS[s4["block"]].expansion, stride=4 * 2**i)
            for i, c in enumerate(s4["num_channels"])
        }

    @property
    def size_divisibility(self) -> int:
        return 32

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC -> ``p1``..``p4`` NHWC (``generator``: the signature
        every backbone shares; nothing here draws)."""
        y = F.relu(self.bn1(self.conv1(nchw(x), train), train))
        y = F.relu(self.bn2(self.conv2(y, train), train))
        for blk in self.layer1:
            y = blk(y, train)
        ys = [y]
        for si in range(len(self.stage_cfgs)):
            xs = []
            for i, t in enumerate(getattr(self, f"transition{si + 1}")):
                src = ys[i] if i < len(ys) else ys[-1]
                if t is None:
                    xs.append(src)
                elif i < len(ys):
                    xs.append(F.relu(_conv_bn(t, src, train)))
                else:
                    for step in t:
                        src = F.relu(_conv_bn(step, src, train))
                    xs.append(src)
            for module in getattr(self, f"stage{si + 2}"):
                xs = module(xs, train)
            ys = xs
        return {f"p{i + 1}": nhwc(y) for i, y in enumerate(ys)}


def _stage_cfgs(cfg) -> List[dict]:
    h = cfg.MODEL.HRNET
    return [
        dict(num_modules=int(s.NUM_MODULES), block=str(s.BLOCK), num_blocks=[int(b) for b in s.NUM_BLOCKS],
             num_channels=[int(c) for c in s.NUM_CHANNELS])
        for s in (h.STAGE2, h.STAGE3, h.STAGE4)
    ]


def build_pose_hrnet_backbone(cfg, input_channels: int = 3) -> PoseHigherResolutionNet:
    """The HRNet trunk alone (``p1``..``p4``)."""
    return PoseHigherResolutionNet.from_config(cfg)
