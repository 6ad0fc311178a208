"""RegNet backbone (counterpart of ``detectron2_tpu/modeling/backbone/regnet.py``).

AnyNet with the RegNet width ladder (``w = w_0 + w_a * i``, quantized by
``w_m``) and X/Y bottleneck blocks: 1x1, grouped 3x3 with optional
squeeze-and-excitation, 1x1, and a projected shortcut where the width or
stride changes. Module names follow d2 (``stem.conv``, ``stem.bn``,
``s{i}.b{j}.f.{a,b,c}`` with sibling norms ``f.{a,b,c}_bn``, ``f.se.f_ex.{0,2}``,
``proj`` and ``bn``), so a d2 checkpoint loads by name. The convs run on
channels_last NCHW tensors; :meth:`RegNet.forward` takes and returns NHWC.
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, get_norm, nchw, nhwc

__all__ = ["RegNet", "generate_regnet_parameters"]


def generate_regnet_parameters(
    w_a: float, w_0: int, w_m: float, d: int, q: int = 8, group_width: int = 1, bot_mul: float = 1.0
):
    """The RegNet width ladder: ``ws[i] = w_0 + w_a * i`` quantized into
    stages by log-steps of ``w_m``, then each stage's group width capped at
    its bottleneck width and the bottleneck width rounded to a multiple of
    it. Returns (stage widths, stage depths, stage group widths)."""
    assert w_a >= 0 and w_0 > 0 and w_m > 1 and w_0 % q == 0
    ws_cont = np.arange(d) * w_a + w_0
    ks = np.round(np.log(ws_cont / w_0) / np.log(w_m))
    ws_all = w_0 * np.power(w_m, ks)
    ws_all = np.round(np.divide(ws_all, q)).astype(int) * q
    ws, ds = np.unique(ws_all, return_counts=True)
    order = np.argsort([np.where(ws_all == w)[0][0] for w in ws])  # the ladder's order
    ws, ds = ws[order].tolist(), ds[order].tolist()
    gs, ws_adj = [], []
    for w in ws:
        w_b = max(1, int(round(w * bot_mul)))
        g = min(group_width, w_b)
        w_b = int(round(w_b / g)) * g
        gs.append(g)
        ws_adj.append(int(round(w_b / bot_mul)))
    return ws_adj, ds, gs


class SimpleStem(nn.Module):
    """3x3 conv, stride 2, norm, ReLU."""

    def __init__(self, w_in: int, w_out: int, norm: str):
        super().__init__()
        self.conv = Conv2d(w_in, w_out, 3, stride=2, padding=1, bias=False)
        self.bn = get_norm(norm, w_out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x, train), train))


class SE(nn.Module):
    """Squeeze-and-excitation: the spatial mean, a 1x1 conv, ReLU, a 1x1
    conv and a sigmoid gate on the input (d2's ``f_ex`` sequence)."""

    def __init__(self, w_in: int, w_se: int):
        super().__init__()
        self.f_ex = nn.Sequential(nn.Conv2d(w_in, w_se, 1), nn.ReLU(), nn.Conv2d(w_se, w_in, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0, _, conv2 = self.f_ex
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(F.conv2d(s, conv0.weight.to(x.dtype), conv0.bias.to(x.dtype)))
        s = F.conv2d(s, conv2.weight.to(x.dtype), conv2.bias.to(x.dtype))
        return x * torch.sigmoid(s)


class BottleneckTransform(nn.Module):
    """1x1, grouped 3x3 (with the stride), optional SE, 1x1; each conv
    followed by its norm (``a_bn``, ``b_bn``, ``c_bn``), ReLU after the
    first two."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int, bottleneck_multiplier: float,
                 se_ratio: float, norm: str):
        super().__init__()
        w_b = int(round(w_out * bottleneck_multiplier))
        groups = max(w_b // group_width, 1)
        self.a = Conv2d(w_in, w_b, 1, bias=False)
        self.a_bn = get_norm(norm, w_b)
        self.b = Conv2d(w_b, w_b, 3, stride=stride, padding=1, groups=groups, bias=False)
        self.b_bn = get_norm(norm, w_b)
        self.se = SE(w_b, int(round(w_in * se_ratio))) if se_ratio > 0 else None
        self.c = Conv2d(w_b, w_out, 1, bias=False)
        self.c_bn = get_norm(norm, w_out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.a_bn(self.a(x, train), train))
        x = F.relu(self.b_bn(self.b(x, train), train))
        if self.se is not None:
            x = self.se(x)
        return self.c_bn(self.c(x, train), train)


class ResBottleneckBlock(nn.Module):
    """The X/Y block: ``relu(f(x) + shortcut)``, the shortcut a strided
    1x1 conv and norm (``proj``, ``bn``) where the width or stride changes."""

    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int, bottleneck_multiplier: float,
                 se_ratio: float, norm: str):
        super().__init__()
        if w_in != w_out or stride != 1:
            self.proj = Conv2d(w_in, w_out, 1, stride=stride, bias=False)
            self.bn = get_norm(norm, w_out)
        else:
            self.proj = self.bn = None
        self.f = BottleneckTransform(w_in, w_out, stride, group_width, bottleneck_multiplier, se_ratio, norm)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        shortcut = x if self.proj is None else self.bn(self.proj(x, train), train)
        return F.relu(self.f(x, train) + shortcut)


class RegNet(nn.Module):
    """A RegNet{X,Y} backbone from the ``(w_a, w_0, w_m, depth)``
    parameterization (RegNetY-4GF: ``w_a=31.41, w_0=96, w_m=2.24, depth=22,
    group_width=64, se_ratio=0.25``); stage ``s{i}`` has stride ``2 ** (i + 1)``.
    ``freeze_at`` k >= 1 takes the gradient from the stem and the first
    k - 1 stages; their norms still behave as in training (the JAX
    package's ``stop_gradient``)."""

    def __init__(
        self,
        w_a: float = 31.41,
        w_0: int = 96,
        w_m: float = 2.24,
        depth: int = 22,
        group_width: int = 64,
        se_ratio: float = 0.0,
        stem_width: int = 32,
        bottleneck_multiplier: float = 1.0,
        norm: str = "BN",
        out_features=("s1", "s2", "s3", "s4"),
        freeze_at: int = 0,
    ):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = SimpleStem(3, stem_width, norm)
        ws, ds, gs = generate_regnet_parameters(w_a, w_0, w_m, depth, group_width=group_width, bot_mul=bottleneck_multiplier)
        self.stage_names = []
        self._out_shapes = {}
        w_in, stride = stem_width, 2
        for i, (w, d, g) in enumerate(zip(ws, ds, gs), start=1):
            stage = nn.Module()
            for b in range(d):
                stage.add_module(f"b{b + 1}", ResBottleneckBlock(
                    w_in if b == 0 else w, w, 2 if b == 0 else 1, g, bottleneck_multiplier, se_ratio, norm))
            self.add_module(f"s{i}", stage)
            self.stage_names.append(f"s{i}")
            w_in, stride = w, stride * 2
            self._out_shapes[f"s{i}"] = ShapeSpec(channels=w, stride=stride)
        if freeze_at >= 1:
            self.stem.requires_grad_(False)
        for i, name in enumerate(self.stage_names, start=2):
            if freeze_at >= i:
                getattr(self, name).requires_grad_(False)

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """x: NHWC -> dict of NHWC stage outputs (``generator``: the
        signature every backbone shares; nothing here draws)."""
        outputs = {}
        x = self.stem(nchw(x), train)
        for name in self.stage_names:
            for block in getattr(self, name).children():
                x = block(x, train)
            if name in self.out_features:
                outputs[name] = nhwc(x)
        return outputs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {f: s for f, s in self._out_shapes.items() if f in self.out_features}

    @property
    def size_divisibility(self) -> int:
        return 2 ** (1 + len(self.stage_names))

    @property
    def padding_constraints(self) -> Dict[str, int]:
        return {"size_divisibility": self.size_divisibility}
