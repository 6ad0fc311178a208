"""Swin Transformer backbone (counterpart of ``detectron2_tpu/modeling/backbone/swin.py``).

Shifted-window attention with the ``(2w - 1)^2`` relative-position bias
table, patch merging, and a LayerNorm on each output stage ``p0``..``p3``.
Modules take and return NHWC; parameters keep d2's names
(``patch_embed.proj``, ``patch_embed.norm``, ``layers.{i}.blocks.{d}``,
``layers.{i}.downsample``, ``norm{i}``, ``mlp.fc{k}``), so a d2 checkpoint
loads by name. The attention is plain PyTorch, as the JAX package computes
it: scores and softmax in float32, the product with v accumulated in float32.

One deliberate difference from the JAX block: a block pads its map to whole
windows first and then rolls the padded map, as d2 does, and the shift mask
is built on that padded grid. The JAX block rolls the unpadded map and then
pads, so wherever a map is not a multiple of the window (every detection
input, e.g. the 256 x 256 first stage of a 1024 x 1024 image) its windows
attend across the cyclic wrap and onto padding in a pattern d2's mask
forbids. Where every map is whole windows the two orders agree.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, DropPath, LayerNorm, Linear, ShapeSpec, nchw, nhwc
from detectron2_tpu_torch.modeling.backbone.vit import Mlp, window_partition, window_unpartition

__all__ = ["SwinTransformer", "SwinBlock", "WindowAttention", "PatchMerging", "shift_window_mask"]


def relative_position_index(window_size: int) -> torch.Tensor:
    """The pairwise index into the bias table inside a window, ``[w^2, w^2]``."""
    coords = np.stack(np.meshgrid(np.arange(window_size), np.arange(window_size), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (window_size - 1)
    return torch.from_numpy(rel[:, :, 0] * (2 * window_size - 1) + rel[:, :, 1])


def shift_window_mask(Hp: int, Wp: int, window_size: int, shift: int, device) -> torch.Tensor:
    """The additive mask of a shifted block on its ``Hp x Wp`` (padded)
    grid, ``[nW, w^2, w^2]``: -100 between tokens that came from different
    regions of the unshifted map, 0 elsewhere."""
    img = torch.zeros((1, Hp, Wp, 1), device=device)
    cnt = 0
    for h in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
        for w in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    windows, _ = window_partition(img, window_size)
    windows = windows.reshape(-1, window_size * window_size)
    differ = windows[:, None, :] != windows[:, :, None]
    return torch.where(differ, torch.tensor(-100.0, device=device), torch.tensor(0.0, device=device))


class WindowAttention(nn.Module):
    """Multi-head attention inside a window with the learned bias table;
    ``relative_position_index`` is a buffer that a state dict does not
    carry (it follows from the window size)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size), persistent=False)
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: ``[B * nW, N, C]``; mask: ``[nW, N, N]`` additive, or None."""
        Bn, N, C = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(Bn, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [Bn, nh, N, hd]
        attn = torch.matmul((q * self.scale).float(), k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)].reshape(N, N, nh)
        attn = attn + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, nh, N, N) + mask[None, :, None].float()).reshape(Bn, nh, N, N)
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn.float(), v.float()).to(v.dtype)
        return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


class SwinBlock(nn.Module):
    """Pre-norm block of (shifted) window attention and an MLP. The map is
    padded to whole windows, then rolled by ``-shift``; after the attention
    it is rolled back and cropped (d2's order)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim, eps=1e-5, channel_dim=-1)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5, channel_dim=-1)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, Hp: int, Wp: int, device) -> torch.Tensor:
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            self._masks[key] = shift_window_mask(Hp, Wp, self.window_size, self.shift_size, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        """x: ``[B, H, W, C]``."""
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._mask(Hp, Wp, x.device)
        windows, _ = window_partition(x, ws)
        out = self.attn(windows.reshape(-1, ws * ws, C), mask)
        x = window_unpartition(out.reshape(-1, ws, ws, C), ws, (Hp, Wp), (Hp, Wp))
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :H, :W], train, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), train, generator)


class PatchMerging(nn.Module):
    """2x2 patches concatenated (zero-padded to even sizes), a LayerNorm and
    a linear reduction to twice the width. The quadrants are concatenated in
    d2's order, (h0, w0), (h1, w0), (h0, w1), (h1, w1), so that d2's
    reduction weights load as they are."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5, channel_dim=-1)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
            H, W = H + H % 2, W + W % 2
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5).reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """A ``patch_size`` strided conv and a LayerNorm (d2's ``patch_embed.proj``
    and ``patch_embed.norm``)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5, channel_dim=-1)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.norm(nhwc(self.proj(nchw(x), train)))


class BasicLayer(nn.Module):
    """One stage: ``blocks`` alternating unshifted and shifted by half a
    window, then ``downsample`` (patch merging) except in the last stage."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Hierarchical Swin backbone: NHWC images -> ``{p{i}: [B, H / 2^(i+2),
    W / 2^(i+2), embed_dim * 2^i]}``. Block ``k`` (counted over all stages)
    drops its residual branches at ``drop_path_rate * k / (total - 1)`` in
    training."""

    def __init__(
        self,
        patch_size: int = 4,
        embed_dim: int = 96,
        depths=(2, 2, 6, 2),
        num_heads=(3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        out_features=("p0", "p1", "p2", "p3"),
        drop_path_rate: float = 0.0,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        total = sum(self.depths)
        layers, dim, k = [], embed_dim, 0
        for i, depth in enumerate(self.depths):
            blocks = []
            for d in range(depth):
                blocks.append(SwinBlock(
                    dim, num_heads[i], window_size, 0 if d % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                    drop_path_rate * k / max(total - 1, 1)))
                k += 1
            last = i == len(self.depths) - 1
            layers.append(BasicLayer(blocks, None if last else PatchMerging(dim)))
            if f"p{i}" in self.out_features:
                self.add_module(f"norm{i}", LayerNorm(dim, eps=1e-5, channel_dim=-1))
            dim *= 2
        self.layers = nn.ModuleList(layers)

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x, train)
        outs = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, train, generator)
            if f"p{i}" in self.out_features:
                outs[f"p{i}"] = getattr(self, f"norm{i}")(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {
            f"p{i}": ShapeSpec(channels=self.embed_dim * 2**i, stride=self.patch_size * 2**i)
            for i in range(len(self.depths))
            if f"p{i}" in self.out_features
        }

    @property
    def size_divisibility(self) -> int:
        return self.patch_size * 2 ** (len(self.depths) - 1)

    @property
    def padding_constraints(self) -> Dict[str, int]:
        return {"size_divisibility": self.size_divisibility}
