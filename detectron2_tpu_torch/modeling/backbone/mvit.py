"""MViTv2 backbone (counterpart of ``detectron2_tpu/modeling/backbone/mvit.py``).

Multi-scale ViT: the attention pools q (stride 2 at a stage's first block)
and k / v (the adaptive stride) with depthwise convs shared across heads,
each followed by a LayerNorm; it runs inside windows except each stage's
last block from the second stage on; a decomposed relative-position bias on
the unscaled q; and a residual from the pooled q. Modules take and return
NHWC; parameters keep d2's names (``blocks.{i}.attn.{qkv,proj,pool_q,norm_q,
...,rel_pos_h,rel_pos_w}``, ``blocks.{i}.proj``, ``mlp.fc{k}``,
``scale{n}_norm``), so a d2 checkpoint loads by name. The attention is plain
PyTorch, as the JAX package computes it: scores and softmax in float32, the
product with v accumulated in float32.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, DropPath, LayerNorm, Linear, ShapeSpec, nchw, nhwc
from detectron2_tpu_torch.modeling.backbone.vit import (
    Mlp,
    PatchEmbed,
    _checkpointed,
    decomposed_rel_pos_factors,
    resize_matrix,
    window_partition,
    window_unpartition,
)

__all__ = ["MViT", "MultiScaleBlock", "MultiScaleAttention"]


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention: ``[B, H, W, dim]`` -> ``[B, H / stride_q,
    W / stride_q, dim_out]``. ``input_size`` (the block's input grid) sizes
    the relative-position tables, ``2 * max(size // stride_q, size //
    stride_kv) - 1`` rows each."""

    def __init__(
        self,
        dim: int,
        dim_out: int,
        num_heads: int,
        qkv_bias: bool = True,
        pool_kernel: int = 3,
        stride_q: int = 1,
        stride_kv: int = 1,
        residual_pooling: bool = True,
        window_size: int = 0,
        use_rel_pos: bool = False,
        input_size: Tuple[int, int] = (56, 56),
    ):
        super().__init__()
        self.num_heads = num_heads
        self.dim_out = dim_out
        hd = dim_out // num_heads
        self.head_dim, self.scale = hd, hd**-0.5
        self.stride_q, self.stride_kv = stride_q, stride_kv
        self.residual_pooling = residual_pooling
        self.window_size = window_size
        self.qkv = Linear(dim, 3 * dim_out, bias=qkv_bias)
        self.proj = Linear(dim_out, dim_out)
        pad = pool_kernel // 2
        for name, stride in (("q", stride_q), ("k", stride_kv), ("v", stride_kv)):
            self.add_module(f"pool_{name}", Conv2d(hd, hd, pool_kernel, stride=stride, padding=pad, groups=hd, bias=False))
            self.add_module(f"norm_{name}", LayerNorm(hd, eps=1e-5, channel_dim=-1))
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            size = input_size[0]
            rel_dim = 2 * max(size // stride_q, size // stride_kv) - 1
            self.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, hd))

    def _pool(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The shared depthwise conv and LayerNorm of ``t`` ``[B * heads, H, W, hd]``."""
        return getattr(self, f"norm_{name}")(nhwc(getattr(self, f"pool_{name}")(nchw(t), False)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, H, W, 3, nh, hd).permute(3, 0, 4, 1, 2, 5).reshape(3, B * nh, H, W, hd)
        q, k, v = self._pool("q", qkv[0]), self._pool("k", qkv[1]), self._pool("v", qkv[2])
        ori_q = q
        if self.window_size:
            q_win, kv_win = self.window_size // self.stride_q, self.window_size // self.stride_kv
            q, q_pad_hw = window_partition(q, q_win)
            k, _ = window_partition(k, kv_win)
            v, _ = window_partition(v, kv_win)
            q_hw, kv_hw = (q_win, q_win), (kv_win, kv_win)
        else:
            q_hw, kv_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
        qf = q.reshape(q.shape[0], q_hw[0] * q_hw[1], hd)
        kf = k.reshape(k.shape[0], kv_hw[0] * kv_hw[1], hd)
        vf = v.reshape(v.shape[0], kv_hw[0] * kv_hw[1], hd)
        attn = torch.matmul((qf * self.scale).float(), kf.float().transpose(1, 2))
        if self.use_rel_pos:
            rel_h, rel_w = decomposed_rel_pos_factors(qf, self.rel_pos_h, self.rel_pos_w, q_hw, kv_hw)
            attn = attn.reshape(-1, q_hw[0] * q_hw[1], kv_hw[0], kv_hw[1])
            attn = (attn + rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(-1, q_hw[0] * q_hw[1], kv_hw[0] * kv_hw[1])
        attn = attn.softmax(dim=-1).to(vf.dtype)
        out = torch.matmul(attn.float(), vf.float()).to(vf.dtype).reshape(-1, q_hw[0], q_hw[1], hd)
        if self.window_size:
            out = window_unpartition(out, q_win, q_pad_hw, tuple(ori_q.shape[1:3]))
        if self.residual_pooling:
            out = out + ori_q
        Hq, Wq = out.shape[1], out.shape[2]
        out = out.reshape(B, nh, Hq, Wq, hd).permute(0, 2, 3, 1, 4).reshape(B, Hq, Wq, self.dim_out)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    """Pre-norm block of pooled attention and an MLP. The residual is
    projected from norm1's output where the width changes, and max-pooled
    (kernel ``stride_q + 1``, padding counted as -inf) where q is strided."""

    def __init__(
        self,
        dim: int,
        dim_out: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        pool_kernel: int = 3,
        stride_q: int = 1,
        stride_kv: int = 1,
        residual_pooling: bool = True,
        window_size: int = 0,
        use_rel_pos: bool = False,
        input_size: Tuple[int, int] = (56, 56),
        drop_path: float = 0.0,
    ):
        super().__init__()
        self.stride_q = stride_q
        self.norm1 = LayerNorm(dim, eps=1e-5, channel_dim=-1)
        self.attn = MultiScaleAttention(
            dim, dim_out, num_heads, qkv_bias, pool_kernel, stride_q, stride_kv, residual_pooling, window_size,
            use_rel_pos, input_size,
        )
        self.proj = Linear(dim, dim_out) if dim != dim_out else None
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim_out, eps=1e-5, channel_dim=-1)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        x_norm = self.norm1(x)
        x_block = self.attn(x_norm)
        if self.proj is not None:
            x = self.proj(x_norm)
        if self.stride_q > 1:
            k = self.stride_q + 1
            x = nhwc(F.max_pool2d(nchw(x), k, stride=self.stride_q, padding=k // 2))
        x = x + self.drop_path(x_block, train, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), train, generator)


class MViT(nn.Module):
    """MViTv2: NHWC images -> ``{scale{n}: [B, H / 2^n, W / 2^n, embed_dim *
    2^(n-2)]}`` for n = 2..5. ``depths`` are the blocks per stage (d2's
    ``last_block_indexes`` are their running sums less one) and
    ``num_heads`` the heads per stage. Block ``i`` drops its residual
    branches at ``drop_path_rate * i / (depth - 1)`` in training;
    ``use_checkpoint`` recomputes each block's activations in the backward."""

    def __init__(
        self,
        img_size: int = 224,
        patch_kernel: int = 7,
        patch_stride: int = 4,
        patch_padding: int = 3,
        embed_dim: int = 96,
        depths=(2, 3, 16, 3),
        num_heads=(1, 2, 4, 8),
        qkv_pool_kernel: int = 3,
        adaptive_kv_stride: int = 4,
        adaptive_window_size: int = 56,
        residual_pooling: bool = True,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        use_abs_pos: bool = False,
        use_rel_pos: bool = True,
        pretrain_img_size: int = 224,
        pretrain_use_cls_token: bool = True,
        out_features=("scale2", "scale3", "scale4", "scale5"),
        drop_path_rate: float = 0.0,
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.patch_stride = patch_stride
        self.out_features = tuple(out_features)
        self.use_checkpoint = use_checkpoint
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.patch_embed = PatchEmbed(patch_kernel, 3, embed_dim, stride=patch_stride, padding=patch_padding)
        if use_abs_pos:
            num_patches = (pretrain_img_size // patch_stride) ** 2
            num_positions = num_patches + 1 if pretrain_use_cls_token else num_patches
            self.pos_embed = nn.Parameter(torch.zeros(1, num_positions, embed_dim))
        else:
            self.pos_embed = None
        self.last_block_indexes = [sum(self.depths[: s + 1]) - 1 for s in range(len(self.depths))]
        lbi = self.last_block_indexes
        depth = sum(self.depths)
        dim = dim_out = embed_dim
        stride_kv, window_size = adaptive_kv_stride, adaptive_window_size
        input_size = (img_size // patch_stride,) * 2
        stage = 2
        self.blocks = nn.ModuleList()
        self._stage_ends = {}
        for i in range(depth):
            stage_idx = next(s for s, lb in enumerate(lbi) if i <= lb)
            # the last blocks of the second and third stage double the kv
            # stride; the last blocks of every stage from the second on attend
            # globally
            self.blocks.append(MultiScaleBlock(
                dim, dim_out, num_heads[stage_idx], mlp_ratio, qkv_bias, qkv_pool_kernel,
                stride_q=2 if i - 1 in lbi else 1,
                stride_kv=stride_kv * 2 if i in lbi[1:3] else stride_kv,
                residual_pooling=residual_pooling,
                window_size=0 if i in lbi[1:] else window_size,
                use_rel_pos=use_rel_pos,
                input_size=input_size,
                drop_path=drop_path_rate * i / max(depth - 1, 1),
            ))
            dim = dim_out
            if i in lbi:
                name = f"scale{stage}"
                if name in self.out_features:
                    self.add_module(f"{name}_norm", LayerNorm(dim_out, eps=1e-5, channel_dim=-1))
                self._stage_ends[i] = name
                dim_out *= 2
                stride_kv = max(stride_kv // 2, 1)
                stage += 1
            if i - 1 in lbi:
                window_size //= 2
                input_size = (input_size[0] // 2, input_size[1] // 2)

    def _abs_pos(self, H: int, W: int) -> torch.Tensor:
        """The position table on an ``H x W`` grid, ``[1, H, W, C]`` float32
        (bicubic, as ``jax.image.resize``)."""
        grid = self.pos_embed[:, 1:] if self.pretrain_use_cls_token else self.pos_embed
        side = int(math.sqrt(grid.shape[1]))
        grid = grid.reshape(1, side, side, self.embed_dim).float()
        if (side, side) != (H, W):
            mh = resize_matrix(side, H, "bicubic").to(grid.device)
            mw = resize_matrix(side, W, "bicubic").to(grid.device)
            grid = torch.einsum("wt,bhtc->bhwc", mw, torch.einsum("hs,bstc->bhtc", mh, grid))
        return grid

    def forward(
        self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x, train)
        if self.pos_embed is not None:
            x = x + self._abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        outs = {}
        for i, blk in enumerate(self.blocks):
            if self.use_checkpoint and train and torch.is_grad_enabled():
                x = _checkpointed(blk, x, generator)
            else:
                x = blk(x, train, generator)
            name = self._stage_ends.get(i)
            if name in self.out_features:
                outs[name] = getattr(self, f"{name}_norm")(x)
        return outs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {
            f"scale{s + 2}": ShapeSpec(channels=self.embed_dim * 2**s, stride=self.patch_stride * 2**s)
            for s in range(len(self.depths))
            if f"scale{s + 2}" in self.out_features
        }

    @property
    def size_divisibility(self) -> int:
        return self.patch_stride * 2 ** (len(self.depths) - 1)

    @property
    def padding_constraints(self) -> Dict[str, int]:
        return {"size_divisibility": self.size_divisibility}
