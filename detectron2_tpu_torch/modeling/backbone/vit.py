"""ViT backbone with windowed attention and the SimpleFeaturePyramid (ViTDet).

Counterpart of ``detectron2_tpu/modeling/backbone/vit.py``: a plain ViT whose
blocks attend inside windows except a few global blocks, and a pyramid that
builds p2..p6 from the single stride-16 map. Modules take and return NHWC,
as the JAX package's do; parameters keep d2's names (``blocks.N.attn.qkv``,
``attn.rel_pos_h``, ``patch_embed.proj``, ``simfp_2.0`` ...), so a d2
checkpoint loads by name.

The linears and norms compute in the input's dtype (flax
``Dense(dtype=x.dtype)``); the attention itself goes through
:func:`detectron2_tpu_torch.ops.attention.attention_with_rel_pos`, the CUDA
kernel on the card.
"""

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import (
    Conv2d,
    ConvTranspose2d,
    DropPath,
    LayerNorm,
    Linear,
    ShapeSpec,
    get_norm,
    nchw,
    nhwc,
)
from detectron2_tpu_torch.ops.attention import attention_with_rel_pos, use_transposed_factors

__all__ = [
    "ViT",
    "SimpleFeaturePyramid",
    "Attention",
    "Block",
    "Mlp",
    "get_vit_lr_decay_rate",
    "window_partition",
    "window_unpartition",
    "get_rel_pos",
    "decomposed_rel_pos_factors",
    "resize_matrix",
]


def window_partition(x: torch.Tensor, window_size: int):
    """``[B, H, W, C]`` -> (``[B * nW, ws, ws, C]``, (Hp, Wp)), zero-padded
    at the bottom and right to a multiple of the window."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw, hw) -> torch.Tensor:
    """Inverse of :func:`window_partition`, dropping the padding."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def resize_matrix(in_size: int, out_size: int, method: str) -> torch.Tensor:
    """The ``[out_size, in_size]`` float32 matrix with which
    ``jax.image.resize`` resamples one axis: half-pixel centres, the kernel
    widened by in/out when shrinking (antialiasing), taps outside the input
    dropped and the rest renormalized. ``"linear"`` is the triangle kernel,
    ``"bicubic"`` the Keys cubic with a = -0.5 (torch's ``F.interpolate``
    uses a = -0.75 and clamps at the border instead, so it cannot stand in)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(in_size, dtype=torch.float64)[None, :]).abs() / kernel_scale
    if method == "linear":
        w = (1.0 - x).clamp_min(0.0)
    elif method == "bicubic":
        near = ((1.5 * x - 2.5) * x) * x + 1.0
        far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
        w = torch.where(x >= 1.0, far, near)
        w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    else:
        raise ValueError(f"resize method {method!r}")
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps, w / total, torch.zeros_like(w))
    return w.float()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The relative-position rows for every (query, key) distance,
    ``[q_size, k_size, C]``, from a table ``[L, C]`` that is resized
    (linearly, as ``jax.image.resize`` does) when L differs from
    ``2 * max(q_size, k_size) - 1``."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        m = resize_matrix(rel_pos.shape[0], max_rel_dist, "linear").to(rel_pos.device)
        rel_pos = (m @ rel_pos.float()).to(rel_pos.dtype)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, dtype=torch.float32, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32, device=dev)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative_coords.long()]


def decomposed_rel_pos_factors(
    q: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_size: Tuple[int, int],
    k_size: Tuple[int, int],
    transposed: bool = False,
):
    """The two factors of the decomposed relative-position bias,
    ``bias[q=(h, w), k=(h2, w2)] = rel_h[q, h2] + rel_w[q, w2]``: contiguous
    ``rel_h`` ``[B, q_h * q_w, k_h]`` and ``rel_w`` ``[B, q_h * q_w, k_w]`` for
    q ``[B, q_h * q_w, C]``, in q's dtype. ``transposed=True`` gives
    ``[B, k_h, q_h * q_w]`` and ``[B, k_w, q_h * q_w]``, the layout of the
    transposed-factor kernel."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype)  # [q_h, k_h, C]
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    if transposed:
        rel_ht = torch.einsum("bhwc,hkc->bkhw", r_q, Rh)
        rel_wt = torch.einsum("bhwc,wkc->bkhw", r_q, Rw)
        return rel_ht.reshape(B, k_h, q_h * q_w).contiguous(), rel_wt.reshape(B, k_w, q_h * q_w).contiguous()
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    return rel_h.reshape(B, q_h * q_w, k_h).contiguous(), rel_w.reshape(B, q_h * q_w, k_w).contiguous()


class Attention(nn.Module):
    """Multi-head attention over an ``[B, H, W, C]`` token grid with an
    optional decomposed relative-position bias. ``input_size`` sizes the
    bias tables, ``2 * size - 1`` rows each."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        qkv_bias: bool = True,
        use_rel_pos: bool = False,
        input_size: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, self.head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x.reshape(B, H * W, C))
        # [3, B * heads, HW, hd]: the one copy that makes q, k, v contiguous
        # (explicit: for B = 1 a reshape of the permuted view would copy nothing)
        qkv = qkv.reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4).contiguous().view(3, B * nh, H * W, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]

        # the layout is chosen first, so that the factors are produced in it
        transposed = use_transposed_factors()
        rel_h = rel_w = None
        if self.use_rel_pos:
            rel_h, rel_w = decomposed_rel_pos_factors(
                q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W), transposed=transposed
            )
        x = attention_with_rel_pos(q, k, v, rel_h, rel_w, scale=self.scale, factors_transposed=transposed)
        x = x.reshape(B, nh, H * W, hd).permute(0, 2, 1, 3).reshape(B, H, W, self.dim)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # the exact (erf) GELU


class Block(nn.Module):
    """Pre-norm transformer block; with ``window_size > 0`` the attention
    runs inside windows. The tokens are zero-padded to whole windows after
    ``norm1``, and the padded tokens take part in their window's softmax as
    keys, as in the reference."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_path: float = 0.0,
        window_size: int = 0,
        use_rel_pos: bool = False,
        input_size: Optional[Tuple[int, int]] = None,
        use_residual_block: bool = False,
    ):
        super().__init__()
        if use_residual_block:
            raise NotImplementedError("ViT use_residual_block is not ported yet")
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-5, channel_dim=-1)
        self.attn = Attention(
            dim,
            num_heads=num_heads,
            qkv_bias=qkv_bias,
            use_rel_pos=use_rel_pos,
            input_size=input_size if window_size == 0 else (window_size, window_size),
        )
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-5, channel_dim=-1)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        shortcut = x
        x = self.norm1(x, train)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + self.drop_path(x, train, generator)
        return x + self.drop_path(self.mlp(self.norm2(x, train)), train, generator)


def _checkpointed(blk: nn.Module, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A training block under ``torch.utils.checkpoint`` (the JAX package's
    ``nn.checkpoint`` remat): its activations are recomputed in the backward.
    The recompute draws DropPath's masks again from ``generator`` as it stood
    before the forward, then leaves the generator where the backward found
    it (checkpoint restores only the default generators)."""
    from torch.utils.checkpoint import checkpoint

    if generator is None:
        return checkpoint(blk, x, True, None, use_reentrant=False)
    state = generator.get_state()
    calls = []

    def run(t):
        if not calls:
            calls.append(1)
            return blk(t, True, generator)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return blk(t, True, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


class PatchEmbed(nn.Module):
    """Image to patch tokens: one strided conv, d2's ``patch_embed.proj``."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return nhwc(self.proj(nchw(x), train))


class ViT(nn.Module):
    """Plain ViT detector backbone: NHWC images -> ``{out_feature: [B, H/16,
    W/16, embed_dim]}``. Global blocks size their bias tables by
    ``img_size // patch_size``; the absolute position table of the
    pretraining size is resized bicubically to the token grid. Block ``i``
    drops its residual branches at ``drop_path_rate * i / (depth - 1)`` in
    training; ``use_checkpoint`` recomputes each block's activations in the
    backward instead of keeping them."""

    def __init__(
        self,
        img_size: int = 1024,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        drop_path_rate: float = 0.0,
        use_abs_pos: bool = True,
        use_rel_pos: bool = False,
        window_size: int = 0,
        window_block_indexes=(),
        residual_block_indexes=(),
        pretrain_img_size: int = 224,
        pretrain_use_cls_token: bool = True,
        out_feature: str = "last_feat",
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.img_size = img_size
        self.use_checkpoint = use_checkpoint
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.out_feature = out_feature
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        if use_abs_pos:
            num_patches = (pretrain_img_size // patch_size) ** 2
            num_positions = num_patches + 1 if pretrain_use_cls_token else num_patches
            self.pos_embed = nn.Parameter(torch.zeros(1, num_positions, embed_dim))
        else:
            self.pos_embed = None
        self.blocks = nn.ModuleList(
            Block(
                dim=embed_dim,
                num_heads=num_heads,
                mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias,
                # linearly increasing stochastic-depth rate
                drop_path=drop_path_rate * i / max(depth - 1, 1),
                window_size=window_size if i in window_block_indexes else 0,
                use_rel_pos=use_rel_pos,
                input_size=(img_size // patch_size,) * 2,
                use_residual_block=i in residual_block_indexes,
            )
            for i in range(depth)
        )

    def _abs_pos(self, H: int, W: int) -> torch.Tensor:
        """The position table on an ``H x W`` grid, ``[1, H, W, C]`` float32."""
        grid = self.pos_embed[:, 1:] if self.pretrain_use_cls_token else self.pos_embed
        side = int(math.sqrt(grid.shape[1]))
        grid = grid.reshape(1, side, side, self.embed_dim).float()
        if (side, side) != (H, W):
            mh = resize_matrix(side, H, "bicubic").to(grid.device)
            mw = resize_matrix(side, W, "bicubic").to(grid.device)
            grid = torch.einsum("hs,bstc->bhtc", mh, grid)
            grid = torch.einsum("wt,bhtc->bhwc", mw, grid)
        return grid

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        x = self.patch_embed(x, train)
        if self.pos_embed is not None:
            x = x + self._abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        for blk in self.blocks:
            if self.use_checkpoint and train and torch.is_grad_enabled():
                x = _checkpointed(blk, x, generator)
            else:
                x = blk(x, train, generator)
        return {self.out_feature: x}

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return {self.out_feature: ShapeSpec(channels=self.embed_dim, stride=self.patch_size)}

    @property
    def size_divisibility(self) -> int:
        return self.patch_size

    @property
    def padding_constraints(self) -> Dict[str, int]:
        """Fixed square inputs keep the global blocks' token grid at the size
        of their bias tables."""
        return {"size_divisibility": self.patch_size, "square_size": self.img_size}


class _Stage(nn.Sequential):
    """One scale of the feature pyramid: d2's ``simfp_*`` sequence (its
    children keep the indices ``0, 1, ...``), with ``train`` handed to the
    layers built to take it."""

    def __init__(self, layers):
        super().__init__(*(layer for layer, _ in layers))
        self._takes_train = tuple(takes for _, takes in layers)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for layer, takes_train in zip(self, self._takes_train):
            x = layer(x, train) if takes_train else layer(x)
        return x


class SimpleFeaturePyramid(nn.Module):
    """p2..p6 from the single stride-16 ViT map: per scale factor a stage
    ``simfp_{log2 stride}`` of deconvs (4x: two, with LN and GELU between;
    2x: one) or a 2x2 max pool (0.5x), then a 1x1 and a 3x3 conv with norm;
    ``top_block_levels`` further levels by stride-2 subsampling of the
    coarsest. NHWC in, NHWC out."""

    def __init__(
        self,
        net: nn.Module,
        in_feature: str = "last_feat",
        out_channels: int = 256,
        scale_factors=(4.0, 2.0, 1.0, 0.5),
        top_block_levels: int = 1,
        norm: str = "LN",
    ):
        super().__init__()
        self.net = net
        self.in_feature = in_feature
        self.scale_factors = tuple(scale_factors)
        self.top_block_levels = top_block_levels
        shape = net.output_shape()[in_feature]
        dim = shape.channels
        self.strides = [int(shape.stride / s) for s in self.scale_factors]
        for stride, scale in zip(self.strides, self.scale_factors):
            out_dim = dim
            # (layer, whether it takes the train flag): the norms and the convs
            if scale == 4.0:
                layers = [
                    (ConvTranspose2d(dim, dim // 2, kernel_size=2, stride=2), False),
                    (get_norm(norm, dim // 2), True),
                    (nn.GELU(), False),
                    (ConvTranspose2d(dim // 2, dim // 4, kernel_size=2, stride=2), False),
                ]
                out_dim = dim // 4
            elif scale == 2.0:
                layers = [(ConvTranspose2d(dim, dim // 2, kernel_size=2, stride=2), False)]
                out_dim = dim // 2
            elif scale == 1.0:
                layers = []
            elif scale == 0.5:
                layers = [(nn.MaxPool2d(kernel_size=2, stride=2), False)]
            else:
                raise NotImplementedError(f"scale_factor={scale} is not supported yet.")
            layers += [
                (Conv2d(out_dim, out_channels, 1, bias=False, norm=get_norm(norm, out_channels)), True),
                (Conv2d(out_channels, out_channels, 3, padding=1, bias=False, norm=get_norm(norm, out_channels)), True),
            ]
            self.add_module(f"simfp_{int(math.log2(stride))}", _Stage(layers))
        strides = list(self.strides)
        for _ in range(top_block_levels):
            strides.append(strides[-1] * 2)
        self._out_shapes = {
            f"p{int(math.log2(s))}": ShapeSpec(channels=out_channels, stride=s) for s in strides
        }

    def output_shape(self) -> Dict[str, ShapeSpec]:
        return dict(self._out_shapes)

    @property
    def size_divisibility(self) -> int:
        stride = self.net.output_shape()[self.in_feature].stride
        return max(int(stride / min(self.scale_factors)), self.net.size_divisibility)

    @property
    def padding_constraints(self) -> Dict[str, int]:
        return self.net.padding_constraints

    def forward(self, x: torch.Tensor, train: bool = False, generator: Optional[torch.Generator] = None):
        features = nchw(self.net(x, train, generator)[self.in_feature])
        results = [getattr(self, f"simfp_{int(math.log2(s))}")(features, train) for s in self.strides]
        for _ in range(self.top_block_levels):
            results.append(F.max_pool2d(results[-1], kernel_size=1, stride=2))
        return {name: nhwc(r) for name, r in zip(self._out_shapes, results)}


def get_vit_lr_decay_rate(name: str, lr_decay_rate: float = 1.0, num_layers: int = 12) -> float:
    """Layer-wise learning-rate decay for ViT fine-tuning: the multiplier of
    the parameter ``name`` (a dotted name of the model's ``named_parameters``,
    e.g. ``backbone.net.blocks.3.attn.qkv.weight``). The embeddings are layer
    0, block i is layer i + 1, everything else layer ``num_layers + 1``."""
    layer_id = num_layers + 1
    if name.startswith("backbone"):
        if ".pos_embed" in name or ".patch_embed" in name:
            layer_id = 0
        elif ".blocks." in name and ".residual." not in name:
            layer_id = int(name[name.find(".blocks.") :].split(".")[2]) + 1
    return lr_decay_rate ** (num_layers + 1 - layer_id)
