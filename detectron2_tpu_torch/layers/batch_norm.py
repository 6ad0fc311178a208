"""Normalization layers (counterpart of ``detectron2_tpu/layers/batch_norm.py``:
FrozenBatchNorm2d :36, GroupNorm :103, LayerNorm :113, ``get_norm`` :143).

FrozenBatchNorm2d holds the d2 buffers ``weight``, ``bias``, ``running_mean``,
``running_var`` so d2 checkpoints load by name, and works on NCHW tensors
(channels_last inside the port's conv towers). LayerNorm normalizes over the
channels only, on NCHW maps or on NHWC tokens.
"""

import torch
from torch import nn

__all__ = ["FrozenBatchNorm2d", "GroupNorm", "LayerNorm", "get_norm"]


class FrozenBatchNorm2d(nn.Module):
    """Affine-only BN with fixed statistics: ``x * scale + shift`` with the
    scale and shift computed in float32 and cast to the input dtype, as the
    JAX module does."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class GroupNorm(nn.GroupNorm):
    """GroupNorm of NCHW maps, 32 groups, eps 1e-5, as flax's ``GroupNorm``
    computes it: statistics in float32 with the variance as E[x^2] - E[x]^2
    (clamped at 0), the normalized and affine result cast back to the input's
    dtype. Its ``weight`` and ``bias`` are d2's names."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        x32 = x.float().reshape(n, self.num_groups, -1)
        mean = x32.mean(dim=2, keepdim=True)
        var = (x32.square().mean(dim=2, keepdim=True) - mean.square()).clamp_min(0.0)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the channel dimension only: ``channel_dim=1`` for the
    NCHW maps of the conv towers (d2's channels-first LayerNorm), ``-1`` for
    NHWC tokens. Mean, variance and the affine step are computed in the
    input's dtype, as the JAX module computes them; in bfloat16 each step
    rounds to bf16."""

    def __init__(self, num_features: int, eps: float = 1e-6, channel_dim: int = 1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.channel_dim
        mean = x.mean(dim=d, keepdim=True)
        centered = x - mean
        var = centered.square().mean(dim=d, keepdim=True)
        y = centered * torch.rsqrt(var + self.eps)
        shape = [1] * x.dim()
        shape[d] = self.num_features
        return y * self.weight.to(y.dtype).view(shape) + self.bias.to(y.dtype).view(shape)


def get_norm(norm: str, out_channels: int):
    """``"FrozenBN"`` -> FrozenBatchNorm2d, ``"GN"`` -> GroupNorm (32
    groups), ``"LN"`` -> LayerNorm over the channels of an NCHW map (eps
    1e-6), ``""`` -> None. The norms with batch statistics of the JAX
    package (BN, SyncBN) are not ported yet."""
    if not norm:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm2d(out_channels)
    if norm == "GN":
        return GroupNorm(out_channels)
    if norm == "LN":
        return LayerNorm(out_channels, eps=1e-6, channel_dim=1)
    raise NotImplementedError(f"norm {norm!r} is not ported yet")
