"""Normalization layers (counterpart of ``detectron2_tpu/layers/batch_norm.py``:
FrozenBatchNorm2d :36, BatchNorm :65, SyncBatchNorm :87, NaiveSyncBatchNorm
:101, GroupNorm :103, LayerNorm :113, CycleBatchNormList :130, ``get_norm``
:143).

FrozenBatchNorm2d holds the d2 buffers ``weight``, ``bias``, ``running_mean``,
``running_var`` so d2 checkpoints load by name, and works on NCHW tensors
(channels_last inside the port's conv towers). LayerNorm normalizes over the
channels only, on NCHW maps or on NHWC tokens.

BatchNorm2d (and SyncBatchNorm) computes what flax 0.12's ``nn.BatchNorm``
computes, not what ``torch.nn.BatchNorm2d`` computes: statistics in float32
over N, H and W with the variance as E[x^2] - E[x]^2 clamped at 0, the
*biased* batch variance in the running average, momentum 0.9 on the kept
value, and ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32,
cast once to the input's dtype (float64 throughout for a float64 input:
flax's ``promote_types``). Batch statistics are used when the caller
passes ``train=True`` (the JAX modules' flag), never from
``nn.Module.training``. Its parameters and buffers have d2's names
(``weight``, ``bias``, ``running_mean``, ``running_var``).

Every norm is called as ``norm(x, train)``, as the JAX ``Conv2d`` calls its
norm; FrozenBatchNorm2d, GroupNorm and LayerNorm ignore ``train``.
"""

from typing import Callable, Union

import torch
from torch import nn

__all__ = [
    "FrozenBatchNorm2d",
    "BatchNorm2d",
    "SyncBatchNorm",
    "NaiveSyncBatchNorm",
    "CycleBatchNormList",
    "GroupNorm",
    "LayerNorm",
    "get_norm",
    "get_bn_modules",
]


class FrozenBatchNorm2d(nn.Module):
    """Affine-only BN with fixed statistics: ``x * scale + shift`` with the
    scale and shift computed in float32 and cast to the input dtype, as the
    JAX module does. ``train`` is ignored."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """The statistics' dtype: float32, or the input's when wider (flax's
    ``promote_types(x.dtype, float32)``)."""
    return torch.promote_types(x.dtype, torch.float32)


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector ``[C]`` shaped to broadcast over NC... maps."""
    return v.view((1, -1) + (1,) * (ndim - 2))


class _BatchNormTrain(torch.autograd.Function):
    """flax's batch-statistics normalization with a backward by formula, so
    that autograd keeps only the input (in its own dtype) and two vectors
    per channel, not the float32 copies the plain ops would save. Returns
    ``(y, mean, var)``; the statistics are not differentiable outputs."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
        dims = [0] + list(range(2, x.dim()))
        x32 = x.to(_stat_dtype(x))
        mean = x32.mean(dims)
        var = (x32.square().mean(dims) - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - _channel(mean, x.dim())) * _channel(rstd * weight, x.dim()) + _channel(bias, x.dim())
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad_y: torch.Tensor, _grad_mean, _grad_var):
        x, weight, mean, rstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        g = grad_y.to(mean.dtype)
        xhat = (x.to(mean.dtype) - _channel(mean, x.dim())) * _channel(rstd, x.dim())
        grad_bias = g.sum(dims)
        grad_weight = (g * xhat).sum(dims)
        grad_x = None
        if ctx.needs_input_grad[0]:
            n = x.numel() // x.shape[1]
            grad_x = _channel(weight * rstd, x.dim()) * (
                g - _channel(grad_bias / n, x.dim()) - xhat * _channel(grad_weight / n, x.dim())
            )
            grad_x = grad_x.to(x.dtype)
        return grad_x, grad_weight, grad_bias, None


class BatchNorm2d(nn.Module):
    """BN of NCHW maps as flax's ``BatchNorm`` (the JAX ``BatchNorm``,
    ``momentum=0.9``, ``epsilon=1e-5``): ``forward(x, train)`` normalizes
    with the batch's statistics and folds them into the running ones when
    ``train`` is true (``running = momentum * running + (1 - momentum) *
    batch``, the biased variance), with the running statistics otherwise.
    ``train`` has no default: a caller that forgets it fails instead of
    normalizing in the wrong mode."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.num_features = features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            scale = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.to(_stat_dtype(x)) - _channel(self.running_mean, x.dim())) * _channel(scale, x.dim())
            return (y + _channel(self.bias, x.dim())).to(x.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}, momentum={self.momentum} (flax convention: kept)"


class SyncBatchNorm(BatchNorm2d):
    """Cross-replica BN. On one process the batch is the card's whole batch,
    as the JAX package's pjit step sees one global array
    (``detectron2_tpu/layers/batch_norm.py:79-90``), so this is
    :class:`BatchNorm2d`. The cross-process reduction comes with ROADMAP A6:
    under ``torch.distributed`` with more than one process it raises rather
    than compute per-process statistics; ``axis_name`` (the JAX pmap/shard_map
    option) is refused the same way."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9, axis_name=None):
        if axis_name is not None:
            raise NotImplementedError(f"SyncBatchNorm(axis_name={axis_name!r}): cross-process statistics come with ROADMAP A6")
        super().__init__(features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dist = torch.distributed
        if train and dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                f"SyncBatchNorm over {dist.get_world_size()} processes: the cross-process reduction "
                "is not ported yet (ROADMAP A6)"
            )
        return super().forward(x, train)


# the JAX package exposes this name for the same module
NaiveSyncBatchNorm = SyncBatchNorm


class CycleBatchNormList(nn.ModuleList):
    """``length`` BN layers of which the call's ``index`` gives the output
    (the JAX module, ``batch_norm.py:130-140``: every layer is applied, so
    in training every layer's running statistics move). ``train`` comes
    second and has no default, as in every norm here (the JAX module takes
    ``(x, index, train)``)."""

    def __init__(self, length: int, features: int):
        super().__init__([BatchNorm2d(features) for _ in range(length)])

    def forward(self, x: torch.Tensor, train: bool, index: int = 0) -> torch.Tensor:
        outs = [bn(x, train) for bn in self]
        return outs[index]


def get_bn_modules(model: nn.Module):
    """The model's norms that keep batch statistics (the layers
    :class:`~detectron2_tpu_torch.engine.hooks.PreciseBN` recomputes)."""
    return [m for m in model.modules() if isinstance(m, BatchNorm2d)]


class GroupNorm(nn.GroupNorm):
    """GroupNorm of NCHW maps, 32 groups, eps 1e-5, as flax's ``GroupNorm``
    computes it: statistics in float32 with the variance as E[x^2] - E[x]^2
    (clamped at 0), the normalized and affine result cast back to the input's
    dtype. Its ``weight`` and ``bias`` are d2's names. ``train`` is ignored."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
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
    rounds to bf16. ``train`` is ignored."""

    def __init__(self, num_features: int, eps: float = 1e-6, channel_dim: int = 1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.channel_dim
        mean = x.mean(dim=d, keepdim=True)
        centered = x - mean
        var = centered.square().mean(dim=d, keepdim=True)
        y = centered * torch.rsqrt(var + self.eps)
        shape = [1] * x.dim()
        shape[d] = self.num_features
        return y * self.weight.to(y.dtype).view(shape) + self.bias.to(y.dtype).view(shape)


def get_norm(norm: Union[str, Callable, None], out_channels: int):
    """The JAX ``get_norm`` table (``detectron2_tpu/layers/batch_norm.py:143-184``):
    ``"BN"`` -> BatchNorm2d, ``"SyncBN"``, ``"nnSyncBN"`` and
    ``"naiveSyncBN"`` -> SyncBatchNorm, ``"FrozenBN"`` -> FrozenBatchNorm2d,
    ``"GN"`` -> GroupNorm (32 groups), ``"LN"`` -> LayerNorm over the
    channels of an NCHW map (eps 1e-6), ``""`` / None -> None, a callable ->
    ``norm(out_channels)``. Returns the module (the JAX function returns a
    factory, which flax needs to name the scope)."""
    if norm is None or (isinstance(norm, str) and not norm):
        return None
    if not isinstance(norm, str):
        return norm(out_channels)
    table = {
        "BN": BatchNorm2d,
        "SyncBN": SyncBatchNorm,
        "FrozenBN": FrozenBatchNorm2d,
        "GN": GroupNorm,
        "nnSyncBN": SyncBatchNorm,
        "naiveSyncBN": SyncBatchNorm,
    }
    if norm == "LN":
        return LayerNorm(out_channels, eps=1e-6, channel_dim=1)
    if norm not in table:
        raise KeyError(f"Unknown norm type: {norm}")
    return table[norm](out_channels)
