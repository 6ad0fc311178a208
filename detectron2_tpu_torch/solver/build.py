"""Optimizer and LR-scheduler builders (counterpart of
``detectron2_tpu/solver/build.py``).

SGD with d2's parameter groups as ``torch.optim.SGD`` groups: parameters of
norm layers take ``WEIGHT_DECAY_NORM``; biases take ``WEIGHT_DECAY_BIAS``
(``WEIGHT_DECAY`` when None) and ``BIAS_LR_FACTOR`` times the LR; the rest
``WEIGHT_DECAY``. The update equals the JAX package's optax chain
``add_decayed_weights -> trace(momentum, nesterov) -> scale_by_schedule``
(``solver/build.py:80-121``): torch's SGD adds ``wd * p`` to the gradient,
keeps the momentum buffer ``g + momentum * buf`` (the first buffer is the
gradient itself, as optax's trace from zero) and steps by ``-lr``.
``SOLVER.CLIP_GRADIENTS`` clips the whole model's gradient first, by value
or by global norm, as ``optax.clip`` / ``optax.clip_by_global_norm`` do.

Parameters with ``requires_grad=False`` (the frozen stages) are left out,
as d2 leaves them out, so they never change.

For lazy configs: :func:`vit_layerwise_adamw` (the ViTDet configs'
``make_optimizer``) and :func:`adamw_with_param_groups` /
:func:`sgd_with_param_groups` (``configs/common/optim.py``), each given the
model as ``params``.
"""

from typing import Dict, List

import torch
from torch import nn

from detectron2_tpu_torch.layers import BatchNorm2d, FrozenBatchNorm2d, GroupNorm, LayerNorm
from detectron2_tpu_torch.solver.lr_scheduler import LRMultiplier, WarmupCosineLR, WarmupMultiStepLR

__all__ = [
    "build_optimizer",
    "build_lr_scheduler",
    "get_default_optimizer_params",
    "SGDWithGradientClipping",
    "AdamWGroupClip",
    "vit_layerwise_adamw",
    "adamw_with_param_groups",
    "sgd_with_param_groups",
]

# the modules whose parameters take WEIGHT_DECAY_NORM: torch's norms and the
# port's own (BN and SyncBN, GN, LN, FrozenBN), as the JAX package labels
# every parameter under a "...Norm" scope
_NORM_TYPES = (
    nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d, nn.SyncBatchNorm, nn.GroupNorm, nn.LayerNorm,
    nn.InstanceNorm2d, nn.LocalResponseNorm, FrozenBatchNorm2d, BatchNorm2d, GroupNorm, LayerNorm,
)


def get_default_optimizer_params(
    model: nn.Module,
    base_lr: float,
    weight_decay: float,
    weight_decay_norm: float,
    bias_lr_factor: float = 1.0,
    weight_decay_bias=None,
) -> List[Dict]:
    """One group per (lr, weight_decay) over the trainable parameters, in
    module order."""
    if weight_decay_bias is None:
        weight_decay_bias = weight_decay
    groups: Dict[tuple, List[nn.Parameter]] = {}
    seen = set()
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if not p.requires_grad or id(p) in seen:
                continue
            seen.add(id(p))
            if isinstance(module, _NORM_TYPES):
                key = (base_lr, weight_decay_norm)
            elif name == "bias":
                key = (base_lr * bias_lr_factor, weight_decay_bias)
            else:
                key = (base_lr, weight_decay)
            groups.setdefault(key, []).append(p)
    return [{"params": ps, "lr": lr, "weight_decay": wd} for (lr, wd), ps in groups.items()]


class SGDWithGradientClipping(torch.optim.SGD):
    """SGD whose ``step`` first clips every gradient it holds: elementwise to
    ``[-clip_value, clip_value]`` (``"value"``), or all of them together by
    their global L2 norm (``"norm"``)."""

    def __init__(self, params, clip_type: str, clip_value: float, **kwargs):
        if clip_type not in ("value", "norm"):
            raise ValueError(f"Unknown clip type {clip_type}")
        super().__init__(params, **kwargs)
        self.clip_type = clip_type
        self.clip_value = clip_value

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if self.clip_type == "value":
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif grads:
            total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            for g in grads:
                g.copy_(torch.where(total < self.clip_value, g, g / total * self.clip_value))
        return super().step(closure)


class AdamWGroupClip(torch.optim.AdamW):
    """AdamW whose ``step`` first clips each parameter group's gradients by
    that group's own global L2 norm (``optax.clip_by_global_norm`` inside
    each group's chain of an ``optax.multi_transform``)."""

    def __init__(self, params, max_norm: float = 1.0, **kwargs):
        super().__init__(params, **kwargs)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if not grads:
                continue
            total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = self.max_norm / torch.maximum(total, torch.full_like(total, self.max_norm))
            for g in grads:
                g.mul_(scale.to(g.dtype))
        return super().step(closure)


def vit_layerwise_adamw(
    params: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.1, lr_decay_rate: float = 0.7, num_layers: int = 12
) -> AdamWGroupClip:
    """AdamW with ViT layer-wise LR decay: the port's counterpart of
    ``make_optimizer`` in ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py:39``,
    held to that optax chain. One group per factor
    ``round(get_vit_lr_decay_rate(name, lr_decay_rate, num_layers), 6)``, in
    increasing order, at ``base_lr * factor``; betas (0.9, 0.999), eps 1e-8;
    ``weight_decay`` on every parameter, norms and position tables included
    (optax ``adamw`` without a mask); each group clipped to a global norm
    of 1 by its own norm. ``params`` is the model."""
    from detectron2_tpu_torch.modeling.backbone.vit import get_vit_lr_decay_rate

    groups: Dict[float, List[nn.Parameter]] = {}
    for name, p in params.named_parameters():
        if p.requires_grad:
            groups.setdefault(round(get_vit_lr_decay_rate(name, lr_decay_rate, num_layers), 6), []).append(p)
    param_groups = [
        {"params": groups[g], "lr": base_lr * g, "weight_decay": weight_decay, "lr_factor": g} for g in sorted(groups)
    ]
    return AdamWGroupClip(param_groups, max_norm=1.0, lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def _constant_lr(lr_schedule) -> float:
    if callable(lr_schedule):
        raise NotImplementedError("a callable lr_schedule: give the base LR and use the config's lr_multiplier")
    return float(lr_schedule)


def adamw_with_param_groups(
    lr_schedule,
    betas: tuple = (0.9, 0.999),
    weight_decay: float = 0.1,
    weight_decay_norm: float = 0.0,
    weight_decay_bias=None,
    param_labels=None,
    params: nn.Module = None,
) -> torch.optim.AdamW:
    """AdamW over ``params`` (the model) with d2's parameter groups
    (:func:`get_default_optimizer_params`): norms at ``weight_decay_norm``,
    biases at ``weight_decay_bias``. ``lr_schedule`` is the base LR; the
    config's ``lr_multiplier`` schedules it. ``param_labels`` is the JAX
    package's optax mask and is not used."""
    if params is None:
        raise ValueError("set the optimizer's params to the model before instantiating it")
    lr = _constant_lr(lr_schedule)
    groups = get_default_optimizer_params(params, lr, weight_decay, weight_decay_norm, 1.0, weight_decay_bias)
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas))


def sgd_with_param_groups(
    lr_schedule,
    momentum: float = 0.9,
    nesterov: bool = False,
    weight_decay: float = 1e-4,
    weight_decay_norm: float = 0.0,
    weight_decay_bias=None,
    bias_lr_factor: float = 1.0,
    param_labels=None,
    params: nn.Module = None,
) -> torch.optim.SGD:
    """SGD over ``params`` (the model) with d2's parameter groups, as
    :func:`build_optimizer` builds it from a yacs config."""
    if params is None:
        raise ValueError("set the optimizer's params to the model before instantiating it")
    lr = _constant_lr(lr_schedule)
    groups = get_default_optimizer_params(params, lr, weight_decay, weight_decay_norm, bias_lr_factor, weight_decay_bias)
    return torch.optim.SGD(groups, lr=lr, momentum=momentum, nesterov=nesterov)


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """SGD over the model's trainable parameters from ``cfg.SOLVER``."""
    s = cfg.SOLVER
    params = get_default_optimizer_params(
        model, s.BASE_LR, s.WEIGHT_DECAY, s.WEIGHT_DECAY_NORM, s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS
    )
    kwargs = dict(lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=s.NESTEROV)
    if s.CLIP_GRADIENTS.ENABLED:
        return SGDWithGradientClipping(params, s.CLIP_GRADIENTS.CLIP_TYPE, s.CLIP_GRADIENTS.CLIP_VALUE, **kwargs)
    return torch.optim.SGD(params, **kwargs)


def build_lr_scheduler(cfg, optimizer: torch.optim.Optimizer) -> LRMultiplier:
    """``WarmupMultiStepLR`` or ``WarmupCosineLR`` from ``cfg.SOLVER``."""
    s = cfg.SOLVER
    warmup = dict(warmup_factor=s.WARMUP_FACTOR, warmup_iters=s.WARMUP_ITERS, warmup_method=s.WARMUP_METHOD)
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        steps = [x for x in s.STEPS if x <= s.MAX_ITER]
        return WarmupMultiStepLR(optimizer, steps, s.MAX_ITER, gamma=s.GAMMA, **warmup)
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        end_fraction = s.BASE_LR_END / max(s.BASE_LR, 1e-12)
        return WarmupCosineLR(optimizer, s.MAX_ITER, end_lr_fraction=end_fraction, **warmup)
    raise ValueError(f"Unknown LR scheduler: {s.LR_SCHEDULER_NAME}")
