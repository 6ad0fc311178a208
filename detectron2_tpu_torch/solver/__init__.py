from detectron2_tpu_torch.solver.build import (
    AdamWGroupClip,
    SGDWithGradientClipping,
    adamw_with_param_groups,
    sgd_with_param_groups,
    vit_layerwise_adamw,
    build_lr_scheduler,
    build_optimizer,
    get_default_optimizer_params,
)
from detectron2_tpu_torch.solver.lr_scheduler import LazyLRMultiplier, LRMultiplier, WarmupCosineLR, WarmupMultiStepLR

__all__ = [
    "AdamWGroupClip",
    "LazyLRMultiplier",
    "adamw_with_param_groups",
    "sgd_with_param_groups",
    "vit_layerwise_adamw",
    "SGDWithGradientClipping",
    "build_lr_scheduler",
    "build_optimizer",
    "get_default_optimizer_params",
    "LRMultiplier",
    "WarmupCosineLR",
    "WarmupMultiStepLR",
]
