from detectron2_tpu_torch.solver.build import (
    SGDWithGradientClipping,
    build_lr_scheduler,
    build_optimizer,
    get_default_optimizer_params,
)
from detectron2_tpu_torch.solver.lr_scheduler import LRMultiplier, WarmupCosineLR, WarmupMultiStepLR

__all__ = [
    "SGDWithGradientClipping",
    "build_lr_scheduler",
    "build_optimizer",
    "get_default_optimizer_params",
    "LRMultiplier",
    "WarmupCosineLR",
    "WarmupMultiStepLR",
]
