"""DeepLab config keys (counterpart of the JAX package's
``projects/deeplab/config.py``): every key of its ``add_deeplab_config``,
with the same values."""

__all__ = ["add_deeplab_config"]


def add_deeplab_config(cfg):
    """Add config for DeepLab."""
    # the poly learning rate schedule
    cfg.SOLVER.LR_SCHEDULER_NAME = "WarmupPolyLR"
    cfg.SOLVER.POLY_LR_POWER = 0.9
    cfg.SOLVER.POLY_LR_CONSTANT_ENDING = 0.0
    # the loss: plain or hard-pixel-mining cross entropy
    cfg.MODEL.SEM_SEG_HEAD.LOSS_TYPE = "hard_pixel_mining"
    cfg.MODEL.SEM_SEG_HEAD.LOSS_TOP_K = 0.2
    # the DeepLabV3+ decoder
    cfg.MODEL.SEM_SEG_HEAD.PROJECT_FEATURES = ["res2"]
    cfg.MODEL.SEM_SEG_HEAD.PROJECT_CHANNELS = [48]
    cfg.MODEL.SEM_SEG_HEAD.ASPP_CHANNELS = 256
    cfg.MODEL.SEM_SEG_HEAD.ASPP_DILATIONS = [6, 12, 18]
    cfg.MODEL.SEM_SEG_HEAD.ASPP_DROPOUT = 0.1
    cfg.MODEL.SEM_SEG_HEAD.USE_DEPTHWISE_SEPARABLE_CONV = False
    # the backbone: the deeper stem and a dilated res5 with multi-grid
    cfg.MODEL.RESNETS.STEM_TYPE = "deeplab"
    cfg.MODEL.RESNETS.RES4_DILATION = 1
    cfg.MODEL.RESNETS.RES5_MULTI_GRID = [1, 2, 4]
    cfg.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA = 1.0
