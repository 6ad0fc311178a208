"""Panoptic-DeepLab config keys (counterpart of the JAX package's
``projects/panoptic_deeplab/config.py``): ``add_deeplab_config``'s keys,
then every key of its ``add_panoptic_deeplab_config``, with the same
values. ``PANOPTIC_DEEPLAB.SIZE_DIVISIBILITY`` and
``BENCHMARK_NETWORK_SPEED`` are read by neither package (ROADMAP C)."""

from detectron2_tpu_torch.config.cfg_node import CfgNode as CN
from detectron2_tpu_torch.projects.deeplab.config import add_deeplab_config

__all__ = ["add_panoptic_deeplab_config"]


def add_panoptic_deeplab_config(cfg):
    """Add config for Panoptic-DeepLab."""
    add_deeplab_config(cfg)
    cfg.MODEL.META_ARCHITECTURE = "PanopticDeepLab"

    # the semantic head: the DeepLabV3+ decoder, then a head tower
    cfg.MODEL.SEM_SEG_HEAD.NAME = "PanopticDeepLabSemSegHead"
    cfg.MODEL.SEM_SEG_HEAD.HEAD_CHANNELS = 256
    cfg.MODEL.SEM_SEG_HEAD.LOSS_TOP_K = 0.2

    cfg.MODEL.INS_EMBED_HEAD = CN()
    cfg.MODEL.INS_EMBED_HEAD.NAME = "PanopticDeepLabInsEmbedHead"
    cfg.MODEL.INS_EMBED_HEAD.IN_FEATURES = ["res2", "res5"]
    cfg.MODEL.INS_EMBED_HEAD.PROJECT_FEATURES = ["res2"]
    cfg.MODEL.INS_EMBED_HEAD.PROJECT_CHANNELS = [32]
    cfg.MODEL.INS_EMBED_HEAD.ASPP_CHANNELS = 256
    cfg.MODEL.INS_EMBED_HEAD.ASPP_DILATIONS = [6, 12, 18]
    cfg.MODEL.INS_EMBED_HEAD.ASPP_DROPOUT = 0.1
    cfg.MODEL.INS_EMBED_HEAD.HEAD_CHANNELS = 32
    cfg.MODEL.INS_EMBED_HEAD.CONVS_DIM = 128
    cfg.MODEL.INS_EMBED_HEAD.COMMON_STRIDE = 4
    cfg.MODEL.INS_EMBED_HEAD.NORM = "SyncBN"
    cfg.MODEL.INS_EMBED_HEAD.CENTER_LOSS_WEIGHT = 200.0
    cfg.MODEL.INS_EMBED_HEAD.OFFSET_LOSS_WEIGHT = 0.01

    cfg.MODEL.PANOPTIC_DEEPLAB = CN()
    cfg.MODEL.PANOPTIC_DEEPLAB.STUFF_AREA = 2048
    cfg.MODEL.PANOPTIC_DEEPLAB.CENTER_THRESHOLD = 0.1
    cfg.MODEL.PANOPTIC_DEEPLAB.NMS_KERNEL = 7
    cfg.MODEL.PANOPTIC_DEEPLAB.TOP_K_INSTANCE = 200
    # the optimizer (build_optimizer reads it; only these configs set it)
    cfg.SOLVER.OPTIMIZER = "ADAM"
    # the center heatmap targets
    cfg.INPUT.GAUSSIAN_SIGMA = 10
    cfg.INPUT.IGNORE_STUFF_IN_OFFSET = True
    cfg.INPUT.SMALL_INSTANCE_AREA = 4096
    cfg.INPUT.SMALL_INSTANCE_WEIGHT = 3

    cfg.MODEL.PANOPTIC_DEEPLAB.PREDICT_INSTANCES = False
    cfg.MODEL.PANOPTIC_DEEPLAB.USE_DEPTHWISE_SEPARABLE_CONV = False
    cfg.MODEL.PANOPTIC_DEEPLAB.SIZE_DIVISIBILITY = -1
    cfg.MODEL.PANOPTIC_DEEPLAB.BENCHMARK_NETWORK_SPEED = False
