"""TridentNet config keys (counterpart of the JAX package's
``projects/tridentnet/config.py``): every key of its
``add_tridentnet_config``, with the same values."""

from detectron2_tpu_torch.config.cfg_node import CfgNode as CN

__all__ = ["add_tridentnet_config"]


def add_tridentnet_config(cfg):
    """Add config for TridentNet."""
    cfg.MODEL.TRIDENT = CN()
    # number of branches for TridentNet
    cfg.MODEL.TRIDENT.NUM_BRANCH = 3
    # per-branch dilations
    cfg.MODEL.TRIDENT.BRANCH_DILATIONS = [1, 2, 3]
    # the stage converted to trident blocks
    cfg.MODEL.TRIDENT.TRIDENT_STAGE = "res4"
    # branch used by the ROI heads (fast approximation); -1 = middle
    cfg.MODEL.TRIDENT.TEST_BRANCH_IDX = 1
