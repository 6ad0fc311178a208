from detectron2_tpu_torch.config.cfg_node import CfgNode
from detectron2_tpu_torch.config.config import configurable
from detectron2_tpu_torch.config.defaults import get_cfg

__all__ = ["CfgNode", "configurable", "get_cfg"]
