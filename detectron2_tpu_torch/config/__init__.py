from detectron2_tpu_torch.config.cfg_node import CfgNode
from detectron2_tpu_torch.config.config import configurable
from detectron2_tpu_torch.config.defaults import get_cfg
from detectron2_tpu_torch.config.instantiate import instantiate
from detectron2_tpu_torch.config.lazy import DictConfig, LazyCall, LazyConfig, ListConfig

__all__ = ["CfgNode", "configurable", "get_cfg", "instantiate", "DictConfig", "LazyCall", "LazyConfig", "ListConfig"]
