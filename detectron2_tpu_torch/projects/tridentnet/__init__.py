"""TridentNet (counterpart of the JAX package's ``projects/tridentnet/``):
scale-aware trident blocks, weight-shared branches of res4 at different
dilations. Each branch is a feature level of its own (``res4_b{i}``), so
the RPN trains over the three and the C4 heads pool the test branch
``res4``: the JAX package's design, where d2 stacks the branches into the
batch. ``build_backbone`` and ``build_rpn`` import it on first use."""

from detectron2_tpu_torch.projects.tridentnet.config import add_tridentnet_config
from detectron2_tpu_torch.projects.tridentnet.trident_backbone import (
    TridentBottleneckBlock,
    TridentResNet,
    build_trident_resnet_backbone,
)
from detectron2_tpu_torch.projects.tridentnet.trident_conv import TridentConv
from detectron2_tpu_torch.projects.tridentnet.trident_rpn import TridentRPN

__all__ = [
    "add_tridentnet_config",
    "TridentConv",
    "TridentBottleneckBlock",
    "TridentResNet",
    "build_trident_resnet_backbone",
    "TridentRPN",
]
