"""TensorMask (counterpart of the JAX package's ``projects/tensormask/``):
dense sliding-window instance segmentation with the tensor bipyramid.
``build_model`` imports it for ``META_ARCHITECTURE`` "TensorMask"."""

from detectron2_tpu_torch.projects.tensormask.arch import (
    TensorMask,
    TensorMaskHead,
    sigmoid_focal_loss_star,
    tensormask_assignment,
)
from detectron2_tpu_torch.projects.tensormask.config import add_tensormask_config
from detectron2_tpu_torch.projects.tensormask.layers import SwapAlign2Nat, swap_align2nat

__all__ = [
    "add_tensormask_config",
    "TensorMask",
    "TensorMaskHead",
    "sigmoid_focal_loss_star",
    "tensormask_assignment",
    "swap_align2nat",
    "SwapAlign2Nat",
]
