from detectron2_tpu_torch.layers.batch_norm import (
    BatchNorm2d,
    CycleBatchNormList,
    FrozenBatchNorm2d,
    GroupNorm,
    LayerNorm,
    NaiveSyncBatchNorm,
    SyncBatchNorm,
    get_bn_modules,
    get_norm,
)
from detectron2_tpu_torch.layers.blocks import DropPath
from detectron2_tpu_torch.layers.deform_conv import DeformConv, ModulatedDeformConv
from detectron2_tpu_torch.layers.shape_spec import ShapeSpec
from detectron2_tpu_torch.layers.wrappers import Conv2d, ConvTranspose2d, Linear, nchw, nhwc

__all__ = [
    "BatchNorm2d",
    "CycleBatchNormList",
    "FrozenBatchNorm2d",
    "GroupNorm",
    "LayerNorm",
    "NaiveSyncBatchNorm",
    "SyncBatchNorm",
    "get_bn_modules",
    "get_norm",
    "DropPath",
    "DeformConv",
    "ModulatedDeformConv",
    "ShapeSpec",
    "Conv2d",
    "ConvTranspose2d",
    "Linear",
    "nchw",
    "nhwc",
]
