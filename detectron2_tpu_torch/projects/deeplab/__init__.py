"""DeepLabV3 and DeepLabV3+ semantic segmentation (counterpart of the JAX
package's ``projects/deeplab/``). Importing it registers
``DeepLabV3Head`` and ``DeepLabV3PlusHead`` in ``SEM_SEG_HEADS_REGISTRY``;
``build_backbone`` and ``build_sem_seg_head`` import it on first use. The
poly schedule is the port's ``solver.WarmupPolyLR``."""

from detectron2_tpu_torch.projects.deeplab.config import add_deeplab_config
from detectron2_tpu_torch.projects.deeplab.loss import hard_pixel_mining_ce
from detectron2_tpu_torch.projects.deeplab.resnet import DeepLabStem, build_resnet_deeplab_backbone
from detectron2_tpu_torch.projects.deeplab.semantic_seg import DeepLabV3Head, DeepLabV3PlusHead
from detectron2_tpu_torch.solver.lr_scheduler import PolyParamScheduler, WarmupPolyLR

__all__ = [
    "add_deeplab_config",
    "hard_pixel_mining_ce",
    "DeepLabStem",
    "build_resnet_deeplab_backbone",
    "DeepLabV3Head",
    "DeepLabV3PlusHead",
    "PolyParamScheduler",
    "WarmupPolyLR",
]
