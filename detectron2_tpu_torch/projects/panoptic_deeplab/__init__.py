"""Panoptic-DeepLab (counterpart of the JAX package's
``projects/panoptic_deeplab/``): bottom-up panoptic segmentation from a
semantic map, an instance center heatmap and center offsets. Importing it
registers ``PanopticDeepLabSemSegHead`` in ``SEM_SEG_HEADS_REGISTRY`` and
``PanopticDeepLabInsEmbedHead`` in ``INS_EMBED_BRANCHES_REGISTRY``;
``build_model`` imports it for ``META_ARCHITECTURE`` "PanopticDeepLab"."""

from detectron2_tpu_torch.projects.panoptic_deeplab.config import add_panoptic_deeplab_config
from detectron2_tpu_torch.projects.panoptic_deeplab.panoptic_seg import (
    INS_EMBED_BRANCHES_REGISTRY,
    PanopticDeepLab,
    PanopticDeepLabInsEmbedHead,
    PanopticDeepLabSemSegHead,
    panoptic_outputs,
)
from detectron2_tpu_torch.projects.panoptic_deeplab.post_processing import (
    find_instance_center,
    get_panoptic_segmentation,
    group_pixels,
    panoptic_deeplab_postprocess,
)
from detectron2_tpu_torch.projects.panoptic_deeplab.target_generator import PanopticDeepLabTargetGenerator

__all__ = [
    "add_panoptic_deeplab_config",
    "INS_EMBED_BRANCHES_REGISTRY",
    "PanopticDeepLab",
    "PanopticDeepLabSemSegHead",
    "PanopticDeepLabInsEmbedHead",
    "panoptic_outputs",
    "find_instance_center",
    "group_pixels",
    "get_panoptic_segmentation",
    "panoptic_deeplab_postprocess",
    "PanopticDeepLabTargetGenerator",
]
