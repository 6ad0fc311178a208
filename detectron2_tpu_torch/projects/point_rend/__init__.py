"""PointRend (counterpart of the JAX package's ``projects/point_rend/``):
masks rendered at adaptively chosen points, for instance segmentation
(``PointRendROIHeads``, ``ImplicitPointRendROIHeads``) and semantic
segmentation (``PointRendSemSegHead``). Importing it registers the heads."""

from detectron2_tpu_torch.projects.point_rend.config import add_pointrend_config
from detectron2_tpu_torch.projects.point_rend.point_features import (
    generate_regular_grid_point_coords,
    get_point_coords_wrt_image,
    get_uncertain_point_coords_on_grid,
    get_uncertain_point_coords_with_randomness,
    point_sample,
    point_sample_fine_grained_features,
)
from detectron2_tpu_torch.projects.point_rend.point_head import (
    POINT_HEAD_REGISTRY,
    ImplicitPointHead,
    StandardPointHead,
    build_point_head,
    roi_mask_point_loss,
)
from detectron2_tpu_torch.projects.point_rend.coarse_mask_head import CoarseMaskHead, ImplicitParameterHead
from detectron2_tpu_torch.projects.point_rend.roi_heads import ImplicitPointRendROIHeads, PointRendROIHeads
from detectron2_tpu_torch.projects.point_rend.semantic_seg import PointRendSemSegHead, calculate_uncertainty_sem_seg

__all__ = [
    "add_pointrend_config",
    "point_sample",
    "point_sample_fine_grained_features",
    "generate_regular_grid_point_coords",
    "get_point_coords_wrt_image",
    "get_uncertain_point_coords_with_randomness",
    "get_uncertain_point_coords_on_grid",
    "POINT_HEAD_REGISTRY",
    "StandardPointHead",
    "ImplicitPointHead",
    "build_point_head",
    "roi_mask_point_loss",
    "CoarseMaskHead",
    "ImplicitParameterHead",
    "PointRendROIHeads",
    "ImplicitPointRendROIHeads",
    "PointRendSemSegHead",
    "calculate_uncertainty_sem_seg",
]
