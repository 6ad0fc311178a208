"""PointSup (counterpart of the JAX package's ``projects/point_sup/``):
masks trained from a few annotated points an instance. The train batch adds
``gt_point_coords`` [B, G, P, 2] (absolute xy) and ``gt_point_labels`` [B,
G, P] (1 foreground, 0 background, -1 padding). Importing it registers its
ROI heads."""

from detectron2_tpu_torch.projects.point_sup.config import add_point_sup_config
from detectron2_tpu_torch.projects.point_sup.point_utils import get_point_coords_from_point_annotation
from detectron2_tpu_torch.projects.point_sup.roi_heads import ImplicitPointRendPointSupROIHeads, PointSupROIHeads

__all__ = [
    "add_point_sup_config",
    "get_point_coords_from_point_annotation",
    "PointSupROIHeads",
    "ImplicitPointRendPointSupROIHeads",
]
