from detectron2_tpu_torch.projects.point_sup.point_utils import get_point_coords_from_point_annotation

__all__ = ["get_point_coords_from_point_annotation"]
