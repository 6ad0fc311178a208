from detectron2_tpu_torch.structures.boxes import Boxes, BoxMode
from detectron2_tpu_torch.structures.instances import Instances
from detectron2_tpu_torch.structures.keypoints import Keypoints, heatmaps_to_keypoints
from detectron2_tpu_torch.structures.masks import BitMasks, PolygonMasks, polygons_to_bitmask

__all__ = [
    "Boxes", "BoxMode", "BitMasks", "Instances", "Keypoints", "PolygonMasks", "heatmaps_to_keypoints",
    "polygons_to_bitmask",
]
