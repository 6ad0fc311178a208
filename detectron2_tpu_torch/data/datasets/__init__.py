from detectron2_tpu_torch.data.datasets import builtin as _builtin  # registers the builtin datasets
from detectron2_tpu_torch.data.datasets.cityscapes import (
    load_cityscapes_instances,
    load_cityscapes_semantic,
    register_cityscapes,
)
from detectron2_tpu_torch.data.datasets.cityscapes_panoptic import (
    load_cityscapes_panoptic,
    register_all_cityscapes_panoptic,
)
from detectron2_tpu_torch.data.datasets.coco import (
    convert_to_coco_dict,
    convert_to_coco_json,
    load_coco_json,
    load_sem_seg,
    register_coco_instances,
)
from detectron2_tpu_torch.data.datasets.coco_panoptic import (
    load_coco_panoptic_json,
    merge_to_panoptic,
    register_coco_panoptic,
    register_coco_panoptic_separated,
)
from detectron2_tpu_torch.data.datasets.lvis import load_lvis_json, register_lvis_instances
from detectron2_tpu_torch.data.datasets.pascal_voc import load_voc_instances, register_pascal_voc

__all__ = [
    "convert_to_coco_dict",
    "convert_to_coco_json",
    "load_cityscapes_instances",
    "load_cityscapes_semantic",
    "load_cityscapes_panoptic",
    "register_all_cityscapes_panoptic",
    "load_coco_json",
    "load_coco_panoptic_json",
    "load_sem_seg",
    "merge_to_panoptic",
    "load_lvis_json",
    "load_voc_instances",
    "register_cityscapes",
    "register_coco_instances",
    "register_coco_panoptic",
    "register_coco_panoptic_separated",
    "register_lvis_instances",
    "register_pascal_voc",
]
