from detectron2_tpu_torch.data.datasets.coco import (
    convert_to_coco_dict,
    convert_to_coco_json,
    load_coco_json,
    register_coco_instances,
)

__all__ = ["convert_to_coco_dict", "convert_to_coco_json", "load_coco_json", "register_coco_instances"]
