"""COCO panoptic datasets (a copy of ``detectron2_tpu/data/datasets/
coco_panoptic.py``): the "standard" format (one RGB-id PNG and a segment
list per image) and the "separated" format PanopticFPN trains on (the
instances json merged by file name with the per-pixel stuff labels), and,
as d2 registers it beside the separated one, its ``_stuffonly`` form
(the stuff labels alone, for semantic segmentation; ROADMAP C)."""

import copy
import json
import os
from typing import List

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets.coco import load_coco_json, load_sem_seg

__all__ = ["load_coco_panoptic_json", "merge_to_panoptic", "register_coco_panoptic", "register_coco_panoptic_separated"]


def load_coco_panoptic_json(json_file: str, image_dir: str, gt_dir: str, meta: dict) -> List[dict]:
    """The "standard" COCO panoptic json: per image its ``.jpg``, the
    panoptic PNG and ``segments_info`` with contiguous category ids and
    ``isthing``."""

    def _convert_category_id(segment_info, meta):
        if segment_info["category_id"] in meta["thing_dataset_id_to_contiguous_id"]:
            segment_info["category_id"] = meta["thing_dataset_id_to_contiguous_id"][segment_info["category_id"]]
            segment_info["isthing"] = True
        else:
            segment_info["category_id"] = meta["stuff_dataset_id_to_contiguous_id"][segment_info["category_id"]]
            segment_info["isthing"] = False
        return segment_info

    with open(json_file) as f:
        json_info = json.load(f)

    ret = []
    for ann in json_info["annotations"]:
        ret.append(
            {
                "file_name": os.path.join(image_dir, os.path.splitext(ann["file_name"])[0] + ".jpg"),
                "image_id": int(ann["image_id"]),
                "pan_seg_file_name": os.path.join(gt_dir, ann["file_name"]),
                "segments_info": [_convert_category_id(dict(x), meta) for x in ann["segments_info"]],
            }
        )
    assert len(ret), f"No images found in {image_dir}!"
    return ret


def register_coco_panoptic(name, metadata, image_root, panoptic_root, panoptic_json, instances_json=None):
    """Register the "standard" format as ``name``."""
    DatasetCatalog.register(name, lambda: load_coco_panoptic_json(panoptic_json, image_root, panoptic_root, metadata))
    MetadataCatalog.get(name).set(
        panoptic_root=panoptic_root,
        image_root=image_root,
        panoptic_json=panoptic_json,
        json_file=instances_json,
        evaluator_type="coco_panoptic_seg",
        ignore_label=255,
        label_divisor=1000,
        **metadata,
    )


def register_coco_panoptic_separated(name, metadata, image_root, panoptic_root, panoptic_json, sem_seg_root, instances_json):
    """Register ``{name}_separated`` (instances + stuff labels,
    ``evaluator_type`` ``coco_panoptic_seg``) and ``{name}_stuffonly``
    (``load_sem_seg`` of the stuff labels, ``evaluator_type`` ``sem_seg``),
    as d2 does; the JAX function registers the first only."""
    panoptic_name = name + "_separated"
    DatasetCatalog.register(
        panoptic_name,
        lambda: merge_to_panoptic(
            load_coco_json(instances_json, image_root, panoptic_name), load_sem_seg(sem_seg_root, image_root)
        ),
    )
    MetadataCatalog.get(panoptic_name).set(
        panoptic_root=panoptic_root,
        image_root=image_root,
        panoptic_json=panoptic_json,
        sem_seg_root=sem_seg_root,
        json_file=instances_json,
        evaluator_type="coco_panoptic_seg",
        ignore_label=255,
        **metadata,
    )

    semantic_name = name + "_stuffonly"
    DatasetCatalog.register(semantic_name, lambda: load_sem_seg(sem_seg_root, image_root))
    MetadataCatalog.get(semantic_name).set(
        sem_seg_root=sem_seg_root, image_root=image_root, evaluator_type="sem_seg", ignore_label=255, **metadata
    )


def merge_to_panoptic(detection_dicts: List[dict], sem_seg_dicts: List[dict]) -> List[dict]:
    """Each detection dict updated with the sem-seg dict of its
    ``file_name``."""
    results = []
    sem_seg_file_to_entry = {x["file_name"]: x for x in sem_seg_dicts}
    assert len(sem_seg_file_to_entry) > 0
    for det_dict in detection_dicts:
        dic = copy.copy(det_dict)
        dic.update(sem_seg_file_to_entry[dic["file_name"]])
        results.append(dic)
    return results
