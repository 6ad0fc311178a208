"""LVIS dataset loading (a copy of ``detectron2_tpu/data/datasets/lvis.py``:
``load_lvis_json`` :26, ``register_lvis_instances`` :19,
``get_lvis_instances_meta_from_json`` :77 and ``get_lvis_instances_meta``
:85), parsed directly from the json, with no lvis-api. Files are read with
``open``."""

import json
import logging
import os
from collections import defaultdict
from typing import List, Optional

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.structures import BoxMode

logger = logging.getLogger(__name__)

__all__ = ["load_lvis_json", "register_lvis_instances", "get_lvis_instances_meta", "get_lvis_instances_meta_from_json"]


def register_lvis_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register an LVIS json as ``name``, evaluated by ``LVISEvaluator``."""
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="lvis", **metadata)


def load_lvis_json(json_file: str, image_root: str, dataset_name: Optional[str] = None) -> List[dict]:
    """The images of an LVIS json in the common dataset format, in image id
    order: ``file_name`` (the image's, else the last two parts of its
    ``coco_url``, under ``image_root``), height, width, image_id,
    ``not_exhaustive_category_ids``, ``neg_category_ids`` and the
    annotations, whose 1-based category ids become contiguous by ``- 1`` and
    whose polygons shorter than 6 numbers or of odd length are dropped.
    With ``dataset_name``, the json's categories set its metadata."""
    with open(json_file) as f:
        lvis = json.load(f)

    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(**get_lvis_instances_meta_from_json(lvis))

    imgs = {img["id"]: img for img in lvis.get("images", [])}
    anns_by_img = defaultdict(list)
    for ann in lvis.get("annotations", []):
        anns_by_img[ann["image_id"]].append(ann)

    dataset_dicts = []
    for img_id in sorted(imgs.keys()):
        img = imgs[img_id]
        # LVIS v1 gives the COCO path in coco_url
        file_name = img["file_name"] if "file_name" in img else "/".join(img["coco_url"].split("/")[-2:])
        record = {
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
            "not_exhaustive_category_ids": img.get("not_exhaustive_category_ids", []),
            "neg_category_ids": img.get("neg_category_ids", []),
        }
        objs = []
        for ann in anns_by_img.get(img_id, []):
            obj = {"bbox": ann["bbox"], "bbox_mode": BoxMode.XYWH_ABS, "category_id": ann["category_id"] - 1}
            segm = ann.get("segmentation", None)
            if segm:
                obj["segmentation"] = [poly for poly in segm if len(poly) % 2 == 0 and len(poly) >= 6]
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)

    logger.info(f"Loaded {len(dataset_dicts)} images in LVIS format from {json_file}")
    return dataset_dicts


def get_lvis_instances_meta_from_json(lvis_json: dict) -> dict:
    """``thing_classes`` (each category's first synonym) and
    ``class_image_count`` of an LVIS json's categories, in id order."""
    cats = sorted(lvis_json.get("categories", []), key=lambda x: x["id"])
    thing_classes = [c.get("synonyms", [c.get("name", str(c["id"]))])[0] for c in cats]
    return {
        "thing_classes": thing_classes,
        "class_image_count": [{"id": c["id"], "image_count": c.get("image_count", 1)} for c in cats],
    }


def get_lvis_instances_meta(dataset_name: str) -> dict:
    """The static metadata of an LVIS version: for v1 the release's
    ``class_image_count`` (so the federated loss's weights need no json on
    disk); ``thing_classes`` come from the json when it is loaded."""
    if "v1" in dataset_name:
        from detectron2_tpu_torch.data.datasets.lvis_v1_category_image_count import LVIS_V1_CATEGORY_IMAGE_COUNT

        return {"class_image_count": LVIS_V1_CATEGORY_IMAGE_COUNT}
    return {}
