"""Cityscapes dataset loading (a copy of
``detectron2_tpu/data/datasets/cityscapes.py``: ``load_cityscapes_instances``
:54, ``load_cityscapes_semantic`` :100, ``register_cityscapes`` :115).

The instances come from the ``*_gtFine_polygons.json`` files, as d2's
``from_json`` path reads them: each polygon of a thing class is one
instance, its box the polygon's extent (XYXY_ABS) and ``image_id`` the
image's file name. A label ending in ``group`` is a crowd of the class
named before it (Cityscapes writes ``cargroup``); the JAX loader cuts the
suffix only, so ``"car group"`` leaves ``"car "``, which is no class, and
the object is skipped, as there. The semantic records point at the
``*_labelTrainIds.png`` beside each image, or at its ``*_labelIds.png``
where there is none."""

import json
import logging
import os
from typing import List

import numpy as np

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.structures import BoxMode

logger = logging.getLogger(__name__)

__all__ = ["CITYSCAPES_THING_CLASSES", "load_cityscapes_instances", "load_cityscapes_semantic", "register_cityscapes"]

# the 8 "thing" classes of the Cityscapes instance benchmark
CITYSCAPES_THING_CLASSES = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]


def _get_files(image_dir: str, gt_dir: str):
    """(image, polygons json, labelIds PNG) of every ``*leftImg8bit.png``
    under ``image_dir/<city>/``, cities and files in sorted order."""
    files = []
    suffix = "leftImg8bit.png"
    for city in sorted(os.listdir(image_dir)):
        city_img_dir = os.path.join(image_dir, city)
        if not os.path.isdir(city_img_dir):
            continue
        city_gt_dir = os.path.join(gt_dir, city)
        for basename in sorted(os.listdir(city_img_dir)):
            if not basename.endswith(suffix):
                continue
            prefix = basename[: -len(suffix)]
            files.append(
                (
                    os.path.join(city_img_dir, basename),
                    os.path.join(city_gt_dir, prefix + "gtFine_polygons.json"),
                    os.path.join(city_gt_dir, prefix + "gtFine_labelIds.png"),
                )
            )
    assert len(files), f"No images found in {image_dir}"
    return files


def load_cityscapes_instances(
    image_dir: str, gt_dir: str, from_json: bool = True, to_polygons: bool = True
) -> List[dict]:
    """The instance records of a split (``image_dir`` =
    ``leftImg8bit/<split>``, ``gt_dir`` = ``gtFine/<split>``); deleted
    objects, stuff and polygons of fewer than 3 points are skipped.
    ``from_json`` and ``to_polygons`` are d2's arguments; the polygons are
    always read from the json."""
    ret = []
    for image_file, polygon_file, _ in _get_files(image_dir, gt_dir):
        with open(polygon_file) as f:
            poly_json = json.load(f)
        record = {
            "file_name": image_file,
            "image_id": os.path.basename(image_file),
            "height": poly_json["imgHeight"],
            "width": poly_json["imgWidth"],
        }
        annos = []
        for obj in poly_json["objects"]:
            if obj.get("deleted", 0):
                continue
            label, iscrowd = obj["label"], 0
            if label.endswith("group"):  # a crowd region
                label, iscrowd = label[: -len("group")], 1
            if label not in CITYSCAPES_THING_CLASSES:
                continue
            polygon = np.asarray(obj["polygon"], dtype=np.float64)
            if len(polygon) < 3:
                continue
            xs, ys = polygon[:, 0], polygon[:, 1]
            annos.append(
                {
                    "category_id": CITYSCAPES_THING_CLASSES.index(label),
                    "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
                    "bbox_mode": BoxMode.XYXY_ABS,
                    "segmentation": [polygon.reshape(-1).tolist()],
                    "iscrowd": iscrowd,
                }
            )
        record["annotations"] = annos
        ret.append(record)
    logger.info("Loaded %d images from %s", len(ret), image_dir)
    return ret


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """``file_name`` and ``sem_seg_file_name`` of every image of a split."""
    ret = []
    for image_file, _, label_file in _get_files(image_dir, gt_dir):
        train_ids = label_file.replace("labelIds", "labelTrainIds")
        gt = train_ids if os.path.exists(train_ids) else label_file
        ret.append({"file_name": image_file, "sem_seg_file_name": gt})
    return ret


def register_cityscapes(name: str, image_dir: str, gt_dir: str, instances: bool = True) -> None:
    """Register one split under ``name``, as instances (``evaluator_type``
    ``cityscapes_instance``) or as semantic labels (``cityscapes_sem_seg``)."""
    if instances:
        DatasetCatalog.register(name, lambda: load_cityscapes_instances(image_dir, gt_dir))
        MetadataCatalog.get(name).set(
            thing_classes=CITYSCAPES_THING_CLASSES,
            image_dir=image_dir,
            gt_dir=gt_dir,
            evaluator_type="cityscapes_instance",
        )
    else:
        DatasetCatalog.register(name, lambda: load_cityscapes_semantic(image_dir, gt_dir))
        MetadataCatalog.get(name).set(
            image_dir=image_dir, gt_dir=gt_dir, evaluator_type="cityscapes_sem_seg", ignore_label=255
        )
