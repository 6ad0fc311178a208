"""Cityscapes panoptic segmentation (counterpart of
``detectron2_tpu/data/datasets/cityscapes_panoptic.py``): the
``cityscapes_panoptic_{split}.json`` files and RGB-id PNGs that
Cityscapes' ``createPanopticImgs`` writes, read into d2's panoptic records
(``pan_seg_file_name``, ``segments_info`` with contiguous category ids and
``isthing``, and the ``*_labelTrainIds.png`` beside each image as
``sem_seg_file_name``).

:func:`register_all_cityscapes_panoptic` registers
``cityscapes_fine_panoptic_{train,val}`` as d2's ``builtin.py`` does, with
d2's metadata: every one of the 19 classes in ``thing_classes`` and
``stuff_classes``, and the label ids of things and of stuff each mapped to
their train ids. The JAX package defines the function but never calls it
(its ``builtin.py:233-239``; ROADMAP C, correction 20).
"""

import json
import os
from typing import List

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

__all__ = ["load_cityscapes_panoptic", "register_all_cityscapes_panoptic", "cityscapes_panoptic_meta"]

_RAW_CITYSCAPES_PANOPTIC_SPLITS = {
    "cityscapes_fine_panoptic_train": (
        "cityscapes/leftImg8bit/train",
        "cityscapes/gtFine/cityscapes_panoptic_train",
        "cityscapes/gtFine/cityscapes_panoptic_train.json",
    ),
    "cityscapes_fine_panoptic_val": (
        "cityscapes/leftImg8bit/val",
        "cityscapes/gtFine/cityscapes_panoptic_val",
        "cityscapes/gtFine/cityscapes_panoptic_val.json",
    ),
}


def _get_cityscapes_panoptic_files(image_dir: str, gt_dir: str, json_info: dict):
    image_dict = {}
    suffix = "_leftImg8bit.png"
    for city in os.listdir(image_dir):
        city_img_dir = os.path.join(image_dir, city)
        for basename in os.listdir(city_img_dir):
            if basename.endswith(suffix):
                image_dict[basename[: -len(suffix)]] = os.path.join(city_img_dir, basename)
    files = []
    for ann in json_info["annotations"]:
        image_file = image_dict.get(ann["image_id"])
        assert image_file is not None, f"No image {ann['image_id']} in {image_dir}"
        files.append((image_file, os.path.join(gt_dir, ann["file_name"]), ann["segments_info"]))
    assert len(files), f"No images found in {image_dir}"
    return files


def load_cityscapes_panoptic(image_dir: str, gt_dir: str, gt_json: str, meta: dict) -> List[dict]:
    """The records of one split, in the json's order: ``file_name``,
    ``image_id`` (``<city>_<seq>_<frame>``), ``sem_seg_file_name``,
    ``pan_seg_file_name`` and ``segments_info``, whose label ids become the
    contiguous ids of ``meta`` (``isthing`` added)."""

    def convert(segment_info):
        seg = dict(segment_info)
        cid = seg["category_id"]
        if cid in meta["thing_dataset_id_to_contiguous_id"]:
            seg["category_id"] = meta["thing_dataset_id_to_contiguous_id"][cid]
            seg["isthing"] = True
        else:
            seg["category_id"] = meta["stuff_dataset_id_to_contiguous_id"][cid]
            seg["isthing"] = False
        return seg

    assert os.path.exists(gt_json), (
        f"Please run `python cityscapesscripts/preparation/createPanopticImgs.py` to generate label files "
        f"(missing {gt_json})."
    )
    with open(gt_json) as f:
        json_info = json.load(f)
    ret = []
    for image_file, label_file, segments_info in _get_cityscapes_panoptic_files(image_dir, gt_dir, json_info):
        ret.append({
            "file_name": image_file,
            "image_id": "_".join(os.path.splitext(os.path.basename(image_file))[0].split("_")[:3]),
            "sem_seg_file_name": image_file.replace("leftImg8bit", "gtFine").split(".")[0] + "_labelTrainIds.png",
            "pan_seg_file_name": label_file,
            "segments_info": [convert(x) for x in segments_info],
        })
    return ret


def cityscapes_panoptic_meta() -> dict:
    """d2's metadata of the panoptic splits: the 19 classes as both things
    and stuff (names, colors), label ids -> train ids for each kind."""
    from detectron2_tpu_torch.data.datasets.builtin_meta import CITYSCAPES_CATEGORIES

    return {
        "thing_classes": [c[2] for c in CITYSCAPES_CATEGORIES],
        "thing_colors": [c[4] for c in CITYSCAPES_CATEGORIES],
        "stuff_classes": [c[2] for c in CITYSCAPES_CATEGORIES],
        "stuff_colors": [c[4] for c in CITYSCAPES_CATEGORIES],
        "thing_dataset_id_to_contiguous_id": {c[0]: c[1] for c in CITYSCAPES_CATEGORIES if c[3]},
        "stuff_dataset_id_to_contiguous_id": {c[0]: c[1] for c in CITYSCAPES_CATEGORIES if not c[3]},
    }


def register_all_cityscapes_panoptic(root: str) -> None:
    """``cityscapes_fine_panoptic_{train,val}`` under ``root``, evaluator
    type ``cityscapes_panoptic_seg``, ignore label 255, label divisor
    1000; ``gt_dir`` the split's ``gtFine/<split>`` (CityscapesSemSegEvaluator
    reads the ``*_gtFine_labelIds.png`` there)."""
    meta = cityscapes_panoptic_meta()
    for key, (image_dir, gt_dir, gt_json) in _RAW_CITYSCAPES_PANOPTIC_SPLITS.items():
        image_dir, gt_dir, gt_json = (os.path.join(root, p) for p in (image_dir, gt_dir, gt_json))
        DatasetCatalog.register(key, lambda x=image_dir, y=gt_dir, z=gt_json: load_cityscapes_panoptic(x, y, z, meta))
        MetadataCatalog.get(key).set(
            panoptic_root=gt_dir,
            image_root=image_dir,
            panoptic_json=gt_json,
            gt_dir=gt_dir.replace("cityscapes_panoptic_", ""),
            evaluator_type="cityscapes_panoptic_seg",
            ignore_label=255,
            label_divisor=1000,
            **meta,
        )
