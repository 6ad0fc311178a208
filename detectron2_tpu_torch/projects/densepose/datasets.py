"""DensePose datasets beyond the chart COCO splits (counterpart of
``detectron2_tpu/projects/densepose/datasets.py`` and the CSE part of its
``dataset_mapper.py``): the DensePose-LVIS loader, and the dataset reading
of the DensePose trainer with the category options.

- :func:`load_densepose_lvis_json` reads an LVIS-format json and carries the
  ``dp_*`` and ``ref_model`` keys; it keeps the raw LVIS category ids, as the
  JAX loader and d2's do, and records ``categories`` (raw id -> name) in the
  dataset's metadata.
- :func:`densepose_dataset_dicts` loads datasets for the DensePose trainer.
  A dataset whose loader keeps raw ids (its metadata has ``categories``)
  goes through d2's category handling (ROADMAP C, correction 17; as
  recalled from d2's ``densepose/data/build.py``, which the JAX package
  does not port): ``DATASETS.WHITELISTED_CATEGORIES`` keeps the listed ids,
  ``DATASETS.CATEGORY_MAPS`` maps ids onto others, the merged ids in sorted
  order become the contiguous classes 0..K-1, annotations of other
  categories are dropped, and the metadata gets ``thing_classes`` and
  ``thing_dataset_id_to_contiguous_id``. The animal configs' sorted
  whitelist (76 bear ... 1202 zebra) gives 0..8, the order of their
  ``CLASS_TO_MESH_NAME_MAPPING``.

- :func:`load_coco_json_raw_ids` reads ``base_coco_2017_{train,val}``
  (COCO 2017's instances, the evolution configs' ground truth) with raw
  ids: ROADMAP C, correction 18; the JAX package registers neither name.

The builtin names (``densepose_coco_2014_*_cse``, the chimps CSE splits,
``densepose_lvis_v1_*`` and ``base_coco_2017_*``) are registered with the
others in ``data/datasets/builtin.py``; ChimpnSee (``register_chimpnsee``)
when the DensePose project is imported.
"""

import json
import logging
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.build import filter_images_with_only_crowd_annotations
from detectron2_tpu_torch.structures import BoxMode

__all__ = [
    "CHIMPNSEE_DATASET_NAME",
    "DENSEPOSE_ALL_POSSIBLE_KEYS",
    "load_coco_json_raw_ids",
    "load_densepose_lvis_json",
    "register_chimpnsee",
    "densepose_dataset_dicts",
    "merge_categories",
]

logger = logging.getLogger(__name__)

# every annotation key a DensePose dataset may carry
DENSEPOSE_ALL_POSSIBLE_KEYS = ["dp_x", "dp_y", "dp_I", "dp_U", "dp_V", "dp_masks", "dp_vertex", "ref_model"]


def load_densepose_lvis_json(json_file: str, image_root: str, dataset_name: Optional[str] = None) -> List[Dict[str, Any]]:
    """An LVIS-format json -> dataset dicts with the DensePose keys and the
    raw category ids (the JAX ``load_densepose_lvis_json``). An image's file
    is its ``file_name``, or the last two parts of its ``coco_url`` under
    ``image_root``. With ``dataset_name``, its metadata gets ``categories``
    (raw id -> name, as d2's loader sets it; the classes come from
    :func:`merge_categories`)."""
    with open(json_file) as f:
        lvis = json.load(f)
    if dataset_name is not None:
        cats = sorted(lvis.get("categories", []), key=lambda x: x["id"])
        MetadataCatalog.get(dataset_name).set(categories={c["id"]: c.get("name", str(c["id"])) for c in cats})
    imgs = {img["id"]: img for img in lvis.get("images", [])}
    anns_by_img = defaultdict(list)
    ann_ids = set()
    for ann in lvis.get("annotations", []):
        assert ann["id"] not in ann_ids, f"duplicate annotation id {ann['id']} in {json_file}"
        ann_ids.add(ann["id"])
        anns_by_img[ann["image_id"]].append(ann)

    dataset_dicts = []
    for img_id in sorted(imgs):
        img = imgs[img_id]
        file_name = img["file_name"] if "file_name" in img else "/".join(img["coco_url"].split("/")[-2:])
        objs = []
        for ann in anns_by_img.get(img_id, []):
            obj: Dict[str, Any] = {"iscrowd": ann.get("iscrowd", 0), "category_id": ann["category_id"]}
            if "bbox" in ann:
                obj["bbox"] = ann["bbox"]
                obj["bbox_mode"] = BoxMode.XYWH_ABS
            segm = ann.get("segmentation")
            if segm:
                obj["segmentation"] = [poly for poly in segm if len(poly) % 2 == 0 and len(poly) >= 6]
            if "keypoints" in ann:
                obj["keypoints"] = ann["keypoints"]
            for key in DENSEPOSE_ALL_POSSIBLE_KEYS:
                if key in ann:
                    obj[key] = ann[key]
            objs.append(obj)
        dataset_dicts.append({
            "file_name": os.path.join(image_root, file_name), "height": img["height"], "width": img["width"],
            "image_id": img_id, "annotations": objs,
        })
    logger.info(f"Loaded {len(dataset_dicts)} images in DensePose-LVIS format from {json_file}")
    return dataset_dicts


def load_coco_json_raw_ids(json_file: str, image_root: str, dataset_name: str) -> List[Dict[str, Any]]:
    """A COCO instances json with the raw category ids kept, as d2's
    DensePose COCO loader reads ``base_coco_2017_*``, and ``categories``
    (raw id -> name) in the dataset's metadata, so that
    :func:`densepose_dataset_dicts` applies the category options to it."""
    from detectron2_tpu_torch.data.datasets.coco import load_coco_json

    with open(json_file) as f:
        cats = sorted(json.load(f).get("categories", []), key=lambda c: c["id"])
    raw = [c["id"] for c in cats]
    dicts = load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_ALL_POSSIBLE_KEYS)
    for record in dicts:
        for a in record["annotations"]:
            a["category_id"] = raw[a["category_id"]]
    MetadataCatalog.get(dataset_name).set(categories={c["id"]: c["name"] for c in cats})
    return dicts


CHIMPNSEE_DATASET_NAME = "chimpnsee"


def register_chimpnsee(root: Optional[str] = None) -> None:
    """The ChimpnSee videos as a bootstrap dataset (JAX ``datasets.py:146``):
    a video list under ``$DETECTRON2_DATASETS/chimpnsee/cdna.eva.mpg.de``
    whose keyframes :class:`~.video.VideoKeyframeDataset` decodes (PyAV)."""
    from detectron2_tpu_torch.projects.densepose.build import DatasetType
    from detectron2_tpu_torch.projects.densepose.video import maybe_prepend_base_path

    if CHIMPNSEE_DATASET_NAME in DatasetCatalog.list():
        return
    root = root or os.environ.get("DETECTRON2_DATASETS", "datasets")
    DatasetCatalog.register(CHIMPNSEE_DATASET_NAME, lambda: [])
    MetadataCatalog.get(CHIMPNSEE_DATASET_NAME).set(
        dataset_type=DatasetType.VIDEO_LIST,
        video_list_fpath=maybe_prepend_base_path(root, "chimpnsee/cdna.eva.mpg.de/video_list.txt"),
        video_base_path=maybe_prepend_base_path(root, "chimpnsee/cdna.eva.mpg.de"),
        category="chimpanzee",
    )


def merge_categories(cfg, names: Sequence[str]) -> Dict[str, Dict[int, int]]:
    """d2's category merge over the datasets ``names`` (each with
    ``categories`` in its metadata): the whitelisted ids (all, without a
    whitelist) through the dataset's category map, the merged ids sorted
    into contiguous classes. Sets each dataset's ``thing_classes`` and
    ``thing_dataset_id_to_contiguous_id`` and returns the latter by
    dataset."""
    merged: Dict[int, List] = {}
    for name in names:
        meta = MetadataCatalog.get(name)
        whitelist = cfg.DATASETS.WHITELISTED_CATEGORIES.get(name)
        cmap = {int(k): int(v) for k, v in cfg.DATASETS.CATEGORY_MAPS.get(name, {}).items()}
        for cat_id in (meta.categories.keys() if whitelist is None else whitelist):
            merged.setdefault(cmap.get(int(cat_id), int(cat_id)), []).append((name, int(cat_id), meta.categories[cat_id]))
    id_maps: Dict[str, Dict[int, int]] = {name: {} for name in names}
    classes: Dict[str, List[str]] = {name: [] for name in names}
    for contiguous, merged_id in enumerate(sorted(merged)):
        for name, cat_id, cat_name in merged[merged_id]:
            id_maps[name][cat_id] = contiguous
            classes[name].append(cat_name)
    for name in names:
        meta = MetadataCatalog.get(name)
        # a merge under another config replaces the last one's classes
        object.__setattr__(meta, "thing_classes", classes[name])
        object.__setattr__(meta, "thing_dataset_id_to_contiguous_id", id_maps[name])
    return id_maps


def densepose_dataset_dicts(cfg, names: Sequence[str], filter_empty: bool = True) -> List[dict]:
    """The records of ``names`` for the DensePose trainer: loaded, the
    datasets with raw category ids put through :func:`merge_categories`
    (their annotations of other categories dropped, the rest given the
    contiguous ids), concatenated, and with ``filter_empty`` the images
    without a non-crowd annotation dropped."""
    names = list(names)
    per_dataset = [DatasetCatalog.get(name) for name in names]
    for name, dicts in zip(names, per_dataset):
        assert len(dicts), f"Dataset '{name}' is empty!"
    raw = [name for name in names if MetadataCatalog.get(name).get("categories") is not None]
    if raw:
        id_maps = merge_categories(cfg, raw)
        for name, dicts in zip(names, per_dataset):
            if name not in id_maps:
                continue
            for record in dicts:
                anns = [a for a in record.get("annotations", []) if a["category_id"] in id_maps[name]]
                for a in anns:
                    a["category_id"] = id_maps[name][a["category_id"]]
                record["annotations"] = anns
    dataset_dicts = [d for dicts in per_dataset for d in dicts]
    if filter_empty and "annotations" in dataset_dicts[0]:
        dataset_dicts = filter_images_with_only_crowd_annotations(dataset_dicts)
    assert len(dataset_dicts), f"No valid data found in {','.join(names)}."
    return dataset_dicts
