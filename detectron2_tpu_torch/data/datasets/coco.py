"""COCO-format dataset loading (a copy of ``detectron2_tpu/data/datasets/coco.py``:
``load_coco_json``, ``load_sem_seg``, ``convert_to_coco_dict``,
``convert_to_coco_json`` and ``register_coco_instances``), directly on the json, with no pycocotools.
Files are read with ``open``; the JAX package's ``PathManager`` is not copied."""

import datetime
import json
import logging
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.structures import BoxMode

logger = logging.getLogger(__name__)

__all__ = ["load_coco_json", "load_sem_seg", "convert_to_coco_json", "convert_to_coco_dict", "register_coco_instances"]


def polygon_area(x: np.ndarray, y: np.ndarray) -> float:
    """Shoelace formula (``detectron2_tpu/structures/masks.py:25``)."""
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def load_coco_json(json_file: str, image_root: str, dataset_name: Optional[str] = None, extra_annotation_keys=None) -> List[dict]:
    """Load a json file with COCO's instances annotation format.

    Returns list[dict] in the framework's common dataset format:
    file_name, image_id, height, width, annotations=[{bbox, bbox_mode,
    category_id, segmentation, keypoints, iscrowd}] (reference coco.py:35-233).
    """
    with open(json_file, "r") as f:
        coco = json.load(f)

    imgs = {img["id"]: img for img in coco.get("images", [])}
    anns_by_img: Dict[int, List[dict]] = defaultdict(list)
    for ann in coco.get("annotations", []):
        anns_by_img[ann["image_id"]].append(ann)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {v: i for i, v in enumerate(cat_ids)}

    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        meta.thing_classes = [c["name"] for c in cats]
        if cat_ids and (min(cat_ids) < 1 or max(cat_ids) > len(cat_ids)):
            logger.warning(
                "Category ids in annotations are not in [1, #categories]! "
                "We'll apply a mapping for you."
            )
        meta.thing_dataset_id_to_contiguous_id = id_map
        meta.json_file = json_file
        meta.image_root = image_root
        # keypoint metadata
        for c in cats:
            if "keypoints" in c:
                meta.keypoint_names = tuple(c["keypoints"])
                break

    ann_keys = ["iscrowd", "bbox", "keypoints", "category_id"] + (extra_annotation_keys or [])

    dataset_dicts = []
    num_without_valid_segmentation = 0
    for img_id in sorted(imgs.keys()):
        img = imgs[img_id]
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img_id,
        }
        objs = []
        for ann in anns_by_img.get(img_id, []):
            assert ann["image_id"] == img_id
            obj = {key: ann[key] for key in ann_keys if key in ann}

            segm = ann.get("segmentation", None)
            if segm:  # either list[list[float]] or dict(RLE)
                if isinstance(segm, dict):
                    if isinstance(segm["counts"], list):
                        # uncompressed RLE -> keep as dict (decoded lazily)
                        pass
                else:
                    # filter invalid polygons (< 3 points)
                    segm = [poly for poly in segm if len(poly) % 2 == 0 and len(poly) >= 6]
                    if len(segm) == 0:
                        num_without_valid_segmentation += 1
                        continue
                obj["segmentation"] = segm

            kpts = obj.get("keypoints", None)
            if kpts:
                # the COCO convention stores pixel indices; +0.5 converts
                # discrete indices to the floating-point coordinates this
                # framework uses (reference coco.py:180-190)
                kpts = np.asarray(kpts, dtype=np.float64)
                kpts[0::3] += 0.5
                kpts[1::3] += 0.5
                obj["keypoints"] = kpts.tolist()

            obj["bbox_mode"] = BoxMode.XYWH_ABS
            if id_map:
                annotation_category_id = obj["category_id"]
                try:
                    obj["category_id"] = id_map[annotation_category_id]
                except KeyError as e:
                    raise KeyError(
                        f"Encountered category_id={annotation_category_id} "
                        "but this id does not exist in 'categories' of the json file."
                    ) from e
            objs.append(obj)
        record["annotations"] = objs
        dataset_dicts.append(record)

    if num_without_valid_segmentation > 0:
        logger.warning(
            f"Filtered out {num_without_valid_segmentation} instances without valid segmentation."
        )
    logger.info(f"Loaded {len(dataset_dicts)} images in COCO format from {json_file}")
    return dataset_dicts


def load_sem_seg(gt_root: str, image_root: str, gt_ext: str = "png", image_ext: str = "jpg") -> List[dict]:
    """Per-file pairs of an image and its label map: ``{"file_name",
    "sem_seg_file_name"}`` for each image of ``image_root`` ending in
    ``image_ext`` whose stem has a file in ``gt_root`` ending in ``gt_ext``
    (the JAX ``coco.py:123``). No height or width: the mapper takes the
    image's own."""

    def file2id(folder_path, file_path):
        return os.path.splitext(os.path.normpath(os.path.relpath(file_path, start=folder_path)))[0]

    input_files = sorted(
        (os.path.join(image_root, f) for f in os.listdir(image_root) if f.endswith(image_ext)),
        key=lambda file_path: file2id(image_root, file_path),
    )
    gt_files = sorted(
        (os.path.join(gt_root, f) for f in os.listdir(gt_root) if f.endswith(gt_ext)),
        key=lambda file_path: file2id(gt_root, file_path),
    )
    assert len(gt_files) > 0, f"No annotations found in {gt_root}."

    if len(input_files) != len(gt_files):
        input_basenames = [os.path.basename(f)[: -len(image_ext)] for f in input_files]
        gt_basenames = [os.path.basename(f)[: -len(gt_ext)] for f in gt_files]
        intersect = sorted(set(input_basenames) & set(gt_basenames))
        logger.warning(f"Will use their intersection of {len(intersect)} files.")
        input_files = [os.path.join(image_root, f + image_ext) for f in intersect]
        gt_files = [os.path.join(gt_root, f + gt_ext) for f in intersect]

    return [{"file_name": img_path, "sem_seg_file_name": gt_path} for img_path, gt_path in zip(input_files, gt_files)]


def convert_to_coco_dict(dataset_name: str) -> dict:
    """Convert an instance-detection dataset to COCO json format
    (reference coco.py:311-453)."""
    dataset_dicts = DatasetCatalog.get(dataset_name)
    metadata = MetadataCatalog.get(dataset_name)

    if hasattr(metadata, "thing_dataset_id_to_contiguous_id"):
        reverse_id_mapping = {v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()}

        def reverse_id_mapper(contiguous_id):
            return reverse_id_mapping[contiguous_id]

    else:

        def reverse_id_mapper(contiguous_id):
            return contiguous_id

    categories = [
        {"id": reverse_id_mapper(i), "name": name}
        for i, name in enumerate(metadata.thing_classes)
    ]

    coco_images = []
    coco_annotations = []
    for image_id, image_dict in enumerate(dataset_dicts):
        coco_image = {
            "id": image_dict.get("image_id", image_id),
            "width": int(image_dict["width"]),
            "height": int(image_dict["height"]),
            "file_name": str(image_dict["file_name"]),
        }
        coco_images.append(coco_image)

        for annotation in image_dict.get("annotations", []):
            coco_annotation = {}
            bbox = annotation["bbox"]
            bbox_mode = annotation["bbox_mode"]
            bbox = BoxMode.convert(bbox, bbox_mode, BoxMode.XYWH_ABS)
            if isinstance(bbox, np.ndarray):
                bbox = bbox.tolist()

            area = bbox[2] * bbox[3]
            if "segmentation" in annotation:
                segmentation = annotation["segmentation"]
                if isinstance(segmentation, list):
                    area = sum(
                        polygon_area(np.asarray(p[0::2]), np.asarray(p[1::2])) for p in segmentation
                    )
                coco_annotation["segmentation"] = segmentation

            coco_annotation["id"] = len(coco_annotations) + 1
            coco_annotation["image_id"] = coco_image["id"]
            coco_annotation["bbox"] = [round(float(x), 3) for x in bbox]
            coco_annotation["area"] = float(area)
            coco_annotation["iscrowd"] = int(annotation.get("iscrowd", 0))
            coco_annotation["category_id"] = int(reverse_id_mapper(annotation["category_id"]))

            if "keypoints" in annotation:
                keypoints = np.asarray(annotation["keypoints"], np.float64)
                keypoints[0::3] -= 0.5
                keypoints[1::3] -= 0.5
                coco_annotation["keypoints"] = keypoints.tolist()
                coco_annotation["num_keypoints"] = int((keypoints[2::3] > 0).sum())

            coco_annotations.append(coco_annotation)

    info = {
        "date_created": str(datetime.datetime.now()),
        "description": f"Automatically generated COCO json file for detectron2_tpu dataset {dataset_name}.",
    }
    coco_dict = {"info": info, "images": coco_images, "categories": categories, "licenses": None}
    if len(coco_annotations) > 0:
        coco_dict["annotations"] = coco_annotations
    return coco_dict


def convert_to_coco_json(dataset_name: str, output_file: str, allow_cached: bool = True) -> None:
    """Convert + cache a dataset to COCO json (reference coco.py:455-487)."""
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    if os.path.exists(output_file) and allow_cached:
        logger.warning(f"Using previously cached COCO format annotations at '{output_file}'.")
        return
    logger.info(f"Converting annotations of dataset '{dataset_name}' to COCO format ...")
    coco_dict = convert_to_coco_dict(dataset_name)
    tmp_file = output_file + ".tmp"
    with open(tmp_file, "w") as f:
        json.dump(coco_dict, f)
    os.replace(tmp_file, output_file)


def register_coco_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register a COCO-format dataset (reference coco.py:489-533)."""
    assert isinstance(name, str), name
    assert isinstance(json_file, (str, os.PathLike)), json_file
    assert isinstance(image_root, (str, os.PathLike)), image_root
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco", **metadata
    )
