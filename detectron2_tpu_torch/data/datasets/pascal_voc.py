"""Pascal VOC dataset loading (a copy of
``detectron2_tpu/data/datasets/pascal_voc.py``: ``load_voc_instances`` :22,
``register_pascal_voc`` :65, ``CLASS_NAMES``). The XML is read with
``xml.etree``; files with ``open``."""

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple, Union

import numpy as np

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.structures import BoxMode

__all__ = ["load_voc_instances", "register_pascal_voc", "CLASS_NAMES"]

CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str, class_names: Union[List[str], Tuple[str, ...]]) -> List[dict]:
    """The images of ``ImageSets/Main/<split>.txt`` under ``dirname`` (which
    holds ``Annotations``, ``ImageSets`` and ``JPEGImages``) in the common
    dataset format. Difficult objects are skipped; VOC's 1-based inclusive
    boxes become float XYXY by moving their minima by -1."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = np.loadtxt(f, dtype=str)

    annotation_dirname = os.path.join(dirname, "Annotations/")
    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(annotation_dirname, fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        with open(anno_file) as f:
            tree = ET.parse(f)

        r = {
            "file_name": jpeg_file,
            "image_id": fileid,
            "height": int(tree.findall("./size/height")[0].text),
            "width": int(tree.findall("./size/width")[0].text),
        }
        instances = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            difficult = int(obj.find("difficult").text) if obj.find("difficult") is not None else 0
            if difficult == 1:
                continue
            bbox = obj.find("bndbox")
            bbox = [float(bbox.find(x).text) for x in ["xmin", "ymin", "xmax", "ymax"]]
            bbox[0] -= 1.0
            bbox[1] -= 1.0
            instances.append({"category_id": class_names.index(cls), "bbox": bbox, "bbox_mode": BoxMode.XYXY_ABS})
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int, class_names=CLASS_NAMES) -> None:
    """Register a VOC split as ``name``, evaluated by
    ``PascalVOCDetectionEvaluator`` (11-point AP for 2007)."""
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split, class_names))
    MetadataCatalog.get(name).set(
        thing_classes=list(class_names), dirname=dirname, year=year, split=split, evaluator_type="pascal_voc"
    )
