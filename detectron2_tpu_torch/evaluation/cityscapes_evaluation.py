"""Cityscapes evaluators (counterpart of
``detectron2_tpu/evaluation/cityscapes_evaluation.py``:
``CityscapesInstanceEvaluator`` :52, ``CityscapesSemSegEvaluator`` :132).

As in the JAX package, neither shells out to ``cityscapesscripts``:

- ``CityscapesInstanceEvaluator`` scores the masks with the numpy COCOeval
  (``segm``; AP over IoU 0.5:0.95 and AP50, in percent, as
  cityscapesscripts reports them) against the polygons of
  ``load_cityscapes_instances``;
- ``CityscapesSemSegEvaluator`` fills a confusion matrix over the 19 train
  ids from the ``*_labelIds.png`` ground truth mapped id -> train id, and
  reports their mean IoU.

The JAX evaluators read the ground truth from each image's metadata
(``annotations``, ``sem_seg_file_name``), which no loader of either package
puts there. The port's instance evaluator takes the dataset's records by
``image_id`` and the semantic one the image's ``*_gtFine_labelIds.png``
under the metadata's ``gt_dir``, as d2's evaluator finds it, with the
image's size in the batch where the record has none (ROADMAP C).
"""

import logging
import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.detection_utils import read_image
from detectron2_tpu_torch.evaluation.coco_eval_np import COCOevalNP, COCOStyleDataset
from detectron2_tpu_torch.evaluation.coco_evaluation import _coco_json, _instances_to_host
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess, sem_seg_postprocess

logger = logging.getLogger(__name__)

__all__ = ["CityscapesInstanceEvaluator", "CityscapesSemSegEvaluator", "CITYSCAPES_ID_TO_TRAINID"]

# label id -> train id of the 19 evaluated classes (every other id is ignored)
CITYSCAPES_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}
_NUM_TRAIN_IDS = 19


class CityscapesEvaluator(DatasetEvaluator):
    """Shared base: the dataset's metadata and the per-image predictions."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._output_dir = output_dir
        self._predictions = []

    def reset(self):
        self._predictions = []


class CityscapesInstanceEvaluator(CityscapesEvaluator):
    """Mask AP on Cityscapes. ``process`` takes the batch dict and the
    model's padded detections, as COCOEvaluator does."""

    def reset(self):
        super().reset()
        self._gt_annotations = {}
        self._next_id = 1
        self._id_of = {}
        self._records = None

    def _annotations(self, meta: dict):
        if self._records is None:
            self._records = {str(r["image_id"]): r["annotations"] for r in DatasetCatalog.get(self._dataset_name)}
        return self._records[str(meta["image_id"])]

    def process(self, inputs, outputs):
        metadata = inputs["metadata"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        instances = []
        for i, meta in enumerate(metadata):
            in_h, in_w = image_sizes[i]
            out = {k: v[i] for k, v in outputs.items() if k != "metadata"}
            instances.append(detector_postprocess(out, meta.get("height", in_h), meta.get("width", in_w), in_h, in_w))
        for meta, host in zip(metadata, _instances_to_host(instances)):
            key = meta.get("image_id", meta["file_name"])
            if key not in self._id_of:
                self._id_of[key] = self._next_id
                self._next_id += 1
            image_id = self._id_of[key]
            self._gt_annotations[image_id] = {
                "height": meta["height"],
                "width": meta["width"],
                "annotations": self._annotations(meta),
            }
            self._predictions.extend(_coco_json(host, image_id))

    def evaluate(self):
        images, annotations = [], []
        ann_id = 1
        for image_id, rec in self._gt_annotations.items():
            images.append({"id": image_id, "height": rec["height"], "width": rec["width"]})
            for ann in rec["annotations"]:
                a = dict(ann)
                a["id"] = ann_id
                a["image_id"] = image_id
                a.setdefault("iscrowd", 0)
                # the JAX evaluator's area: the product of the box's last two
                # numbers (XYXY here), read only by the area ranges, which
                # AP and AP50 do not use
                a.setdefault("area", a["bbox"][2] * a["bbox"][3])
                annotations.append(a)
                ann_id += 1
        categories = [{"id": i, "name": n} for i, n in enumerate(self._metadata.thing_classes)]
        gt = COCOStyleDataset({"images": images, "annotations": annotations, "categories": categories})
        ev = COCOevalNP(gt, gt.loadRes(self._predictions), iouType="segm")
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        return OrderedDict(segm={"AP": ev.stats[0] * 100, "AP50": ev.stats[1] * 100})


class CityscapesSemSegEvaluator(CityscapesEvaluator):
    """Mean IoU over the 19 Cityscapes train ids. ``process`` takes the
    batch dict and the model's ``[B, H, W, C]`` logits in the padded frame."""

    def reset(self):
        super().reset()
        n = _NUM_TRAIN_IDS
        self._conf_matrix = np.zeros((n + 1, n + 1), dtype=np.int64)
        self._train_id = np.full(256, n, np.int64)
        for label_id, train_id in CITYSCAPES_ID_TO_TRAINID.items():
            self._train_id[label_id] = train_id

    def _gt_file(self, meta: dict) -> str:
        city = os.path.basename(os.path.dirname(meta["file_name"]))
        name = os.path.basename(meta["file_name"]).replace("leftImg8bit.png", "gtFine_labelIds.png")
        return os.path.join(self._metadata.gt_dir, city, name)

    def process(self, inputs, outputs):
        n = _NUM_TRAIN_IDS
        sem_seg = outputs["sem_seg"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        labels = []
        for i, (meta, hw) in enumerate(zip(inputs["metadata"], image_sizes)):
            h, w = meta.get("height", hw[0]), meta.get("width", hw[1])
            labels.append(sem_seg_postprocess(sem_seg[i], hw, h, w).argmax(dim=-1))
        host = torch.cat([x.flatten() for x in labels]).cpu().numpy()
        start = 0
        for meta, lab in zip(inputs["metadata"], labels):
            pred = np.clip(host[start : start + lab.numel()], 0, n)
            start += lab.numel()
            gt = self._train_id[read_image(self._gt_file(meta), "L").squeeze(-1).astype(np.int64)]
            self._conf_matrix += np.bincount(
                (n + 1) * gt.reshape(-1) + pred, minlength=(n + 1) ** 2
            ).reshape(n + 1, n + 1)

    def evaluate(self):
        n = _NUM_TRAIN_IDS
        cm = self._conf_matrix[:n, :n].astype(np.float64)  # without the ignored row and column
        tp = np.diag(cm)
        union = cm.sum(0) + cm.sum(1) - tp
        iou = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
        return OrderedDict(sem_seg={"IoU": 100 * float(np.nanmean(iou))})
