"""Semantic segmentation evaluation (counterpart of ``detectron2_tpu/
evaluation/sem_seg_evaluation.py:23-107``): a (C+1)^2 confusion matrix over
the pixels of the ground-truth label maps, the last row and column the
ignored label, and mIoU, fwIoU, mACC and pACC from it.

``process`` takes the model's ``[B, H, W, C]`` logits in the padded frame:
on their device each image's are cropped and resized to its original size
(``sem_seg_postprocess``) and reduced to labels, and one int64 copy of the
batch's labels goes to the host. Where the metadata has no height and
width (``load_sem_seg``'s dicts have none), the image's size in the batch is
taken, as d2 does; the JAX evaluator reads ``meta["height"]`` and raises
(ROADMAP C)."""

import json
import logging
import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.detection_utils import read_image
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator
from detectron2_tpu_torch.modeling.postprocessing import sem_seg_postprocess

logger = logging.getLogger(__name__)

__all__ = ["SemSegEvaluator"]


class SemSegEvaluator(DatasetEvaluator):
    """mIoU and the rest over a dataset with ``stuff_classes`` and
    ``sem_seg_file_name`` records. ``distributed`` is kept for d2's
    signature: the port runs one process."""

    def __init__(self, dataset_name: str, distributed: bool = True, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._distributed = distributed
        self._output_dir = output_dir
        meta = MetadataCatalog.get(dataset_name)
        self._num_classes = len(meta.stuff_classes)
        self._ignore_label = meta.get("ignore_label", 255)
        self._class_names = meta.stuff_classes
        self.input_file_to_gt_file = {
            record["file_name"]: record["sem_seg_file_name"] for record in DatasetCatalog.get(dataset_name)
        }
        self._conf_matrix = None

    def reset(self):
        self._conf_matrix = np.zeros((self._num_classes + 1, self._num_classes + 1), dtype=np.int64)

    def process(self, inputs, outputs):
        """``inputs``: the batch dict (with "metadata" and "image_sizes");
        ``outputs``: the model's outputs with "sem_seg" ``[B, H, W, C]``."""
        sem_seg = outputs["sem_seg"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        labels = []
        for i, (meta, hw) in enumerate(zip(inputs["metadata"], image_sizes)):
            h, w = meta.get("height", hw[0]), meta.get("width", hw[1])
            labels.append(sem_seg_postprocess(sem_seg[i], hw, h, w).argmax(dim=-1))
        host = torch.cat([x.flatten() for x in labels]).cpu().numpy()
        start = 0
        for meta, lab in zip(inputs["metadata"], labels):
            pred = host[start : start + lab.numel()].reshape(lab.shape)
            start += lab.numel()
            gt = read_image(self.input_file_to_gt_file[meta["file_name"]], "L").squeeze(-1).astype(int)
            gt[gt == self._ignore_label] = self._num_classes
            self._conf_matrix += np.bincount(
                (self._num_classes + 1) * pred.reshape(-1) + gt.reshape(-1), minlength=self._conf_matrix.size
            ).reshape(self._conf_matrix.shape)

    def evaluate(self):
        acc = np.full(self._num_classes, np.nan, dtype=float)
        iou = np.full(self._num_classes, np.nan, dtype=float)
        tp = self._conf_matrix.diagonal()[:-1].astype(float)
        pos_gt = np.sum(self._conf_matrix[:-1, :-1], axis=0).astype(float)
        class_weights = pos_gt / np.maximum(np.sum(pos_gt), 1)
        pos_pred = np.sum(self._conf_matrix[:-1, :-1], axis=1).astype(float)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        iou_valid = (pos_gt + pos_pred) > 0
        union = pos_gt + pos_pred - tp
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]
        macc = np.sum(acc[acc_valid]) / max(np.sum(acc_valid), 1)
        miou = np.sum(iou[iou_valid]) / max(np.sum(iou_valid), 1)
        fiou = np.sum(iou[iou_valid] * class_weights[iou_valid])
        pacc = np.sum(tp) / max(np.sum(pos_gt), 1)

        res = {"mIoU": 100 * miou, "fwIoU": 100 * fiou}
        for i, name in enumerate(self._class_names):
            res[f"IoU-{name}"] = 100 * iou[i]
        res["mACC"] = 100 * macc
        res["pACC"] = 100 * pacc
        for i, name in enumerate(self._class_names):
            res[f"ACC-{name}"] = 100 * acc[i]

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "sem_seg_evaluation.json"), "w") as f:
                json.dump(res, f)
        results = OrderedDict({"sem_seg": res})
        logger.info(results)
        return results
