"""Panoptic quality (counterpart of ``detectron2_tpu/evaluation/
panoptic_evaluation.py:25-226``): PQ, SQ and RQ over all, thing and stuff
categories, computed in numpy by the panopticapi protocol (per category the
matched IoUs over TP, with FP and FN; void and crowd overlap not counted as
FP), as the JAX evaluator does.

``process`` takes ``outputs["panoptic_seg"]``: per image ``(panoptic_seg
[h, w], segments_info)`` at the original size, which
:func:`~detectron2_tpu_torch.modeling.meta_arch.panoptic_fpn.
add_panoptic_outputs` makes for a PanopticFPN. The ground truth's RGB-id
PNGs are read with the port's PNG codec (``data/png.py``) where the JAX
evaluator calls ``cv2.imread``; the decoded RGB is ``cv2.imread(...)[:, :,
::-1]``."""

import itertools
import json
import logging
import os
from collections import OrderedDict, defaultdict

import numpy as np

from detectron2_tpu_torch.data.catalog import MetadataCatalog
from detectron2_tpu_torch.data.png import read_png
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)

__all__ = ["COCOPanopticEvaluator", "pq_compute_single_image", "rgb2id", "id2rgb"]

OFFSET = 256 * 256 * 256
VOID = 0


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi's id encoding of ``[..., 3]`` RGB: r + 256 g + 256^2 b."""
    color = color.astype(np.int64)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """The inverse of :func:`rgb2id`, uint8 ``[..., 3]``."""
    id_map = np.asarray(id_map, np.int64)
    out = np.zeros(id_map.shape + (3,), dtype=np.uint8)
    for i in range(3):
        out[..., i] = id_map % 256
        id_map = id_map // 256
    return out


def pq_compute_single_image(pan_gt: np.ndarray, pan_pred: np.ndarray, gt_segments, pred_segments, categories):
    """Per-category (iou, tp, fp, fn) of one image, panopticapi's
    ``pq_compute_single_core`` protocol."""
    stats = defaultdict(lambda: {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0})

    gt_segms = {el["id"]: el for el in gt_segments}
    pred_segms = {el["id"]: el for el in pred_segments}

    pred_labels, pred_areas = np.unique(pan_pred, return_counts=True)
    for label, area in zip(pred_labels, pred_areas):
        if label == VOID:
            continue
        if label in pred_segms:
            pred_segms[label]["area"] = int(area)
    gt_labels, gt_areas = np.unique(pan_gt, return_counts=True)
    for label, area in zip(gt_labels, gt_areas):
        if label in gt_segms:
            gt_segms[label]["area"] = int(area)

    pan_both = pan_gt.astype(np.int64) * OFFSET + pan_pred.astype(np.int64)
    labels, areas = np.unique(pan_both, return_counts=True)
    gt_pred_intersections = {}
    for label, area in zip(labels, areas):
        gt_pred_intersections[(label // OFFSET, label % OFFSET)] = int(area)

    matched_gt = set()
    matched_pred = set()
    for (gt_id, pred_id), inter in gt_pred_intersections.items():
        if gt_id not in gt_segms or pred_id not in pred_segms:
            continue
        gt_info = gt_segms[gt_id]
        pred_info = pred_segms[pred_id]
        if gt_info.get("iscrowd", 0) == 1:
            continue
        if gt_info["category_id"] != pred_info["category_id"]:
            continue
        union = gt_info.get("area", 0) + pred_info.get("area", 0) - inter - gt_pred_intersections.get((VOID, pred_id), 0)
        iou = inter / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gt_info["category_id"]
            stats[cat]["tp"] += 1
            stats[cat]["iou"] += iou
            matched_gt.add(gt_id)
            matched_pred.add(pred_id)

    crowd_by_cat = {}
    for gt_id, gt_info in gt_segms.items():
        if gt_id in matched_gt:
            continue
        if gt_info.get("iscrowd", 0) == 1:
            crowd_by_cat[gt_info["category_id"]] = gt_id
            continue
        stats[gt_info["category_id"]]["fn"] += 1

    for pred_id, pred_info in pred_segms.items():
        if pred_id in matched_pred:
            continue
        inter_void = gt_pred_intersections.get((VOID, pred_id), 0)
        # overlap with a crowd region of the category is not an FP either
        cat = pred_info["category_id"]
        if cat in crowd_by_cat:
            inter_void += gt_pred_intersections.get((crowd_by_cat[cat], pred_id), 0)
        if pred_info.get("area", 0) > 0 and inter_void / pred_info["area"] > 0.5:
            continue
        stats[cat]["fp"] += 1

    return stats


class COCOPanopticEvaluator(DatasetEvaluator):
    """PQ of a dataset registered with ``panoptic_json`` and
    ``panoptic_root`` (COCO's panoptic format)."""

    def __init__(self, dataset_name: str, output_dir=None):
        self._metadata = MetadataCatalog.get(dataset_name)
        self._thing_contiguous_id_to_dataset_id = {v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()}
        self._stuff_contiguous_id_to_dataset_id = {v: k for k, v in self._metadata.stuff_dataset_id_to_contiguous_id.items()}
        self._output_dir = output_dir
        self._predictions = []

    def reset(self):
        self._predictions = []

    def _convert_category_id(self, segment_info):
        isthing = segment_info.pop("isthing", None)
        if isthing is None:
            return segment_info
        table = self._thing_contiguous_id_to_dataset_id if isthing else self._stuff_contiguous_id_to_dataset_id
        segment_info["category_id"] = table[segment_info["category_id"]]
        return segment_info

    def process(self, inputs, outputs):
        for meta, (panoptic_img, segments_info) in zip(inputs["metadata"], outputs["panoptic_seg"]):
            self._predictions.append(
                {
                    "image_id": meta["image_id"],
                    # a PanopticDeepLab's map comes on its device
                    "panoptic_seg": panoptic_img.cpu().numpy() if hasattr(panoptic_img, "cpu") else np.asarray(panoptic_img),
                    "segments_info": [self._convert_category_id(dict(x)) for x in segments_info],
                }
            )

    def evaluate(self):
        with open(self._metadata.panoptic_json) as f:
            gt_data = json.load(f)
        gt_by_image = {a["image_id"]: a for a in gt_data["annotations"]}
        categories = {c["id"]: c for c in gt_data["categories"]}

        total = defaultdict(lambda: {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0})
        for pred in self._predictions:
            gt_ann = gt_by_image.get(pred["image_id"])
            if gt_ann is None:
                continue
            pan_gt = rgb2id(read_png(os.path.join(self._metadata.panoptic_root, gt_ann["file_name"]))[:, :, :3])
            stats = pq_compute_single_image(
                pan_gt, pred["panoptic_seg"], gt_ann["segments_info"], pred["segments_info"], categories
            )
            for cat, s in stats.items():
                for k in s:
                    total[cat][k] += s[k]

        def _pq_of(cats):
            pq, sq, rq, n = 0.0, 0.0, 0.0, 0
            for cat in cats:
                s = total.get(cat, None)
                if s is None or (s["tp"] + s["fp"] + s["fn"] == 0):
                    continue
                n += 1
                denom = s["tp"] + 0.5 * s["fp"] + 0.5 * s["fn"]
                pq += s["iou"] / denom if denom else 0.0
                sq += (s["iou"] / s["tp"]) if s["tp"] else 0.0
                rq += (s["tp"] / denom) if denom else 0.0
            n = max(n, 1)
            return 100 * pq / n, 100 * sq / n, 100 * rq / n

        all_cats = list(categories.keys())
        thing_cats = [c for c in all_cats if categories[c].get("isthing", 0) == 1]
        stuff_cats = [c for c in all_cats if categories[c].get("isthing", 0) == 0]

        res = {}
        res["PQ"], res["SQ"], res["RQ"] = _pq_of(all_cats)
        res["PQ_th"], res["SQ_th"], res["RQ_th"] = _pq_of(thing_cats)
        res["PQ_st"], res["SQ_st"], res["RQ_st"] = _pq_of(stuff_cats)

        results = OrderedDict({"panoptic_seg": res})
        logger.info(results)
        return results
