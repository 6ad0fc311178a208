"""Pascal VOC detection AP (counterpart of
``detectron2_tpu/evaluation/pascal_voc_evaluation.py``:
``PascalVOCDetectionEvaluator`` :21, ``voc_ap`` :105, ``_parse_rec`` :125,
``voc_eval`` :146): VOC's matlab-style AP over the XML annotations, the
11-point metric for 2007, averaged over IoU 0.50:0.95. Difficult objects are
neither hits nor misses. ``evaluate`` parses each XML once (the JAX package
parses them again for every class and threshold; the numbers are the same).
"""

import logging
import os
import xml.etree.ElementTree as ET
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from detectron2_tpu_torch.data.catalog import MetadataCatalog
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

logger = logging.getLogger(__name__)

__all__ = ["PascalVOCDetectionEvaluator", "voc_ap", "voc_eval"]


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    """Box AP, AP50 and AP75 of a registered VOC split."""

    def __init__(self, dataset_name: str):
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self._anno_file_template = os.path.join(meta.dirname, "Annotations", "{}.xml")
        self._image_set_path = os.path.join(meta.dirname, "ImageSets", "Main", meta.split + ".txt")
        self._class_names = meta.thing_classes
        assert meta.year in [2007, 2012], meta.year
        self._is_2007 = meta.year == 2007
        self.reset()

    def reset(self):
        self._predictions = defaultdict(list)  # class -> "image_id score xmin ymin xmax ymax" lines

    def process(self, inputs, outputs):
        """``inputs``: the batch dict (with "metadata" and "image_sizes");
        ``outputs``: the model's padded detections. One host copy a batch."""
        metadata = inputs["metadata"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        instances = [
            detector_postprocess({k: v[i] for k, v in outputs.items()}, meta["height"], meta["width"], *hw)
            for i, (meta, hw) in enumerate(zip(metadata, image_sizes))
        ]
        host = torch.cat(
            [torch.cat([inst.pred_boxes.tensor.float(), inst.scores.float()[:, None], inst.pred_classes.float()[:, None]], 1)
             for inst in instances]
        ).cpu().numpy()
        row = 0
        for meta, inst in zip(metadata, instances):
            rec = host[row : row + len(inst)]
            row += len(inst)
            for xmin, ymin, xmax, ymax, score, cls in rec:
                # VOC's coordinates are 1-based
                xmin += 1
                ymin += 1
                self._predictions[int(cls)].append(
                    f"{meta['image_id']} {score:.3f} {xmin:.1f} {ymin:.1f} {xmax:.1f} {ymax:.1f}"
                )

    def evaluate(self):
        with open(self._image_set_path) as f:
            imagenames = [x.strip() for x in f.readlines()]
        recs = {name: _parse_rec(self._anno_file_template.format(name)) for name in imagenames}
        aps = defaultdict(list)
        for cls_id, cls_name in enumerate(self._class_names):
            lines = self._predictions.get(cls_id, [""])
            for thresh in range(50, 100, 5):
                _, _, ap = voc_eval(
                    lines, self._anno_file_template, self._image_set_path, cls_name,
                    ovthresh=thresh / 100.0, use_07_metric=self._is_2007, recs=recs,
                )
                aps[thresh].append(ap * 100)

        mAP = {iou: np.mean(x) for iou, x in aps.items()}
        ret = OrderedDict()
        ret["bbox"] = {"AP": float(np.mean(list(mAP.values()))), "AP50": float(mAP[50]), "AP75": float(mAP[75])}
        return ret


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall and precision: the 11-point metric of VOC 2007, or the
    area under the precision envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap = ap + p / 11.0
    else:
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], prec, [0.0]))
        for i in range(mpre.size - 1, 0, -1):
            mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
        i = np.where(mrec[1:] != mrec[:-1])[0]
        ap = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def _parse_rec(filename):
    """The objects of one VOC XML: name, pose, truncated, difficult, bbox."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        objects.append({
            "name": obj.find("name").text,
            "pose": obj.find("pose").text if obj.find("pose") is not None else "",
            "truncated": int(obj.find("truncated").text) if obj.find("truncated") is not None else 0,
            "difficult": int(obj.find("difficult").text) if obj.find("difficult") is not None else 0,
            "bbox": [int(bbox.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")],
        })
    return objects


def voc_eval(detlines, annopath, imagesetfile, classname, ovthresh=0.5, use_07_metric=False, recs=None):
    """(recall, precision, AP) of one class: ``detlines`` are "image_id
    score xmin ymin xmax ymax" strings; ``recs`` the parsed annotations of
    the image set when the caller has them."""
    with open(imagesetfile, "r") as f:
        imagenames = [x.strip() for x in f.readlines()]
    if recs is None:
        recs = {imagename: _parse_rec(annopath.format(imagename)) for imagename in imagenames}

    class_recs = {}
    npos = 0
    for imagename in imagenames:
        R = [obj for obj in recs[imagename] if obj["name"] == classname]
        bbox = np.array([x["bbox"] for x in R])
        difficult = np.array([x["difficult"] for x in R]).astype(bool)
        npos = npos + sum(~difficult)
        class_recs[imagename] = {"bbox": bbox, "difficult": difficult, "det": [False] * len(R)}

    splitlines = [x.strip().split(" ") for x in detlines if x.strip()]
    image_ids = [x[0] for x in splitlines]
    confidence = np.array([float(x[1]) for x in splitlines])
    BB = np.array([[float(z) for z in x[2:]] for x in splitlines]).reshape(-1, 4)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, :]
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d, :].astype(float)
        ovmax = -np.inf
        BBGT = R["bbox"].astype(float)
        if BBGT.size > 0:
            ixmin = np.maximum(BBGT[:, 0], bb[0])
            iymin = np.maximum(BBGT[:, 1], bb[1])
            ixmax = np.minimum(BBGT[:, 2], bb[2])
            iymax = np.minimum(BBGT[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (BBGT[:, 2] - BBGT[:, 0] + 1.0) * (BBGT[:, 3] - BBGT[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = np.argmax(overlaps)

        if ovmax > ovthresh:
            if not R["difficult"][jmax]:
                if not R["det"][jmax]:
                    tp[d] = 1.0
                    R["det"][jmax] = 1
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return rec, prec, ap
