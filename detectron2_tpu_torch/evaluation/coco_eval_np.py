"""COCO evaluation (AP/AR) in pure numpy: a copy of
``detectron2_tpu/evaluation/coco_eval_np.py`` with its Python matcher only
(the JAX package's ctypes ``cocoeval.cpp`` path is not copied).

Self-contained replacement for pycocotools' COCOeval: the same matching
protocol, greedy per-(image, category) matching in score order at 10 IoU
thresholds, crowd leniency, area-range ignores, 101-point interpolated AP.
"""

import copy
import logging
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["COCOStyleDataset", "COCOevalNP"]


def _bbox_iou(dt: np.ndarray, gt: np.ndarray, iscrowd: List[int]) -> np.ndarray:
    """IoU between XYWH boxes; crowd gt use IoA (detection-area denominator)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    d_area = dt[:, 2] * dt[:, 3]
    g_area = gt[:, 2] * gt[:, 3]

    ix0 = np.maximum(dx0[:, None], gx0[None, :])
    iy0 = np.maximum(dy0[:, None], gy0[None, :])
    ix1 = np.minimum(dx1[:, None], gx1[None, :])
    iy1 = np.minimum(dy1[:, None], gy1[None, :])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)

    crowd = np.asarray(iscrowd, dtype=bool)
    union = d_area[:, None] + g_area[None, :] - inter
    denom = np.where(crowd[None, :], d_area[:, None], union)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


class COCOStyleDataset:
    """A minimal COCO-API-compatible container over a COCO json dict
    (the subset of pycocotools.coco.COCO used for evaluation)."""

    def __init__(self, dataset: Dict[str, Any]):
        self.dataset = dataset
        self.anns: Dict[int, dict] = {}
        self.imgToAnns: Dict[int, List[dict]] = defaultdict(list)
        self.cats: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self._create_index()

    @classmethod
    def from_json(cls, json_file: str) -> "COCOStyleDataset":
        import json

        with open(json_file) as f:
            return cls(json.load(f))

    def _create_index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns[ann["image_id"]].append(ann)

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds=None) -> List[int]:
        if imgIds is None:
            return sorted(self.anns.keys())
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        return [a["id"] for i in imgIds for a in self.imgToAnns[i]]

    def loadAnns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    def loadRes(self, results: List[dict]) -> "COCOStyleDataset":
        """Create a result dataset from detection dicts (pycocotools loadRes)."""
        res_dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": list(self.dataset.get("categories", [])),
        }
        results = copy.deepcopy(results)
        for i, ann in enumerate(results):
            ann["id"] = i + 1
            if "bbox" in ann and "area" not in ann:
                bb = ann["bbox"]
                ann["area"] = bb[2] * bb[3]
            if "segmentation" in ann and "area" not in ann:
                from detectron2_tpu_torch.evaluation.rle import rle_area

                ann["area"] = rle_area(ann["segmentation"])
            if "segmentation" in ann and "bbox" not in ann:
                from detectron2_tpu_torch.evaluation.rle import rle_to_bbox

                ann["bbox"] = rle_to_bbox(ann["segmentation"]).tolist()
            ann.setdefault("iscrowd", 0)
        res_dataset["annotations"] = results
        return COCOStyleDataset(res_dataset)


class Params:
    def __init__(self, iouType: str = "bbox"):
        self.iouType = iouType
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        if iouType == "keypoints":
            # pycocotools Params.setKpParams: keypoint eval caps at 20
            # detections and drops the "small" area bucket (no small people)
            self.maxDets = [20]
            self.areaRng = [
                [0, 1e10],
                [32**2, 96**2],
                [96**2, 1e10],
            ]
            self.areaRngLbl = ["all", "medium", "large"]
        else:
            self.maxDets = [1, 10, 100]
            self.areaRng = [
                [0, 1e10],
                [0, 32**2],
                [32**2, 96**2],
                [96**2, 1e10],
            ]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.kpt_oks_sigmas = (
            np.array(
                [0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89]
            )
            / 10.0
        )


class COCOevalNP:
    """The evaluation core. Protocol identical to pycocotools COCOeval."""

    def __init__(self, cocoGt: COCOStyleDataset, cocoDt: COCOStyleDataset, iouType: str = "bbox"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.params.imgIds = cocoGt.getImgIds()
        self.params.catIds = cocoGt.getCatIds()
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats: np.ndarray = np.array([])
        self.ious: Dict = {}

    # ------------------------------------------------------------------ iou
    def _get_anns(self, coco, img_id, cat_id):
        anns = coco.imgToAnns.get(img_id, [])
        if self.params.useCats:
            return [a for a in anns if a["category_id"] == cat_id]
        return anns

    def computeIoU(self, imgId, catId) -> np.ndarray:
        p = self.params
        gt = self._get_anns(self.cocoGt, imgId, catId)
        dt = self._get_anns(self.cocoDt, imgId, catId)
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        dt = sorted(dt, key=lambda x: -x.get("score", 0.0))[: p.maxDets[-1]]

        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        if p.iouType == "bbox":
            d_boxes = np.asarray([d["bbox"] for d in dt], np.float64)
            g_boxes = np.asarray([g["bbox"] for g in gt], np.float64)
            return _bbox_iou(d_boxes, g_boxes, iscrowd)
        elif p.iouType == "segm":
            from detectron2_tpu_torch.evaluation.rle import polygons_to_rle, rle_iou

            def to_rle(ann):
                segm = ann["segmentation"]
                if isinstance(segm, dict):
                    return segm
                img = self.cocoGt.imgs[imgId]
                return polygons_to_rle(
                    [np.asarray(pp) for pp in segm], img["height"], img["width"]
                )

            d = [to_rle(x) for x in dt]
            g = [to_rle(x) for x in gt]
            return rle_iou(d, g, iscrowd)
        elif p.iouType == "keypoints":
            return self._compute_oks(dt, gt)
        raise ValueError(f"unknown iouType {p.iouType}")

    def _compute_oks(self, dts, gts) -> np.ndarray:
        """Object keypoint similarity (pycocotools computeOks protocol)."""
        p = self.params
        sigmas = p.kpt_oks_sigmas
        vars = (sigmas * 2) ** 2
        k = len(sigmas)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.array(gt["keypoints"])
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = np.count_nonzero(vg > 0)
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.array(dt["keypoints"])
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx = xd - xg
                    dy = yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx**2 + dy**2) / vars / (gt.get("area", bb[2] * bb[3]) + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
        return ious

    # ------------------------------------------------------------- evaluate
    def evaluate(self):
        tic = time.time()
        p = self.params
        self.ious = {
            (imgId, catId): self.computeIoU(imgId, catId)
            for imgId in p.imgIds
            for catId in (p.catIds if p.useCats else [-1])
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = {
            (imgId, catId): [
                self.evaluateImg(imgId, catId, areaRng, maxDet) for areaRng in p.areaRng
            ]
            for imgId in p.imgIds
            for catId in (p.catIds if p.useCats else [-1])
        }
        logger.debug("COCOeval evaluate() took %.2fs", time.time() - tic)

    def evaluateImg(self, imgId, catId, aRng, maxDet) -> Optional[dict]:
        p = self.params
        gt = self._get_anns(self.cocoGt, imgId, catId)
        dt = self._get_anns(self.cocoDt, imgId, catId)
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            area = g.get("area", g["bbox"][2] * g["bbox"][3] if "bbox" in g else 0)
            ig = g.get("ignore", 0) or g.get("iscrowd", 0)
            if p.iouType == "keypoints":
                # pycocotools _prepare: gts with no labeled keypoints are ignored
                nk = g.get("num_keypoints")
                if nk is None:
                    nk = int(np.count_nonzero(np.asarray(g.get("keypoints", []))[2::3] > 0))
                ig = ig or nk == 0
            g["_ignore"] = int(ig or area < aRng[0] or area > aRng[1])

        # sort gt: non-ignored first; dt by score desc
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d.get("score", 0.0) for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]

        ious = self.ious[imgId, catId]
        ious = ious[:, gtind] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        # gt already matched (and not crowd) -> skip
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # dt matched an unignored gt; later gts are all ignored -> stop
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        # detections outside the area range are ignored unless matched
        a = np.array(
            [d.get("area", d["bbox"][2] * d["bbox"][3]) < aRng[0] or d.get("area", d["bbox"][2] * d["bbox"][3]) > aRng[1] for d in dt]
        ).reshape(1, D)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d.get("score", 0.0) for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # ------------------------------------------------------------ accumulate
    def accumulate(self):
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        cat_list = p.catIds if p.useCats else [-1]
        for k, catId in enumerate(cat_list):
            for a, _ in enumerate(p.areaRng):
                E = [
                    self.evalImgs.get((imgId, catId), [None] * A)[a] for imgId in p.imgIds
                ]
                E = [e for e in E if e is not None]
                if len(E) == 0:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate([e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]

                    dtm = np.concatenate([e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate([e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dtIg))

                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))

                        recall[t, k, a, m] = rc[-1] if nd else 0

                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]

                        q = np.zeros(R)
                        ss = np.zeros(R)
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss

        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    # ------------------------------------------------------------- summarize
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100) -> float:
        p = self.params
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        p = self.params
        if p.iouType == "keypoints":
            maxDet = p.maxDets[-1]
            self.stats = np.array(
                [
                    self._summarize(1, maxDets=maxDet),
                    self._summarize(1, iouThr=0.5, maxDets=maxDet),
                    self._summarize(1, iouThr=0.75, maxDets=maxDet),
                    self._summarize(1, areaRng="medium", maxDets=maxDet),
                    self._summarize(1, areaRng="large", maxDets=maxDet),
                    self._summarize(0, maxDets=maxDet),
                    self._summarize(0, iouThr=0.5, maxDets=maxDet),
                    self._summarize(0, iouThr=0.75, maxDets=maxDet),
                    self._summarize(0, areaRng="medium", maxDets=maxDet),
                    self._summarize(0, areaRng="large", maxDets=maxDet),
                ]
            )
        else:
            self.stats = np.array(
                [
                    # AP at maxDets[2] (not the hardcoded 100 of stock
                    # pycocotools) so non-default caps summarize correctly —
                    # the reference needs COCOevalMaxDets for this
                    # (coco_evaluation.py:634); identical for [1, 10, 100]
                    self._summarize(1, maxDets=self.params.maxDets[2]),
                    self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2]),
                    self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2]),
                    self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2]),
                    self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2]),
                    self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2]),
                    self._summarize(0, maxDets=self.params.maxDets[0]),
                    self._summarize(0, maxDets=self.params.maxDets[1]),
                    self._summarize(0, maxDets=self.params.maxDets[2]),
                    self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2]),
                    self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2]),
                    self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2]),
                ]
            )
        return self.stats
