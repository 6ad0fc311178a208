"""The DensePose COCOeval protocol in numpy (counterpart of
``detectron2_tpu/projects/densepose/dp_coco_eval.py``, which states d2's
``densepose_coco_evaluation.py``; a copy, as the port imports nothing of the
JAX package): GPS, GPSM and IOU match quality, the greedy per-threshold
matching with crowd reuse and d2's last-threshold bbox-IoU rescue, and the
accumulate / summarize of the UV metric vector.

- GPS (geodesic point similarity): per (dt, gt) pair, the gt's points are
  mapped into the dt box, the predicted IUV is read there, both point sets
  snap to their nearest chart vertices, and gps = mean(exp(-geodist^2 /
  (2 k^2))) with per-part normalizers k;
- GPSM: sqrt(gps * mask IoU), the gt coarse segmentation (``dp_masks``
  zoomed to the gt box) against the predicted foreground on the image;
- IOU: the mask IoU alone.

Inputs are COCO-shaped dict lists; the mesh tables come in as
:class:`GeodesicMeshTables` (``evaluation.load_smpl_mesh_tables`` reads
the DensePose release files). Held to ``tests/projects/data/
densepose_eval_goldens.json`` (d2's evaluation file on a synthetic scenario)
by ``tests/test_torch_densepose_eval.py``.
"""

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DensePoseEvalParams", "DensePoseCocoEvalEngine", "GeodesicMeshTables", "densepose_metric_names"]

logger = logging.getLogger(__name__)


class GeodesicMeshTables:
    """The mesh tables the GPS computation needs (the reference loads these
    from SMPL_subdiv.mat / SMPL_SUBDIV_TRANSFORM.mat / Pdist_matrix.pkl in
    _loadGEval:255-285):

    - part_uvs: 24 arrays [2, N_i] — the (U, V) of every mesh vertex
      belonging to chart part i+1;
    - part_vert_inds: 24 arrays [N_i] — their 1-based raw vertex ids;
    - pdist_transform: [V] int — raw vertex id (1-based, indexed -1) ->
      1-based reduced vertex id into the condensed geodesic matrix;
    - part_ids: [V] int — raw vertex id (indexed -1) -> chart part 1..24;
    - mean_distances [9] / coarse_parts [25] — per-coarse-part gps
      normalizers and the fine->coarse map.
    """

    def __init__(
        self,
        part_uvs: Sequence[np.ndarray],
        part_vert_inds: Sequence[np.ndarray],
        pdist_transform: np.ndarray,
        part_ids: np.ndarray,
        pdist_matrix: np.ndarray,
        mean_distances: Optional[np.ndarray] = None,
        coarse_parts: Optional[np.ndarray] = None,
        n_reduced: Optional[int] = None,
    ):
        self.part_uvs = [np.asarray(p, np.float64) for p in part_uvs]
        self.part_vert_inds = [np.asarray(p, np.int64) for p in part_vert_inds]
        self.pdist_transform = np.asarray(pdist_transform, np.int64)
        self.part_ids = np.asarray(part_ids, np.int64)
        self.pdist_matrix = pdist_matrix
        self.mean_distances = (
            np.asarray(mean_distances, np.float64)
            if mean_distances is not None
            else np.array([0, 0.351, 0.107, 0.126, 0.237, 0.173, 0.142, 0.128, 0.150])
        )
        self.coarse_parts = (
            np.asarray(coarse_parts, np.int64)
            if coarse_parts is not None
            else np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8])
        )
        # the reference hardcodes n = 27554 (the SMPL_subdiv vertex count) in
        # its condensed-index arithmetic; synthetic meshes pass their own
        self.n_reduced = 27554 if n_reduced is None else int(n_reduced)

    # -- vertex lookup (reference findAllClosestVertsUV / ...GT:1166-1219)

    def snap_to_chart_verts(self, u_pts, v_pts, i_pts) -> np.ndarray:
        """Nearest mesh vertex per (U, V, chart-label) point: raw 1-based
        vertex ids, -1 where the label is outside 1..24 (background /
        out-of-box). One pass over the 24 charts handles any number of
        points, so callers batch all points of an image into one call."""
        i_pts = np.asarray(i_pts)
        u_pts = np.asarray(u_pts, np.float64)
        v_pts = np.asarray(v_pts, np.float64)
        raw = np.full(i_pts.shape, -1.0)
        for part in range(24):
            sel = i_pts == (part + 1)
            if not sel.any():
                continue
            uvs = np.array([u_pts[sel], v_pts[sel]])  # [2, n]
            table = self.part_uvs[part]  # [2, N]
            d2 = ((table[:, :, None] - uvs[:, None, :]) ** 2).sum(axis=0)  # [N, n]
            raw[sel] = self.part_vert_inds[part][np.argmin(d2, axis=0)]
        return raw

    def reduce_vert_ids(self, raw: np.ndarray) -> np.ndarray:
        """Raw 1-based vertex ids -> 1-based reduced ids into the condensed
        geodesic matrix; 0 where raw is invalid (< 0)."""
        reduced = self.pdist_transform[raw.astype(int) - 1]
        reduced[raw < 0] = 0
        return reduced

    def closest_verts_uv(self, u_pts: np.ndarray, v_pts: np.ndarray, i_pts: np.ndarray) -> np.ndarray:
        """Points -> 1-based reduced vertex ids; 0 where the chart label is
        not in 1..24 (background / out-of-box)."""
        return self.reduce_vert_ids(self.snap_to_chart_verts(u_pts, v_pts, i_pts))

    def closest_verts_gt(self, gt: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """gt dp points -> (raw 1-based vertex ids with -1 for bad labels,
        reduced ids with 0 for bad labels)."""
        raw = self.snap_to_chart_verts(gt["dp_U"], gt["dp_V"], gt["dp_I"])
        return raw, self.reduce_vert_ids(raw)

    # -- geodesic lookup (reference getDistancesUV:1221-1249)

    def distances(self, c_verts_gt_t: np.ndarray, c_verts_dt_t: np.ndarray) -> np.ndarray:
        """Per-point geodesics for the gt points that have a valid vertex;
        inf where the prediction has none (reference getDistancesUV:1221-1249
        defines the semantics; the lookup here is a vectorized condensed-index
        read instead of a per-point python loop)."""
        gt_t = np.asarray(c_verts_gt_t, np.int64)
        dt_t = np.asarray(c_verts_dt_t, np.int64)
        has_gt = gt_t > 0
        return self.geodesic_lookup(gt_t[has_gt] - 1, dt_t[has_gt] - 1)

    def geodesic_lookup(self, va: np.ndarray, vb: np.ndarray) -> np.ndarray:
        """Geodesic distance between 0-based reduced vertex id pairs, reading
        the condensed (upper-triangular, reverse-indexed) distance matrix the
        DensePose release ships: scipy-pdist order over vertices renumbered
        n-1-i. Pairs on the diagonal are 0; pairs where ``vb`` is invalid
        (< 0, i.e. the prediction had no vertex) are inf. Fully vectorized;
        int64 arithmetic is exact where the float formulation relies on
        float64 exactness below 2**53."""
        va = np.asarray(va, np.int64)
        vb = np.asarray(vb, np.int64)
        out = np.full(va.shape, np.inf, np.float64)
        same = (va == vb) & (vb >= 0)
        out[same] = 0.0
        need = (vb >= 0) & ~same
        if need.any():
            n = self.n_reduced
            hi = np.maximum(va[need], vb[need])
            lo = np.minimum(va[need], vb[need])
            # renumber v -> n-1-v, then condensed row-major upper-tri index,
            # then the release's global reversal of that index
            i = n - 1 - hi
            j = n - 1 - lo
            k = n * (n - 1) // 2 - (n - i) * (n - i - 1) // 2 + j - i - 1
            k = (n * n - n) // 2 - k - 1
            pm = self.pdist_matrix
            if isinstance(pm, np.ndarray) and pm.ndim >= 1 and pm.dtype != object:
                flat = pm.reshape(pm.shape[0], -1)[:, 0] if pm.ndim > 1 else pm
                vals = flat[k].astype(np.float64)
            else:
                # virtual / object-array matrices only support scalar access
                vals = np.array(
                    [np.asarray(pm[int(kk)]).reshape(-1)[0] for kk in k], np.float64
                )
            out[need] = vals
        return out

    def norm_coeffs(self, c_verts_gt_raw: np.ndarray) -> np.ndarray:
        """Per-valid-gt-point gps normalizer k (reference
        computeOgps_single_pair_iuv:676-687)."""
        valid = c_verts_gt_raw[c_verts_gt_raw > 0].astype(int)
        return self.mean_distances[self.coarse_parts[self.part_ids[valid - 1]]]


class DensePoseEvalParams:
    """(reference Params.setUvParams:1243-1253)."""

    def __init__(self, iou_thrs: Optional[np.ndarray] = None):
        self.iouThrs = (
            np.asarray(iou_thrs)
            if iou_thrs is not None
            else np.linspace(0.5, 0.95, int(np.round((0.95 - 0.5) / 0.05)) + 1, endpoint=True)
        )
        self.recThrs = np.linspace(0.0, 1.00, int(np.round(1.00 / 0.01)) + 1, endpoint=True)
        self.maxDets = [20]
        self.areaRng = [[0**2, 1e5**2], [32**2, 96**2], [96**2, 1e5**2]]
        self.areaRngLbl = ["all", "medium", "large"]
        self.useCats = 1
        self.imgIds: List[Any] = []
        self.catIds: List[Any] = []


def _bbox_iou_crowd(dboxes: np.ndarray, gboxes: np.ndarray, iscrowd: Sequence[int]) -> np.ndarray:
    """pycocotools bbIou semantics (XYWH, crowd gt -> union = dt area),
    broadcast over the full [D, G] grid."""
    D, G = len(dboxes), len(gboxes)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    d = np.asarray(dboxes, np.float64)[:, None, :]  # [D, 1, 4]
    g = np.asarray(gboxes, np.float64)[None, :, :]  # [1, G, 4]
    iw = np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2]) - np.maximum(d[..., 0], g[..., 0])
    ih = np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3]) - np.maximum(d[..., 1], g[..., 1])
    overlap = (iw > 0) & (ih > 0)
    inter = np.where(overlap, iw * ih, 0.0)
    darea = d[..., 2] * d[..., 3]
    union = np.where(np.asarray(iscrowd, bool)[None, :], darea, darea + g[..., 2] * g[..., 3] - inter)
    safe = np.where(union > 0, union, 1.0)
    return np.where(overlap & (union > 0), inter / safe, 0.0)


def _mask_iou_crowd(dmasks: List[np.ndarray], gmasks: List[np.ndarray], iscrowd: Sequence[int]) -> np.ndarray:
    """pycocotools rleIou semantics on binary canvas masks. The full [D, G]
    intersection grid is one matmul over flattened 0/1 canvases (exact in
    float64: every count is an integer far below 2**53), replacing the
    per-pair logical_and/sum loop."""
    D, G = len(dmasks), len(gmasks)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dflat = np.stack([(np.asarray(m) > 0).reshape(-1) for m in dmasks]).astype(np.float64)
    gflat = np.stack([(np.asarray(m) > 0).reshape(-1) for m in gmasks]).astype(np.float64)
    inter = dflat @ gflat.T  # [D, G]
    darea = dflat.sum(axis=1)[:, None]
    garea = gflat.sum(axis=1)[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :], darea, darea + garea - inter)
    safe = np.where(union > 0, union, 1.0)
    return np.where(union > 0, inter / safe, 0.0)


class DensePoseCocoEvalEngine:
    """The protocol engine. ``gts``/``dts`` are COCO-shaped dicts:

    gt: {id, image_id, category_id, bbox XYWH, area, iscrowd?, ignore?,
         dp_x/dp_y (points, 255-normalized gt-box frame), dp_I/dp_U/dp_V,
         dp_masks? (list of <=14 RLE dicts at 256x256) or segmentation?
         (binary canvas array)}
    dt: {id, image_id, category_id, bbox XYWH, score,
         densepose: [3, int(h), int(w)] uint8-valued IUV stack in the
         int-truncated dt-box frame (labels, U*255, V*255) — the reference's
         quantized results format (extract_iuv_from_quantized:655-661,
         _extract_mask:538-556)}

    ``image_sizes``: image_id -> (height, width). Optional per-image ignore
    regions come as image dicts via ``ignore_regions``: image_id -> binary
    canvas array (the reference rasterizes ignore_regions_x/y polygons;
    rasterization happens outside the engine so gt jsons and synthetic tests
    share one code path).
    """

    def __init__(
        self,
        gts: List[Dict[str, Any]],
        dts: List[Dict[str, Any]],
        image_sizes: Dict[Any, Tuple[int, int]],
        tables: GeodesicMeshTables,
        dp_eval_mode: str = "gps",
        params: Optional[DensePoseEvalParams] = None,
        ignore_regions: Optional[Dict[Any, np.ndarray]] = None,
    ):
        assert dp_eval_mode in ("gps", "gpsm", "iou"), dp_eval_mode
        self.mode = dp_eval_mode
        self.tables = tables
        self.params = params or DensePoseEvalParams()
        self.size_mapping = dict(image_sizes)
        self._ignore_regions = ignore_regions or {}
        self.ignoreThrBB = 0.7
        self.ignoreThrUV = 0.9
        self._input_gts = gts
        self._input_dts = dts
        self.evalImgs: List[Optional[Dict[str, Any]]] = []
        self.eval: Dict[str, Any] = {}
        self.stats = np.zeros(0)
        if not self.params.imgIds:
            self.params.imgIds = sorted({g["image_id"] for g in gts})
        if not self.params.catIds:
            self.params.catIds = sorted({g["category_id"] for g in gts})

    # ------------------------------------------------------------- prepare

    def _check_ignore(self, ann: Dict[str, Any], iregion: Optional[np.ndarray], is_dt: bool) -> bool:
        """(reference _prepare._checkIgnore:318-345)."""
        if iregion is None:
            return True
        bb = np.array(ann["bbox"]).astype(int)
        x1, y1 = bb[0], bb[1]
        x2 = min(bb[0] + bb[2], iregion.shape[1])
        y2 = min(bb[1] + bb[3], iregion.shape[0])
        if bb[2] * bb[3] == 0:
            return False
        crop = iregion[y1:y2, x1:x2]
        if crop.sum() == 0:
            return True
        if not (is_dt and "densepose" in ann):
            return crop.sum() / bb[2] / bb[3] < self.ignoreThrBB
        uvmask = np.asarray(self._extract_mask(ann) > 0, np.uint8)
        # pad/crop the label mask to the crop window, IoU against the region
        h, w = crop.shape
        m = np.zeros_like(crop, dtype=np.uint8)
        m[: min(h, uvmask.shape[0]), : min(w, uvmask.shape[1])] = uvmask[
            : min(h, uvmask.shape[0]), : min(w, uvmask.shape[1])
        ]
        inter = int(np.logical_and(m, crop).sum())
        union = int(m.sum())  # crowd semantics vs the region
        uviou = inter / union if union > 0 else 0.0
        return uviou < self.ignoreThrUV

    def _prepare(self):
        p = self.params
        gts = [g for g in self._input_gts if g["image_id"] in set(p.imgIds)]
        dts = [d for d in self._input_dts if d["image_id"] in set(p.imgIds)]
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0)
            gt["ignore"] = 1 if gt.get("iscrowd", 0) else gt["ignore"]
            gt["ignore"] = ("dp_x" in gt) == 0  # densepose rule (overrides)
        from collections import defaultdict

        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            ireg = self._ignore_regions.get(gt["image_id"])
            if self._check_ignore(gt, ireg, is_dt=False):
                self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            ireg = self._ignore_regions.get(dt["image_id"])
            if (dt["image_id"] not in self._ignore_regions) or self._check_ignore(dt, ireg, is_dt=True):
                self._dts[dt["image_id"], dt["category_id"]].append(dt)

    # -------------------------------------------------------------- masks

    @staticmethod
    def get_densepose_mask(polys: Sequence[Optional[Dict[str, Any]]]) -> np.ndarray:
        """dp_masks (<=14 per-part RLEs at 256x256) -> labeled 256x256 mask
        (reference getDensePoseMask:353-360)."""
        from detectron2_tpu_torch.evaluation.rle import rle_to_mask

        mask_gen = np.zeros([256, 256])
        stop = min(len(polys) + 1, 15)
        for i in range(1, stop):
            if polys[i - 1]:
                mask_gen[rle_to_mask(polys[i - 1]) > 0] = i
        return mask_gen

    def _extract_mask(self, dt: Dict[str, Any]) -> np.ndarray:
        """Foreground label mask in the dt-box frame
        (reference _extract_mask:538-556, quantized branch)."""
        return np.asarray(dt["densepose"])[0]

    def _rlemask_on_image(self, mask: Optional[np.ndarray], img_id, ann: Dict[str, Any]) -> np.ndarray:
        """Paste a box-frame mask onto the image canvas
        (reference _generate_rlemask_on_image:362-377)."""
        x, y, w, h = np.array(ann["bbox"])
        im_h, im_w = self.size_mapping[img_id]
        im_mask = np.zeros((im_h, im_w), dtype=np.uint8)
        if mask is not None:
            x0 = max(int(x), 0)
            x1 = min(int(x + w), im_w, int(x) + mask.shape[1])
            y0 = max(int(y), 0)
            y1 = min(int(y + h), im_h, int(y) + mask.shape[0])
            y = int(y)
            x = int(x)
            im_mask[y0:y1, x0:x1] = mask[y0 - y : y1 - y, x0 - x : x1 - x]
        return im_mask

    def compute_dp_iou(self, img_id, cat_id) -> np.ndarray:
        """Mask IoU matrix [D, G] (reference computeDPIoU:379-436)."""
        from scipy.ndimage import zoom as spzoom

        p = self.params
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 and len(dt) == 0:
            return np.zeros((0, 0))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds]
        if len(dt) > p.maxDets[-1]:
            dt = dt[0 : p.maxDets[-1]]

        gtmasks = []
        for g in gt:
            if "dp_masks" in g:
                mask = np.minimum(self.get_densepose_mask(g["dp_masks"]), 1.0)
                _, _, w, h = g["bbox"]
                scale_x = float(max(w, 1)) / mask.shape[1]
                scale_y = float(max(h, 1)) / mask.shape[0]
                mask = spzoom(mask, (scale_y, scale_x), order=1, prefilter=False)
                mask = np.array(mask > 0.5, dtype=np.uint8)
                gtmasks.append(self._rlemask_on_image(mask, img_id, g))
            elif "segmentation" in g and isinstance(g["segmentation"], np.ndarray):
                gtmasks.append(np.asarray(g["segmentation"], np.uint8))
            else:
                gtmasks.append(self._rlemask_on_image(None, img_id, g))

        dtmasks = []
        for d in dt:
            mask = np.asarray(self._extract_mask(d) > 0, np.uint8)
            dtmasks.append(self._rlemask_on_image(mask, img_id, d))

        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        return _mask_iou_crowd(dtmasks, gtmasks, iscrowd)

    # ---------------------------------------------------------------- gps

    def _gt_point_tables(self, gts: List[Dict[str, Any]]):
        """Hoist every detection-independent GPS quantity out of the (dt, gt)
        pair grid, computed ONCE per ground truth. The protocol this
        implements is the reference's computeOgps (721-778), but restructured:
        the reference re-snaps the gt points to mesh vertices inside the pair
        loop (O(D*G) nearest-vertex searches); the gt side doesn't depend on
        the detection, so here it is O(G).

        Returns None when no gt contributes points, else a dict of per-point
        arrays concatenated across the non-ignored gts (ignored gts keep a
        zero GPS column and contribute no points):

        - ``ax``/``ay``: absolute image coords of the annotated points (the
          255-normalized gt-box-frame dp_x/dp_y scaled by the gt box);
        - ``gt_col``: owning gt column per point;
        - ``vert_reduced``: 1-based reduced mesh vertex per point (0 invalid);
        - ``seg``: [G+1] point-range boundaries per gt column;
        - ``kappa``/``kappa_seg``: per-valid-point gps normalizers and their
          own per-gt boundaries (valid = the raw vertex snap succeeded).
        """
        ax, ay, gt_col, vert_reduced = [], [], [], []
        kappas = []
        seg = np.zeros(len(gts) + 1, np.int64)
        kappa_seg = np.zeros(len(gts) + 1, np.int64)
        for j, gt in enumerate(gts):
            seg[j + 1] = seg[j]
            kappa_seg[j + 1] = kappa_seg[j]
            if gt["ignore"]:
                continue
            gx, gy, gw, gh = gt["bbox"]
            px = np.array(gt["dp_x"]) * gw / 255.0 + gx
            py = np.array(gt["dp_y"]) * gh / 255.0 + gy
            raw, reduced = self.tables.closest_verts_gt(gt)
            ax.append(px)
            ay.append(py)
            gt_col.append(np.full(len(px), j, np.int64))
            vert_reduced.append(reduced)
            kappas.append(self.tables.norm_coeffs(raw))
            seg[j + 1] += len(px)
            kappa_seg[j + 1] += len(kappas[-1])
        if not ax:
            return None
        return {
            "ax": np.concatenate(ax),
            "ay": np.concatenate(ay),
            "gt_col": np.concatenate(gt_col),
            "vert_reduced": np.concatenate(vert_reduced),
            "seg": seg,
            "kappa": np.concatenate(kappas),
            "kappa_seg": kappa_seg,
        }

    def compute_ogps(self, img_id, cat_id) -> Tuple[np.ndarray, np.ndarray]:
        """GPS matrix [D, G] + bbox IoU matrix.

        Protocol (defined by reference computeOgps:721-778 + the quantized
        IUV extraction at 619-687, pinned by the oracle goldens): each gt's
        annotated points are mapped into the detection's int-truncated box
        frame; points landing outside contribute zero similarity, points
        inside read the predicted chart label + U/V there; both point sets
        snap to their nearest chart vertices and
        gps = mean(exp(-geodesic^2 / (2 kappa^2))) over the gt points whose
        own vertex snap succeeded (a prediction-side miss gives geodesic=inf,
        i.e. a zero term, NOT a dropped term).

        Implementation is a redesign of that protocol around one flat point
        table per image: per detection, a single gather reads the IUV of all
        gts' points at once, one chart-table pass snaps them, one vectorized
        condensed-matrix lookup gets the geodesics, and per-gt means come off
        contiguous segments — O(D+G) chart searches instead of the
        reference's O(D*G), no per-pair python work."""
        p = self.params
        g = self._gts[img_id, cat_id]
        d = self._dts[img_id, cat_id]
        inds = np.argsort([-d_["score"] for d_ in d], kind="mergesort")
        d = [d[i] for i in inds]
        if len(d) > p.maxDets[-1]:
            d = d[0 : p.maxDets[-1]]
        if len(g) == 0 or len(d) == 0:
            return np.zeros((0, 0)), np.zeros((0, 0))
        ious = np.zeros((len(d), len(g)))
        pts = self._gt_point_tables(g)
        if pts is not None:
            gt_has_vert = pts["vert_reduced"] > 0
            for i, dt in enumerate(d):
                dtx, dty, dtw, dth = dt["bbox"]
                # int truncation (not floor) of box-frame coords, then the
                # in-box test on the truncated values: the -0.x band snaps
                # to column 0 and counts as inside, matching the pinned
                # reference arithmetic
                px = (pts["ax"] - dtx).astype(int)
                py = (pts["ay"] - dty).astype(int)
                inside = (px >= 0) & (py >= 0) & (px < int(dtw)) & (py < int(dth))
                if not inside.any():
                    continue  # all-outside for every gt: the row stays 0
                iuv = np.asarray(dt["densepose"])
                rd_x = np.where(inside, px, 0)
                rd_y = np.where(inside, py, 0)
                labels = np.where(inside, iuv[0, rd_y, rd_x].astype(np.float64), 0)
                u = iuv[1, rd_y, rd_x] / 255.0
                v = iuv[2, rd_y, rd_x] / 255.0
                dt_vert = self.tables.closest_verts_uv(u, v, labels)
                # geodesics only for gt-valid points; kappa is per-valid-point
                geo = self.tables.geodesic_lookup(
                    pts["vert_reduced"][gt_has_vert] - 1, dt_vert[gt_has_vert] - 1
                )
                with np.errstate(over="ignore"):
                    sim = np.exp(-(geo**2) / (2 * (pts["kappa"] ** 2)))
                for j in range(len(g)):
                    lo, hi = pts["kappa_seg"][j], pts["kappa_seg"][j + 1]
                    n_pts = pts["seg"][j + 1] - pts["seg"][j]
                    if n_pts == 0:
                        continue  # ignored or point-less gt: column stays 0
                    ious[i, j] = np.mean(sim[lo:hi]) if hi > lo else 0.0

        gbb = np.array([gt["bbox"] for gt in g], np.float64)
        dbb = np.array([dt["bbox"] for dt in d], np.float64)
        iscrowd = [int(o.get("iscrowd", 0)) for o in g]
        ious_bb = _bbox_iou_crowd(dbb, gbb, iscrowd)
        return ious, ious_bb

    # ------------------------------------------------------------ evaluate

    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self._prepare()
        cat_ids = p.catIds if p.useCats else [-1]

        if self.mode in ("gpsm", "iou"):
            self.real_ious = {
                (img_id, cat_id): self.compute_dp_iou(img_id, cat_id)
                for img_id in p.imgIds
                for cat_id in cat_ids
            }
        self.ious = {
            (img_id, cat_id): self.compute_ogps(img_id, cat_id)
            for img_id in p.imgIds
            for cat_id in cat_ids
        }

        self.evalImgs = [
            self.evaluate_img(img_id, cat_id, area_rng, p.maxDets[-1])
            for cat_id in cat_ids
            for area_rng in p.areaRng
            for img_id in p.imgIds
        ]
        import copy

        self._paramsEval = copy.deepcopy(self.params)

    @staticmethod
    def _pick_candidate(row: np.ndarray, eligible: np.ndarray) -> int:
        """Index of the best eligible gt for one detection: maximum
        similarity, ties resolved to the LATER gt (the protocol's greedy scan
        updates on >=, so among equals the last one scanned wins). -1 when
        nothing is eligible."""
        cand = np.flatnonzero(eligible)
        if cand.size == 0:
            return -1
        vals = row[cand]
        # last argmax: first max of the reversed slice
        return int(cand[cand.size - 1 - vals[::-1].argmax()])

    def _greedy_match(self, sim, thresholds, gt_ignored, iscrowd, gt_ids, dt_ids):
        """COCO-protocol greedy assignment: detections (already in score
        order) each claim the best still-available gt at every threshold.
        This is the metric's *definition* (pycocotools COCOeval.evaluateImg;
        the DensePose reference inherits it at evaluateImg:781-925) — the
        same protocol as our COCO engine (evaluation/coco_eval_np.py), so the
        semantics here must track that file, not diverge per-project:

        - a matched non-crowd gt leaves the pool; crowd gts can absorb any
          number of detections;
        - gts arrive sorted non-ignored-first, and a detection considers
          ignored gts only when NO non-ignored gt clears the threshold;
        - similarity must be >= threshold and nonzero; equal scores resolve
          to the later gt.

        Returns (gt_match_ids [T,G], dt_match_ids [T,D], dt_ignored [T,D]).
        dt_ignored starts all-True when every gt is ignored (the protocol's
        all-ignored-image rule) — matches can only re-write True there.
        """
        T, G, D = len(thresholds), len(gt_ids), len(dt_ids)
        gt_match = np.zeros((T, G))
        dt_match = np.zeros((T, D))
        dt_ignored = np.zeros((T, D), dtype=bool)
        if G == 0 or gt_ignored.all():
            dt_ignored[:] = True
        if sim.size == 0:
            return gt_match, dt_match, dt_ignored
        n_real = int(np.count_nonzero(~gt_ignored))  # sorted: reals first
        crowd = np.asarray(iscrowd, bool)
        for ti, t in enumerate(thresholds):
            floor = min(t, 1 - 1e-10)
            for di in range(D):
                row = sim[di]
                eligible = ((gt_match[ti] == 0) | crowd) & (row >= floor) & (row > 0)
                g = self._pick_candidate(row, eligible & ~gt_ignored)
                if g < 0:
                    g = self._pick_candidate(row, eligible)  # ignored pool
                if g < 0:
                    continue
                dt_ignored[ti, di] = gt_ignored[g]
                dt_match[ti, di] = gt_ids[g]
                gt_match[ti, g] = dt_ids[di]
        return gt_match, dt_match, dt_ignored

    def _bbox_rescue(self, bbox_iou, gt_ignored, iscrowd, gt_ids, dt_ids,
                     gt_match, dt_match, dt_ignored):
        """DensePose-specific second pass (the protocol of reference
        evaluateImg's trailing loop, pinned by the oracle goldens including
        its quirks): a detection left unmatched at the LAST threshold but
        sitting on a gt with bbox IoU >= 0.8 inherits that gt's ignore flag
        across ALL thresholds — parking detections whose box is right on an
        ignored/crowd person so they don't count as false positives; the
        match itself is recorded only when that gt IS ignored, and only at
        the last threshold row."""
        last = gt_match.shape[0] - 1
        crowd = np.asarray(iscrowd, bool)
        for di in range(len(dt_ids)):
            if dt_match[last, di] != 0:
                continue
            row = bbox_iou[di]
            eligible = ((gt_match[last] == 0) | crowd) & (row >= 0.8)
            g = self._pick_candidate(row, eligible)
            if g < 0:
                continue
            dt_ignored[:, di] = gt_ignored[g]
            if gt_ignored[g]:
                dt_match[last, di] = gt_ids[g]
                gt_match[last, g] = dt_ids[di]

    def evaluate_img(self, img_id, cat_id, a_rng, max_det) -> Optional[Dict[str, Any]]:
        """Per-(image, category, area-range) matching record for accumulate.

        Structure: sort gts ignored-last and dts by score, build the ONE
        effective similarity matrix for the configured mode (gps / gpsm =
        sqrt(gps * mask-IoU) / iou = mask-IoU), run the protocol's greedy
        threshold matching, then the DensePose bbox-IoU rescue pass, then the
        area-range ignore rule for unmatched detections."""
        p = self.params
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 and len(dt) == 0:
            return None

        for g in gt:
            g["_ignore"] = bool(g["ignore"]) or not (a_rng[0] <= g["area"] <= a_rng[1])

        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[0:max_det]]
        iscrowd = [int(o.get("iscrowd", 0)) for o in gt]
        gtIg = np.array([g["_ignore"] for g in gt])
        gt_ids = np.array([g["id"] for g in gt])
        dt_ids = np.array([d["id"] for d in dt])

        gps, bbox_iou = self.ious[img_id, cat_id]
        gps = gps[:, gtind] if gps.size else gps
        bbox_iou = bbox_iou[:, gtind] if bbox_iou.size else bbox_iou
        if self.mode == "gps":
            sim = gps
        else:
            mask_iou = self.real_ious[img_id, cat_id]
            mask_iou = mask_iou[:, gtind] if mask_iou.size else mask_iou
            sim = np.sqrt(mask_iou * gps) if self.mode == "gpsm" else mask_iou

        # the protocol skips matching entirely (but NOT the rescue pass) when
        # the gps matrix has no rows — sim may still be empty for gpsm/iou
        if len(gps) == 0:
            sim = np.zeros((0, 0))
        gtm, dtm, dtIg = self._greedy_match(
            sim, p.iouThrs, gtIg, iscrowd, gt_ids, dt_ids
        )
        if len(bbox_iou) > 0:
            self._bbox_rescue(bbox_iou, gtIg, iscrowd, gt_ids, dt_ids, gtm, dtm, dtIg)

        # unmatched detections outside the area range are ignored
        out_of_range = np.array(
            [d["area"] < a_rng[0] or d["area"] > a_rng[1] for d in dt]
        ).reshape(1, len(dt))
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, out_of_range))
        return {
            "image_id": img_id,
            "category_id": cat_id,
            "aRng": a_rng,
            "maxDet": max_det,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # ---------------------------------------------------------- accumulate

    def accumulate(self):
        """(reference accumulate:926-1029)."""
        p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        _pe = self._paramsEval
        cat_ids = _pe.catIds if _pe.useCats else [-1]
        set_k = set(cat_ids)
        set_a = set(map(tuple, _pe.areaRng))
        set_m = set(_pe.maxDets)
        set_i = set(_pe.imgIds)
        k_list = [n for n, k in enumerate(p.catIds) if k in set_k]
        m_list = [m for n, m in enumerate(p.maxDets) if m in set_m]
        a_list = [n for n, a in enumerate(map(tuple, p.areaRng)) if a in set_a]
        i_list = [n for n, i in enumerate(p.imgIds) if i in set_i]
        I0 = len(_pe.imgIds)
        A0 = len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, max_det in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dt_scores = np.concatenate([e["dtScores"][0:max_det] for e in E])
                    inds = np.argsort(-dt_scores, kind="mergesort")
                    dtm = np.concatenate([e["dtMatches"][:, 0:max_det] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate([e["dtIgnore"][:, 0:max_det] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds2 = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds2):
                                q[ri] = pr[pi]
                        except Exception:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
        }

    # ----------------------------------------------------------- summarize

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=20) -> float:
        p = self.params
        aind = [i for i, lbl in enumerate(p.areaRngLbl) if lbl == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.abs(iouThr - p.iouThrs) < 0.001)[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.abs(iouThr - p.iouThrs) < 0.001)[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self):
        """The UV metric vector (reference _summarizeUvs:1106-1127): AP,
        AP{20,30,40 when thresholds reach that low}, AP50, AP75, APm, APl,
        AR, AR50, AR75, ARm, ARl."""
        max_det = self.params.maxDets[0]
        stats = [self._summarize(1, maxDets=max_det)]
        min_threshold = self.params.iouThrs.min()
        if min_threshold <= 0.201:
            stats += [self._summarize(1, maxDets=max_det, iouThr=0.2)]
        if min_threshold <= 0.301:
            stats += [self._summarize(1, maxDets=max_det, iouThr=0.3)]
        if min_threshold <= 0.401:
            stats += [self._summarize(1, maxDets=max_det, iouThr=0.4)]
        stats += [
            self._summarize(1, maxDets=max_det, iouThr=0.5),
            self._summarize(1, maxDets=max_det, iouThr=0.75),
            self._summarize(1, maxDets=max_det, areaRng="medium"),
            self._summarize(1, maxDets=max_det, areaRng="large"),
            self._summarize(0, maxDets=max_det),
            self._summarize(0, maxDets=max_det, iouThr=0.5),
            self._summarize(0, maxDets=max_det, iouThr=0.75),
            self._summarize(0, maxDets=max_det, areaRng="medium"),
            self._summarize(0, maxDets=max_det, areaRng="large"),
        ]
        self.stats = np.array(stats)
        return self.stats


def densepose_metric_names(min_threshold: float = 0.5) -> List[str]:
    """(reference evaluator.py _get_densepose_metrics)."""
    metrics = ["AP"]
    if min_threshold <= 0.201:
        metrics += ["AP20"]
    if min_threshold <= 0.301:
        metrics += ["AP30"]
    if min_threshold <= 0.401:
        metrics += ["AP40"]
    metrics += ["AP50", "AP75", "APm", "APl", "AR", "AR50", "AR75", "ARm", "ARl"]
    return metrics
