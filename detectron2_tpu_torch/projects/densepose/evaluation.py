"""DensePose evaluation (counterpart of
``detectron2_tpu/projects/densepose/evaluation.py``): the
``DensePoseCOCOEvaluator`` (GPS, GPSM and IOU through
:mod:`.dp_coco_eval`), the SMPL release-file loaders and the CSE
``MeshAlignmentEvaluator``.

The evaluator follows d2 where the JAX one cannot score a model in the
trainer (ROADMAP C, correction 16): it reads the ground truth from the
dataset (``DatasetCatalog.get``: each annotation's ``bbox`` and ``dp_*``,
each record's size), takes the image id from the inputs, and turns the
model's detections into result dicts: ``pred_boxes`` as XYWH, ``scores``,
``pred_classes`` and ``pred_densepose`` quantized in the box frame
(:meth:`DensePoseCOCOEvaluator._to_quantized`). Category ids are the
contiguous ones on both sides.

The SMPL files (``SMPL_subdiv.mat``, ``SMPL_SUBDIV_TRANSFORM.mat``,
``Pdist_matrix.pkl``) are downloads in d2; here they are read from
``$DETECTRON2_DATASETS/densepose_eval_data``
(``testing.write_synthetic_densepose_eval_data`` writes files of their
layout).
"""

import itertools
import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator
from detectron2_tpu_torch.projects.densepose.dp_coco_eval import (
    DensePoseCocoEvalEngine,
    DensePoseEvalParams,
    GeodesicMeshTables,
    densepose_metric_names,
)
from detectron2_tpu_torch.projects.densepose.tensor_storage import BlobRef, LazyBlob

__all__ = [
    "DensePoseCOCOEvaluator",
    "MeshAlignmentEvaluator",
    "load_smpl_mesh_tables",
    "smpl_data_dir",
]

logger = logging.getLogger(__name__)


def smpl_data_dir() -> str:
    return os.path.join(os.environ.get("DETECTRON2_DATASETS", "datasets"), "densepose_eval_data")


def _require_smpl_files(data_dir: str) -> None:
    if not os.path.exists(os.path.join(data_dir, "SMPL_subdiv.mat")):
        raise FileNotFoundError(
            f"DensePose SMPL evaluation data not found in {data_dir}: put SMPL_subdiv.mat, Pdist_matrix.pkl and "
            "SMPL_SUBDIV_TRANSFORM.mat of the DensePose data release there"
        )


_TABLES_CACHE: Dict[tuple, GeodesicMeshTables] = {}


def load_smpl_mesh_tables(data_dir: Optional[str] = None) -> GeodesicMeshTables:
    """The engine's :class:`GeodesicMeshTables` from the SMPL release files,
    as d2's ``_loadGEval`` reads them: per-part UV tables and 1-based vertex
    ids grouped by ``Part_ID_subdiv``, the raw -> reduced index of
    ``SMPL_SUBDIV_TRANSFORM.mat`` and the condensed geodesic matrix (1.5
    GB). Read once a process for the files as they are (each evaluation
    during training builds its evaluator anew)."""
    data_dir = data_dir or smpl_data_dir()
    _require_smpl_files(data_dir)
    names = ("SMPL_subdiv.mat", "SMPL_SUBDIV_TRANSFORM.mat", "Pdist_matrix.pkl")
    key = (os.path.abspath(data_dir),) + tuple(os.stat(os.path.join(data_dir, n)).st_mtime_ns for n in names)
    if key not in _TABLES_CACHE:
        _TABLES_CACHE.clear()
        _TABLES_CACHE[key] = _read_smpl_mesh_tables(data_dir)
    return _TABLES_CACHE[key]


def _read_smpl_mesh_tables(data_dir: str) -> GeodesicMeshTables:
    import pickle

    import scipy.io as sio

    smpl_subdiv = sio.loadmat(f"{data_dir}/SMPL_subdiv.mat")
    part_id = smpl_subdiv["Part_ID_subdiv"].squeeze()
    uv = np.array([smpl_subdiv["U_subdiv"], smpl_subdiv["V_subdiv"]]).squeeze()
    vert_inds = np.arange(uv.shape[1]) + 1
    part_uvs = [uv[:, part_id == (i + 1)] for i in range(24)]
    part_vert_inds = [vert_inds[part_id == (i + 1)] for i in range(24)]
    pdist_transform = sio.loadmat(f"{data_dir}/SMPL_SUBDIV_TRANSFORM.mat")["index"].squeeze()
    with open(f"{data_dir}/Pdist_matrix.pkl", "rb") as f:
        pdist_matrix = pickle.load(f, encoding="latin1")["Pdist_matrix"]
    return GeodesicMeshTables(
        part_uvs=part_uvs, part_vert_inds=part_vert_inds, pdist_transform=pdist_transform, part_ids=part_id,
        pdist_matrix=pdist_matrix,
    )


def _xywh(box, mode) -> List[float]:
    from detectron2_tpu_torch.structures import BoxMode

    return [float(v) for v in BoxMode.convert(list(box), mode, BoxMode.XYWH_ABS)]


class DensePoseCOCOEvaluator(DatasetEvaluator):
    """d2's DensePose evaluation: the DensePose COCOeval protocol in the GPS,
    GPSM and IOU modes (``mode`` "all" runs the three), each reported as the
    UV metric vector in ``densepose_gps`` / ``densepose_gpsm`` /
    ``densepose_segm``, in percent.

    Ground truth: the dataset's records (``DatasetCatalog.get``), or what
    :meth:`set_ground_truth` gives. Predictions: :meth:`process` takes the
    evaluation loop's batch and the model's padded detections;
    :meth:`add_predictions` takes one image's result dicts (``bbox`` XYWH,
    ``score``, ``densepose`` as a quantized ``[3, h, w]`` stack or an ``[M,
    M, 3]`` (part, U, V) grid). With a spool (``storage``, from
    ``build_densepose_evaluator_storage``) the stacks are kept there."""

    def __init__(
        self,
        dataset_name: str,
        tables: GeodesicMeshTables,
        mode: str = "all",
        min_iou_threshold: float = 0.5,
        max_dets: int = 20,
        storage=None,
    ):
        assert isinstance(tables, GeodesicMeshTables), type(tables)
        assert mode in ("gps", "gpsm", "iou", "all"), mode
        self._dataset_name = dataset_name
        self._metadata = MetadataCatalog.get(dataset_name)
        self._tables = tables
        self._mode = mode
        self._min_thr = float(min_iou_threshold)
        self._max_dets = int(max_dets)
        self._storage = storage
        self._predictions: List[Dict] = []
        self._gts: Optional[Dict[int, List[Dict]]] = None
        self._image_sizes: Dict[int, tuple] = {}
        self._ignore_regions: Dict[int, np.ndarray] = {}

    def reset(self):
        self._predictions = []

    def set_ground_truth(self, gts_by_image, image_sizes=None, ignore_regions=None) -> None:
        """image_id -> list of annotation dicts (``bbox`` XYWH, ``dp_x`` /
        ``dp_y`` / ``dp_I`` / ``dp_U`` / ``dp_V``, ``dp_masks``) in place of
        the dataset's; ``image_sizes`` image_id -> (height, width);
        ``ignore_regions`` image_id -> binary mask."""
        self._gts = gts_by_image
        if image_sizes:
            self._image_sizes.update(image_sizes)
        self._ignore_regions = dict(ignore_regions or {})

    def _load_ground_truth(self) -> None:
        """The dataset's records as the engine's gt dicts (correction 16):
        every annotation with its bbox in XYWH, its contiguous category and
        its ``dp_*`` keys; the records' sizes."""
        gts: Dict[int, List[Dict]] = {}
        # a loader that keeps raw category ids (DensePose-LVIS): the ids the
        # trainer's dataset reading gave the model (``thing_dataset_id_to_
        # contiguous_id``), the other categories left out
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id") if self._metadata.get("categories") else None
        for rec in DatasetCatalog.get(self._dataset_name):
            img_id = rec["image_id"]
            self._image_sizes[img_id] = (rec["height"], rec["width"])
            anns = []
            for ann in rec.get("annotations", []):
                if id_map is not None and ann["category_id"] not in id_map:
                    continue
                g = {k: v for k, v in ann.items() if k.startswith("dp_") or k in ("iscrowd", "category_id")}
                if id_map is not None:
                    g["category_id"] = id_map[ann["category_id"]]
                g["bbox"] = _xywh(ann["bbox"], ann["bbox_mode"])
                anns.append(g)
            gts[img_id] = anns
        self._gts = gts

    def process(self, inputs, outputs):
        """``inputs``: the batch (with "metadata" and "image_sizes");
        ``outputs``: the model's padded detections with
        ``pred_densepose``."""
        import torch

        from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

        metadata = inputs["metadata"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        for i, meta in enumerate(metadata):
            h, w = meta.get("height", image_sizes[i][0]), meta.get("width", image_sizes[i][1])
            inst = detector_postprocess({k: v[i] for k, v in outputs.items() if torch.is_tensor(v)}, h, w, *image_sizes[i])
            boxes = inst.pred_boxes.tensor.cpu().numpy().astype(np.float64)
            scores = inst.scores.cpu().numpy()
            classes = inst.pred_classes.cpu().numpy()
            dps = inst.pred_densepose.cpu().numpy()
            dets = [
                {"bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "score": float(s), "category_id": int(c), "densepose": dp}
                for b, s, c, dp in zip(boxes.tolist(), scores, classes, dps)
            ]
            self.add_predictions(meta["image_id"], dets, h, w)

    def add_predictions(self, image_id, instances: List[Dict], height=None, width=None) -> None:
        """One image's result dicts (see the class docstring)."""
        self._predictions.append(
            {"image_id": image_id,
             "instances": [{**d, "densepose": self._spooled(self._to_quantized(d))} for d in instances]}
        )
        if height is not None and width is not None:
            self._image_sizes[image_id] = (height, width)

    def _spooled(self, arr: np.ndarray):
        return arr if self._storage is None else self._storage.put(arr)

    @staticmethod
    def _to_quantized(dt: Dict) -> np.ndarray:
        """A prediction's densepose as the quantized ``[3, h, w]`` uint8
        stack in its int-truncated box frame: an ``[M, M, 3]`` (part, U, V)
        grid is zoomed to the box (nearest for the part, bilinear for U and
        V), U and V scaled to 0..255."""
        dp = dt["densepose"]
        if hasattr(dp, "labels_uv_uint8"):
            return np.asarray(dp.labels_uv_uint8)
        dp = np.asarray(dp)
        if dp.ndim == 3 and dp.shape[0] == 3:
            return dp.astype(np.uint8)
        assert dp.ndim == 3 and dp.shape[2] == 3, dp.shape
        from scipy.ndimage import zoom as spzoom

        h = max(int(dt["bbox"][3]), 1)
        w = max(int(dt["bbox"][2]), 1)
        zy, zx = h / dp.shape[0], w / dp.shape[1]
        labels = spzoom(dp[..., 0], (zy, zx), order=0, prefilter=False)
        u = spzoom(dp[..., 1], (zy, zx), order=1, prefilter=False)
        v = spzoom(dp[..., 2], (zy, zx), order=1, prefilter=False)
        return np.stack(
            [labels.astype(np.uint8), (np.clip(u, 0.0, 1.0) * 255).astype(np.uint8),
             (np.clip(v, 0.0, 1.0) * 255).astype(np.uint8)]
        )

    def _assemble(self):
        """The gts and predictions as the engine's COCO-shaped lists, with
        ids, image ids, categories (1 where absent) and areas (the box's
        where absent); image sizes grown to cover every box."""
        gts, dts = [], []
        image_sizes = dict(self._image_sizes)
        for img_id, recs in self._gts.items():
            for r in recs:
                g = dict(r)
                g.setdefault("id", len(gts) + 1)
                g.setdefault("image_id", img_id)
                g.setdefault("category_id", 1)
                g.setdefault("area", g["bbox"][2] * g["bbox"][3])
                gts.append(g)
        for out in self._predictions:
            for d in out["instances"]:
                d = dict(d)
                d.setdefault("id", len(dts) + 1)
                d.setdefault("image_id", out["image_id"])
                d.setdefault("category_id", 1)
                d.setdefault("area", d["bbox"][2] * d["bbox"][3])
                dts.append(d)
        for ann in itertools.chain(gts, dts):
            img_id = ann["image_id"]
            x, y, w, h = ann["bbox"]
            need = (int(np.ceil(y + h)) + 1, int(np.ceil(x + w)) + 1)
            cur = image_sizes.get(img_id, need)
            image_sizes[img_id] = (max(cur[0], need[0]), max(cur[1], need[1]))
        return gts, dts, image_sizes

    def evaluate(self):
        if self._gts is None:
            self._load_ground_truth()
        if self._storage is not None:
            self._storage.finalize_for_read()
        gts, dts, image_sizes = self._assemble()
        if self._storage is not None:
            for d in dts:
                if isinstance(d.get("densepose"), BlobRef):
                    d["densepose"] = LazyBlob(self._storage, d["densepose"])
        if not gts:
            return OrderedDict({"densepose_gps": {"AP": float("nan")}})
        n = int(np.round((0.95 - self._min_thr) / 0.05)) + 1
        modes = ("gps", "gpsm", "iou") if self._mode == "all" else (self._mode,)
        section = {"gps": "densepose_gps", "gpsm": "densepose_gpsm", "iou": "densepose_segm"}
        names = densepose_metric_names(self._min_thr)
        results: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
        for mode in modes:
            params = DensePoseEvalParams(iou_thrs=np.linspace(self._min_thr, 0.95, n, endpoint=True))
            params.maxDets = [self._max_dets]
            engine = DensePoseCocoEvalEngine(
                gts=[dict(g) for g in gts], dts=dts, image_sizes=image_sizes, tables=self._tables,
                dp_eval_mode=mode, params=params, ignore_regions=self._ignore_regions or None,
            )
            engine.evaluate()
            engine.accumulate()
            stats = engine.summarize()
            results[section[mode]] = {name: float(v) * 100.0 for name, v in zip(names, stats)}
        logger.info(results)
        return results


class MeshAlignmentEvaluator:
    """Mesh alignment of CSE vertex embeddings (d2's
    ``mesh_alignment_evaluator.py``): for each ordered mesh pair, each named
    key vertex of the first mesh is matched to its most similar vertex on
    the second (inner product of the embeddings); the geodesic on the second
    mesh between the match and its key vertex of that name gives GE, and
    exp(-d^2 / (2 * 0.255^2)) GPS; means per mesh, then over meshes.

    ``embedder``: mesh name -> ``[V, D]`` embeddings. ``mesh_keyvertices``:
    mesh name -> {key vertex name: vertex id}, by default d2's
    ``mesh_keyvertices_v0.json`` under ``$DETECTRON2_DATASETS/
    densepose_meshes``. ``mesh_loader``: mesh name -> an object with
    ``geodists`` (``meshes.create_mesh`` by default). Neither package wires
    it to ``EVALUATE_MESH_ALIGNMENT`` (ROADMAP C)."""

    GPS_NORM = 0.255

    def __init__(self, embedder, mesh_names=None, mesh_keyvertices=None, mesh_loader=None):
        self.embedder = embedder
        self.mesh_names = mesh_names if mesh_names else embedder.mesh_names
        if mesh_keyvertices is None:
            import json

            path = os.path.join(
                os.environ.get("DETECTRON2_DATASETS", "datasets"), "densepose_meshes", "mesh_keyvertices_v0.json"
            )
            with open(path) as f:
                mesh_keyvertices = json.load(f)
        self.mesh_keyvertices = mesh_keyvertices
        if mesh_loader is None:
            from detectron2_tpu_torch.projects.densepose.meshes import create_mesh as mesh_loader
        self.mesh_loader = mesh_loader

    def _embeddings(self, name) -> np.ndarray:
        e = self.embedder(name)
        return e.detach().cpu().numpy() if hasattr(e, "detach") else np.asarray(e)

    def evaluate(self):
        ge_per_mesh, gps_per_mesh = {}, {}
        for mesh_name_1 in self.mesh_names:
            avg_errors, avg_gps = [], []
            embeddings_1 = self._embeddings(mesh_name_1)
            keyvertices_1 = self.mesh_keyvertices[mesh_name_1]
            keyvertex_names_1 = list(keyvertices_1.keys())
            keyvertex_indices_1 = [keyvertices_1[name] for name in keyvertex_names_1]
            for mesh_name_2 in self.mesh_names:
                if mesh_name_1 == mesh_name_2:
                    continue
                embeddings_2 = self._embeddings(mesh_name_2)
                matches_on_2 = (embeddings_1[keyvertex_indices_1] @ embeddings_2.T).argmax(axis=1)
                keyvertices_2 = self.mesh_keyvertices[mesh_name_2]
                geodists = np.asarray(self.mesh_loader(mesh_name_2).geodists)[
                    matches_on_2, [keyvertices_2[name] for name in keyvertex_names_1]
                ]
                gps = np.exp(-(geodists**2) / (2 * self.GPS_NORM**2))
                avg_errors.append(float(geodists.mean()))
                avg_gps.append(float(gps.mean()))
            ge_per_mesh[mesh_name_1] = float(np.mean(avg_errors)) if avg_errors else float("nan")
            gps_per_mesh[mesh_name_1] = float(np.mean(avg_gps)) if avg_gps else float("nan")
        ge_mean_global = float(np.mean(list(ge_per_mesh.values())))
        gps_mean_global = float(np.mean(list(gps_per_mesh.values())))
        return ge_mean_global, gps_mean_global, {"GE": ge_per_mesh, "GPS": gps_per_mesh}
