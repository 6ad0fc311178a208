"""DensePose annotation and result structures (counterpart of
``detectron2_tpu/projects/densepose/structures.py``), numpy on the host.

- :class:`DensePoseDataRelative` holds one person's chart annotations in the
  box-relative [0, 255] frame and transforms itself (a horizontal flip swaps
  the part semantics through the symmetry tables);
- :class:`DensePoseTransformData` carries those tables;
- :class:`DensePoseChartResult` (with confidences, quantized, compressed) is
  the result of one detection: per-pixel chart labels and UV in its box.

The ``dp_masks`` RLEs decode through the port's ``evaluation/rle.py``. The
port has no rotation transform, so only flips act on the annotations (no
config rotates). A flip of CSE annotations (``dp_vertex``) maps the vertex
ids through the mesh's symmetry table (``vertex_transforms``); where the
table is not staged, the ids are kept and a warning logged, as the JAX
package does (d2 would fail).
"""

import base64
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "DensePoseDataRelative",
    "DensePoseList",
    "DensePoseTransformData",
    "DensePoseChartResult",
    "DensePoseChartResultWithConfidences",
    "DensePoseChartResultQuantized",
    "DensePoseChartResultCompressed",
    "quantize_densepose_chart_result",
    "compress_quantized_densepose_chart_result",
    "decompress_compressed_densepose_chart_result",
]


class DensePoseTransformData:
    """Symmetry tables for horizontal flips
    (reference structures/transform_data.py:22-81).

    ``uv_symmetries`` maps {"U_transforms", "V_transforms"} to per-part
    [256, 256] lookup tables (indexed by (v*255, u*255)). The official
    tables ship with the DensePose data release
    (UV_symmetry_transforms.mat); :meth:`load` reads them from a pickled
    dict. When absent, U/V are left unchanged on flip (identity fallback) —
    part labels and the segmentation mask are still correctly swapped.
    """

    MASK_LABEL_SYMMETRIES = [0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 14]
    # fmt: off
    POINT_LABEL_SYMMETRIES = [0, 1, 2, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17, 20, 19, 22, 21, 24, 23]  # noqa
    # fmt: on

    def __init__(self, uv_symmetries: Optional[Dict[str, np.ndarray]] = None):
        self.mask_label_symmetries = DensePoseTransformData.MASK_LABEL_SYMMETRIES
        self.point_label_symmetries = DensePoseTransformData.POINT_LABEL_SYMMETRIES
        self.uv_symmetries = uv_symmetries

    @staticmethod
    def load(fpath: str) -> "DensePoseTransformData":
        """Load UV symmetry tables from a pickle of
        {"U_transforms": [24][256,256], "V_transforms": [24][256,256]}
        (the format the reference's load() consumes,
        transform_data.py:54-81)."""
        import pickle

        with open(fpath, "rb") as f:
            data = pickle.load(f)
        uv = {
            key: np.stack([np.asarray(t, np.float32) for t in data[key]])
            for key in ("U_transforms", "V_transforms")
        }
        return DensePoseTransformData(uv)


class DensePoseDataRelative:
    """One person's DensePose chart annotations, box-relative
    (reference structures/data_relative.py:13-260).

    x, y are in [0, 255] relative to the person's bbox; absolute coords are
    ``x_img = x0 + x * w / 256``. i are point part labels 1..24; u, v in
    [0, 1]; segm is the 256x256 coarse body-part mask (values 0..14) decoded
    from the ``dp_masks`` RLEs.
    """

    X_KEY = "dp_x"
    Y_KEY = "dp_y"
    U_KEY = "dp_U"
    V_KEY = "dp_V"
    I_KEY = "dp_I"
    S_KEY = "dp_masks"
    VERTEX_IDS_KEY = "dp_vertex"
    MESH_NAME_KEY = "ref_model"
    N_BODY_PARTS = 14
    N_PART_LABELS = 24
    MASK_SIZE = 256

    def __init__(self, annotation: dict, cleanup: bool = False):
        self.x = np.asarray(annotation[self.X_KEY], np.float32)
        self.y = np.asarray(annotation[self.Y_KEY], np.float32)
        if all(k in annotation for k in (self.I_KEY, self.U_KEY, self.V_KEY)):
            self.i = np.asarray(annotation[self.I_KEY], np.int64)
            self.u = np.asarray(annotation[self.U_KEY], np.float32)
            self.v = np.asarray(annotation[self.V_KEY], np.float32)
        if self.VERTEX_IDS_KEY in annotation:
            self.vertex_ids = np.asarray(annotation[self.VERTEX_IDS_KEY], np.int64)
            self.mesh_name = annotation.get(self.MESH_NAME_KEY)
        if self.S_KEY in annotation:
            self.segm = self.extract_segmentation_mask(annotation)
        if cleanup:
            self.cleanup_annotation(annotation)

    @staticmethod
    def extract_segmentation_mask(annotation) -> np.ndarray:
        """dp_masks (list of 14 per-part RLEs, or one RLE) -> [256, 256]
        float mask with values 0..14 (reference data_relative.py:94-116)."""
        poly_specs = annotation[DensePoseDataRelative.S_KEY]
        if isinstance(poly_specs, np.ndarray):
            return poly_specs
        segm = np.zeros((DensePoseDataRelative.MASK_SIZE,) * 2, np.float32)
        if isinstance(poly_specs, dict):
            if poly_specs:
                segm[_decode_rle(poly_specs) > 0] = 1
        else:
            for i, poly_i in enumerate(poly_specs):
                if poly_i:
                    segm[_decode_rle(poly_i) > 0] = i + 1
        return segm

    @staticmethod
    def validate_annotation(annotation):
        for key in (DensePoseDataRelative.X_KEY, DensePoseDataRelative.Y_KEY):
            if key not in annotation:
                return False, f"no {key} data in the annotation"
        iuv_ok = all(
            k in annotation
            for k in (
                DensePoseDataRelative.I_KEY,
                DensePoseDataRelative.U_KEY,
                DensePoseDataRelative.V_KEY,
            )
        )
        cse_ok = DensePoseDataRelative.VERTEX_IDS_KEY in annotation
        if not iuv_ok and not cse_ok:
            return False, "expected either dp_I/dp_U/dp_V or dp_vertex annotations"
        return True, None

    @staticmethod
    def cleanup_annotation(annotation):
        for key in (
            DensePoseDataRelative.X_KEY,
            DensePoseDataRelative.Y_KEY,
            DensePoseDataRelative.I_KEY,
            DensePoseDataRelative.U_KEY,
            DensePoseDataRelative.V_KEY,
            DensePoseDataRelative.S_KEY,
            DensePoseDataRelative.VERTEX_IDS_KEY,
            DensePoseDataRelative.MESH_NAME_KEY,
        ):
            annotation.pop(key, None)

    def apply_transform(self, transforms, densepose_transform_data: DensePoseTransformData):
        """Apply a TransformList. Because coordinates are box-relative,
        scaling and cropping are no-ops here (the box moves instead); only
        flips act (a swap of the part semantics)."""
        self._transform_pts(transforms, densepose_transform_data)
        if hasattr(self, "segm"):
            self._transform_segm(transforms, densepose_transform_data)

    def _transform_pts(self, transforms, dp_transform_data):
        from detectron2_tpu_torch.data.transforms import HFlipTransform

        do_hflip = sum(isinstance(t, HFlipTransform) for t in transforms.transforms) % 2 == 1
        if do_hflip:
            self.x = self.MASK_SIZE - self.x
            if hasattr(self, "i"):
                self._flip_iuv_semantics(dp_transform_data)
            if hasattr(self, "vertex_ids"):
                self._flip_vertices()

    def _flip_iuv_semantics(self, dp_transform_data: DensePoseTransformData):
        i_old = self.i.copy()
        pt_sym = dp_transform_data.point_label_symmetries
        uv_sym = dp_transform_data.uv_symmetries
        for i in range(self.N_PART_LABELS):
            sel = i_old == i + 1
            if not sel.any():
                continue
            if pt_sym[i + 1] != i + 1:
                self.i[sel] = pt_sym[i + 1]
            if uv_sym is not None:
                u_loc = (self.u[sel] * 255).astype(np.int64)
                v_loc = (self.v[sel] * 255).astype(np.int64)
                self.u[sel] = uv_sym["U_transforms"][i][v_loc, u_loc]
                self.v[sel] = uv_sym["V_transforms"][i][v_loc, u_loc]

    def _flip_vertices(self):
        """The mirrored vertex of each point: ``vertex_transforms`` of the
        mesh's symmetry table (d2's ``data_relative.py:216-221``), read once
        a process (``meshes.load_mesh_symmetry``); no table: the ids stay."""
        import logging

        from detectron2_tpu_torch.projects.densepose.meshes import load_mesh_symmetry

        name = getattr(self, "mesh_name", None) or "smpl_27554"
        sym = load_mesh_symmetry(name)
        if sym is None or "vertex_transforms" not in sym:
            logging.getLogger(__name__).warning("mesh %s symmetry table unavailable; hflip keeps vertex ids", name)
            return
        self.vertex_ids = np.asarray(sym["vertex_transforms"])[self.vertex_ids]

    def _transform_segm(self, transforms, dp_transform_data):
        from detectron2_tpu_torch.data.transforms import HFlipTransform

        do_hflip = sum(isinstance(t, HFlipTransform) for t in transforms.transforms) % 2 == 1
        if do_hflip:
            self.segm = self.segm[:, ::-1].copy()
            self._flip_segm_semantics(dp_transform_data)

    def _flip_segm_semantics(self, dp_transform_data):
        old = self.segm.copy()
        sym = dp_transform_data.mask_label_symmetries
        for i in range(self.N_BODY_PARTS):
            if sym[i + 1] != i + 1:
                self.segm[old == i + 1] = sym[i + 1]


def _decode_rle(rle_spec) -> np.ndarray:
    from detectron2_tpu_torch.evaluation.rle import rle_to_mask

    return rle_to_mask(rle_spec)


class DensePoseList:
    """Per-image list of DensePose annotations with their boxes (reference
    structures/list.py:11-69): one DensePoseDataRelative (or None) per
    detection, plus the XYXY_ABS boxes they are relative to."""

    def __init__(self, densepose_datas, boxes_xyxy_abs, image_size_hw):
        assert len(densepose_datas) == len(boxes_xyxy_abs), (
            f"Attempt to initialize DensePoseList with {len(densepose_datas)} "
            f"DensePose datas and {len(boxes_xyxy_abs)} boxes"
        )
        self.densepose_datas = list(densepose_datas)
        self.boxes_xyxy_abs = np.asarray(boxes_xyxy_abs, np.float32).reshape(-1, 4)
        self.image_size_hw = tuple(image_size_hw)

    def to(self, *args, **kwargs) -> "DensePoseList":
        return self  # host numpy

    def __iter__(self):
        return iter(self.densepose_datas)

    def __len__(self) -> int:
        return len(self.densepose_datas)

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.densepose_datas[item]
        if hasattr(item, "dtype") and getattr(item, "dtype", None) == np.bool_:
            idx = np.nonzero(np.asarray(item))[0]
        else:
            idx = np.arange(len(self))[item]
        datas = [self.densepose_datas[int(i)] for i in idx]
        return DensePoseList(datas, self.boxes_xyxy_abs[idx], self.image_size_hw)

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(num_instances={len(self)}, "
            f"image_height={self.image_size_hw[0]}, image_width={self.image_size_hw[1]})"
        )


# --------------------------------------------------------------------------
# inference results (reference structures/chart_result.py)
# --------------------------------------------------------------------------


@dataclass
class DensePoseChartResult:
    """Per-pixel chart labels [H, W] (int) and UV [2, H, W] (float) inside
    one detection box (reference chart_result.py:10-33)."""

    labels: np.ndarray
    uv: np.ndarray

    def to(self, device=None):  # host numpy
        return self


@dataclass
class DensePoseChartResultWithConfidences:
    """Chart result plus optional per-pixel confidence maps
    (reference chart_result.py:36-70)."""

    labels: np.ndarray
    uv: np.ndarray
    sigma_1: Optional[np.ndarray] = None
    sigma_2: Optional[np.ndarray] = None
    kappa_u: Optional[np.ndarray] = None
    kappa_v: Optional[np.ndarray] = None
    fine_segm_confidence: Optional[np.ndarray] = None
    coarse_segm_confidence: Optional[np.ndarray] = None

    def to(self, device=None):
        return self


@dataclass
class DensePoseChartResultQuantized:
    """labels + UV packed into one [3, H, W] uint8 tensor: channel 0 labels,
    channels 1/2 U/V scaled to 0..255 (reference chart_result.py:73-101)."""

    labels_uv_uint8: np.ndarray

    def to(self, device=None):
        return self


@dataclass
class DensePoseChartResultCompressed:
    """Quantized result PNG-compressed + base64-encoded for storage
    (reference chart_result.py:104-122)."""

    shape_chw: Any
    labels_uv_str: str


def quantize_densepose_chart_result(result: DensePoseChartResult) -> DensePoseChartResultQuantized:
    """(reference chart_result.py:125-141)."""
    h, w = result.labels.shape
    labels_uv_uint8 = np.zeros((3, h, w), np.uint8)
    labels_uv_uint8[0] = result.labels.astype(np.uint8)
    labels_uv_uint8[1:] = (np.clip(result.uv, 0.0, 1.0) * 255).astype(np.uint8)
    return DensePoseChartResultQuantized(labels_uv_uint8=labels_uv_uint8)


def compress_quantized_densepose_chart_result(
    result: DensePoseChartResultQuantized,
) -> DensePoseChartResultCompressed:
    """zlib + base64 of the quantized payload, lossless: decompress restores
    the exact uint8 tensor (the JAX package's format)."""
    arr = np.ascontiguousarray(result.labels_uv_uint8)
    payload = zlib.compress(arr.tobytes())
    return DensePoseChartResultCompressed(
        shape_chw=tuple(arr.shape), labels_uv_str=base64.b64encode(payload).decode("ascii")
    )


def decompress_compressed_densepose_chart_result(
    result: DensePoseChartResultCompressed,
) -> DensePoseChartResultQuantized:
    """(reference chart_result.py:163-183)."""
    payload = zlib.decompress(base64.b64decode(result.labels_uv_str))
    arr = np.frombuffer(payload, np.uint8).reshape(result.shape_chw).copy()
    return DensePoseChartResultQuantized(labels_uv_uint8=arr)
