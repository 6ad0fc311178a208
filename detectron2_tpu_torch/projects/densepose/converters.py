"""DensePose output converters, host code in numpy (counterpart of
``detectron2_tpu/projects/densepose/converters.py``): one detection's chart
maps (coarse_segm / fine_segm / u / v and the confidences, each ``[S, S,
C]`` in the box frame) to a :class:`DensePoseChartResult` (labels and UV
at the box's integer size), or the coarse foreground of detections pasted
into full-image :class:`~detectron2_tpu_torch.structures.BitMasks`; and
the horizontal flip of a detection's maps (d2's
``chart_output_hflip``; neither package has the DensePose TTA wrapper that
would call it).

The maps are resized as the JAX package's ``cv2.resize(..., INTER_LINEAR)``
computes it with OpenCV's own code (:func:`resize_linear`); OpenCV built
with IPP takes IPP's resize for one, three and four channels, whose
weights differ by up to 2e-5 (``cv2.ipp.setUseIPP(False)`` gives OpenCV's).
"""

from typing import Dict, Optional, Tuple

import numpy as np

from detectron2_tpu_torch.projects.densepose.structures import (
    DensePoseChartResult,
    DensePoseChartResultWithConfidences,
)
from detectron2_tpu_torch.structures import BitMasks, Boxes, BoxMode

__all__ = [
    "make_int_box",
    "resize_linear",
    "resize_linear_channel",
    "resample_fine_and_coarse_segm_tensors_to_bbox",
    "resample_uv_tensors_to_bbox",
    "densepose_chart_predictor_output_to_result",
    "densepose_chart_predictor_output_to_result_with_confidences",
    "predictor_output_with_coarse_segm_to_mask",
    "densepose_chart_predictor_output_hflip",
    "ToChartResultConverter",
    "ToChartResultConverterWithConfidences",
    "ToMaskConverter",
]


def make_int_box(box_xywh) -> Tuple[int, int, int, int]:
    """XYWH truncated to ints (d2's ``make_int_box``)."""
    return tuple(int(v) for v in np.asarray(box_xywh, np.float64).reshape(-1)[:4].tolist())


def _linear_taps(in_size: int, out_size: int, clamp_fraction: bool):
    """One axis of OpenCV's ``INTER_LINEAR``: source coordinate ``(d + 0.5)
    * in / out - 0.5`` (float64, then float32), its floor and fraction.
    Along x a tap past the edge takes the edge pixel with weight (1, 0);
    along y both taps are clamped into the image and keep their fraction."""
    f = ((np.arange(out_size, dtype=np.float64) + 0.5) * (1.0 / (out_size / in_size)) - 0.5).astype(np.float32)
    lo = np.floor(f)
    frac = (f - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    if clamp_fraction:
        frac = np.where((lo < 0) | (lo >= in_size - 1), np.float32(0), frac)
        lo = np.clip(lo, 0, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
    else:
        hi = np.clip(lo + 1, 0, in_size - 1)
        lo = np.clip(lo, 0, in_size - 1)
    return lo, hi, (np.float32(1) - frac).astype(np.float32), frac


def _resized_rows(maps: np.ndarray, w: int):
    """The column pass of :func:`resize_linear`: ``[H, w, C]`` float32, and
    the input's height H."""
    x = np.asarray(maps, np.float32)
    if x.ndim == 2:
        x = x[:, :, None]
    x0, x1, a0, a1 = _linear_taps(x.shape[1], w, True)
    rows = np.take(x, x0, axis=1)
    rows *= a0[None, :, None]
    right = np.take(x, x1, axis=1)
    right *= a1[None, :, None]
    rows += right
    return rows, x.shape[0]


def resize_linear(maps: np.ndarray, h: int, w: int) -> np.ndarray:
    """``[H, W, C]`` (or ``[H, W]``) float32 maps resized to ``[h, w, C]``
    bilinearly with half-pixel centres, as OpenCV's ``INTER_LINEAR``:
    float32 taps and weights, the columns first, then the rows."""
    rows, H = _resized_rows(maps, w)
    y0, y1, b0, b1 = _linear_taps(H, h, False)
    out = np.take(rows, y0, axis=0)
    out *= b0[:, None, None]
    below = np.take(rows, y1, axis=0)
    below *= b1[:, None, None]
    out += below
    return out


def resize_linear_channel(maps: np.ndarray, h: int, w: int, channel: np.ndarray) -> np.ndarray:
    """``resize_linear(maps, h, w)[i, j, channel[i, j]]``, ``[h, w]``, the
    same float32 operations on the one channel each pixel reads."""
    rows, H = _resized_rows(maps, w)
    y0, y1, b0, b1 = _linear_taps(H, h, False)
    jj = np.arange(w)[None, :]
    return rows[y0[:, None], jj, channel] * b0[:, None] + rows[y1[:, None], jj, channel] * b1[:, None]


def resample_fine_and_coarse_segm_tensors_to_bbox(fine_segm: np.ndarray, coarse_segm: np.ndarray, box_xywh_abs) -> np.ndarray:
    """Per-pixel labels ``[h, w]`` inside the box: the argmax of the
    resized fine segmentation where the resized coarse one is foreground."""
    _, _, w, h = box_xywh_abs
    w, h = max(int(w), 1), max(int(h), 1)
    coarse = resize_linear(coarse_segm, h, w).argmax(axis=-1)
    return (resize_linear(fine_segm, h, w).argmax(axis=-1) * (coarse > 0)).astype(np.int64)


def resample_uv_tensors_to_bbox(u: np.ndarray, v: np.ndarray, labels: np.ndarray, box_xywh_abs) -> np.ndarray:
    """Each labelled pixel's U and V from its part's channel, ``[2, h, w]``
    (0 on the background)."""
    _, _, w, h = box_xywh_abs
    w, h = max(int(w), 1), max(int(h), 1)
    part = np.clip(labels, 0, np.asarray(u).shape[-1] - 1)
    uv = np.zeros((2, h, w), np.float32)
    fg = labels > 0
    uv[0][fg] = resize_linear_channel(u, h, w, part)[fg]
    uv[1][fg] = resize_linear_channel(v, h, w, part)[fg]
    return uv


def _int_box_xywh(box_xyxy_abs) -> Tuple[int, int, int, int]:
    xyxy = np.asarray(box_xyxy_abs, np.float64).reshape(1, 4)
    return make_int_box(BoxMode.convert(xyxy, BoxMode.XYXY_ABS, BoxMode.XYWH_ABS))


def _select_confidence(conf_map: Optional[np.ndarray], h: int, w: int) -> Optional[np.ndarray]:
    return None if conf_map is None else resize_linear(conf_map, h, w)[..., 0]


def densepose_chart_predictor_output_to_result(predictor_output: Dict[str, np.ndarray], box_xyxy_abs) -> DensePoseChartResult:
    """One detection's chart maps and its XYXY box -> labels and UV."""
    box_xywh = _int_box_xywh(box_xyxy_abs)
    labels = resample_fine_and_coarse_segm_tensors_to_bbox(
        predictor_output["fine_segm"], predictor_output["coarse_segm"], box_xywh
    )
    uv = resample_uv_tensors_to_bbox(predictor_output["u"], predictor_output["v"], labels, box_xywh)
    return DensePoseChartResult(labels=labels, uv=uv)


def densepose_chart_predictor_output_to_result_with_confidences(
    predictor_output: Dict[str, np.ndarray], box_xyxy_abs
) -> DensePoseChartResultWithConfidences:
    """As :func:`densepose_chart_predictor_output_to_result`, with each
    confidence map the detection has resized to the box."""
    base = densepose_chart_predictor_output_to_result(predictor_output, box_xyxy_abs)
    h, w = base.labels.shape
    conf = {
        k: _select_confidence(predictor_output.get(k), h, w)
        for k in ("sigma_1", "sigma_2", "kappa_u", "kappa_v", "fine_segm_confidence", "coarse_segm_confidence")
    }
    return DensePoseChartResultWithConfidences(labels=base.labels, uv=base.uv, **conf)


def predictor_output_with_coarse_segm_to_mask(
    coarse_segm: np.ndarray, boxes: np.ndarray, image_size_hw: Tuple[int, int]
) -> BitMasks:
    """``[N, S, S, K]`` coarse segmentations and ``[N, 4]`` XYXY boxes ->
    full-image BitMasks of each detection's foreground."""
    H, W = image_size_hw
    masks = np.zeros((coarse_segm.shape[0], H, W), bool)
    for i in range(coarse_segm.shape[0]):
        x, y, w, h = _int_box_xywh(boxes[i])
        w, h = max(w, 1), max(h, 1)
        fg = resize_linear(coarse_segm[i], h, w).argmax(axis=-1) > 0
        x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + w, W), min(y + h, H)
        if x1 > x0 and y1 > y0:
            masks[i, y0:y1, x0:x1] = fg[y0 - y : y1 - y, x0 - x : x1 - x]
    return BitMasks(masks)


def _box_array(boxes) -> np.ndarray:
    b = boxes.tensor if isinstance(boxes, Boxes) else boxes
    return b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)


class ToChartResultConverter:
    """``convert(outputs, boxes)`` of one detection (d2's facade)."""

    @staticmethod
    def convert(predictor_output: Dict[str, np.ndarray], boxes) -> DensePoseChartResult:
        return densepose_chart_predictor_output_to_result(predictor_output, _box_array(boxes).reshape(-1)[:4])


class ToChartResultConverterWithConfidences:
    @staticmethod
    def convert(predictor_output: Dict[str, np.ndarray], boxes) -> DensePoseChartResultWithConfidences:
        return densepose_chart_predictor_output_to_result_with_confidences(
            predictor_output, _box_array(boxes).reshape(-1)[:4]
        )


class ToMaskConverter:
    @staticmethod
    def convert(coarse_segm: np.ndarray, boxes, image_size_hw) -> BitMasks:
        return predictor_output_with_coarse_segm_to_mask(coarse_segm, _box_array(boxes), image_size_hw)


def densepose_chart_predictor_output_hflip(output: Dict[str, np.ndarray], transform_data) -> Dict[str, np.ndarray]:
    """One detection's ``[H, W, C]`` maps mirrored along W: U and V through
    the UV symmetry tables, the part channels of fine_segm / u / v by the
    point-label symmetry, a body-part coarse_segm (more than two channels)
    by the mask-label symmetry; confidence maps are only mirrored."""
    out = {k: np.asarray(v, np.float32)[:, ::-1].copy() for k, v in output.items()}
    uv_sym = transform_data.uv_symmetries
    if uv_sym is not None and "u" in out:
        C = out["u"].shape[-1]
        u_loc = (np.clip(out["u"][..., 1:], 0, 1) * 255).astype(np.int64)
        v_loc = (np.clip(out["v"][..., 1:], 0, 1) * 255).astype(np.int64)
        idx = np.arange(C - 1)[None, None, :]
        out["u"][..., 1:] = uv_sym["U_transforms"][idx, v_loc, u_loc]
        out["v"][..., 1:] = uv_sym["V_transforms"][idx, v_loc, u_loc]
    for k in ("fine_segm", "u", "v"):
        if k in out:
            out[k] = out[k][..., transform_data.point_label_symmetries]
    if "coarse_segm" in out and out["coarse_segm"].shape[-1] > 2:
        out["coarse_segm"] = out["coarse_segm"][..., transform_data.mask_label_symmetries]
    return out
