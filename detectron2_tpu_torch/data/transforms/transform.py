"""Deterministic transforms of the test-time data path (counterpart of
``detectron2_tpu/data/transforms/transform.py``: ``Transform``,
``TransformList``, ``NoOpTransform`` and ``ResizeTransform``), and the
resize they use.

The JAX package resizes uint8 images through PIL's ``BILINEAR`` filter,
which is antialiased when it shrinks. The port does not depend on PIL (the
card's machine lacks it), so :func:`pil_bilinear_resize` reimplements that
filter bit for bit, following ``ImagingResample`` in Pillow's
``libImaging/Resample.c``, in int64 torch ops on the image's device:

- per output pixel, float64 coefficients of the triangle filter over the
  window ``[xmin, xmin + xmax)`` with ``support = max(scale, 1)``,
  normalized to sum 1;
- fixed point with 22 fractional bits, rounded half away from zero;
- the horizontal pass first, then the vertical one; each accumulates in
  integers from ``1 << 21``, shifts right by 22 and clamps to 0..255, so
  the intermediate image is uint8 as in PIL.
"""

import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["NoOpTransform", "ResizeTransform", "Transform", "TransformList", "pil_bilinear_resize"]

_PRECISION_BITS = 22  # 32 - 8 - 2, Resample.c


def _pil_coefficients(in_size: int, out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the bilinear
    filter: source indices ``[out, ksize]`` and int64 fixed-point weights
    ``[out, ksize]`` (0 beyond each pixel's window)."""
    f64 = torch.float64
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (torch.arange(out_size, dtype=f64) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = torch.trunc(center - support + 0.5).clamp_min(0)
    xmax = torch.trunc(center + support + 0.5).clamp_max(in_size) - xmin
    ss = 1.0 / filterscale
    x = torch.arange(ksize, dtype=f64)
    w = ((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss).abs()
    w = torch.where(w < 1.0, 1.0 - w, torch.zeros_like(w))
    w = torch.where(x[None, :] < xmax[:, None], w, torch.zeros_like(w))
    ww = torch.zeros(out_size, dtype=f64)
    for k in range(ksize):  # in order, as the C loop sums
        ww = ww + w[:, k]
    w = torch.where(ww[:, None] != 0.0, w / torch.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * float(1 << _PRECISION_BITS)
    fixed = torch.where(w < 0, torch.trunc(-0.5 + scaled), torch.trunc(0.5 + scaled)).to(torch.int64)
    index = (xmin.to(torch.int64)[:, None] + x.to(torch.int64)[None, :]).clamp_max(in_size - 1)
    return index, fixed


def _resample_axis(image: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """One 8-bit pass of ``ImagingResampleHorizontal/Vertical_8bpc`` along
    ``axis`` (0 rows, 1 columns) of an ``[H, W, C]`` uint8 image."""
    index, fixed = _pil_coefficients(image.shape[axis], out_size)
    index, fixed = index.to(image.device), fixed.to(image.device)
    src = image.to(torch.int64)
    acc = None
    for k in range(index.shape[1]):
        taps = src.index_select(axis, index[:, k])
        wk = fixed[:, k].reshape((-1, 1, 1) if axis == 0 else (1, -1, 1))
        term = taps * wk
        acc = term if acc is None else acc + term
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return (acc >> _PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def pil_bilinear_resize(image: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """``PIL.Image.resize((new_w, new_h), BILINEAR)`` of an ``[H, W, C]``
    uint8 image, bit for bit. A pass whose size does not change is skipped,
    as PIL skips it."""
    out = image
    if new_w != image.shape[1]:
        out = _resample_axis(out, 1, new_w)
    if new_h != image.shape[0]:
        out = _resample_axis(out, 0, new_h)
    return out


class Transform:
    """Base class for deterministic transforms of an image and its
    coordinates."""

    def apply_image(self, img):
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        """coords: [N, 2] float array of (x, y)."""
        raise NotImplementedError

    def apply_box(self, box: np.ndarray) -> np.ndarray:
        """box: [N, 4] XYXY: the 4 corners transformed, then their
        axis-aligned envelope."""
        box = np.asarray(box, dtype=np.float64).reshape(-1, 4)
        idxs = np.array([(0, 1), (2, 1), (0, 3), (2, 3)]).flatten()
        coords = box[:, idxs].reshape(-1, 2)
        coords = self.apply_coords(coords).reshape(-1, 4, 2)
        return np.concatenate((coords.min(axis=1), coords.max(axis=1)), axis=1)

    def apply_polygons(self, polygons: List[np.ndarray]) -> List[np.ndarray]:
        return [self.apply_coords(np.asarray(p, dtype=np.float64).reshape(-1, 2)).reshape(-1) for p in polygons]

    def apply_segmentation(self, segmentation):
        return self.apply_image(segmentation)

    def inverse(self) -> "Transform":
        raise NotImplementedError

    def __add__(self, other):
        t1 = self.transforms if isinstance(self, TransformList) else [self]
        t2 = other.transforms if isinstance(other, TransformList) else [other]
        return TransformList(t1 + t2)


class TransformList(Transform):
    """Composition of transforms, applied in order."""

    def __init__(self, transforms: List[Transform]):
        flat = []
        for t in transforms:
            if isinstance(t, TransformList):
                flat.extend(t.transforms)
            else:
                flat.append(t)
        self.transforms = flat

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg

    def apply_box(self, box):
        for t in self.transforms:
            box = t.apply_box(box)
        return box

    def apply_polygons(self, polygons):
        for t in self.transforms:
            polygons = t.apply_polygons(polygons)
        return polygons

    def inverse(self) -> "TransformList":
        return TransformList([t.inverse() for t in self.transforms[::-1]])

    def __len__(self):
        return len(self.transforms)

    def __getitem__(self, i):
        return self.transforms[i]


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords

    def inverse(self):
        return self


class ResizeTransform(Transform):
    """Resize an ``[H, W, C]`` (or ``[H, W]``) uint8 image, a numpy array or
    a tensor on any device, with PIL's bilinear filter bit for bit; coords
    scale linearly. Other filters and dtypes are not ported (the JAX package
    reaches them through PIL and cv2 in training and for segmentation maps)."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int, interp: str = "bilinear"):
        self.h, self.w = h, w
        self.new_h, self.new_w = new_h, new_w
        self.interp = interp

    def apply_image(self, img, interp: str = None):
        assert tuple(img.shape[:2]) == (self.h, self.w), (tuple(img.shape), (self.h, self.w))
        method = interp or self.interp
        if method != "bilinear" or img.dtype not in (np.uint8, torch.uint8):
            raise NotImplementedError(f"ResizeTransform: {method} of {img.dtype} images (bilinear of uint8 only)")
        is_numpy = isinstance(img, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(img)) if is_numpy else img
        squeeze = t.dim() == 2
        out = pil_bilinear_resize(t[:, :, None] if squeeze else t, self.new_h, self.new_w)
        out = out[:, :, 0] if squeeze else out
        return out.numpy() if is_numpy else out

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] = coords[:, 0] * (self.new_w * 1.0 / self.w)
        coords[:, 1] = coords[:, 1] * (self.new_h * 1.0 / self.h)
        return coords

    def apply_segmentation(self, segmentation):
        return self.apply_image(segmentation, interp="nearest")

    def inverse(self):
        return ResizeTransform(self.new_h, self.new_w, self.h, self.w, self.interp)
