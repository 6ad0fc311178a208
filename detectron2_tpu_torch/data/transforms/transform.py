"""Deterministic transforms of the data path (counterpart of
``detectron2_tpu/data/transforms/transform.py``: ``Transform``,
``TransformList``, ``NoOpTransform``, ``HFlipTransform``,
``VFlipTransform``, ``ResizeTransform``, ``CropTransform`` and
``PadTransform``), and the resizes they use. Images are numpy arrays (the
loader) or tensors (the predictor); each transform returns what it was
given.

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

__all__ = [
    "CropTransform",
    "HFlipTransform",
    "NoOpTransform",
    "PadTransform",
    "ResizeTransform",
    "Transform",
    "TransformList",
    "VFlipTransform",
    "pil_bilinear_resize",
]

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


def _nearest_index(in_size: int, out_size: int, pil: bool) -> np.ndarray:
    """Source index of each output pixel of a nearest-neighbour resize.
    PIL (uint8 images) walks the centers ``(x + 0.5) * in / out`` by
    repeated float64 addition, as ``ImagingScaleAffine`` does, and truncates;
    OpenCV's ``INTER_NEAREST`` (other dtypes) floors ``x * (1 / (out /
    in))``, capped at the last pixel."""
    if pil:
        step = in_size / out_size
        centers = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
        return np.minimum(centers.astype(np.int64), in_size - 1)
    inv = 1.0 / (out_size / in_size)
    return np.minimum(np.floor(np.arange(out_size) * inv).astype(np.int64), in_size - 1)


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


class HFlipTransform(Transform):
    """Mirror left to right in an image of width ``width``."""

    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        if isinstance(img, torch.Tensor):
            return img.flip(1)
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def inverse(self):
        return self


class VFlipTransform(Transform):
    """Mirror top to bottom in an image of height ``height``."""

    def __init__(self, height: int):
        self.height = height

    def apply_image(self, img):
        if isinstance(img, torch.Tensor):
            return img.flip(0)
        return np.ascontiguousarray(img[::-1])

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 1] = self.height - coords[:, 1]
        return coords

    def inverse(self):
        return self


class ResizeTransform(Transform):
    """Resize an ``[H, W, C]`` or ``[H, W]`` image, a numpy array or a
    tensor on any device; coords scale linearly. The filters are those the
    JAX package reaches through PIL (uint8) and OpenCV (other dtypes):

    - uint8 "bilinear": PIL's antialiased ``BILINEAR``, bit for bit
      (:func:`pil_bilinear_resize`);
    - uint8 "nearest": PIL's ``NEAREST``, and float "nearest": OpenCV's
      ``INTER_NEAREST``, both bit for bit (:func:`_nearest_index`);
    - float "bilinear": OpenCV's ``INTER_LINEAR`` (half-pixel centers, edge
      clamp, no antialiasing) as ``F.interpolate(mode="bilinear",
      align_corners=False)`` in the image's dtype.

    Other filters are not ported."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int, interp: str = "bilinear"):
        self.h, self.w = h, w
        self.new_h, self.new_w = new_h, new_w
        self.interp = interp or "bilinear"

    def apply_image(self, img, interp: str = None):
        assert tuple(img.shape[:2]) == (self.h, self.w), (tuple(img.shape), (self.h, self.w))
        method = interp or self.interp
        if method not in ("bilinear", "nearest"):
            raise NotImplementedError(f"ResizeTransform: interpolation {method!r} (bilinear or nearest)")
        is_numpy = isinstance(img, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(img)) if is_numpy else img
        uint8 = t.dtype == torch.uint8
        if method == "nearest":
            rows = torch.from_numpy(_nearest_index(self.h, self.new_h, uint8)).to(t.device)
            cols = torch.from_numpy(_nearest_index(self.w, self.new_w, uint8)).to(t.device)
            out = t.index_select(0, rows).index_select(1, cols)
        elif uint8:
            squeeze = t.dim() == 2
            out = pil_bilinear_resize(t[:, :, None] if squeeze else t, self.new_h, self.new_w)
            out = out[:, :, 0] if squeeze else out
        else:
            x = (t[:, :, None] if t.dim() == 2 else t).permute(2, 0, 1)[None]
            out = torch.nn.functional.interpolate(x, size=(self.new_h, self.new_w), mode="bilinear", align_corners=False)
            out = out[0].permute(1, 2, 0)
            out = out[:, :, 0] if t.dim() == 2 else out.contiguous()
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


class CropTransform(Transform):
    """The ``w`` x ``h`` window at (``x0``, ``y0``)."""

    def __init__(self, x0: int, y0: int, w: int, h: int, orig_w: int = None, orig_h: int = None):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h
        self.orig_w, self.orig_h = orig_w, orig_h

    def apply_image(self, img):
        if len(img.shape) <= 3:
            return img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]
        return img[..., self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w, :]

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords

    def apply_polygons(self, polygons):
        """Each vertex clamped into the window, then shifted to its corner
        (the JAX package's shapely-free crop: a polygon that leaves the
        window keeps its vertex count, with vertices on the window's edge)."""
        out = []
        for p in polygons:
            coords = np.asarray(p, dtype=np.float64).reshape(-1, 2).copy()
            coords[:, 0] = np.clip(coords[:, 0], self.x0, self.x0 + self.w) - self.x0
            coords[:, 1] = np.clip(coords[:, 1], self.y0, self.y0 + self.h) - self.y0
            out.append(coords.reshape(-1))
        return out

    def inverse(self):
        assert self.orig_w is not None and self.orig_h is not None, "Crop inverse needs original size"
        return PadTransform(
            self.x0, self.y0, self.orig_w - self.x0 - self.w, self.orig_h - self.y0 - self.h, self.w, self.h
        )


class PadTransform(Transform):
    """``x0``/``x1`` columns left/right and ``y0``/``y1`` rows above/below,
    of ``pad_value``."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int, orig_w: int = None, orig_h: int = None, pad_value: float = 0):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.orig_w, self.orig_h = orig_w, orig_h
        self.pad_value = pad_value

    def apply_image(self, img):
        h, w = img.shape[:2]
        shape = (h + self.y0 + self.y1, w + self.x0 + self.x1) + tuple(img.shape[2:])
        if isinstance(img, torch.Tensor):
            out = torch.full(shape, self.pad_value, dtype=img.dtype, device=img.device)
        else:
            out = np.full(shape, self.pad_value, dtype=img.dtype)
        out[self.y0 : self.y0 + h, self.x0 : self.x0 + w] = img
        return out

    def apply_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[:, 0] += self.x0
        coords[:, 1] += self.y0
        return coords

    def inverse(self):
        assert self.orig_w is not None and self.orig_h is not None
        return CropTransform(self.x0, self.y0, self.orig_w, self.orig_h)
