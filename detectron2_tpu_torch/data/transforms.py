"""Test-time resize (counterpart of ``ResizeShortestEdge`` in
``detectron2_tpu/data/transforms/augmentation_impl.py`` and the resize of
``transform.py:166-184``).

The JAX package resizes uint8 images through PIL's ``BILINEAR`` filter,
which is antialiased when it shrinks. The port has no PIL (the card's
machine lacks it), so :func:`pil_bilinear_resize` reimplements that filter
bit for bit, following ``ImagingResample`` in Pillow's
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
from typing import Tuple

import torch

__all__ = ["ResizeShortestEdge", "pil_bilinear_resize"]

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


class ResizeShortestEdge:
    """Scale the short edge to ``short_edge_length``, capping the long edge
    at ``max_size``."""

    def __init__(self, short_edge_length: int, max_size: int):
        self.short_edge_length = int(short_edge_length)
        self.max_size = int(max_size)

    @staticmethod
    def get_output_shape(oldh: int, oldw: int, short_edge_length: int, max_size: int) -> Tuple[int, int]:
        """Rounded half-up, value-identical to the JAX package and d2."""
        scale = float(short_edge_length) / min(oldh, oldw)
        nh, nw = oldh * scale, oldw * scale
        longest = max(nh, nw)
        if longest > max_size:
            nh, nw = nh * max_size / longest, nw * max_size / longest
        return int(nh + 0.5), int(nw + 0.5)

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        """``[H, W, C]`` uint8 -> resized ``[h, w, C]`` uint8."""
        h, w = image.shape[:2]
        newh, neww = self.get_output_shape(h, w, self.short_edge_length, self.max_size)
        if (newh, neww) == (h, w):
            return image
        return pil_bilinear_resize(image, newh, neww)
