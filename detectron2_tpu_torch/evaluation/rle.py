"""COCO-compatible run-length encoding (RLE) and polygon rasterization, in
numpy (a copy of ``detectron2_tpu/evaluation/rle.py``; pycocotools is not a
dependency):

- compressed RLE string codec (the 6-bit LEB-style format used in COCO json),
- column-major RLE <-> binary mask,
- polygon -> mask rasterization: a numpy statement of ``cv2.fillPoly``, which
  the JAX package calls (the card's machine has no OpenCV); COCO's integer
  5x-upsampled boundary tracing differs at sub-pixel level, below AP
  resolution,
- RLE area / bbox / merge / pairwise IoU used by the COCO evaluator (the
  decoded-mask path: the JAX package's ``_native`` RLE kernel is not copied).
"""

from typing import Any, Dict, List, Sequence, Union

import numpy as np

__all__ = [
    "mask_to_rle",
    "rle_to_mask",
    "encode_counts",
    "decode_counts",
    "polygons_to_mask",
    "polygons_to_rle",
    "rle_area",
    "rle_to_bbox",
    "rle_merge",
    "rle_iou",
]


def encode_counts(counts: Sequence[int]) -> bytes:
    """Compress an RLE counts list to the COCO string format (maskApi rleToString)."""
    out = bytearray()
    cnts = list(counts)
    for i in range(len(cnts)):
        x = int(cnts[i])
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def decode_counts(s: Union[bytes, str]) -> List[int]:
    """Decompress a COCO RLE counts string (maskApi rleFrString)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Encode a binary mask (H, W) into compressed COCO RLE (column-major)."""
    mask = np.asarray(mask, order="F", dtype=np.uint8)
    h, w = mask.shape
    flat = mask.flatten(order="F")
    # run lengths, starting with the count of zeros
    diffs = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    boundaries = np.concatenate([[0], diffs, [len(flat)]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [int(h), int(w)], "counts": encode_counts(counts)}


def _rle_counts(rle: Dict[str, Any]) -> List[int]:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return decode_counts(counts)
    return list(counts)


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Decode a COCO RLE (compressed or uncompressed counts) to a bool mask."""
    h, w = rle["size"]
    counts = _rle_counts(rle)
    total = h * w
    flat = np.zeros(total, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    assert pos == total, f"RLE decodes to {pos} pixels, expected {total}"
    return flat.reshape((h, w), order="F")


# ------------------------------------------------------- polygon rasterization
#
# cv2.fillPoly(mask, pts, 1) on int32 vertices (shift 0, 8-connected lines),
# restated in numpy after OpenCV's drawing code (imgproc/src/drawing.cpp) as
# OpenCV 5.0 behaves; held equal to it on thousands of seeded polygons:
#
# - every edge is drawn as an 8-connected line (``LineIterator``: left to
#   right, after ``clipLine`` to the image; one pixel per step of the major
#   axis, the minor axis stepping where the error term before the step is
#   negative, so that ties round toward the left end);
# - the interior is filled scanline by scanline from the edges of all
#   polygons together (``FillEdgeCollection``): a non-horizontal edge covers
#   rows [y0, y1), its x runs in 16.16 fixed point from its upper end with a
#   step truncated toward zero, the edges of a row are paired in x order
#   (even-odd) and a pair fills [ceil(xl), floor(xr)], clipped to the image;
# - an edge whose line leaves the image takes the x of its line's clipped
#   ends, and their y too unless the clipped line is horizontal.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width: int, height: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's ``clipLine``, in place on [x, y] lists: whether any part of
    the segment lies in the image."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False

    def code(p, full=True):
        c = (p[0] < 0) + (p[0] > right) * 2
        return c + ((p[1] < 0) * 4 + (p[1] > bottom) * 8 if full else 0)

    c1, c2 = code(p1), code(p2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            p1[0] += int(float(a - p1[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p1[1] = a
            c1 = code(p1, False)
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            p2[0] += int(float(a - p2[1]) * (p2[0] - p1[0]) / (p2[1] - p1[1]))
            p2[1] = a
            c2 = code(p2, False)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                p1[1] += int(float(a - p1[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p1[0] = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                p2[1] += int(float(a - p2[0]) * (p2[1] - p1[1]) / (p2[0] - p1[0]))
                p2[0] = a
                c2 = 0
    return (c1 | c2) == 0


def _line_pixels(width: int, height: int, p1: List[int], p2: List[int]):
    """(ys, xs) of the 8-connected line p1 -> p2 (``LineIterator``, left to
    right): one pixel per step of the major axis, the minor axis stepping when
    the error term before the step is negative."""
    p1, p2 = list(p1), list(p2)
    inside = all(0 <= p[0] < width and 0 <= p[1] < height for p in (p1, p2))
    if not inside and not _clip_line(width, height, p1, p2):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    # the minor step after step i is taken when err_i = major - 2 minor (i + 1)
    # + 2 major m_i < 0; m_0 = 0, so m_i counts the i' < i with a negative err
    m = np.zeros(major + 1, np.int64)
    if major > 0:
        # m_{i+1} = m_i + [2 minor (i + 1) > major + 2 major m_i]: closed form
        # ceil((2 minor (i + 1) - major) / (2 major)), the rounding half down
        num = 2 * minor * i[1:] - major
        m[1:] = np.maximum(-((-num) // (2 * major)), 0)
    if vert:
        return p1[1] + sy * i, p1[0] + m
    return p1[1] + sy * m, p1[0] + i


def polygons_to_mask(polygons: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize polygons (list of flat [x0,y0,x1,y1,...] arrays) to a uint8
    mask: ``cv2.fillPoly`` of the vertices rounded to integers, without cv2."""
    mask = np.zeros((height, width), dtype=np.uint8)
    pts = [
        np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2)).astype(np.int32).astype(np.int64)
        for p in polygons
        if len(p) >= 6
    ]
    if not pts or height <= 0 or width <= 0:
        return mask
    edges = []  # (y0, y1, x at y0, dx), 16.16 fixed point
    for v in pts:
        pt0 = [int(v[-1][0]), int(v[-1][1])]
        for x, y in v.tolist():
            pt1 = [x, y]
            ys, xs = _line_pixels(width, height, pt0, pt1)
            mask[ys, xs] = 1
            # the fill's edge: its line's clipped ends where the line leaves the
            # image (their x alone where the clipped line is horizontal)
            c0 = [pt0[0] << _XY_SHIFT, pt0[1]]
            c1 = [pt1[0] << _XY_SHIFT, pt1[1]]
            t0, t1 = list(pt0), list(pt1)
            if not all(0 <= p[0] < width and 0 <= p[1] < height for p in (t0, t1)):
                _clip_line(width, height, t0, t1)
                c0[0], c1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
                if t0[1] != t1[1]:
                    c0[1], c1[1] = t0[1], t1[1]
            if pt0[1] != pt1[1]:
                dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
                if pt0[1] < pt1[1]:
                    edges.append((pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
                else:
                    edges.append((pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
            pt0 = pt1
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, dtype=np.int64)
    y0, y1, x0, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    xend = x0 + (y1 - y0) * dx
    if (
        y1.max() < 0
        or y0.min() >= height
        or max(x0.max(), xend.max()) < 0
        or min(x0.min(), xend.min()) >= (width << _XY_SHIFT)
    ):
        return mask
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), height), dtype=np.int64)
    if rows.size == 0:
        return mask
    active = (rows[:, None] >= y0[None, :]) & (rows[:, None] < y1[None, :])
    xs = np.where(active, x0[None, :] + (rows[:, None] - y0[None, :]) * dx[None, :], np.iinfo(np.int64).max)
    xs.sort(axis=1)
    n_active = active.sum(axis=1)
    k = xs.shape[1] // 2
    xl, xr = xs[:, 0 : 2 * k : 2], xs[:, 1 : 2 * k : 2]
    pair = np.arange(k)[None, :] < (n_active[:, None] // 2)
    a = (np.where(pair, xl, 0) + _XY_ONE - 1) >> _XY_SHIFT  # ceil
    b = np.where(pair, xr, 0) >> _XY_SHIFT  # floor
    draw = pair & (a < width) & (b >= 0)
    a, b = np.clip(a, 0, None), np.clip(b, None, width - 1)
    # spans [a, b] of each row as +1 / -1 steps, summed along the row
    steps = np.zeros((rows.size, width + 1), np.int64)
    r = np.broadcast_to(np.arange(rows.size)[:, None], a.shape)
    np.add.at(steps, (r[draw], a[draw]), 1)
    np.add.at(steps, (r[draw], b[draw] + 1), -1)
    mask[rows] |= (np.cumsum(steps[:, :width], axis=1) > 0).astype(np.uint8)
    return mask


def polygons_to_rle(polygons: List[np.ndarray], height: int, width: int) -> Dict[str, Any]:
    return mask_to_rle(polygons_to_mask(polygons, height, width))


def rle_area(rle: Dict[str, Any]) -> int:
    counts = _rle_counts(rle)
    return int(sum(counts[1::2]))


def rle_to_bbox(rle: Dict[str, Any]) -> np.ndarray:
    """Tight XYWH bbox of an RLE mask (maskApi rleToBbox)."""
    m = rle_to_mask(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4, dtype=np.float64)
    return np.array(
        [xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1], dtype=np.float64
    )


def rle_merge(rles: List[Dict[str, Any]], intersect: bool = False) -> Dict[str, Any]:
    """Union (or intersection) of several RLE masks."""
    assert len(rles) > 0
    m = rle_to_mask(rles[0])
    for r in rles[1:]:
        if intersect:
            m &= rle_to_mask(r)
        else:
            m |= rle_to_mask(r)
    return mask_to_rle(m)


def rle_iou(dt: List[Dict[str, Any]], gt: List[Dict[str, Any]], iscrowd: List[int]) -> np.ndarray:
    """Pairwise IoU between detection and gt RLE masks (maskApi rleIou).

    For crowd gt, the denominator is the detection area (IoA), matching COCO.
    """
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))

    d_masks = [rle_to_mask(d) for d in dt]
    g_masks = [rle_to_mask(g) for g in gt]
    ious = np.zeros((len(dt), len(gt)))
    for j, (g, crowd) in enumerate(zip(g_masks, iscrowd)):
        g_area = g.sum()
        for i, d in enumerate(d_masks):
            inter = np.logical_and(d, g).sum()
            if crowd:
                denom = d.sum()
            else:
                denom = d.sum() + g_area - inter
            ious[i, j] = inter / denom if denom > 0 else 0.0
    return ious
