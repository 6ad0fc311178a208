"""Augmentation policies (counterpart of
``detectron2_tpu/data/transforms/augmentation_impl.py``): ``RandomApply``
:59, ``RandomFlip`` :81, ``ResizeShortestEdge`` :114 in its "choice" and
"range" styles, large-scale jitter (``ResizeScale`` :162 and
``FixedSizeCrop`` :180), ``RandomCrop`` :210 in its four styles and
``RandomCrop_CategoryAreaConstraint`` :253. Each
draws what the JAX policy draws, in the same order, from its ``rng``
(:class:`Augmentation`; the JAX package draws from numpy's global state).
The color augmentations and the rotations are not ported (ROADMAP A8).
"""

import sys
from typing import Tuple

import numpy as np

from detectron2_tpu_torch.data.transforms.augmentation import Augmentation, _transform_to_aug
from detectron2_tpu_torch.data.transforms.transform import (
    CropTransform,
    HFlipTransform,
    NoOpTransform,
    PadTransform,
    ResizeTransform,
    TransformList,
    VFlipTransform,
)

__all__ = ["FixedSizeCrop", "RandomApply", "RandomCrop", "RandomFlip", "ResizeScale", "ResizeShortestEdge",
           "RandomCrop_CategoryAreaConstraint"]


class RandomApply(Augmentation):
    """Apply the wrapped augmentation with probability ``prob``."""

    def __init__(self, tfm_or_aug, prob=0.5):
        super().__init__()
        self.aug = _transform_to_aug(tfm_or_aug)
        assert 0.0 <= prob <= 1.0, f"Probablity must be between 0.0 and 1.0 (given: {prob})"
        self.prob = prob

    def set_rng(self, rng) -> None:
        super().set_rng(rng)
        self.aug.set_rng(rng)

    def get_transform(self, *args):
        if self._rand_range() < self.prob:
            return self.aug.get_transform(*args)
        return NoOpTransform()

    def __call__(self, aug_input):
        if self._rand_range() < self.prob:
            return self.aug(aug_input)
        return NoOpTransform()


class RandomFlip(Augmentation):
    """Flip horizontally or vertically with probability ``prob``."""

    def __init__(self, prob=0.5, *, horizontal=True, vertical=False):
        super().__init__()
        if horizontal == vertical:
            raise ValueError(
                "Exactly one of horizontal/vertical must be set; compose two "
                "RandomFlip augmentations to get both."
            )
        self._init(locals())

    def get_transform(self, image):
        if self._rand_range() >= self.prob:
            return NoOpTransform()
        h, w = image.shape[:2]
        return HFlipTransform(w) if self.horizontal else VFlipTransform(h)


class ResizeShortestEdge(Augmentation):
    """Resize so the shorter edge hits a target, capping the longer edge:
    the COCO standard policy. ``sample_style`` "range" draws the target from
    ``[lo, hi]``, "choice" from the given lengths."""

    def __init__(self, short_edge_length, max_size=sys.maxsize, sample_style="range", interp="bilinear"):
        super().__init__()
        if sample_style not in ("range", "choice"):
            raise ValueError(f"unknown sample_style {sample_style!r}")
        self.is_range = sample_style == "range"
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length, short_edge_length)
        if self.is_range and len(short_edge_length) != 2:
            raise ValueError(f"'range' style needs a (lo, hi) pair, got {short_edge_length}")
        self._init(locals())

    def _sample_short_edge(self) -> int:
        lo_hi = self.short_edge_length
        if self.is_range:
            return int(self._random.randint(lo_hi[0], lo_hi[1] + 1))
        return int(self._random.choice(lo_hi))

    def get_transform(self, image):
        target = self._sample_short_edge()
        if target == 0:
            return NoOpTransform()
        h, w = image.shape[:2]
        newh, neww = ResizeShortestEdge.get_output_shape(h, w, target, self.max_size)
        return ResizeTransform(h, w, newh, neww, self.interp)

    @staticmethod
    def get_output_shape(oldh: int, oldw: int, short_edge_length: int, max_size: int) -> Tuple[int, int]:
        """Output (h, w): short edge scaled to the target, long edge capped at
        max_size, both rounded half-up, value-identical to the JAX package and
        d2 (the rounding is AP-relevant)."""
        scale = float(short_edge_length) / min(oldh, oldw)
        nh, nw = oldh * scale, oldw * scale
        longest = max(nh, nw)
        if longest > max_size:
            nh, nw = nh * max_size / longest, nw * max_size / longest
        return int(nh + 0.5), int(nw + 0.5)


class ResizeScale(Augmentation):
    """Large-scale jitter: a scale drawn from ``[min_scale, max_scale]`` of
    the target box, then a resize that fits the image into the scaled box,
    keeping its aspect ratio (sides rounded half to even, as the JAX
    package's ``round``)."""

    def __init__(self, min_scale: float, max_scale: float, target_height: int, target_width: int, interp="bilinear"):
        super().__init__()
        self._init(locals())

    def get_transform(self, image):
        h, w = image.shape[:2]
        scale = self._random.uniform(self.min_scale, self.max_scale)
        fit = min(self.target_height * scale / h, self.target_width * scale / w)
        return ResizeTransform(h, w, int(round(h * fit)), int(round(w * fit)), self.interp)


class FixedSizeCrop(Augmentation):
    """A crop of at most ``crop_size`` at a drawn place (one fraction drawn
    for both axes), then, with ``pad``, a bottom/right pad of ``pad_value``
    up to exactly ``crop_size``: the JAX package's LSJ crop.
    ``seg_pad_value`` is accepted as the JAX package accepts it; it pads
    nothing there either."""

    def __init__(self, crop_size: Tuple[int, int], pad: bool = True, pad_value: float = 128.0, seg_pad_value: int = 255):
        super().__init__()
        self._init(locals())

    def get_transform(self, image):
        h, w = image.shape[:2]
        out_h, out_w = self.crop_size
        u = self._random.uniform(0.0, 1.0)
        y0 = int(round(max(h - out_h, 0) * u))
        x0 = int(round(max(w - out_w, 0) * u))
        crop = CropTransform(x0, y0, min(out_w, w - x0), min(out_h, h - y0), w, h)
        if not self.pad:
            return TransformList([crop])
        ch, cw = min(h, out_h), min(w, out_w)
        pad = PadTransform(0, 0, max(out_w - w, 0), max(out_h - h, 0), cw, ch, self.pad_value)
        return TransformList([crop, pad])


class RandomCrop(Augmentation):
    """A crop of a drawn size at a drawn place: ``crop_type`` "relative"
    (``crop_size`` the fractions of h and w), "relative_range" (fractions
    drawn from ``[crop_size, 1]``), "absolute" (pixels, capped at the image)
    or "absolute_range" (pixels drawn from ``[lo, hi]``)."""

    def __init__(self, crop_type: str, crop_size):
        super().__init__()
        assert crop_type in ["relative_range", "relative", "absolute", "absolute_range"]
        self._init(locals())

    def get_transform(self, image):
        h, w = image.shape[:2]
        croph, cropw = self.get_crop_size((h, w))
        if croph > h or cropw > w:
            raise RuntimeError(f"crop {croph}x{cropw} larger than image {h}x{w} in {self}")
        y0 = int(self._random.randint(h - croph + 1))
        x0 = int(self._random.randint(w - cropw + 1))
        return CropTransform(x0, y0, cropw, croph)

    def get_crop_size(self, image_size):
        """The drawn (crop_h, crop_w)."""
        h, w = image_size
        kind = self.crop_type
        if kind == "relative":
            fh, fw = self.crop_size
        elif kind == "relative_range":
            lo = np.asarray(self.crop_size, dtype=np.float32)
            fh, fw = lo + self._random.rand(2) * (1 - lo)
        elif kind == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        elif kind == "absolute_range":
            lo, hi = self.crop_size
            assert lo <= hi, self.crop_size
            return (
                int(self._random.randint(min(h, lo), min(h, hi) + 1)),
                int(self._random.randint(min(w, lo), min(w, hi) + 1)),
            )
        else:
            raise NotImplementedError(f"Unknown crop type {kind}")
        return int(h * fh + 0.5), int(w * fw + 0.5)


class RandomCrop_CategoryAreaConstraint(Augmentation):
    """A :class:`RandomCrop` drawn again, up to 10 times, until no single
    category of the crop's semantic labels (``ignored_category`` left out)
    covers ``single_category_max_area`` of it or more and it holds more than
    one; the last draw stands if none does. With
    ``single_category_max_area`` 1.0 it is the plain crop. The crop and
    its place draw from this augmentation's ``rng``, as the JAX policy's
    from numpy's global state. (The mapper does not apply it, in either
    package: ROADMAP C.)"""

    def __init__(self, crop_type: str, crop_size, single_category_max_area: float = 1.0, ignored_category=None):
        super().__init__()
        self.crop_aug = RandomCrop(crop_type, crop_size)
        self._init(locals())

    def set_rng(self, rng) -> None:
        super().set_rng(rng)
        self.crop_aug.set_rng(rng)

    def _area_ok(self, window) -> bool:
        labels, counts = np.unique(window, return_counts=True)
        if self.ignored_category is not None:
            counts = counts[labels != self.ignored_category]
        return len(counts) > 1 and counts.max() < counts.sum() * self.single_category_max_area

    def get_transform(self, image, sem_seg):
        if self.single_category_max_area >= 1.0:
            return self.crop_aug.get_transform(image)
        h, w = sem_seg.shape
        for _ in range(10):
            ch, cw = self.crop_aug.get_crop_size((h, w))
            y0 = int(self._random.randint(h - ch + 1))
            x0 = int(self._random.randint(w - cw + 1))
            if self._area_ok(sem_seg[y0 : y0 + ch, x0 : x0 + cw]):
                break
        return CropTransform(x0, y0, cw, ch)
