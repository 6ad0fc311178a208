"""Augmentation policies (counterpart of
``detectron2_tpu/data/transforms/augmentation_impl.py``): ``RandomApply``
:59, ``RandomFlip`` :81, ``ResizeShortestEdge`` :114 in its "choice" and
"range" styles, and ``RandomCrop`` :210 in its four styles. Each draws what
the JAX policy draws, in the same order, from its ``rng``
(:class:`Augmentation`). LSJ (``ResizeScale``, ``FixedSizeCrop``), the
color augmentations and the rotations wait for ViTDet training (ROADMAP A8).
"""

import sys
from typing import Tuple

import numpy as np

from detectron2_tpu_torch.data.transforms.augmentation import Augmentation, _transform_to_aug
from detectron2_tpu_torch.data.transforms.transform import (
    CropTransform,
    HFlipTransform,
    NoOpTransform,
    ResizeTransform,
    VFlipTransform,
)

__all__ = ["RandomApply", "RandomCrop", "RandomFlip", "ResizeShortestEdge"]


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
