"""The test-time augmentation (``ResizeShortestEdge`` of
``detectron2_tpu/data/transforms/augmentation_impl.py``). The training
augmentations wait for the train half of the data path (ROADMAP A2)."""

import sys
from typing import Tuple

import numpy as np

from detectron2_tpu_torch.data.transforms.augmentation import Augmentation
from detectron2_tpu_torch.data.transforms.transform import NoOpTransform, ResizeTransform

__all__ = ["ResizeShortestEdge"]


class ResizeShortestEdge(Augmentation):
    """Resize so the shorter edge hits a target, capping the longer edge:
    the COCO standard policy. ``sample_style`` "range" draws the target from
    ``[lo, hi]``, "choice" from the given lengths, with ``np.random``."""

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
            return int(np.random.randint(lo_hi[0], lo_hi[1] + 1))
        return int(np.random.choice(lo_hi))

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
