"""Anchor generation (counterpart of ``detectron2_tpu/modeling/anchor_generator.py``).

Anchors depend only on the feature map sizes and strides: they are computed
with numpy in float32, exactly as the JAX package does, and cached on the
device per grid size. Ordering is (H, W, A) flattened with A fastest.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DefaultAnchorGenerator", "build_anchor_generator"]


def _broadcast_params(params, num_features: int, name: str):
    assert isinstance(params, Sequence) and len(params), f"{name} must be a non-empty list, got {params}"
    if not isinstance(params[0], Sequence):
        return [list(params)] * num_features
    if len(params) == 1:
        return list(params) * num_features
    assert len(params) == num_features, f"{name}: {len(params)} entries for {num_features} feature maps"
    return [list(p) for p in params]


class DefaultAnchorGenerator:
    """Anchors as described in "Faster R-CNN"."""

    box_dim = 4

    def __init__(self, *, sizes, aspect_ratios, strides, offset: float = 0.5):
        self.strides = list(strides)
        n = len(self.strides)
        sizes = _broadcast_params(sizes, n, "sizes")
        aspect_ratios = _broadcast_params(aspect_ratios, n, "aspect_ratios")
        self.cell_anchors = [self._cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)]
        assert 0.0 <= offset < 1.0, offset
        self.offset = offset
        self._cache: Dict[Tuple, List[torch.Tensor]] = {}

    @property
    def num_anchors(self) -> List[int]:
        return [len(c) for c in self.cell_anchors]

    @staticmethod
    def _cell_anchors(sizes, aspect_ratios) -> np.ndarray:
        anchors = []
        for size in sizes:
            area = size**2.0
            for aspect_ratio in aspect_ratios:
                w = math.sqrt(area / aspect_ratio)
                h = aspect_ratio * w
                anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
        return np.asarray(anchors, dtype=np.float32)

    def __call__(self, grid_sizes: List[Tuple[int, int]], device) -> List[torch.Tensor]:
        """Per level ``[H*W*A, 4]`` float32 anchors on ``device``."""
        key = (tuple(grid_sizes), str(device))
        if key not in self._cache:
            out = []
            for (H, W), stride, base in zip(grid_sizes, self.strides, self.cell_anchors):
                shift_x = (np.arange(W, dtype=np.float32) + self.offset) * stride
                shift_y = (np.arange(H, dtype=np.float32) + self.offset) * stride
                sx, sy = np.meshgrid(shift_x, shift_y)
                shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
                a = (shifts + base[None, :, :]).reshape(-1, 4)
                out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
            self._cache[key] = out
        return self._cache[key]


def build_anchor_generator(cfg, strides) -> DefaultAnchorGenerator:
    name = cfg.MODEL.ANCHOR_GENERATOR.NAME
    if name != "DefaultAnchorGenerator":
        raise NotImplementedError(f"anchor generator {name!r} is not ported yet (ROADMAP A9)")
    return DefaultAnchorGenerator(
        sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
        aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
        strides=strides,
        offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
    )
