"""PointRend semantic segmentation head (counterpart of the JAX package's
``projects/point_rend/semantic_seg.py``), registered in
``SEM_SEG_HEADS_REGISTRY``.

A coarse per-pixel head (``POINT_HEAD.COARSE_SEM_SEG_HEAD_NAME``, d2's
``sem_seg_head.coarse_sem_seg_head``) refined by a point head over the
``POINT_HEAD.IN_FEATURES`` maps and the coarse logits at each point:

- training: the coarse head's loss, and ``loss_sem_seg_point``, the cross
  entropy at ``TRAIN_NUM_POINTS`` points drawn by uncertainty (the top-2
  logit margin) against the nearest target pixel, ``IGNORE_VALUE`` left out;
- inference: ``SUBDIVISION_STEPS`` rounds of a 2x bilinear upsample and the
  point head at the ``SUBDIVISION_NUM_POINTS`` most uncertain cells, then
  the rest of the way to the input's stride.
"""

from typing import Dict, Optional

import torch
from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.layers.losses import cross_entropy
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import SEM_SEG_HEADS_REGISTRY, upsample_bilinear
from detectron2_tpu_torch.projects.point_rend.point_features import (
    get_uncertain_point_coords_on_grid,
    point_sample,
    sample_uncertain_points,
)
from detectron2_tpu_torch.projects.point_rend.point_head import build_point_head

__all__ = ["PointRendSemSegHead", "calculate_uncertainty_sem_seg"]


def calculate_uncertainty_sem_seg(logits: torch.Tensor) -> torch.Tensor:
    """The top-2 logit margin over the last dim, negated: ``[...]``, most
    uncertain near 0."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 1] - top2[..., 0]


@SEM_SEG_HEADS_REGISTRY.register()
class PointRendSemSegHead(nn.Module):
    def __init__(self, coarse_sem_seg_head: nn.Module, point_head: nn.Module, in_features, train_num_points: int = 1024,
                 oversample_ratio: int = 3, importance_sample_ratio: float = 0.75, subdivision_steps: int = 2,
                 subdivision_num_points: int = 8192, common_stride: int = 4, ignore_value: int = 255):
        super().__init__()
        self.coarse_sem_seg_head = coarse_sem_seg_head
        self.point_head = point_head
        self.in_features = tuple(in_features)
        self.train_num_points = train_num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.common_stride = common_stride
        self.ignore_value = ignore_value

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "PointRendSemSegHead":
        ph, sh = cfg.MODEL.POINT_HEAD, cfg.MODEL.SEM_SEG_HEAD
        assert sh.NUM_CLASSES == ph.NUM_CLASSES
        coarse = SEM_SEG_HEADS_REGISTRY.get(ph.COARSE_SEM_SEG_HEAD_NAME).from_config(cfg, input_shape)
        return cls(
            coarse, build_point_head(cfg, sum(input_shape[f].channels for f in ph.IN_FEATURES)), ph.IN_FEATURES,
            ph.TRAIN_NUM_POINTS, ph.OVERSAMPLE_RATIO, ph.IMPORTANCE_SAMPLE_RATIO, ph.SUBDIVISION_STEPS,
            ph.SUBDIVISION_NUM_POINTS, sh.COMMON_STRIDE, sh.IGNORE_VALUE,
        )

    def _point_logits(self, features, coarse_logits, coords):
        fine = torch.cat([point_sample(features[f], coords) for f in self.in_features], dim=-1)
        return self.point_head(fine, point_sample(coarse_logits, coords))

    def forward(self, features: Dict[str, torch.Tensor], targets: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``(None, losses)`` in training (the points drawn from
        ``generator``), else ``(logits [B, H, W, C] float32 at the input's
        stride, {})``."""
        coarse_logits = self.coarse_sem_seg_head.layers(features, train)
        if train:
            assert targets is not None, "training needs gt_sem_seg"
            losses = self.coarse_sem_seg_head.losses(coarse_logits, targets)
            coords = sample_uncertain_points(
                calculate_uncertainty_sem_seg, coarse_logits.detach(), self.train_num_points, self.oversample_ratio,
                self.importance_sample_ratio, generator,
            )
            point_logits = self._point_logits(features, coarse_logits, coords)
            point_targets = point_sample(targets[..., None].float(), coords, mode="nearest")[..., 0].long()
            losses["loss_sem_seg_point"] = cross_entropy(point_logits, point_targets, "mean", self.ignore_value)
            return None, losses
        logits = coarse_logits
        for _ in range(self.subdivision_steps):
            logits = upsample_bilinear(logits, 2)
            B, H, W, C = logits.shape
            idx, coords = get_uncertain_point_coords_on_grid(calculate_uncertainty_sem_seg(logits), self.subdivision_num_points)
            point_logits = self._point_logits(features, coarse_logits, coords)
            flat = logits.reshape(B, H * W, C).scatter(1, idx[..., None].expand(-1, -1, C), point_logits.to(logits.dtype))
            logits = flat.reshape(B, H, W, C)
        remaining = self.common_stride // 2**self.subdivision_steps
        if remaining > 1:
            logits = upsample_bilinear(logits, remaining)
        return logits, {}
