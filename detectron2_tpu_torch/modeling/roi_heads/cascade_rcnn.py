"""Cascade R-CNN heads, inference (counterpart of
``detectron2_tpu/modeling/roi_heads/cascade_rcnn.py:55-240``).

Three stages of pool -> box head -> class-agnostic predictor, each with its
own decode weights; each stage's boxes, decoded and clipped to the image,
are the next stage's proposals. The class probabilities are averaged over
the stages and the last stage's boxes go through the padded Fast R-CNN
inference, then the mask and keypoint branches run on the detections. The
training half (per-stage rematching, the 1/stages gradient scale of the
JAX package's ``_scale_gradient``) waits for the cascade train path
(ROADMAP A7).
"""

from typing import Dict

import torch
from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.modeling.roi_heads.box_head import build_box_head
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_inference_padded
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    StandardROIHeads,
    _batch_index,
    build_box_predictor,
)

__all__ = ["CascadeROIHeads"]


@ROI_HEADS_REGISTRY.register()
class CascadeROIHeads(StandardROIHeads):
    """StandardROIHeads whose ``box_head`` and ``box_predictor`` are
    ModuleLists of one module per stage (d2's ``box_head.{k}``,
    ``box_predictor.{k}``)."""

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "CascadeROIHeads":
        ious = cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS
        weights = cfg.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS
        assert len(ious) == len(weights), (ious, weights)
        channels = input_shape[cfg.MODEL.ROI_HEADS.IN_FEATURES[0]].channels
        heads = [build_box_head(cfg, channels) for _ in ious]
        # every stage's predictor is class-agnostic with the stage's decode
        # weights (d2 cascade_rcnn.py:120-139)
        predictors = [
            build_box_predictor(cfg, h.output_dim, cls_agnostic_bbox_reg=True, box2box_weights=tuple(w))
            for h, w in zip(heads, weights)
        ]
        return super().from_config(
            cfg, input_shape, box_head=nn.ModuleList(heads), box_predictor=nn.ModuleList(predictors)
        )

    @property
    def num_cascade_stages(self) -> int:
        return len(self.box_head)

    def _refine_boxes(self, stage: int, predictions, boxes: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
        """The stage's decoded boxes ``[R, 4]`` clipped to each roi's image
        ``image_sizes`` ``[R, 2]`` (h, w): the next stage's proposals."""
        new = self.box_predictor[stage].predict_boxes(predictions, boxes)[:, 0]
        zero = torch.zeros((), dtype=new.dtype, device=new.device)
        h = image_sizes[:, 0].to(new.dtype)
        w = image_sizes[:, 1].to(new.dtype)
        return torch.stack(
            [
                torch.minimum(torch.maximum(new[:, 0], zero), w),
                torch.minimum(torch.maximum(new[:, 1], zero), h),
                torch.minimum(torch.maximum(new[:, 2], zero), w),
                torch.minimum(torch.maximum(new[:, 3], zero), h),
            ],
            dim=-1,
        )

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposal_boxes: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_sizes: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        feats = [features[f] for f in self.in_features]
        B, P = proposal_boxes.shape[:2]
        boxes = proposal_boxes.reshape(-1, 4)
        batch_idx = _batch_index(B, P, boxes.device)
        sizes = image_sizes.repeat_interleave(P, dim=0)
        probs, predictions = [], None
        for k in range(self.num_cascade_stages):
            if k > 0:
                boxes = self._refine_boxes(k - 1, predictions, boxes, sizes)
            predictions = self.box_predictor[k](self.box_head[k](self.box_pooler(feats, boxes, batch_idx)))
            probs.append(self.box_predictor[k].predict_probs(predictions))
        # the stages' class probabilities averaged (d2 cascade_rcnn.py:188-194)
        scores = sum(probs) / self.num_cascade_stages
        last = self.box_predictor[-1]
        detections = fast_rcnn_inference_padded(
            last.predict_boxes(predictions, boxes).reshape(B, P, -1, 4),
            scores.reshape(B, P, -1),
            proposal_valid,
            image_sizes,
            last.test_score_thresh,
            last.test_nms_thresh,
            last.test_topk_per_image,
        )
        return self.forward_with_given_boxes(features, detections)

    def forward_train(self, *args, **kwargs):
        raise NotImplementedError("CascadeROIHeads training is not ported yet (ROADMAP A7)")
