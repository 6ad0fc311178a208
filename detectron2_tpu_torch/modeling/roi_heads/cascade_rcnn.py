"""Cascade R-CNN heads (counterpart of
``detectron2_tpu/modeling/roi_heads/cascade_rcnn.py``).

Three stages of pool -> box head -> class-agnostic predictor, each with its
own decode weights; each stage's boxes, decoded and clipped to the image,
are the next stage's proposals.

Inference: the class probabilities are averaged over the stages and the
last stage's boxes go through the padded Fast R-CNN inference, then the
mask and keypoint branches run on the detections.

Training (JAX ``cascade_rcnn.py:147-210,241-261``): stage 0 matches the
proposals (with the gt appended) at its IoU and samples
``batch_size_per_image`` slots; each later stage rematches the previous
stage's refined boxes (detached) at its own IoU, without sampling again.
Every stage's pooled features pass :class:`_ScaleGradient`, which scales
their gradient by 1 / stages, and each stage adds
``{loss_cls, loss_box_reg}_stage{k}``. The mask and keypoint losses are
computed on the last stage's slots: boxes refined by the stages before it
and labelled at the last IoU (0.7 in the zoo configs). This follows the
JAX package, the reference of this port; d2's ``CascadeROIHeads.forward``
gives ``_forward_mask`` / ``_forward_keypoint`` the stage-0 proposals
labelled at 0.5 instead (ROADMAP section C, reference-side quirks).
"""

from typing import Dict, Optional

import torch
from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.proposal_generator.proposal_utils import add_ground_truth_to_proposals_padded
from detectron2_tpu_torch.modeling.roi_heads.box_head import build_box_head
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_inference_padded
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    StandardROIHeads,
    _batch_index,
    build_box_predictor,
    label_and_sample_proposals_padded,
)
from detectron2_tpu_torch.ops.nms import pairwise_iou

__all__ = ["CascadeROIHeads"]


class _ScaleGradient(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by ``scale``
    (JAX ``_scale_gradient``, :39-51)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float) -> torch.Tensor:
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad * ctx.scale, None


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
            cfg, input_shape, box_head=nn.ModuleList(heads), box_predictor=nn.ModuleList(predictors),
            cascade_ious=ious,
        )

    def __init__(self, *, cascade_ious=(0.5, 0.6, 0.7), **kwargs):
        super().__init__(**kwargs)
        self.cascade_ious = tuple(cascade_ious)

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
            predictions = self.box_predictor[k](self.box_head[k](self.box_pooler(feats, boxes, batch_idx), False))
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

    def _run_stage(self, stage: int, feats, boxes: torch.Tensor, batch_idx: torch.Tensor, train: bool):
        """Pool, scale the gradient by 1 / stages, box head, predictor."""
        pooled = _ScaleGradient.apply(self.box_pooler(feats, boxes, batch_idx), 1.0 / self.num_cascade_stages)
        return self.box_predictor[stage](self.box_head[stage](pooled, train))

    def forward_train(
        self,
        features: Dict[str, torch.Tensor],
        proposal_boxes: torch.Tensor,
        proposal_logits: torch.Tensor,
        proposal_valid: torch.Tensor,
        targets: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        image_sizes: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """``{loss_cls, loss_box_reg}_stage{k}`` for every stage, and the
        mask and keypoint losses on the last stage's slots. The refined
        boxes are clipped to ``image_sizes`` ``[B, 2]`` (h, w)."""
        feats = [features[f] for f in self.in_features]
        if self.proposal_append_gt:
            proposal_boxes, proposal_logits, proposal_valid = add_ground_truth_to_proposals_padded(
                targets["gt_boxes"], targets["gt_valid"], proposal_boxes, proposal_logits, proposal_valid
            )
        B = proposal_boxes.shape[0]
        S = self.batch_size_per_image
        batch_idx = _batch_index(B, S, proposal_boxes.device)
        sizes = image_sizes.repeat_interleave(S, dim=0)
        losses, sampled, boxes = {}, None, None
        for k, iou in enumerate(self.cascade_ious):
            matcher = Matcher([iou], [0, 1], allow_low_quality_matches=False)
            if k == 0:
                sampled = label_and_sample_proposals_padded(
                    proposal_boxes, proposal_valid, targets, matcher, S, self.positive_fraction, self.num_classes,
                    generator,
                )
            else:
                sampled = self._rematch_only(boxes.reshape(B, S, 4), sampled["valid"], targets, matcher)
            boxes_flat = sampled["boxes"].reshape(-1, 4)
            predictions = self._run_stage(k, feats, boxes_flat, batch_idx, True)
            gt_boxes = torch.gather(targets["gt_boxes"].float(), 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
            stage_losses = self.box_predictor[k].losses(
                predictions, boxes_flat, gt_boxes.reshape(-1, 4), sampled["gt_classes"].reshape(-1)
            )
            losses.update({f"{name}_stage{k}": v for name, v in stage_losses.items()})
            boxes = self._refine_boxes(k, predictions, boxes_flat, sizes).detach()
        losses.update(self._forward_mask_keypoint_train(feats, sampled, targets))
        return losses

    def _rematch_only(self, boxes: torch.Tensor, valid: torch.Tensor, targets, matcher: Matcher):
        """Stages > 0: the refined boxes ``[B, S, 4]`` matched against the gt
        at the stage's IoU, every slot kept (JAX :241-261)."""
        iou = pairwise_iou(targets["gt_boxes"].float(), boxes) * valid[:, None, :].float()
        matched_idx, matched_labels = matcher(iou, gt_valid=targets["gt_valid"])
        gt_cls = torch.gather(targets["gt_classes"].long(), 1, matched_idx)
        cls = torch.where(matched_labels == 1, gt_cls, torch.full_like(gt_cls, self.num_classes))
        cls = torch.where(valid, cls, torch.full_like(cls, -1))
        return {
            "boxes": boxes,
            "gt_classes": cls,
            "gt_idx": matched_idx,
            "valid": valid,
            "is_fg": (cls >= 0) & (cls < self.num_classes),
        }
