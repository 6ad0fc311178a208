"""StandardROIHeads (counterpart of
``detectron2_tpu/modeling/roi_heads/roi_heads.py:170``).

Inference. Box branch: pool 7x7 over every proposal slot, box head, Fast
R-CNN decode and per-class NMS to a fixed number of detections. Mask branch:
pool 14x14 over those detection slots, mask head, class channel, sigmoid.

Training, on the padded gt ``{gt_boxes [B,G,4], gt_classes [B,G],
gt_valid [B,G], gt_masks [B,G,Ms,Ms]}`` (each gt mask rasterized inside its
own box): the gt is appended to the proposals, every image's proposals are
matched and sampled to exactly ``batch_size_per_image`` slots, the box
branch runs on all of them and the mask branch on a fixed foreground budget
of ``batch_size_per_image * positive_fraction`` slots, with the mask targets
cropped from the gt masks on the device (``roi_align_separable``).
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.poolers import ROIPooler
from detectron2_tpu_torch.modeling.proposal_generator.proposal_utils import add_ground_truth_to_proposals_padded
from detectron2_tpu_torch.modeling.roi_heads.box_head import build_box_head
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers
from detectron2_tpu_torch.modeling.roi_heads.mask_head import build_mask_head, mask_rcnn_inference, mask_rcnn_loss
from detectron2_tpu_torch.modeling.sampling import subsample_labels_padded
from detectron2_tpu_torch.ops.nms import pairwise_iou
from detectron2_tpu_torch.ops.roi_align import roi_align_separable
from detectron2_tpu_torch.ops.topk import top_k

__all__ = [
    "StandardROIHeads",
    "build_roi_heads",
    "label_and_sample_proposals_padded",
    "select_foreground_slots",
    "crop_gt_masks_to_proposals",
]


def label_and_sample_proposals_padded(
    proposal_boxes: torch.Tensor,
    proposal_valid: torch.Tensor,
    targets: Dict[str, torch.Tensor],
    matcher: Matcher,
    num_samples: int,
    positive_fraction: float,
    num_classes: int,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Match every image's proposals ``[B, P, 4]`` to its gt and sample
    ``num_samples`` slots. Returns ``[B, S, ...]``: boxes, gt_classes (-1 on
    an invalid slot, ``num_classes`` on background), gt_idx, valid, is_fg."""
    iou = pairwise_iou(targets["gt_boxes"].float(), proposal_boxes) * proposal_valid[:, None, :].float()
    matched_idx, matched_labels = matcher(iou, gt_valid=targets["gt_valid"])
    gt_cls = torch.gather(targets["gt_classes"].long(), 1, matched_idx)
    cls = torch.where(matched_labels == 1, gt_cls, torch.full_like(gt_cls, num_classes))
    samp_labels = torch.where(proposal_valid, (matched_labels == 1).long(), torch.full_like(gt_cls, -1))
    samp_labels = torch.where(matched_labels == -1, torch.full_like(samp_labels, -1), samp_labels)
    idx, sel_valid, is_fg = subsample_labels_padded(
        samp_labels, num_samples, positive_fraction, bg_label=0, generator=generator
    )
    out_cls = torch.where(sel_valid, torch.gather(cls, 1, idx), torch.full_like(idx, -1))
    return {
        "boxes": torch.gather(proposal_boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "gt_classes": out_cls,
        "gt_idx": torch.gather(matched_idx, 1, idx),
        "valid": sel_valid,
        "is_fg": is_fg & (out_cls >= 0) & (out_cls < num_classes),
    }


def select_foreground_slots(is_fg: torch.Tensor, budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``budget`` foreground slots of each row of ``is_fg`` ``[B, S]``,
    in slot order: (indices, valid) ``[B, budget]``."""
    S = is_fg.shape[-1]
    order = torch.arange(S, dtype=torch.float32, device=is_fg.device)
    priority = is_fg.float() * 2.0 - order / torch.full_like(order, S)
    _, idx = top_k(priority, budget)
    return idx, torch.gather(is_fg, -1, idx)


def crop_gt_masks_to_proposals(
    gt_masks: torch.Tensor,
    gt_boxes: torch.Tensor,
    matched_gt_idx: torch.Tensor,
    proposal_boxes: torch.Tensor,
    mask_size: int,
) -> torch.Tensor:
    """``[B, R, mask_size, mask_size]`` {0, 1} float targets: each
    proposal's crop of its matched gt mask. The gt masks ``[B, G, Ms, Ms]``
    are rasterized inside their boxes ``[B, G, 4]``, so each proposal box is
    mapped into its gt box's mask frame and RoIAligned there (aligned,
    sampling ratio 2), then thresholded at 0.5."""
    B, G, Ms = gt_masks.shape[:3]
    R = matched_gt_idx.shape[1]
    g = torch.gather(gt_boxes.float(), 1, matched_gt_idx[..., None].expand(-1, -1, 4))
    gw = (g[..., 2] - g[..., 0]).clamp_min(1e-4)
    gh = (g[..., 3] - g[..., 1]).clamp_min(1e-4)
    p = proposal_boxes.float()
    boxes_in_mask = torch.stack(
        [
            (p[..., 0] - g[..., 0]) / gw * Ms,
            (p[..., 1] - g[..., 1]) / gh * Ms,
            (p[..., 2] - g[..., 0]) / gw * Ms,
            (p[..., 3] - g[..., 1]) / gh * Ms,
        ],
        dim=-1,
    )
    src = matched_gt_idx + torch.arange(B, device=matched_gt_idx.device)[:, None] * G
    crops = roi_align_separable(
        gt_masks.reshape(B * G, Ms, Ms), boxes_in_mask.reshape(-1, 4), src.reshape(-1),
        (mask_size, mask_size), sampling_ratio=2, aligned=True,
    )
    return (crops >= 0.5).float().reshape(B, R, mask_size, mask_size)


class StandardROIHeads(nn.Module):
    def __init__(
        self,
        *,
        in_features,
        box_pooler: ROIPooler,
        box_head: nn.Module,
        box_predictor: FastRCNNOutputLayers,
        proposal_matcher: Matcher,
        mask_pooler: ROIPooler = None,
        mask_head: nn.Module = None,
        num_classes: int = 80,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.box_pooler = box_pooler
        self.box_head = box_head
        self.box_predictor = box_predictor
        self.mask_pooler = mask_pooler
        self.mask_head = mask_head
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_matcher = proposal_matcher
        self.proposal_append_gt = proposal_append_gt

    @property
    def fg_budget(self) -> int:
        """Mask-branch slots per image: the sampler's cap on positives."""
        return max(1, int(self.batch_size_per_image * self.positive_fraction))

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposal_boxes: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_sizes: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        feats = [features[f] for f in self.in_features]
        B, P = proposal_boxes.shape[:2]
        batch_idx = torch.arange(B, dtype=torch.int32, device=proposal_boxes.device).repeat_interleave(P)
        pooled = self.box_pooler(feats, proposal_boxes.reshape(-1, 4), batch_idx)
        predictions = self.box_predictor(self.box_head(pooled))
        detections = self.box_predictor.inference(predictions, proposal_boxes, proposal_valid, image_sizes)
        if self.mask_head is not None:
            detections = self._forward_mask(feats, detections)
        return detections

    def forward_train(
        self,
        features: Dict[str, torch.Tensor],
        proposal_boxes: torch.Tensor,
        proposal_logits: torch.Tensor,
        proposal_valid: torch.Tensor,
        targets: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Losses ``loss_cls``, ``loss_box_reg`` and, with a mask head,
        ``loss_mask``, from detached proposals ``[B, P, 4]`` and the padded
        gt; the proposal sampler draws from ``generator``."""
        feats = [features[f] for f in self.in_features]
        if self.proposal_append_gt:
            proposal_boxes, proposal_logits, proposal_valid = add_ground_truth_to_proposals_padded(
                targets["gt_boxes"], targets["gt_valid"], proposal_boxes, proposal_logits, proposal_valid
            )
        sampled = label_and_sample_proposals_padded(
            proposal_boxes, proposal_valid, targets, self.proposal_matcher, self.batch_size_per_image,
            self.positive_fraction, self.num_classes, generator,
        )
        losses = self._forward_box_train(feats, sampled, targets)
        if self.mask_head is not None:
            losses.update(self._forward_mask_train(feats, sampled, targets))
        return losses

    def _forward_box_train(self, feats, sampled, targets):
        B, S = sampled["gt_classes"].shape
        boxes_flat = sampled["boxes"].reshape(-1, 4)
        batch_idx = torch.arange(B, dtype=torch.int32, device=boxes_flat.device).repeat_interleave(S)
        predictions = self.box_predictor(self.box_head(self.box_pooler(feats, boxes_flat, batch_idx)))
        gt_boxes = torch.gather(targets["gt_boxes"].float(), 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
        return self.box_predictor.losses(
            predictions, boxes_flat, gt_boxes.reshape(-1, 4), sampled["gt_classes"].reshape(-1)
        )

    def _forward_mask_train(self, feats, sampled, targets):
        B = sampled["gt_classes"].shape[0]
        Rf = self.fg_budget
        fg_idx, fg_valid = select_foreground_slots(sampled["is_fg"], Rf)  # [B, Rf]
        fg_boxes = torch.gather(sampled["boxes"], 1, fg_idx[..., None].expand(-1, -1, 4))
        fg_cls = torch.gather(sampled["gt_classes"], 1, fg_idx)
        fg_gt_idx = torch.gather(sampled["gt_idx"], 1, fg_idx)
        batch_idx = torch.arange(B, dtype=torch.int32, device=fg_boxes.device).repeat_interleave(Rf)
        mask_logits = self.mask_head(self.mask_pooler(feats, fg_boxes.reshape(-1, 4), batch_idx))
        M = mask_logits.shape[1]
        gt_targets = crop_gt_masks_to_proposals(targets["gt_masks"], targets["gt_boxes"], fg_gt_idx, fg_boxes, M)
        loss = mask_rcnn_loss(mask_logits, fg_cls.reshape(-1), gt_targets.reshape(-1, M, M), fg_valid.reshape(-1))
        return {"loss_mask": loss}

    def _forward_mask(self, feats, detections):
        B, D = detections["pred_classes"].shape
        batch_idx = torch.arange(B, dtype=torch.int32, device=feats[0].device).repeat_interleave(D)
        pooled = self.mask_pooler(feats, detections["pred_boxes"].reshape(-1, 4), batch_idx)
        probs = mask_rcnn_inference(self.mask_head(pooled), detections["pred_classes"].reshape(-1))
        M = probs.shape[-1]
        detections["pred_masks"] = probs.reshape(B, D, M, M)
        return detections


def build_roi_heads(cfg, input_shape: Dict[str, ShapeSpec]) -> StandardROIHeads:
    if cfg.MODEL.ROI_HEADS.NAME != "StandardROIHeads":
        raise NotImplementedError(f"ROI heads {cfg.MODEL.ROI_HEADS.NAME!r} are not ported yet")
    if cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError("MODEL.KEYPOINT_ON: the keypoint head is not ported yet (ROADMAP A7)")
    in_features = cfg.MODEL.ROI_HEADS.IN_FEATURES
    scales = tuple(1.0 / input_shape[f].stride for f in in_features)
    channels = input_shape[in_features[0]].channels
    bh = cfg.MODEL.ROI_BOX_HEAD
    rh = cfg.MODEL.ROI_HEADS
    unported = {
        "ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE": bh.BBOX_REG_LOSS_TYPE != "smooth_l1",
        "ROI_BOX_HEAD.USE_SIGMOID_CE": bh.USE_SIGMOID_CE,
        "ROI_BOX_HEAD.USE_FED_LOSS": bh.USE_FED_LOSS,
        "ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES": bh.TRAIN_ON_PRED_BOXES,
    }
    for key, on in unported.items():
        if on:
            raise NotImplementedError(f"MODEL.{key} is not ported yet")
    box_head = build_box_head(cfg, channels)
    box_predictor = FastRCNNOutputLayers(
        box_head.output_dim,
        cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        box2box_weights=bh.BBOX_REG_WEIGHTS,
        cls_agnostic_bbox_reg=bh.CLS_AGNOSTIC_BBOX_REG,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        smooth_l1_beta=bh.SMOOTH_L1_BETA,
        loss_weight_box=bh.BBOX_REG_LOSS_WEIGHT,
    )
    # both poolers take the box head's sampling ratio and type, as the JAX
    # StandardROIHeads does
    pool = lambda res: ROIPooler(res, scales, bh.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE)  # noqa: E731
    mask_on = cfg.MODEL.MASK_ON
    return StandardROIHeads(
        in_features=in_features,
        box_pooler=pool(bh.POOLER_RESOLUTION),
        box_head=box_head,
        box_predictor=box_predictor,
        mask_pooler=pool(cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION) if mask_on else None,
        mask_head=build_mask_head(cfg, channels) if mask_on else None,
        num_classes=rh.NUM_CLASSES,
        batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE,
        positive_fraction=rh.POSITIVE_FRACTION,
        proposal_matcher=Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS, allow_low_quality_matches=False),
        proposal_append_gt=rh.PROPOSAL_APPEND_GT,
    )
