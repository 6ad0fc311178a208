"""StandardROIHeads and Res5ROIHeads (counterpart of
``detectron2_tpu/modeling/roi_heads/roi_heads.py``: StandardROIHeads :170,
Res5ROIHeads :431), registered by name in ``ROI_HEADS_REGISTRY``.

Inference. Box branch: pool 7x7 over every proposal slot, box head, Fast
R-CNN decode and per-class NMS to a fixed number of detections. Then
``forward_with_given_boxes`` on those detection slots (or on boxes a caller
gives, as test-time augmentation does): the mask branch pools 14x14, runs
the mask head and takes each class channel through a sigmoid; the keypoint
branch pools 14x14, runs the keypoint head and decodes its heatmaps. The C4
heads pool 14x14 from ``res4`` once and run the res5 stage, built inside the
heads, for the box predictor (a mean over the 7x7 output) and again on the
detections for the mask head.

Training, on the padded gt ``{gt_boxes [B,G,4], gt_classes [B,G],
gt_valid [B,G], gt_masks [B,G,Ms,Ms], gt_keypoints [B,G,K,3]}`` (each gt
mask rasterized inside its own box): the gt is appended to the proposals,
every image's proposals are matched and sampled to exactly
``batch_size_per_image`` slots, the box branch runs on all of them and the
mask and keypoint branches on a fixed foreground budget of
``batch_size_per_image * positive_fraction`` slots, with the mask targets
cropped from the gt masks on the device (``roi_align_separable``) and the
keypoint targets binned on the device (``_keypoints_to_heatmap``). The C4
heads pool ``res4`` once over the sampled slots and run res5 once: the box
losses read the mean of its output, the mask loss its foreground-budget
rows (JAX ``roi_heads.py:512-571``).
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from detectron2_tpu_torch.data.detection_utils import get_fed_loss_cls_weights
from detectron2_tpu_torch.layers import ShapeSpec, nchw
from detectron2_tpu_torch.modeling.backbone.resnet import BottleneckBlock
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.poolers import ROIPooler
from detectron2_tpu_torch.modeling.proposal_generator.proposal_utils import add_ground_truth_to_proposals_padded
from detectron2_tpu_torch.modeling.roi_heads.box_head import build_box_head
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers
from detectron2_tpu_torch.modeling.roi_heads.keypoint_head import (
    build_keypoint_head,
    keypoint_rcnn_inference,
    keypoint_rcnn_loss,
)
from detectron2_tpu_torch.modeling.roi_heads.mask_head import build_mask_head, mask_rcnn_inference, mask_rcnn_loss
from detectron2_tpu_torch.modeling.sampling import subsample_labels_padded
from detectron2_tpu_torch.ops.nms import pairwise_iou
from detectron2_tpu_torch.ops.roi_align import roi_align_separable
from detectron2_tpu_torch.ops.topk import top_k
from detectron2_tpu_torch.utils.registry import Registry

ROI_HEADS_REGISTRY = Registry("ROI_HEADS")

__all__ = [
    "ROI_HEADS_REGISTRY",
    "StandardROIHeads",
    "Res5ROIHeads",
    "build_roi_heads",
    "build_box_predictor",
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


def _batch_index(B: int, n: int, device) -> torch.Tensor:
    """``[B * n]`` int32 image index of each of ``n`` slots per image."""
    return torch.arange(B, dtype=torch.int32, device=device).repeat_interleave(n)


def _foreground(sampled: Dict[str, torch.Tensor], budget: int) -> Dict[str, torch.Tensor]:
    """The mask and keypoint branches' slots: up to ``budget`` foreground
    slots of each image of ``sampled``, ``[B, budget, ...]``: their index,
    validity, boxes, classes and matched gt index."""
    idx, valid = select_foreground_slots(sampled["is_fg"], budget)
    return {
        "idx": idx,
        "valid": valid,
        "boxes": torch.gather(sampled["boxes"], 1, idx[..., None].expand(-1, -1, 4)),
        "gt_classes": torch.gather(sampled["gt_classes"], 1, idx),
        "gt_idx": torch.gather(sampled["gt_idx"], 1, idx),
    }


def _mask_loss(mask_logits: torch.Tensor, fg: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mask loss of the foreground slots ``fg`` (:func:`_foreground`)
    from their logits ``[B * budget, M, M, classes]``."""
    M = mask_logits.shape[1]
    gt_targets = crop_gt_masks_to_proposals(targets["gt_masks"], targets["gt_boxes"], fg["gt_idx"], fg["boxes"], M)
    return mask_rcnn_loss(mask_logits, fg["gt_classes"].reshape(-1), gt_targets.reshape(-1, M, M), fg["valid"].reshape(-1))


@ROI_HEADS_REGISTRY.register()
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
        keypoint_pooler: ROIPooler = None,
        keypoint_head: nn.Module = None,
        num_classes: int = 80,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
        normalize_kpt_loss_by_visible: bool = True,
        keypoint_loss_weight: float = 1.0,
        train_on_pred_boxes: bool = False,
    ):
        """``train_on_pred_boxes`` is kept and read nowhere, as in the JAX
        package (``StandardROIHeads.train_on_pred_boxes``): the mask head
        trains on the sampled proposals either way. d2 trains it on the box
        head's predicted boxes instead (ROADMAP C, a known difference)."""
        super().__init__()
        self.in_features = tuple(in_features)
        self.box_pooler = box_pooler
        self.box_head = box_head
        self.box_predictor = box_predictor
        self.mask_pooler = mask_pooler
        self.mask_head = mask_head
        self.keypoint_pooler = keypoint_pooler
        self.keypoint_head = keypoint_head
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_matcher = proposal_matcher
        self.proposal_append_gt = proposal_append_gt
        self.normalize_kpt_loss_by_visible = normalize_kpt_loss_by_visible
        self.keypoint_loss_weight = keypoint_loss_weight
        self.train_on_pred_boxes = train_on_pred_boxes

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec], **kwargs) -> "StandardROIHeads":
        """The heads of ``cfg``; ``kwargs`` replace constructor arguments (a
        subclass passes its own box heads and predictors)."""
        in_features = cfg.MODEL.ROI_HEADS.IN_FEATURES
        channels = input_shape[in_features[0]].channels
        bh = cfg.MODEL.ROI_BOX_HEAD
        if "box_head" not in kwargs:
            kwargs["box_head"] = build_box_head(cfg, channels)
            kwargs["box_predictor"] = build_box_predictor(cfg, kwargs["box_head"].output_dim)
        # every pooler takes the box head's sampling ratio and type, as the
        # JAX StandardROIHeads does
        pool = _pooler_factory(cfg, input_shape)
        mask_on, keypoint_on = cfg.MODEL.MASK_ON, cfg.MODEL.KEYPOINT_ON
        kh = cfg.MODEL.ROI_KEYPOINT_HEAD
        args = dict(
            in_features=in_features,
            box_pooler=pool(bh.POOLER_RESOLUTION),
            mask_pooler=pool(cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION) if mask_on else None,
            mask_head=build_mask_head(cfg, channels) if mask_on else None,
            keypoint_pooler=pool(cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION) if keypoint_on else None,
            keypoint_head=build_keypoint_head(cfg, channels) if keypoint_on else None,
            normalize_kpt_loss_by_visible=kh.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS,
            keypoint_loss_weight=kh.LOSS_WEIGHT,
            train_on_pred_boxes=bh.TRAIN_ON_PRED_BOXES,
            **_matcher_args(cfg),
        )
        args.update(kwargs)
        return cls(**args)

    @property
    def fg_budget(self) -> int:
        """Mask- and keypoint-branch slots per image: the sampler's cap on
        positives."""
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
        batch_idx = _batch_index(B, P, proposal_boxes.device)
        pooled = self.box_pooler(feats, proposal_boxes.reshape(-1, 4), batch_idx)
        predictions = self.box_predictor(self.box_head(pooled, False))
        detections = self.box_predictor.inference(predictions, proposal_boxes, proposal_valid, image_sizes)
        return self.forward_with_given_boxes(features, detections)

    def forward_with_given_boxes(self, features: Dict[str, torch.Tensor], detections: Dict) -> Dict:
        """The mask and keypoint branches on the detections' ``pred_boxes``
        ``[B, D, 4]`` (and ``pred_classes``): adds ``pred_masks`` ``[B, D, M,
        M]`` and ``pred_keypoints`` ``[B, D, K, 4]`` (x, y, logit, prob)."""
        feats = [features[f] for f in self.in_features]
        B, D = detections["pred_classes"].shape
        boxes = detections["pred_boxes"].reshape(-1, 4)
        batch_idx = _batch_index(B, D, boxes.device)
        if self.mask_head is not None:
            probs = mask_rcnn_inference(
                self.mask_head(self.mask_pooler(feats, boxes, batch_idx), False), detections["pred_classes"].reshape(-1)
            )
            detections["pred_masks"] = probs.reshape(B, D, *probs.shape[1:])
        if self.keypoint_head is not None:
            kpts = keypoint_rcnn_inference(self.keypoint_head(self.keypoint_pooler(feats, boxes, batch_idx), False), boxes)
            detections["pred_keypoints"] = kpts.reshape(B, D, *kpts.shape[1:])
        return detections

    def keypoint_logits(self, features: Dict[str, torch.Tensor], boxes: torch.Tensor, batch_idx: torch.Tensor):
        """The keypoint head's raw heatmap logits ``[R, S, S, K]`` on boxes
        ``[R, 4]`` of images ``batch_idx``: the surface before the decode."""
        feats = [features[f] for f in self.in_features]
        return self.keypoint_head(self.keypoint_pooler(feats, boxes, batch_idx), False)

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
        """Losses ``loss_cls``, ``loss_box_reg`` and, with a mask head,
        ``loss_mask``, with a keypoint head ``loss_keypoint``, from detached
        proposals ``[B, P, 4]`` and the padded gt; the proposal sampler
        draws from ``generator``. ``image_sizes`` is for the cascade's
        signature; these heads clip nothing."""
        feats = [features[f] for f in self.in_features]
        if self.proposal_append_gt:
            proposal_boxes, proposal_logits, proposal_valid = add_ground_truth_to_proposals_padded(
                targets["gt_boxes"], targets["gt_valid"], proposal_boxes, proposal_logits, proposal_valid
            )
        sampled = label_and_sample_proposals_padded(
            proposal_boxes, proposal_valid, targets, self.proposal_matcher, self.batch_size_per_image,
            self.positive_fraction, self.num_classes, generator,
        )
        losses = self._forward_box_train(feats, sampled, targets, generator)
        losses.update(self._forward_mask_keypoint_train(feats, sampled, targets))
        return losses

    def _forward_mask_keypoint_train(self, feats, sampled, targets):
        """The mask and keypoint losses of the heads there are, on
        ``sampled``."""
        losses = {}
        fg = _foreground(sampled, self.fg_budget)
        if self.mask_head is not None:
            losses.update(self._forward_mask_train(feats, fg, targets))
        if self.keypoint_head is not None:
            losses.update(self._forward_keypoint_train(feats, fg, targets))
        return losses

    def _forward_box_train(self, feats, sampled, targets, generator):
        B, S = sampled["gt_classes"].shape
        boxes_flat = sampled["boxes"].reshape(-1, 4)
        pooled = self.box_pooler(feats, boxes_flat, _batch_index(B, S, boxes_flat.device))
        predictions = self.box_predictor(self.box_head(pooled, True))
        gt_boxes = torch.gather(targets["gt_boxes"].float(), 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
        return self.box_predictor.losses(
            predictions, boxes_flat, gt_boxes.reshape(-1, 4), sampled["gt_classes"].reshape(-1), generator
        )

    def _forward_mask_train(self, feats, fg, targets):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4)
        mask_logits = self.mask_head(self.mask_pooler(feats, boxes, _batch_index(B, Rf, boxes.device)), True)
        return {"loss_mask": _mask_loss(mask_logits, fg, targets)}

    def _forward_keypoint_train(self, feats, fg, targets):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4)
        kpt_logits = self.keypoint_head(self.keypoint_pooler(feats, boxes, _batch_index(B, Rf, boxes.device)), True)
        gt = targets["gt_keypoints"].float()
        K = gt.shape[2]
        gt_kpts = torch.gather(gt, 1, fg["gt_idx"][..., None, None].expand(-1, -1, K, 3))  # [B, Rf, K, 3]
        normalizer = None
        if not self.normalize_kpt_loss_by_visible:
            normalizer = float(B * self.batch_size_per_image * self.positive_fraction)
        loss = keypoint_rcnn_loss(kpt_logits, boxes, gt_kpts.reshape(-1, K, 3), fg["valid"].reshape(-1), normalizer)
        return {"loss_keypoint": loss * self.keypoint_loss_weight}


def _matcher_args(cfg) -> dict:
    rh = cfg.MODEL.ROI_HEADS
    return dict(
        num_classes=rh.NUM_CLASSES,
        batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE,
        positive_fraction=rh.POSITIVE_FRACTION,
        proposal_matcher=Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS, allow_low_quality_matches=False),
        proposal_append_gt=rh.PROPOSAL_APPEND_GT,
    )


def _pooler_factory(cfg, input_shape: Dict[str, ShapeSpec]):
    """resolution -> ROIPooler over ``ROI_HEADS.IN_FEATURES`` with the box
    head's sampling ratio and pooler type."""
    bh = cfg.MODEL.ROI_BOX_HEAD
    scales = tuple(1.0 / input_shape[f].stride for f in cfg.MODEL.ROI_HEADS.IN_FEATURES)
    return lambda res: ROIPooler(res, scales, bh.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE)


def build_box_predictor(cfg, input_dim: int, **overrides) -> FastRCNNOutputLayers:
    """FastRCNNOutputLayers of ``cfg`` over ``input_dim`` features;
    ``overrides`` replace its arguments (a cascade stage's agnostic
    regression and decode weights). With ``USE_FED_LOSS`` the class weights
    are ``DATASETS.TRAIN``'s ``class_image_count`` to the power
    ``FED_LOSS_FREQ_WEIGHT_POWER``."""
    bh = cfg.MODEL.ROI_BOX_HEAD
    fed_weights = None
    if bh.USE_FED_LOSS:
        fed_weights = get_fed_loss_cls_weights(cfg.DATASETS.TRAIN, bh.FED_LOSS_FREQ_WEIGHT_POWER)
    args = dict(
        box2box_weights=bh.BBOX_REG_WEIGHTS,
        cls_agnostic_bbox_reg=bh.CLS_AGNOSTIC_BBOX_REG,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        test_topk_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        smooth_l1_beta=bh.SMOOTH_L1_BETA,
        box_reg_loss_type=bh.BBOX_REG_LOSS_TYPE,
        loss_weight_box=bh.BBOX_REG_LOSS_WEIGHT,
        use_sigmoid_ce=bh.USE_SIGMOID_CE,
        use_fed_loss=bh.USE_FED_LOSS,
        fed_loss_num_classes=bh.FED_LOSS_NUM_CLASSES,
        fed_loss_cls_weights=fed_weights,
    )
    args.update(overrides)
    return FastRCNNOutputLayers(input_dim, cfg.MODEL.ROI_HEADS.NUM_CLASSES, **args)


@ROI_HEADS_REGISTRY.register()
class Res5ROIHeads(nn.Module):
    """The C4 heads: one pooler on ``res4`` and the res5 stage, built here,
    shared by the box predictor and the mask head."""

    def __init__(
        self,
        *,
        in_features,
        pooler: ROIPooler,
        res5: nn.Sequential,
        box_predictor: FastRCNNOutputLayers,
        proposal_matcher: Matcher,
        mask_head: nn.Module = None,
        num_classes: int = 80,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        proposal_append_gt: bool = True,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.pooler = pooler
        self.res5 = res5
        self.box_predictor = box_predictor
        self.mask_head = mask_head
        self.num_classes = num_classes
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.proposal_matcher = proposal_matcher
        self.proposal_append_gt = proposal_append_gt

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "Res5ROIHeads":
        r = cfg.MODEL.RESNETS
        # the C4 head always builds 3 bottleneck blocks of RES2_OUT_CHANNELS
        # * 8 outputs, even for BasicBlock depths (R18): d2's
        # _build_res5_block, and the JAX package (roi_heads.py:455-472)
        bottleneck_channels = r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8
        out_channels = r.RES2_OUT_CHANNELS * 8
        res5 = nn.Sequential(*[
            BottleneckBlock(
                out_channels // 2 if b == 0 else out_channels, out_channels,
                bottleneck_channels=bottleneck_channels, stride=2 if b == 0 else 1, num_groups=r.NUM_GROUPS,
                norm=r.NORM, stride_in_1x1=r.STRIDE_IN_1X1,
            )
            for b in range(3)
        ])
        return cls(
            in_features=cfg.MODEL.ROI_HEADS.IN_FEATURES,
            pooler=_pooler_factory(cfg, input_shape)(cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION),
            res5=res5,
            box_predictor=build_box_predictor(cfg, out_channels),
            mask_head=build_mask_head(cfg, out_channels) if cfg.MODEL.MASK_ON else None,
            **_matcher_args(cfg),
        )

    fg_budget = StandardROIHeads.fg_budget

    def _shared_roi_transform(self, feats, boxes: torch.Tensor, batch_idx: torch.Tensor, train: bool) -> torch.Tensor:
        """Pool ``[R, res, res, C]`` and run res5: ``[R, 2048, res/2, res/2]``
        channels_last NCHW."""
        x = nchw(self.pooler(feats, boxes, batch_idx))
        for block in self.res5:
            x = block(x, train)
        return x

    def forward(
        self,
        features: Dict[str, torch.Tensor],
        proposal_boxes: torch.Tensor,
        proposal_valid: torch.Tensor,
        image_sizes: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        feats = [features[f] for f in self.in_features]
        B, P = proposal_boxes.shape[:2]
        x = self._shared_roi_transform(feats, proposal_boxes.reshape(-1, 4), _batch_index(B, P, proposal_boxes.device), False)
        predictions = self.box_predictor(x.mean(dim=(2, 3)))
        del x
        detections = self.box_predictor.inference(predictions, proposal_boxes, proposal_valid, image_sizes)
        return self.forward_with_given_boxes(features, detections)

    def forward_with_given_boxes(self, features: Dict[str, torch.Tensor], detections: Dict) -> Dict:
        """The mask head on the res5 features of the detections' boxes."""
        if self.mask_head is None:
            return detections
        feats = [features[f] for f in self.in_features]
        B, D = detections["pred_classes"].shape
        boxes = detections["pred_boxes"].reshape(-1, 4)
        x = self._shared_roi_transform(feats, boxes, _batch_index(B, D, boxes.device), False)
        probs = mask_rcnn_inference(self.mask_head(x.permute(0, 2, 3, 1), False), detections["pred_classes"].reshape(-1))
        detections["pred_masks"] = probs.reshape(B, D, *probs.shape[1:])
        return detections

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
        """Losses ``loss_cls``, ``loss_box_reg`` and, with a mask head,
        ``loss_mask``: one pool of the sampled slots on ``res4`` and one
        res5 pass; the mask head reads the foreground-budget rows of that
        res5 output (no second pool)."""
        feats = [features[f] for f in self.in_features]
        if self.proposal_append_gt:
            proposal_boxes, proposal_logits, proposal_valid = add_ground_truth_to_proposals_padded(
                targets["gt_boxes"], targets["gt_valid"], proposal_boxes, proposal_logits, proposal_valid
            )
        sampled = label_and_sample_proposals_padded(
            proposal_boxes, proposal_valid, targets, self.proposal_matcher, self.batch_size_per_image,
            self.positive_fraction, self.num_classes, generator,
        )
        B, S = sampled["gt_classes"].shape
        boxes_flat = sampled["boxes"].reshape(-1, 4)
        x = self._shared_roi_transform(feats, boxes_flat, _batch_index(B, S, boxes_flat.device), True)
        predictions = self.box_predictor(x.mean(dim=(2, 3)))
        gt_boxes = torch.gather(targets["gt_boxes"].float(), 1, sampled["gt_idx"][..., None].expand(-1, -1, 4))
        losses = self.box_predictor.losses(
            predictions, boxes_flat, gt_boxes.reshape(-1, 4), sampled["gt_classes"].reshape(-1), generator
        )
        if self.mask_head is not None:
            fg = _foreground(sampled, self.fg_budget)
            rows = (fg["idx"] + torch.arange(B, device=x.device)[:, None] * S).reshape(-1)
            losses["loss_mask"] = _mask_loss(self.mask_head(x[rows].permute(0, 2, 3, 1), True), fg, targets)
        return losses


def build_roi_heads(cfg, input_shape: Dict[str, ShapeSpec]) -> nn.Module:
    """The heads named by ``MODEL.ROI_HEADS.NAME`` in ``ROI_HEADS_REGISTRY``."""
    return ROI_HEADS_REGISTRY.get(cfg.MODEL.ROI_HEADS.NAME).from_config(cfg, input_shape)
