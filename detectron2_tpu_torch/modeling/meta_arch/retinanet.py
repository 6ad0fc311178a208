"""RetinaNet (counterpart of ``detectron2_tpu/modeling/meta_arch/retinanet.py``).

Anchors are labelled by the matcher with low-quality matches over
``pairwise_iou(gt, anchors)``; the losses are the sigmoid focal loss over
the anchors that are not ignored and the dense box loss over foreground
anchors, both computed over every anchor and multiplied by their masks, and
divided by the EMA loss normalizer. The head's towers run in the compute
dtype; ``cls_score`` and ``bbox_pred`` take the tower output in float32, as
the JAX head's plain ``nn.Conv`` promotes a bf16 input to its float32
kernel's type.
"""

from typing import Dict, List, Sequence

import torch
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, nchw, nhwc
from detectron2_tpu_torch.layers.losses import sigmoid_focal_loss
from detectron2_tpu_torch.modeling.anchor_generator import build_anchor_generator
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform, _dense_box_regression_loss
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.meta_arch.dense_detector import (
    DenseDetector,
    HeadTower,
    decode_dense_predictions_padded,
    permute_to_N_HWA_K,
)
from detectron2_tpu_torch.ops.nms import pairwise_iou

__all__ = ["RetinaNet", "RetinaNetHead"]


class RetinaNetHead(nn.Module):
    """Two towers of 3x3 convs, for classification and box regression,
    shared by every level, then ``cls_score`` and ``bbox_pred``. Takes and
    returns NHWC maps. ``prior_prob`` sets ``cls_score``'s initial bias
    (``modeling.init_weights``)."""

    def __init__(
        self,
        *,
        in_channels: int,
        num_classes: int,
        num_anchors: int,
        conv_dims: Sequence[int],
        norm="",
        prior_prob: float = 0.01,
    ):
        super().__init__()
        self.cls_subnet = HeadTower(in_channels, conv_dims, norm)
        self.bbox_subnet = HeadTower(in_channels, conv_dims, norm)
        dim = conv_dims[-1] if len(conv_dims) else in_channels
        self.cls_score = Conv2d(dim, num_anchors * num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(dim, num_anchors * 4, 3, padding=1)
        self.prior_prob = prior_prob

    def forward(self, features: List[torch.Tensor], train: bool):
        logits, deltas = [], []
        for x in features:
            x = nchw(x)
            logits.append(nhwc(self.cls_score(self.cls_subnet(x, train).float(), train)))
            deltas.append(nhwc(self.bbox_pred(self.bbox_subnet(x, train).float(), train)))
        return logits, deltas


class RetinaNet(DenseDetector):
    def __init__(
        self,
        *,
        backbone: nn.Module,
        head: RetinaNetHead,
        head_in_features: Sequence[str],
        anchor_generator,
        anchor_matcher: Matcher,
        pixel_mean,
        pixel_std,
        box2box_weights=(1.0, 1.0, 1.0, 1.0),
        num_classes: int = 80,
        focal_loss_alpha: float = 0.25,
        focal_loss_gamma: float = 2.0,
        smooth_l1_beta: float = 0.1,
        box_reg_loss_type: str = "smooth_l1",
        test_score_thresh: float = 0.05,
        test_topk_candidates: int = 1000,
        test_nms_thresh: float = 0.5,
        max_detections_per_image: int = 100,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
    ):
        super().__init__(
            backbone=backbone,
            head=head,
            head_in_features=head_in_features,
            pixel_mean=pixel_mean,
            pixel_std=pixel_std,
            input_format=input_format,
            compute_dtype=compute_dtype,
        )
        self.anchor_generator = anchor_generator
        self.anchor_matcher = anchor_matcher
        self.box2box_transform = Box2BoxTransform(tuple(box2box_weights))
        self.num_classes = num_classes
        self.focal_loss_alpha = focal_loss_alpha
        self.focal_loss_gamma = focal_loss_gamma
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.test_score_thresh = test_score_thresh
        self.test_topk_candidates = test_topk_candidates
        self.test_nms_thresh = test_nms_thresh
        self.max_detections_per_image = max_detections_per_image

    @classmethod
    def from_config(cls, cfg) -> "RetinaNet":
        """The model of a yacs ``cfg`` (``MODEL.RETINANET``), on the CPU."""
        from detectron2_tpu_torch.modeling.backbone import build_backbone

        backbone = build_backbone(cfg)
        shapes = [backbone.output_shape()[f] for f in cfg.MODEL.RETINANET.IN_FEATURES]
        anchor_generator = build_anchor_generator(cfg, [s.stride for s in shapes])
        r = cfg.MODEL.RETINANET
        return cls(
            backbone=backbone,
            head=RetinaNetHead(
                in_channels=shapes[0].channels,
                num_classes=r.NUM_CLASSES,
                num_anchors=anchor_generator.num_anchors[0],
                conv_dims=[shapes[0].channels] * r.NUM_CONVS,
                norm=r.NORM,
                prior_prob=r.PRIOR_PROB,
            ),
            head_in_features=r.IN_FEATURES,
            anchor_generator=anchor_generator,
            anchor_matcher=Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True),
            box2box_weights=r.BBOX_REG_WEIGHTS,
            num_classes=r.NUM_CLASSES,
            focal_loss_alpha=r.FOCAL_LOSS_ALPHA,
            focal_loss_gamma=r.FOCAL_LOSS_GAMMA,
            smooth_l1_beta=r.SMOOTH_L1_LOSS_BETA,
            box_reg_loss_type=r.BBOX_REG_LOSS_TYPE,
            test_score_thresh=r.SCORE_THRESH_TEST,
            test_topk_candidates=r.TOPK_CANDIDATES_TEST,
            test_nms_thresh=r.NMS_THRESH_TEST,
            max_detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        )

    def _head_outputs(self, batch: Dict, train: bool, generator=None):
        features = self._features(batch, train, generator)
        anchors = self.anchor_generator([(f.shape[1], f.shape[2]) for f in features], self.device)
        logits_l, deltas_l = self.head(features, train)
        logits_l = [permute_to_N_HWA_K(x, self.num_classes).float() for x in logits_l]
        deltas_l = [permute_to_N_HWA_K(x, 4).float() for x in deltas_l]
        return anchors, logits_l, deltas_l

    def forward_inference(self, batch: Dict, raw: bool = False) -> Dict:
        anchors, logits_l, deltas_l = self._head_outputs(batch, False)
        if raw:
            return {"logits": logits_l, "deltas": deltas_l}
        return decode_dense_predictions_padded(
            self.box2box_transform,
            anchors,
            [torch.sigmoid(x) for x in logits_l],
            deltas_l,
            self.test_score_thresh,
            self.test_topk_candidates,
            self.test_nms_thresh,
            self.max_detections_per_image,
        )

    def forward_train(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        anchors, logits_l, deltas_l = self._head_outputs(batch, True, generator)
        return self.losses(anchors, logits_l, deltas_l, *self._targets(batch))

    def losses(self, anchors, logits_l, deltas_l, gt_boxes, gt_classes, gt_valid) -> Dict[str, torch.Tensor]:
        """Focal loss and the dense box loss, each over every anchor times
        its mask, divided by ``max(EMA normalizer, 1)``."""
        anchors_cat = torch.cat(anchors, dim=0)  # [R, 4]
        logits = torch.cat(logits_l, dim=1)  # [B, R, C]
        deltas = torch.cat(deltas_l, dim=1)  # [B, R, 4]
        C = self.num_classes
        gt_boxes = gt_boxes.float()
        matched_idx, labels = self.anchor_matcher(pairwise_iou(gt_boxes, anchors_cat[None]), gt_valid=gt_valid)
        gt_labels = torch.where(labels == 1, torch.gather(gt_classes.long(), 1, matched_idx), torch.full_like(matched_idx, C))
        gt_labels = torch.where(labels == -1, torch.full_like(gt_labels, -1), gt_labels)  # the ignored band
        matched_boxes = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))

        valid = gt_labels >= 0
        fg = valid & (gt_labels < C)
        normalizer = self._ema_loss_normalizer(fg.sum())
        # one-hot over the C classes (background all zero); an ignored
        # anchor's row is zeroed by ``valid``
        onehot = (gt_labels.clamp(0, C)[..., None] == torch.arange(C, device=logits.device)).float()
        cls_loss = sigmoid_focal_loss(logits, onehot, alpha=self.focal_loss_alpha, gamma=self.focal_loss_gamma).sum(-1)
        loss_cls = (cls_loss * valid.float()).sum() / normalizer
        loss_box = (
            _dense_box_regression_loss(
                anchors_cat[None].expand_as(deltas),
                self.box2box_transform,
                deltas,
                matched_boxes,
                fg,
                box_reg_loss_type=self.box_reg_loss_type,
                smooth_l1_beta=self.smooth_l1_beta,
            )
            / normalizer
        )
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box}
