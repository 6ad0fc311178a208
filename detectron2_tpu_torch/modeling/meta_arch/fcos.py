"""FCOS, the anchor-free one-stage detector (counterpart of
``detectron2_tpu/modeling/meta_arch/fcos.py``).

One point anchor per location: a box the size of the level's stride around
the location's centre, used for the linear box transform and the decode.
Matching is the fixed-shape FCOS protocol over every (location, gt) pair:
the centre within ``center_sampling_radius * stride`` of the gt's centre,
inside the gt box, and the largest distance to its edges within the level's
size range (``[0, 64, 128, 256, 512, 1e8]`` for strides 8-128); the feasible
gt of smallest area wins, and a location with none is background (its gt
index is 0, and the masks zero it). The losses are the focal loss over
every location, GIoU and centerness BCE over foreground locations, as
masked sums divided by the EMA normalizer. The score is
``sqrt(sigmoid(cls) * sigmoid(ctrness))``.
"""

import copy
from typing import Dict, List, Sequence

import torch
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, nchw, nhwc
from detectron2_tpu_torch.layers.losses import binary_cross_entropy_with_logits, giou_loss, sigmoid_focal_loss
from detectron2_tpu_torch.modeling.anchor_generator import DefaultAnchorGenerator
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransformLinear
from detectron2_tpu_torch.modeling.meta_arch.rcnn import _DTYPES
from detectron2_tpu_torch.modeling.meta_arch.dense_detector import (
    DenseDetector,
    HeadTower,
    decode_dense_predictions_padded,
    permute_to_N_HWA_K,
)

__all__ = ["FCOS", "FCOSHead"]


class FCOSHead(nn.Module):
    """RetinaNet's two towers (GN by default), ``cls_score``, ``bbox_pred``
    (through a ReLU) and ``ctrness``, which reads the box tower. The
    predictors take the tower output in float32, as in
    :class:`~detectron2_tpu_torch.modeling.meta_arch.retinanet.RetinaNetHead`."""

    def __init__(self, *, in_channels: int, num_classes: int, conv_dims: Sequence[int], norm="GN", prior_prob: float = 0.01):
        super().__init__()
        self.cls_subnet = HeadTower(in_channels, conv_dims, norm)
        self.bbox_subnet = HeadTower(in_channels, conv_dims, norm)
        dim = conv_dims[-1] if len(conv_dims) else in_channels
        self.cls_score = Conv2d(dim, num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(dim, 4, 3, padding=1)
        self.ctrness = Conv2d(dim, 1, 3, padding=1)
        self.prior_prob = prior_prob

    def forward(self, features: List[torch.Tensor], train: bool):
        logits, bbox_reg, ctr = [], [], []
        for x in features:
            x = nchw(x)
            logits.append(nhwc(self.cls_score(self.cls_subnet(x, train).float(), train)))
            b = self.bbox_subnet(x, train).float()
            bbox_reg.append(nhwc(torch.relu(self.bbox_pred(b, train))))
            ctr.append(nhwc(self.ctrness(b, train)))
        return logits, bbox_reg, ctr


class FCOS(DenseDetector):
    def __init__(
        self,
        *,
        backbone: nn.Module,
        head: FCOSHead,
        head_in_features: Sequence[str],
        pixel_mean,
        pixel_std,
        strides: Sequence[int] = (8, 16, 32, 64, 128),
        num_classes: int = 80,
        center_sampling_radius: float = 1.5,
        focal_loss_alpha: float = 0.25,
        focal_loss_gamma: float = 2.0,
        test_score_thresh: float = 0.2,
        test_topk_candidates: int = 1000,
        test_nms_thresh: float = 0.6,
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
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.center_sampling_radius = center_sampling_radius
        self.focal_loss_alpha = focal_loss_alpha
        self.focal_loss_gamma = focal_loss_gamma
        self.test_score_thresh = test_score_thresh
        self.test_topk_candidates = test_topk_candidates
        self.test_nms_thresh = test_nms_thresh
        self.max_detections_per_image = max_detections_per_image
        self.box2box_transform = Box2BoxTransformLinear(normalize_by_size=True)
        n = len(self.head_in_features)
        self.point_anchors = DefaultAnchorGenerator(
            sizes=[[float(s)] for s in self.strides[:n]], aspect_ratios=[[1.0]], strides=self.strides[:n], offset=0.5
        )

    @classmethod
    def from_config(cls, cfg) -> "FCOS":
        """The model of a yacs ``cfg``, on the CPU: ``MODEL.RETINANET``'s
        features, classes and tower depth; the head is GN whatever
        ``RETINANET.NORM`` says, and the test thresholds are FCOS's own."""
        from detectron2_tpu_torch.modeling.backbone import build_backbone

        backbone = build_backbone(cfg)
        shapes = [backbone.output_shape()[f] for f in cfg.MODEL.RETINANET.IN_FEATURES]
        r = cfg.MODEL.RETINANET
        return cls(
            backbone=backbone,
            head=FCOSHead(in_channels=shapes[0].channels, num_classes=r.NUM_CLASSES, conv_dims=[shapes[0].channels] * r.NUM_CONVS),
            head_in_features=r.IN_FEATURES,
            num_classes=r.NUM_CLASSES,
            strides=[s.stride for s in shapes],
            max_detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        )

    def clone(self, **children) -> "FCOS":
        """A new FCOS with the given children (``backbone``, ``head``)
        replaced and every other setting kept, as flax's ``Module.clone``;
        the children it keeps are copied, so the two models share no
        parameter."""
        parts = {"backbone": self.backbone, "head": self.head}
        unknown = set(children) - set(parts)
        if unknown:
            raise TypeError(f"FCOS.clone replaces backbone and head, not {sorted(unknown)}")
        parts = {k: children[k] if k in children else copy.deepcopy(v) for k, v in parts.items()}
        model = FCOS(
            **parts,
            head_in_features=self.head_in_features,
            pixel_mean=self.pixel_mean.tolist(),
            pixel_std=self.pixel_std.tolist(),
            strides=self.strides,
            num_classes=self.num_classes,
            center_sampling_radius=self.center_sampling_radius,
            focal_loss_alpha=self.focal_loss_alpha,
            focal_loss_gamma=self.focal_loss_gamma,
            test_score_thresh=self.test_score_thresh,
            test_topk_candidates=self.test_topk_candidates,
            test_nms_thresh=self.test_nms_thresh,
            max_detections_per_image=self.max_detections_per_image,
            input_format=self.input_format,
            compute_dtype={v: k for k, v in _DTYPES.items()}[self.compute_dtype],
        )
        with torch.no_grad():
            model.loss_normalizer.copy_(self.loss_normalizer)
        return model.to(self.device)

    def _head_outputs(self, batch: Dict, train: bool, generator=None):
        features = self._features(batch, train, generator)
        anchors = self.point_anchors([(f.shape[1], f.shape[2]) for f in features], self.device)
        logits_l, deltas_l, ctr_l = self.head(features, train)
        logits_l = [permute_to_N_HWA_K(x, self.num_classes).float() for x in logits_l]
        deltas_l = [permute_to_N_HWA_K(x, 4).float() for x in deltas_l]
        ctr_l = [permute_to_N_HWA_K(x, 1).float() for x in ctr_l]
        return anchors, logits_l, deltas_l, ctr_l

    def forward_inference(self, batch: Dict, raw: bool = False) -> Dict:
        anchors, logits_l, deltas_l, ctr_l = self._head_outputs(batch, False)
        if raw:
            return {"logits": logits_l, "deltas": deltas_l, "ctrness": ctr_l}
        scores = [torch.sqrt(torch.sigmoid(x) * torch.sigmoid(c)) for x, c in zip(logits_l, ctr_l)]
        return decode_dense_predictions_padded(
            self.box2box_transform,
            anchors,
            scores,
            deltas_l,
            self.test_score_thresh,
            self.test_topk_candidates,
            self.test_nms_thresh,
            self.max_detections_per_image,
        )

    def forward_train(self, batch: Dict, generator=None) -> Dict[str, torch.Tensor]:
        anchors, logits_l, deltas_l, ctr_l = self._head_outputs(batch, True, generator)
        return self.losses(anchors, logits_l, deltas_l, ctr_l, *self._targets(batch))

    def match_points_to_gt(self, anchors: List[torch.Tensor], gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
        """gt ``[B, G, 4]``, ``gt_valid [B, G]`` -> the matched gt index and
        the foreground mask, ``[B, R]`` each, over the concatenated levels."""
        dev = gt_boxes.device
        level = torch.cat([torch.full((a.shape[0],), i, dtype=torch.long, device=dev) for i, a in enumerate(anchors)])
        anchors_cat = torch.cat(anchors, dim=0)
        centers = (anchors_cat[:, :2] + anchors_cat[:, 2:]) / 2  # [R, 2]
        strides = torch.tensor(self.strides, dtype=torch.float32, device=dev)[level]
        lows = torch.tensor([0.0] + [s * 8.0 for s in self.strides[:-1]], dtype=torch.float32, device=dev)[level]
        highs = torch.tensor([s * 8.0 for s in self.strides[:-1]] + [1e8], dtype=torch.float32, device=dev)[level]

        cx, cy = centers[None, :, None, 0], centers[None, :, None, 1]  # [1, R, 1]
        x1, y1, x2, y2 = (gt_boxes[:, None, :, i] for i in range(4))  # [B, 1, G]
        d_center = torch.maximum((cx - (x1 + x2) / 2).abs(), (cy - (y1 + y2) / 2).abs())  # [B, R, G]
        feasible = d_center < self.center_sampling_radius * strides[None, :, None]
        l, t, r, b = cx - x1, cy - y1, x2 - cx, y2 - cy
        feasible &= torch.minimum(torch.minimum(l, t), torch.minimum(r, b)) > 0
        max_dist = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
        feasible &= (max_dist >= lows[None, :, None]) & (max_dist < highs[None, :, None])
        feasible &= gt_valid[:, None, :]
        areas = (x2 - x1) * (y2 - y1)
        cost = torch.where(feasible, areas, torch.full_like(max_dist, float("inf")))
        min_cost, matched = cost.min(dim=2)  # the first of equal minima, as jnp.argmin
        return matched, torch.isfinite(min_cost)

    def losses(self, anchors, logits_l, deltas_l, ctr_l, gt_boxes, gt_classes, gt_valid) -> Dict[str, torch.Tensor]:
        anchors_cat = torch.cat(anchors, dim=0)
        logits = torch.cat(logits_l, dim=1)  # [B, R, C]
        deltas = torch.cat(deltas_l, dim=1)  # [B, R, 4]
        ctr = torch.cat(ctr_l, dim=1)[..., 0]  # [B, R]
        C = self.num_classes
        gt_boxes = gt_boxes.float()
        matched, is_fg = self.match_points_to_gt(anchors, gt_boxes, gt_valid)
        fg = is_fg.float()
        m_boxes = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
        m_cls = torch.where(is_fg, torch.gather(gt_classes.long(), 1, matched), torch.full_like(matched, C))
        onehot = (m_cls.clamp(0, C)[..., None] == torch.arange(C, device=logits.device)).float()
        cls_loss = sigmoid_focal_loss(logits, onehot, alpha=self.focal_loss_alpha, gamma=self.focal_loss_gamma)
        cls_loss = cls_loss.sum(-1).sum(-1)  # per image

        anchors_b = anchors_cat[None].expand_as(deltas)
        reg_loss = (giou_loss(self.box2box_transform.apply_deltas(deltas, anchors_b), m_boxes) * fg).sum(-1)

        gt_deltas = self.box2box_transform.get_deltas(anchors_b, m_boxes)
        lr, tb = gt_deltas[..., [0, 2]], gt_deltas[..., [1, 3]]
        ctrness = torch.sqrt(
            (lr.amin(-1) / lr.amax(-1).clamp_min(1e-6)).clamp_min(0) * (tb.amin(-1) / tb.amax(-1).clamp_min(1e-6)).clamp_min(0)
        )
        ctr_loss = (binary_cross_entropy_with_logits(ctr, ctrness) * fg).sum(-1)

        normalizer = self._ema_loss_normalizer(fg.sum(-1).sum())
        return {
            "loss_fcos_cls": cls_loss.sum() / normalizer,
            "loss_fcos_loc": reg_loss.sum() / normalizer,
            "loss_fcos_ctr": ctr_loss.sum() / normalizer,
        }
