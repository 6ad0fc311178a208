"""Region Proposal Network (counterpart of
``detectron2_tpu/modeling/proposal_generator/rpn.py``: StandardRPNHead :42,
RPN :89).

Proposals are decoded only for each level's top-k anchors, after the top-k,
as the JAX package does: selection reads only objectness, so this equals
decoding every anchor first. In training the gt comes padded ``[B, G, 4]``
with a validity mask; anchors are matched and sampled for every image at
once, and the losses are normalized as the reference's (``rpn.py:365-429``).
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, nchw, nhwc
from detectron2_tpu_torch.layers.losses import binary_cross_entropy_with_logits
from detectron2_tpu_torch.modeling.anchor_generator import build_anchor_generator
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform, _dense_box_regression_loss
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.proposal_generator.proposal_utils import (
    find_top_rpn_proposals_padded,
)
from detectron2_tpu_torch.modeling.sampling import subsample_labels_padded
from detectron2_tpu_torch.ops.nms import pairwise_iou
from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["StandardRPNHead", "RPN", "build_rpn"]


class StandardRPNHead(nn.Module):
    """3x3 conv(s) + sibling 1x1 convs for objectness and deltas, shared
    across levels. Takes and returns NHWC. With several ``conv_dims`` the
    convs are ``conv.conv{i}``, as d2 names them."""

    def __init__(self, in_channels: int, num_anchors: int, box_dim: int = 4, conv_dims=(-1,)):
        super().__init__()
        convs = []
        dim = in_channels
        for out_dim in conv_dims:
            out_dim = in_channels if out_dim == -1 else out_dim
            convs.append(Conv2d(dim, out_dim, 3, padding=1, activation=F.relu))
            dim = out_dim
        if len(convs) == 1:
            self.conv = convs[0]
        else:
            self.conv = nn.Sequential()
            for i, conv in enumerate(convs):
                self.conv.add_module(f"conv{i}", conv)
        self._convs = convs  # in order, not registered a second time
        self.objectness_logits = Conv2d(dim, num_anchors, 1)
        self.anchor_deltas = Conv2d(dim, num_anchors * box_dim, 1)

    def forward(self, features: List[torch.Tensor], train: bool):
        """``train`` goes to every conv, as in the JAX head."""
        logits, deltas = [], []
        for x in features:
            t = nchw(x)
            for conv in self._convs:
                t = conv(t, train)
            logits.append(nhwc(self.objectness_logits(t, train)))
            deltas.append(nhwc(self.anchor_deltas(t, train)))
        return logits, deltas


class RPN(nn.Module):
    def __init__(
        self,
        *,
        in_features,
        head: StandardRPNHead,
        anchor_generator,
        anchor_matcher: Matcher,
        box2box_weights=(1.0, 1.0, 1.0, 1.0),
        batch_size_per_image: int = 256,
        positive_fraction: float = 0.5,
        pre_nms_topk_train: int = 12000,
        pre_nms_topk_test: int = 6000,
        post_nms_topk_train: int = 2000,
        post_nms_topk_test: int = 1000,
        nms_thresh: float = 0.7,
        min_box_size: float = 0.0,
        anchor_boundary_thresh: float = -1.0,
        loss_weight_cls: float = 1.0,
        loss_weight_loc: float = 1.0,
        smooth_l1_beta: float = 0.0,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.rpn_head = head
        self.anchor_generator = anchor_generator
        self.box2box_transform = Box2BoxTransform(box2box_weights)
        self.anchor_matcher = anchor_matcher
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.pre_nms_topk = {True: pre_nms_topk_train, False: pre_nms_topk_test}
        self.post_nms_topk = {True: post_nms_topk_train, False: post_nms_topk_test}
        self.nms_thresh = nms_thresh
        self.min_box_size = min_box_size
        self.anchor_boundary_thresh = anchor_boundary_thresh
        self.loss_weight_cls = loss_weight_cls
        self.loss_weight_loc = loss_weight_loc
        self.smooth_l1_beta = smooth_l1_beta

    def _head(self, features, train: bool):
        feats = [features[f] for f in self.in_features]
        anchors = self.anchor_generator([(f.shape[1], f.shape[2]) for f in feats], feats[0].device)
        logits_l, deltas_l = self.rpn_head(feats, train)
        B = feats[0].shape[0]
        box_dim = self.anchor_generator.box_dim
        logits_l = [l.reshape(B, -1).float() for l in logits_l]
        deltas_l = [d.reshape(B, -1, box_dim) for d in deltas_l]
        return anchors, logits_l, deltas_l

    def _proposals(self, anchors, logits_l, deltas_l, image_sizes, train: bool):
        """Per level, decode only the top-k anchors by objectness (selection
        reads only objectness), from detached logits and deltas."""
        pre, post = self.pre_nms_topk[train], self.post_nms_topk[train]
        box_dim = self.anchor_generator.box_dim
        proposals, top_logits = [], []
        for d, l, a in zip(deltas_l, logits_l, anchors):
            l, d = l.detach(), d.detach()
            B = l.shape[0]
            k = min(pre, l.shape[1])
            top_l, idx = top_k(l, k)
            top_d = torch.gather(d, 1, idx[..., None].expand(-1, -1, box_dim)).float()
            top_a = a[idx]
            proposals.append(
                self.box2box_transform.apply_deltas(
                    top_d.reshape(-1, box_dim), top_a.reshape(-1, box_dim)
                ).reshape(B, k, box_dim)
            )
            top_logits.append(top_l)
        return find_top_rpn_proposals_padded(
            proposals, top_logits, image_sizes, self.nms_thresh, pre, post, self.min_box_size
        )

    def forward(
        self, features: Dict[str, torch.Tensor], image_sizes: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Inference: proposal boxes ``[B, P, 4]``, logits ``[B, P]``, valid ``[B, P]``."""
        anchors, logits_l, deltas_l = self._head(features, False)
        return self._proposals(anchors, logits_l, deltas_l, image_sizes, train=False)

    def forward_train(
        self,
        features: Dict[str, torch.Tensor],
        image_sizes: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_valid: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        proposals: bool = True,
    ):
        """Training: ``((boxes, logits, valid), losses)`` with the train
        top-k sizes and the losses ``loss_rpn_cls``, ``loss_rpn_loc``; the
        anchor sampler draws from ``generator``. With ``proposals=False``
        (an RPN-only model) no proposal is decoded: ``(None, losses)``."""
        anchors, logits_l, deltas_l = self._head(features, True)
        losses = self.losses(anchors, logits_l, deltas_l, gt_boxes, gt_valid, image_sizes, generator)
        if not proposals:
            return None, losses
        return self._proposals(anchors, logits_l, deltas_l, image_sizes, train=True), losses

    def losses(self, anchors, logits_l, deltas_l, gt_boxes, gt_valid, image_sizes, generator=None):
        """Match anchors to gt, sample ``batch_size_per_image`` per image and
        normalize both sums by ``batch_size_per_image * B``
        (``rpn.py:222-285`` of the JAX package)."""
        anchors_cat = torch.cat(anchors, dim=0)  # [R, 4]
        logits = torch.cat(logits_l, dim=1)  # [B, R]
        deltas = torch.cat(deltas_l, dim=1)  # [B, R, 4]
        B = logits.shape[0]
        S = self.batch_size_per_image
        gt_boxes = gt_boxes.float()
        iou = pairwise_iou(gt_boxes, anchors_cat[None])  # [B, G, R]
        matched_idx, match_labels = self.anchor_matcher(iou, gt_valid=gt_valid)
        if self.anchor_boundary_thresh >= 0:
            t = self.anchor_boundary_thresh
            h = image_sizes[:, 0:1].to(anchors_cat.dtype)
            w = image_sizes[:, 1:2].to(anchors_cat.dtype)
            inside = (
                (anchors_cat[None, :, 0] >= -t)
                & (anchors_cat[None, :, 1] >= -t)
                & (anchors_cat[None, :, 2] < w + t)
                & (anchors_cat[None, :, 3] < h + t)
            )
            match_labels = torch.where(inside, match_labels, torch.full_like(match_labels, -1))

        idx, valid, is_pos = subsample_labels_padded(
            match_labels.long(), S, self.positive_fraction, bg_label=0, generator=generator
        )
        s_logits = torch.gather(logits, 1, idx)
        cls_loss = (binary_cross_entropy_with_logits(s_logits, is_pos.float()) * valid.float()).sum()

        s_anchors = anchors_cat[idx]  # [B, S, 4]
        s_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)).float()
        s_gt_idx = torch.gather(matched_idx, 1, idx)
        s_gt = torch.gather(gt_boxes, 1, s_gt_idx[..., None].expand(-1, -1, 4))
        loc_loss = _dense_box_regression_loss(
            s_anchors, self.box2box_transform, s_deltas, s_gt, is_pos, "smooth_l1", self.smooth_l1_beta
        )
        normalizer = S * B
        return {
            "loss_rpn_cls": cls_loss / normalizer * self.loss_weight_cls,
            "loss_rpn_loc": loc_loss / normalizer * self.loss_weight_loc,
        }


def build_rpn(cfg, input_shape: Dict[str, ShapeSpec]) -> RPN:
    name = cfg.MODEL.PROPOSAL_GENERATOR.NAME
    if name != "RPN" or cfg.MODEL.RPN.HEAD_NAME != "StandardRPNHead":
        raise NotImplementedError(f"proposal generator {name!r} is not ported yet")
    in_features = cfg.MODEL.RPN.IN_FEATURES
    shapes = [input_shape[f] for f in in_features]
    channels = {s.channels for s in shapes}
    assert len(channels) == 1, "Each level must have the same channel!"
    anchor_generator = build_anchor_generator(cfg, [s.stride for s in shapes])
    num_anchors = set(anchor_generator.num_anchors)
    assert len(num_anchors) == 1, "Each level must have the same number of anchors per position"
    r = cfg.MODEL.RPN
    if r.BBOX_REG_LOSS_TYPE != "smooth_l1":
        raise NotImplementedError(f"RPN box loss {r.BBOX_REG_LOSS_TYPE!r} is not ported yet")
    return RPN(
        in_features=in_features,
        head=StandardRPNHead(channels.pop(), num_anchors.pop(), anchor_generator.box_dim, tuple(r.CONV_DIMS)),
        anchor_generator=anchor_generator,
        box2box_weights=r.BBOX_REG_WEIGHTS,
        anchor_matcher=Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True),
        batch_size_per_image=r.BATCH_SIZE_PER_IMAGE,
        positive_fraction=r.POSITIVE_FRACTION,
        pre_nms_topk_train=r.PRE_NMS_TOPK_TRAIN,
        pre_nms_topk_test=r.PRE_NMS_TOPK_TEST,
        post_nms_topk_train=r.POST_NMS_TOPK_TRAIN,
        post_nms_topk_test=r.POST_NMS_TOPK_TEST,
        nms_thresh=r.NMS_THRESH,
        min_box_size=float(cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE),
        anchor_boundary_thresh=r.BOUNDARY_THRESH,
        loss_weight_cls=r.LOSS_WEIGHT,
        loss_weight_loc=r.LOSS_WEIGHT * r.BBOX_REG_LOSS_WEIGHT,
        smooth_l1_beta=r.SMOOTH_L1_BETA,
    )
