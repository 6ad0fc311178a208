"""TensorMask (counterpart of the JAX package's
``projects/tensormask/arch.py``): dense sliding-window instance
segmentation with the tensor bipyramid.

Per FPN level the head predicts class logits, box deltas and a mask window
at every location. With ``BIPYRAMID_ON`` every level's mask features are
upsampled by exactly ``2**lvl`` to the finest level (then cropped), added
to it and fused by the shared ``mask_fuse``; ``mask_pred_{m:02d}`` predicts
the ``m x m`` aligned window there, and ``swap_align2nat`` (λ ``2**lvl``)
takes it to the level's natural ``(m * 2**lvl)``-sided window.

The fixed-shape design of the JAX package, kept:

- the assignment (containment, scale, spatial and uniqueness rules) is one
  ``[B, G, R]`` boolean computation over the padded gt;
- the mask targets are the top ``MASK_GT_BUDGETS[lvl]`` foreground sites of
  each (level, anchor) per image, the BCE weighted by slot validity;
- inference is a top-k over the ``[R * K]`` scores of each image, the
  class-batched NMS on the unclipped boxes and the top ``D``; each
  detection's window is gathered from its (level, anchor) and resized
  bilinearly (``jax.image.resize``'s, antialiased when shrinking) to 28.

The masks live in each detection's *anchor* frame: ``mask_boxes`` ``[B, D,
4]`` is the box to paste them in, which ``detector_postprocess`` does (d2
pastes in the anchor box; the JAX package pastes in ``pred_boxes``).
d2's names: ``head.cls_subnet`` / ``bbox_subnet`` / ``mask_subnet`` (conv,
ReLU, ...), ``cls_score``, ``bbox_pred``, ``mask_pred_{m:02d}``,
``mask_fuse.0``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, nchw, nhwc
from detectron2_tpu_torch.modeling.anchor_generator import build_anchor_generator
from detectron2_tpu_torch.modeling.backbone.vit import resize_matrix
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform
from detectron2_tpu_torch.modeling.meta_arch.dense_detector import HeadTower
from detectron2_tpu_torch.modeling.meta_arch.rcnn import _DTYPES
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import crop_gt_masks_to_proposals
from detectron2_tpu_torch.ops.nms import batched_nms_padded
from detectron2_tpu_torch.ops.topk import top_k
from detectron2_tpu_torch.projects.tensormask.layers import swap_align2nat

__all__ = ["TensorMask", "TensorMaskHead", "sigmoid_focal_loss_star", "tensormask_assignment"]


def sigmoid_focal_loss_star(logits: torch.Tensor, targets: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Focal loss* (fvcore's ``sigmoid_focal_loss_star``), elementwise."""
    loss = -F.logsigmoid(gamma * (logits * (2.0 * targets - 1.0))) / gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1.0 - alpha) * (1.0 - targets))
    return loss


def tensormask_assignment(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    anchors: torch.Tensor,
    unit_lengths: torch.Tensor,
    min_anchor_size: float,
    scale_thresh: float = 2.0,
    spatial_thresh: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TensorMask's assignment rule over padded gt ``[B, G, 4]`` (valid
    ``[B, G]``) and anchors ``[R, 4]`` with their unit lengths ``[R]``: an
    anchor is positive iff it contains its gt box, is at most
    ``scale_thresh`` times its size (after deducting the unit length, and
    never below ``min_anchor_size``), its centre lies within
    ``spatial_thresh`` units of the gt's, and exactly one gt claims it.
    Returns (matches int64 ``[B, R]``, the first claiming gt or 0; labels
    bool ``[B, R]``)."""
    g = gt_boxes[:, :, None, :]
    a = anchors[None, None]
    contain = (a[..., 0] <= g[..., 0]) & (a[..., 1] <= g[..., 1]) & (a[..., 2] >= g[..., 2]) & (a[..., 3] >= g[..., 3])

    gt_size = (gt_boxes[..., 2:] - gt_boxes[..., :2]).amax(dim=-1)  # [B, G]
    gt_upper = torch.clamp_min(gt_size * scale_thresh, min_anchor_size)
    anchor_size = (anchors[:, 2:] - anchors[:, :2]).amax(dim=-1) - unit_lengths  # [R]
    scale_ok = (gt_upper[..., None] - anchor_size) >= 0

    gc = (gt_boxes[..., 2:] + gt_boxes[..., :2]) / 2  # [B, G, 2]
    ac = (anchors[:, 2:] + anchors[:, :2]) / 2  # [R, 2]
    dx = (gc[..., 0, None] - ac[:, 0]) / unit_lengths
    dy = (gc[..., 1, None] - ac[:, 1]) / unit_lengths
    spatial_ok = dx * dx + dy * dy <= spatial_thresh * spatial_thresh

    assign = contain & scale_ok & spatial_ok & gt_valid.bool()[..., None]  # [B, G, R]
    count = assign.sum(dim=1)
    matches = assign.to(torch.uint8).argmax(dim=1)
    return matches, count == 1


class TensorMaskHead(nn.Module):
    """The class, box and mask towers shared by the levels, the mask
    predictor of each anchor size and, with ``bipyramid_on``, the fuse.
    Takes and returns NHWC maps; every conv runs in the features' dtype and
    the outputs are cast to float32."""

    def __init__(
        self,
        *,
        in_channels: int,
        num_classes: int,
        num_anchors: int,
        mask_sizes: Sequence[int],
        num_convs: int = 4,
        cls_channels: int = 256,
        bbox_channels: int = 128,
        mask_channels: int = 128,
        mask_on: bool = True,
        aligned_on: bool = False,
        bipyramid_on: bool = False,
        prior_prob: float = 0.01,
    ):
        super().__init__()
        self.mask_sizes = tuple(mask_sizes)
        self.mask_on, self.aligned_on, self.bipyramid_on = mask_on, aligned_on, bipyramid_on
        self.prior_prob = prior_prob  # cls_score's initial bias (modeling.init_weights)
        self.cls_subnet = HeadTower(in_channels, [cls_channels] * num_convs)
        self.cls_score = Conv2d(cls_channels, num_anchors * num_classes, 3, padding=1)
        self.bbox_subnet = HeadTower(in_channels, [bbox_channels] * num_convs)
        self.bbox_pred = Conv2d(bbox_channels, num_anchors * 4, 3, padding=1)
        if mask_on:
            self.mask_subnet = HeadTower(in_channels, [mask_channels] * num_convs)
            for m in self.mask_sizes:
                self.add_module(f"mask_pred_{m:02d}", Conv2d(mask_channels, m * m, 1))
            if bipyramid_on:  # d2's nn.Sequential(conv, ReLU): the conv is mask_fuse.0
                self.mask_fuse = nn.Sequential(Conv2d(mask_channels, mask_channels, 3, padding=1, activation=F.relu))

    def forward(self, features: List[torch.Tensor], train: bool):
        """features: per level ``[B, Hl, Wl, C]``, finest first. Returns
        logits per level ``[B, Hl, Wl, A*K]``, deltas ``[B, Hl, Wl, A*4]``
        and masks per level and anchor ``[B, Hl, Wl, side**2]`` (None
        without masks)."""
        logits = [nhwc(self.cls_score(self.cls_subnet(nchw(x), train), train)).float() for x in features]
        deltas = [nhwc(self.bbox_pred(self.bbox_subnet(nchw(x), train), train)).float() for x in features]
        if not self.mask_on:
            return logits, deltas, None
        feats = [self.mask_subnet(nchw(x), train) for x in features]
        if self.bipyramid_on:
            hi = feats[0]
            H0, W0 = hi.shape[2:]
            up = [self.mask_fuse[0](hi + hi, train)]
            for lvl, f in enumerate(feats[1:], 1):
                # exactly 2**lvl, then cropped: resizing straight to (H0, W0)
                # would move the samples where Hl * 2**lvl != H0
                f = F.interpolate(f, scale_factor=2**lvl, mode="bilinear", align_corners=False)[:, :, :H0, :W0]
                up.append(self.mask_fuse[0](f + hi, train))
            feats = up
        masks = []
        for lvl, f in enumerate(feats):
            cur = []
            for m in self.mask_sizes:
                pm = nhwc(getattr(self, f"mask_pred_{m:02d}")(f, train)).float()
                if self.aligned_on:
                    pm = swap_align2nat(pm, 2**lvl if self.bipyramid_on else 1)
                cur.append(pm)
            masks.append(cur)
        return logits, deltas, masks


class TensorMask(nn.Module):
    """The model: a backbone, :class:`TensorMaskHead` over
    ``in_features`` and the anchors. The forward takes the JAX package's
    padded batch dict (as ``GeneralizedRCNN``), with ``gt_masks [B, G, Ms,
    Ms]`` in training, and returns the losses ``loss_cls``,
    ``loss_box_reg`` (and ``loss_mask``) or, under
    ``torch.inference_mode``, pred_boxes ``[B, D, 4]`` (network frame,
    unclipped), scores, pred_classes, valid ``[B, D]``, pred_masks ``[B, D,
    28, 28]`` (probabilities, in the anchor's frame) and mask_boxes ``[B,
    D, 4]``."""

    def __init__(
        self,
        *,
        backbone: nn.Module,
        head: TensorMaskHead,
        anchor_generator,
        in_features: Sequence[str],
        num_classes: int,
        mask_sizes: Sequence[int],
        min_anchor_size: float,
        pixel_mean,
        pixel_std,
        bbox_reg_weights=(1.5, 1.5, 0.75, 0.75),
        focal_loss_alpha: float = 0.3,
        focal_loss_gamma: float = 3.0,
        mask_on: bool = True,
        mask_loss_weight: float = 2.0,
        mask_pos_weight: float = 1.5,
        bipyramid_on: bool = False,
        score_threshold: float = 0.05,
        topk_candidates: int = 6000,
        nms_threshold: float = 0.5,
        detections_im: int = 100,
        mask_gt_budgets: Sequence[int] = (64, 32, 16, 8, 4, 4),
        mask_test_size: int = 28,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.anchor_generator = anchor_generator
        self.in_features = tuple(in_features)
        self.num_classes = num_classes
        self.mask_sizes = tuple(mask_sizes)
        self.min_anchor_size = min_anchor_size
        self.box2box_transform = Box2BoxTransform(tuple(bbox_reg_weights))
        self.focal_loss_alpha, self.focal_loss_gamma = focal_loss_alpha, focal_loss_gamma
        self.mask_on = mask_on
        self.mask_loss_weight, self.mask_pos_weight = mask_loss_weight, mask_pos_weight
        self.bipyramid_on = bipyramid_on
        self.score_threshold, self.topk_candidates, self.nms_threshold = score_threshold, topk_candidates, nms_threshold
        self.detections_im = detections_im
        self.mask_gt_budgets = tuple(mask_gt_budgets)
        self.mask_test_size = mask_test_size
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.input_format = input_format
        self.compute_dtype = _DTYPES[compute_dtype]

    @classmethod
    def from_config(cls, cfg) -> "TensorMask":
        """The model of a yacs ``cfg`` (``MODEL.TENSOR_MASK``), on the CPU."""
        from detectron2_tpu_torch.modeling.backbone import build_backbone

        backbone = build_backbone(cfg)
        t = cfg.MODEL.TENSOR_MASK
        shapes = [backbone.output_shape()[f] for f in t.IN_FEATURES]
        strides = [s.stride for s in shapes]
        sizes0 = cfg.MODEL.ANCHOR_GENERATOR.SIZES[0]
        mask_sizes = tuple(int(s) // strides[0] for s in sizes0)
        head = TensorMaskHead(
            in_channels=shapes[0].channels,
            num_classes=t.NUM_CLASSES,
            num_anchors=len(sizes0),
            mask_sizes=mask_sizes,
            num_convs=t.NUM_CONVS,
            cls_channels=t.CLS_CHANNELS,
            bbox_channels=t.BBOX_CHANNELS,
            mask_channels=t.MASK_CHANNELS,
            mask_on=cfg.MODEL.MASK_ON,
            aligned_on=t.ALIGNED_ON,
            bipyramid_on=t.BIPYRAMID_ON,
        )
        return cls(
            backbone=backbone,
            head=head,
            anchor_generator=build_anchor_generator(cfg, strides),
            in_features=t.IN_FEATURES,
            num_classes=t.NUM_CLASSES,
            mask_sizes=mask_sizes,
            min_anchor_size=min(sizes0) - strides[0],
            bbox_reg_weights=t.BBOX_REG_WEIGHTS,
            focal_loss_alpha=t.FOCAL_LOSS_ALPHA,
            focal_loss_gamma=t.FOCAL_LOSS_GAMMA,
            mask_on=cfg.MODEL.MASK_ON,
            mask_loss_weight=t.MASK_LOSS_WEIGHT,
            mask_pos_weight=t.POSITIVE_WEIGHT,
            bipyramid_on=t.BIPYRAMID_ON,
            score_threshold=t.SCORE_THRESH_TEST,
            topk_candidates=t.TOPK_CANDIDATES_TEST,
            nms_threshold=t.NMS_THRESH_TEST,
            detections_im=cfg.TEST.DETECTIONS_PER_IMAGE,
            mask_gt_budgets=t.MASK_GT_BUDGETS,
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        )

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def preprocess_image(self, image: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std in float32, then the compute dtype."""
        return ((image.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def forward(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None, raw: bool = False):
        """``train=True``: the loss dict (``generator`` is the trainers'
        signature; nothing here draws). Otherwise, under
        ``torch.inference_mode``, the padded detections or, with ``raw``,
        the head's outputs (``logits``, ``deltas``, ``masks`` per level)."""
        if train:
            return self._run(batch, True, generator)
        with torch.inference_mode():
            return self._run(batch, False, None, raw)

    def _run(self, batch: Dict, train: bool, generator, raw: bool = False):
        image = torch.as_tensor(batch["image"], device=self.device)
        features = self.backbone(self.preprocess_image(image), train=train, generator=generator)
        feats = [features[f] for f in self.in_features]
        logits_l, deltas_l, masks_l = self.head(feats, train)
        if raw:
            return {"logits": logits_l, "deltas": deltas_l, "masks": masks_l}
        B, K = feats[0].shape[0], self.num_classes
        grid_sizes = [(f.shape[1], f.shape[2]) for f in feats]
        anchors_l = self.anchor_generator(grid_sizes, self.device)
        logits = torch.cat([x.reshape(B, -1, K) for x in logits_l], dim=1)  # [B, R, K], (h, w, a) order
        deltas = torch.cat([x.reshape(B, -1, 4) for x in deltas_l], dim=1)
        anchors = torch.cat(anchors_l, dim=0)
        if train:
            units = torch.cat([torch.full((a.shape[0],), float(s), device=self.device)
                               for a, s in zip(anchors_l, self.anchor_generator.strides)])
            return self.losses(batch, logits, deltas, masks_l, anchors, units, grid_sizes)
        return self.inference(logits, deltas, masks_l, anchors, grid_sizes)

    def losses(self, batch, logits, deltas, masks_l, anchors, units, grid_sizes) -> Dict[str, torch.Tensor]:
        """Focal loss* over every anchor and class, the L1 box loss and the
        weighted mask BCE over the foregrounds, each divided by
        ``max(num_fg, 1)``."""
        gt_boxes, gt_classes, gt_valid = (torch.as_tensor(batch[k], device=self.device)
                                          for k in ("gt_boxes", "gt_classes", "gt_valid"))
        gt_boxes = gt_boxes.float()
        B, R, K = logits.shape
        A = len(self.mask_sizes)
        matches, fg = tensormask_assignment(gt_boxes, gt_valid, anchors, units, self.min_anchor_size)
        normalizer = fg.sum().float().clamp_min(1.0)

        matched_cls = torch.gather(gt_classes.long(), 1, matches)
        onehot = (torch.where(fg, matched_cls, -1)[..., None] == torch.arange(K, device=self.device)).float()
        loss_cls = sigmoid_focal_loss_star(logits, onehot, self.focal_loss_alpha, self.focal_loss_gamma).sum() / normalizer

        matched_boxes = torch.gather(gt_boxes, 1, matches[..., None].expand(-1, -1, 4))
        gt_deltas = self.box2box_transform.get_deltas(anchors[None].expand_as(matched_boxes), matched_boxes)
        loss_box = ((deltas - gt_deltas).abs() * fg[..., None].float()).sum() / normalizer
        losses = {"loss_cls": loss_cls, "loss_box_reg": loss_box}
        if not self.mask_on or masks_l is None:
            return losses

        gt_masks = torch.as_tensor(batch["gt_masks"], device=self.device).float()
        loss_mask = logits.new_zeros(())
        offset = 0
        for lvl, (Hl, Wl) in enumerate(grid_sizes):
            n_l = Hl * Wl * A
            fg_l = fg[:, offset:offset + n_l].reshape(B, Hl * Wl, A)
            matches_l = matches[:, offset:offset + n_l].reshape(B, Hl * Wl, A)
            anchors_lvl = anchors[offset:offset + n_l].reshape(Hl * Wl, A, 4)
            budget = min(self.mask_gt_budgets[min(lvl, len(self.mask_gt_budgets) - 1)], Hl * Wl)
            factor = 2**lvl if self.bipyramid_on else 1
            for anc in range(A):
                side = self.mask_sizes[anc] * factor
                # the budget's foreground sites first, the lower index first
                _, sites = top_k(fg_l[:, :, anc].float(), budget)  # [B, Kb]
                valid = torch.gather(fg_l[:, :, anc], 1, sites)
                gt_idx = torch.gather(matches_l[:, :, anc], 1, sites)
                pred = masks_l[lvl][anc].reshape(B, Hl * Wl, side * side)
                pm = torch.gather(pred, 1, sites[..., None].expand(-1, -1, side * side)).reshape(B, budget, side, side)
                tgt = crop_gt_masks_to_proposals(gt_masks, gt_boxes, gt_idx, anchors_lvl[sites, anc], side)
                bce = -(self.mask_pos_weight * tgt * F.logsigmoid(pm) + (1.0 - tgt) * F.logsigmoid(-pm))
                loss_mask = loss_mask + (bce * valid.float()[..., None, None]).sum() * (
                    self.mask_loss_weight / float(side * side))
            offset += n_l
        losses["loss_mask"] = loss_mask / normalizer
        return losses

    def inference(self, logits, deltas, masks_l, anchors, grid_sizes) -> Dict[str, torch.Tensor]:
        """The top ``TOPK_CANDIDATES_TEST`` of each image's ``[R * K]``
        probabilities over the threshold (strictly greater), decoded, the
        class-batched NMS on the unclipped boxes, the top
        ``DETECTIONS_PER_IMAGE``; each detection's mask window from its
        (level, anchor), resized to 28, and its anchor box."""
        B, R, K = logits.shape
        A = len(self.mask_sizes)
        flat = torch.sigmoid(logits).reshape(B, R * K)
        flat = torch.where(flat > self.score_threshold, flat, torch.full_like(flat, float("-inf")))
        n_cand = min(self.topk_candidates, R * K)
        top_p, top_idx = top_k(flat, n_cand)
        cls = top_idx % K
        site = top_idx // K
        sel_deltas = torch.gather(deltas, 1, site[..., None].expand(-1, -1, 4))
        boxes = self.box2box_transform.apply_deltas(sel_deltas, anchors[site])
        keep = batched_nms_padded(boxes, top_p, cls, self.nms_threshold, valid=torch.isfinite(top_p))
        scores = torch.where(keep, top_p, torch.full_like(top_p, float("-inf")))
        D = min(self.detections_im, n_cand)
        out_s, oi = top_k(scores, D)
        out_valid = torch.isfinite(out_s)
        psite = torch.gather(site, 1, oi)
        out = {
            "pred_boxes": torch.gather(boxes, 1, oi[..., None].expand(-1, -1, 4)),
            "scores": torch.where(out_valid, out_s, torch.zeros_like(out_s)),
            "pred_classes": torch.gather(cls, 1, oi),
            "valid": out_valid,
        }
        if not self.mask_on or masks_l is None:
            return out
        S = self.mask_test_size
        out_masks = logits.new_zeros((B, D, S, S))
        mask_boxes = logits.new_zeros((B, D, 4))
        offset = 0
        for lvl, (Hl, Wl) in enumerate(grid_sizes):
            n_l = Hl * Wl * A
            factor = 2**lvl if self.bipyramid_on else 1
            anchors_lvl = anchors[offset:offset + n_l].reshape(Hl * Wl, A, 4)
            rel = psite - offset
            hw_idx = torch.div(rel, A, rounding_mode="floor").clamp(0, Hl * Wl - 1)
            for anc in range(A):
                in_bucket = (psite >= offset) & (psite < offset + n_l) & (torch.remainder(rel, A) == anc)
                side = self.mask_sizes[anc] * factor
                pred = masks_l[lvl][anc].reshape(B, Hl * Wl, side * side)
                gathered = torch.gather(pred, 1, hw_idx[..., None].expand(-1, -1, side * side)).reshape(B, D, side, side)
                m = resize_matrix(side, S, "linear").to(self.device)
                resized = torch.einsum("ij,bdjk,lk->bdil", m, gathered, m)
                out_masks = torch.where(in_bucket[..., None, None], torch.sigmoid(resized), out_masks)
                mask_boxes = torch.where(in_bucket[..., None], anchors_lvl[hw_idx, anc], mask_boxes)
            offset += n_l
        out["pred_masks"] = out_masks
        out["mask_boxes"] = mask_boxes
        return out
