"""DensePoseROIHeads, the chart branch (counterpart of
``detectron2_tpu/projects/densepose/roi_heads.py:40``): StandardROIHeads
plus the DensePose IUV branch, registered in ``ROI_HEADS_REGISTRY``.

The pool: with ``DECODER_ON`` the FPN decoder's single stride-4 map, pooled
by :func:`~detectron2_tpu_torch.ops.roi_align.roi_align_separable_chan` (two
batched products; person boxes span hundreds of pixels there); otherwise the
FPN levels through ``ROIPooler``, the RoIAlign kernel on the card (the
``_legacy`` configs' 14x14 pool). Both take the box head's pooler type and
the DensePose head's resolution and sampling ratio.

Training: of the sampled slots, up to ``MAX_TRAIN_INSTANCES`` per image
that are foreground, whose IoU with their matched gt is at least
``FG_IOU_THRESHOLD`` and whose gt carries annotated points (the padded form
of d2's DensePoseDataFilter), through ``select_foreground_slots``. Each
slot's gt points go into its box frame and the predictor's maps are sampled
there (``point_sample``): cross entropy of the fine segmentation against
the point's part ``dp_I`` (1..24; 0 is the background channel), of the
coarse segmentation against channel 1 (every annotated point is on the
body), and smooth L1 of U and V at the part's channel, or with
``UV_CONFIDENCE`` the confidence loss. Losses ``loss_densepose_{I,S,U,V}``
(``loss_densepose_UV`` with confidences), each a mean over the valid
points. The JAX loss takes ``dp_I + 1`` as the class (ROADMAP C).

Inference: the branch runs on the first ``MAX_INFERENCE_INSTANCES``
detection slots (they come score-sorted); ``pred_densepose`` ``[B, D, M, M,
3]`` holds per pixel the part (the fine argmax where the coarse argmax is
foreground, else 0) and its U and V clipped to [0, 1], zeros on the slots
not run. ``RAW_OUTPUTS`` adds the predictor's maps as
``pred_densepose_raw``.

What refuses, naming ROADMAP A10: the CSE predictor, the shape-to-shape and
pixel-to-shape cycle losses, ``COARSE_SEGM_TRAINED_BY_MASKS`` and the
bootstrap datasets (the evolution configs).
"""

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers.losses import smooth_l1_loss
from detectron2_tpu_torch.modeling.poolers import ROIPooler
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    StandardROIHeads,
    _batch_index,
    select_foreground_slots,
)
from detectron2_tpu_torch.ops.roi_align import roi_align_separable_chan
from detectron2_tpu_torch.projects.densepose.confidences import (
    iid_isotropic_gaussian_uv_loss,
    indep_anisotropic_gaussian_uv_loss,
)
from detectron2_tpu_torch.projects.densepose.densepose_head import (
    DensePoseDecoder,
    build_densepose_head,
    build_densepose_predictor,
)
from detectron2_tpu_torch.projects.point_rend.point_features import point_sample
from detectron2_tpu_torch.projects.point_sup.point_utils import get_point_coords_from_point_annotation

__all__ = ["DensePoseROIHeads"]


def _refuse_unported(cfg) -> None:
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    for on, what in (
        (h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.ENABLED, "the CSE shape-to-shape cycle loss"),
        (h.CSE.PIX_TO_SHAPE_CYCLE_LOSS.ENABLED, "the CSE pixel-to-shape cycle loss"),
        (h.COARSE_SEGM_TRAINED_BY_MASKS, "ROI_DENSEPOSE_HEAD.COARSE_SEGM_TRAINED_BY_MASKS"),
        (len(cfg.BOOTSTRAP_DATASETS) > 0, "BOOTSTRAP_DATASETS (bootstrap training, the evolution configs)"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP A10)")


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, r]]`` for ``x`` ``[B, G, ...]`` and ``idx`` ``[B, R]``."""
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, index)


def _matched_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU of matched box pairs ``[..., 4]`` -> ``[...]``."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    wh = (torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, iou, torch.zeros_like(iou))


@ROI_HEADS_REGISTRY.register()
class DensePoseROIHeads(StandardROIHeads):
    def __init__(
        self,
        *,
        densepose_head: Optional[nn.Module] = None,
        densepose_predictor: Optional[nn.Module] = None,
        decoder: Optional[DensePoseDecoder] = None,
        densepose_pooler: Optional[ROIPooler] = None,
        densepose_pooler_resolution: int = 28,
        densepose_pooler_sampling_ratio: int = 2,
        index_weight: float = 5.0,
        part_weight: float = 1.0,
        point_regression_weight: float = 0.01,
        uv_confidence: str = "none",
        raw_outputs: bool = False,
        max_inference_instances: int = 24,
        max_train_instances: int = 32,
        densepose_fg_iou_threshold: float = 0.7,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.densepose_head = densepose_head
        self.densepose_predictor = densepose_predictor
        self.decoder = decoder
        self.densepose_pooler = densepose_pooler
        self.densepose_pooler_resolution = densepose_pooler_resolution
        self.densepose_pooler_sampling_ratio = densepose_pooler_sampling_ratio
        self.index_weight = index_weight
        self.part_weight = part_weight
        self.point_regression_weight = point_regression_weight
        self.uv_confidence = uv_confidence
        self.raw_outputs = raw_outputs
        self.max_inference_instances = max_inference_instances
        self.max_train_instances = max_train_instances
        self.densepose_fg_iou_threshold = densepose_fg_iou_threshold

    @classmethod
    def from_config(cls, cfg, input_shape) -> "DensePoseROIHeads":
        if not cfg.MODEL.DENSEPOSE_ON:
            return super().from_config(cfg, input_shape)
        _refuse_unported(cfg)
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        in_features = cfg.MODEL.ROI_HEADS.IN_FEATURES
        bh = cfg.MODEL.ROI_BOX_HEAD
        decoder = DensePoseDecoder.from_config(cfg, input_shape, in_features) if h.DECODER_ON else None
        head = build_densepose_head(cfg, h.DECODER_NUM_CLASSES if decoder else input_shape[in_features[0]].channels)
        pooler = None
        if decoder is None:
            scales = tuple(1.0 / input_shape[f].stride for f in in_features)
            pooler = ROIPooler(h.POOLER_RESOLUTION, scales, h.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE)
        return super().from_config(
            cfg, input_shape,
            densepose_head=head,
            densepose_predictor=build_densepose_predictor(cfg, h.CONV_HEAD_DIM),
            decoder=decoder,
            densepose_pooler=pooler,
            densepose_pooler_resolution=h.POOLER_RESOLUTION,
            densepose_pooler_sampling_ratio=h.POOLER_SAMPLING_RATIO,
            index_weight=h.INDEX_WEIGHTS,
            part_weight=h.PART_WEIGHTS,
            point_regression_weight=h.POINT_REGRESSION_WEIGHTS,
            uv_confidence=h.UV_CONFIDENCE.TYPE if h.UV_CONFIDENCE.ENABLED else "none",
            raw_outputs=h.RAW_OUTPUTS,
            max_inference_instances=h.MAX_INFERENCE_INSTANCES,
            max_train_instances=h.MAX_TRAIN_INSTANCES,
            densepose_fg_iou_threshold=h.FG_IOU_THRESHOLD,
        )

    def forward_with_given_boxes(self, features: Dict[str, torch.Tensor], detections: Dict) -> Dict:
        detections = super().forward_with_given_boxes(features, detections)
        if self.densepose_head is not None:
            detections = self._forward_densepose_inference([features[f] for f in self.in_features], detections)
        return detections

    def _forward_mask_keypoint_train(self, feats, sampled, targets):
        losses = super()._forward_mask_keypoint_train(feats, sampled, targets)
        if self.densepose_head is not None and "gt_dp_points" in targets:
            losses.update(self._forward_densepose_train(feats, sampled, targets))
        return losses

    def _densepose_pool(self, feats: List[torch.Tensor], boxes: torch.Tensor, B: int, train: bool) -> torch.Tensor:
        """``[R, res, res, C]`` DensePose features of ``boxes`` ``[B * K, 4]``
        (K rois an image, in image order)."""
        if self.decoder is None:
            return self.densepose_pooler(feats, boxes, _batch_index(B, boxes.shape[0] // B, boxes.device))
        dec = self.decoder(feats, train)
        res = self.densepose_pooler_resolution
        out = roi_align_separable_chan(
            dec, boxes.reshape(B, -1, 4), res, spatial_scale=self.box_pooler.scales[0],
            sampling_ratio=self.densepose_pooler_sampling_ratio, aligned=self.box_pooler.aligned,
        )
        return out.reshape(-1, res, res, dec.shape[-1])

    def _densepose_outputs(self, feats, boxes, B, train) -> Dict[str, torch.Tensor]:
        return self.densepose_predictor(self.densepose_head(self._densepose_pool(feats, boxes, B, train), train))

    def _densepose_train_mask(self, sampled, targets) -> torch.Tensor:
        """The slots that qualify for the branch ``[B, S]``: foreground, IoU
        with the matched gt at least the threshold, and a gt with points."""
        gt_boxes = _gather_slots(targets["gt_boxes"].float(), sampled["gt_idx"])
        iou = _matched_iou(gt_boxes, sampled["boxes"])
        has_pts = (targets["gt_dp_part"] >= 0).any(-1)
        slot_has_pts = torch.gather(has_pts, 1, sampled["gt_idx"])
        return sampled["is_fg"] & (iou >= self.densepose_fg_iou_threshold) & slot_has_pts

    def _forward_densepose_train(self, feats, sampled, targets) -> Dict[str, torch.Tensor]:
        B = sampled["gt_classes"].shape[0]
        if self.max_train_instances > 0:
            Rf = min(self.max_train_instances, self.fg_budget)
            dp_mask = self._densepose_train_mask(sampled, targets)
        else:
            Rf, dp_mask = self.fg_budget, sampled["is_fg"]
        fg_idx, fg_valid = select_foreground_slots(dp_mask, Rf)
        boxes = _gather_slots(sampled["boxes"], fg_idx).reshape(-1, 4)
        fg_gt_idx = torch.gather(sampled["gt_idx"], 1, fg_idx)
        valid = fg_valid.reshape(-1).float()
        out = self._densepose_outputs(feats, boxes, B, True)
        K = out["fine_segm"].shape[-1]

        # the matched gt's points, in the slot's box frame
        pts = _gather_slots(targets["gt_dp_points"].float(), fg_gt_idx).flatten(0, 1)  # [R, P, 2]
        part = _gather_slots(targets["gt_dp_part"], fg_gt_idx).flatten(0, 1).long()  # [R, P]
        gt_u = _gather_slots(targets["gt_dp_u"].float(), fg_gt_idx).flatten(0, 1)
        gt_v = _gather_slots(targets["gt_dp_v"].float(), fg_gt_idx).flatten(0, 1)
        coords, _, weights = get_point_coords_from_point_annotation(
            boxes, pts, torch.where(part >= 0, torch.ones_like(part), -torch.ones_like(part))
        )
        w = weights * valid[:, None]
        norm = w.sum().clamp_min(1.0)

        part_cls = part.clamp(0, K - 1)[..., None]
        logp = F.log_softmax(point_sample(out["fine_segm"], coords), dim=-1)
        loss_index = (-torch.gather(logp, -1, part_cls)[..., 0] * w).sum() / norm
        logp_c = F.log_softmax(point_sample(out["coarse_segm"], coords), dim=-1)
        loss_coarse = (-logp_c[..., 1] * w).sum() / norm

        def at_part(name):
            return torch.gather(point_sample(out[name], coords), -1, part_cls)[..., 0]

        u_at, v_at = at_part("u"), at_part("v")
        losses = {
            "loss_densepose_I": loss_index * self.part_weight,
            "loss_densepose_S": loss_coarse * self.index_weight,
        }
        if self.uv_confidence == "none":
            losses["loss_densepose_U"] = (smooth_l1_loss(u_at, gt_u, beta=0.0) * w).sum() / norm * self.point_regression_weight
            losses["loss_densepose_V"] = (smooth_l1_loss(v_at, gt_v, beta=0.0) * w).sum() / norm * self.point_regression_weight
        elif self.uv_confidence == "iid_iso":
            loss_uv = iid_isotropic_gaussian_uv_loss(u_at, v_at, at_part("sigma_2"), gt_u, gt_v, w)
            losses["loss_densepose_UV"] = loss_uv * self.point_regression_weight
        else:
            loss_uv = indep_anisotropic_gaussian_uv_loss(
                u_at, v_at, at_part("sigma_2"), at_part("kappa_u"), at_part("kappa_v"), gt_u, gt_v, w
            )
            losses["loss_densepose_UV"] = loss_uv * self.point_regression_weight
        return losses

    def _forward_densepose_inference(self, feats, detections: Dict) -> Dict:
        B, D = detections["pred_classes"].shape
        K = D if self.max_inference_instances <= 0 else min(D, self.max_inference_instances)
        out = self._densepose_outputs(feats, detections["pred_boxes"][:, :K].reshape(-1, 4), B, False)

        def pad_slots(x):
            """``[B * K, ...]`` -> ``[B, D, ...]``, zeros on the slots not run."""
            x = x.reshape((B, K) + x.shape[1:])
            return x if K == D else F.pad(x, (0, 0) * (x.dim() - 2) + (0, D - K))

        if self.raw_outputs:
            detections["pred_densepose_raw"] = {k: pad_slots(v) for k, v in out.items()}
        part = out["fine_segm"].argmax(dim=-1)  # [R, M, M]
        u = torch.gather(out["u"], -1, part[..., None])[..., 0]
        v = torch.gather(out["v"], -1, part[..., None])[..., 0]
        part = torch.where(out["coarse_segm"].argmax(dim=-1) > 0, part, torch.zeros_like(part))
        detections["pred_densepose"] = pad_slots(torch.stack([part.float(), u.clamp(0, 1), v.clamp(0, 1)], dim=-1))
        return detections
