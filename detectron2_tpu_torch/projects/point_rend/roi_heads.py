"""PointRend ROI heads (counterpart of the JAX package's
``projects/point_rend/roi_heads.py``): StandardROIHeads whose mask branch is
PointRend's, registered in ``ROI_HEADS_REGISTRY``.

The box branch is the standard one (B1/B2 on the card). The mask branch
pools no RoIAlign: its coarse pool samples the ``ROI_MASK_HEAD.IN_FEATURES``
maps at the cell centres of a ``POOLER_RESOLUTION`` grid in each box
(``point_sample_fine_grained_features``).

- ``PointRendROIHeads``: ``roi_heads.mask_head`` holds d2's ``coarse_head``
  (``CoarseMaskHead``) and ``point_head`` (``StandardPointHead``).
  Training: the coarse mask loss against each slot's crop of its gt mask at
  the coarse side, then the point loss at ``TRAIN_NUM_POINTS`` points drawn
  by uncertainty from the (detached) coarse logits; a point's label is its
  matched gt's bitmask, bilinear at the point in the gt box's frame, >= 0.5.
  Inference: the point head on a regular grid at the initial resolution
  (d2's shortcut: 7 becomes 14, one step fewer, while ``4 * res^2 <=
  SUBDIVISION_NUM_POINTS``), then each step upsamples the class logits 2x
  bilinear (as ``jax.image.resize``) and re-evaluates the
  ``SUBDIVISION_NUM_POINTS`` most uncertain cells.
- ``ImplicitPointRendROIHeads``: ``roi_heads.mask_head`` holds
  ``parameter_head`` (each instance's MLP) and ``point_head``
  (``ImplicitPointHead``). Training: uniform points in the box, the point
  loss and ``loss_l2``, the parameters' squares as a mean over the valid
  slots; inference starts from a ``sqrt(SUBDIVISION_NUM_POINTS)`` grid.

Every draw comes from the train step's generator through
``point_features.point_draws``.
"""

from typing import Dict

import torch
from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.modeling.roi_heads.mask_head import build_mask_head, mask_rcnn_loss
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import (
    ROI_HEADS_REGISTRY,
    StandardROIHeads,
    _batch_index,
    crop_gt_masks_to_proposals,
)
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import upsample_bilinear
from detectron2_tpu_torch.projects.point_rend import point_features
from detectron2_tpu_torch.projects.point_rend.coarse_mask_head import ImplicitParameterHead
from detectron2_tpu_torch.projects.point_rend.point_features import (
    generate_regular_grid_point_coords,
    get_uncertain_point_coords_on_grid,
    get_uncertain_point_coords_with_randomness,
    point_sample,
    point_sample_fine_grained_features,
)
from detectron2_tpu_torch.projects.point_rend.point_head import ImplicitPointHead, build_point_head, roi_mask_point_loss

__all__ = ["PointRendROIHeads", "ImplicitPointRendROIHeads"]


def _class_logits(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """``[R, ..., C]`` -> each roi's class channel ``[R, ...]``."""
    C = logits.shape[-1]
    if C == 1:
        return logits[..., 0]
    cls = classes.clamp(0, C - 1).long().reshape(-1, *([1] * (logits.dim() - 1)))
    return torch.gather(logits, -1, cls.expand(*logits.shape[:-1], 1))[..., 0]


def gt_point_labels(targets: Dict[str, torch.Tensor], fg: Dict[str, torch.Tensor], abs_coords: torch.Tensor) -> torch.Tensor:
    """{0, 1} labels ``[R, P]`` of image points ``[R, P, 2]`` of the slots
    ``fg``: each point in its matched gt box's frame, the gt bitmask
    (rasterized inside that box) bilinear there, >= 0.5."""
    gt_masks = targets["gt_masks"]
    B, G = gt_masks.shape[:2]
    src = (fg["gt_idx"] + torch.arange(B, device=gt_masks.device)[:, None] * G).reshape(-1)
    masks = gt_masks.reshape(B * G, *gt_masks.shape[2:])[src].float()
    g = targets["gt_boxes"].float().reshape(B * G, 4)[src]
    gw = (g[:, 2] - g[:, 0]).clamp_min(1e-4)
    gh = (g[:, 3] - g[:, 1]).clamp_min(1e-4)
    norm = torch.stack(
        [(abs_coords[..., 0] - g[:, 0, None]) / gw[:, None], (abs_coords[..., 1] - g[:, 1, None]) / gh[:, None]], dim=-1
    )
    return (point_sample(masks[..., None], norm)[..., 0] >= 0.5).float()


class PointRendMaskHead(nn.Module):
    """d2's ``roi_heads.mask_head`` of PointRend: its two heads."""

    def __init__(self, coarse_head: nn.Module, point_head: nn.Module):
        super().__init__()
        self.coarse_head = coarse_head
        self.point_head = point_head


class ImplicitPointRendMaskHead(nn.Module):
    """d2's ``roi_heads.mask_head`` of Implicit PointRend."""

    def __init__(self, parameter_head: nn.Module, point_head: ImplicitPointHead):
        super().__init__()
        self.parameter_head = parameter_head
        self.point_head = point_head


@ROI_HEADS_REGISTRY.register()
class PointRendROIHeads(StandardROIHeads):
    def __init__(self, *, point_in_features, point_scales, coarse_in_features, coarse_scales, coarse_pooler_resolution: int,
                 train_num_points: int, oversample_ratio: int, importance_sample_ratio: float, subdivision_steps: int,
                 subdivision_num_points: int, subdivision_init_resolution: int, **kwargs):
        super().__init__(**kwargs)
        self.point_in_features = tuple(point_in_features)
        self.point_scales = tuple(point_scales)
        self.coarse_in_features = tuple(coarse_in_features)
        self.coarse_scales = tuple(coarse_scales)
        self.coarse_pooler_resolution = coarse_pooler_resolution
        self.train_num_points = train_num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.subdivision_init_resolution = subdivision_init_resolution

    @classmethod
    def _point_args(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> dict:
        mh, ph = cfg.MODEL.ROI_MASK_HEAD, cfg.MODEL.POINT_HEAD
        return dict(
            point_in_features=ph.IN_FEATURES,
            point_scales=[1.0 / input_shape[f].stride for f in ph.IN_FEATURES],
            coarse_in_features=mh.IN_FEATURES,
            coarse_scales=[1.0 / input_shape[f].stride for f in mh.IN_FEATURES],
            coarse_pooler_resolution=mh.POOLER_RESOLUTION,
            train_num_points=ph.TRAIN_NUM_POINTS,
            oversample_ratio=ph.OVERSAMPLE_RATIO,
            importance_sample_ratio=ph.IMPORTANCE_SAMPLE_RATIO,
            subdivision_num_points=ph.SUBDIVISION_NUM_POINTS,
        )

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec], **kwargs) -> "PointRendROIHeads":
        args = cls._point_args(cfg, input_shape)
        # d2's shortcut: start at a 2x larger grid while it fits the budget
        init_res, steps = cfg.MODEL.ROI_MASK_HEAD.OUTPUT_SIDE_RESOLUTION, cfg.MODEL.POINT_HEAD.SUBDIVISION_STEPS
        while 4 * init_res**2 <= args["subdivision_num_points"]:
            init_res, steps = init_res * 2, steps - 1
        args.update(subdivision_init_resolution=init_res, subdivision_steps=max(steps, 0))
        if cfg.MODEL.MASK_ON and "mask_head" not in kwargs:
            coarse_ch = sum(input_shape[f].channels for f in args["coarse_in_features"])
            point_ch = sum(input_shape[f].channels for f in args["point_in_features"])
            kwargs["mask_head"] = PointRendMaskHead(build_mask_head(cfg, coarse_ch), build_point_head(cfg, point_ch))
        args.update(kwargs)
        return super().from_config(cfg, input_shape, **args)

    def _by_name(self, feats, names):
        index_of = {f: i for i, f in enumerate(self.in_features)}
        return [feats[index_of[f]] for f in names]

    def _coarse_pool(self, feats, boxes: torch.Tensor, batch_idx: torch.Tensor) -> torch.Tensor:
        """The coarse head's input ``[R, res, res, C]``: the image features
        at the cell centres of a regular grid in each box."""
        R, res = boxes.shape[0], self.coarse_pooler_resolution
        grid = generate_regular_grid_point_coords(R, res, boxes.device)
        pts, _ = point_sample_fine_grained_features(
            self._by_name(feats, self.coarse_in_features), self.coarse_scales, boxes, batch_idx, grid
        )
        return pts.reshape(R, res, res, pts.shape[-1])

    def _fine(self, feats, boxes, batch_idx, coords):
        return point_sample_fine_grained_features(
            self._by_name(feats, self.point_in_features), self.point_scales, boxes, batch_idx, coords
        )

    def _forward_mask_train(self, feats, fg, targets, generator=None):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4).float()
        batch_idx = _batch_index(B, Rf, boxes.device)
        classes, valid = fg["gt_classes"].reshape(-1), fg["valid"].reshape(-1)
        coarse = self.mask_head.coarse_head(self._coarse_pool(feats, boxes, batch_idx), True)
        side = coarse.shape[1]
        gt_coarse = crop_gt_masks_to_proposals(targets["gt_masks"], targets["gt_boxes"], fg["gt_idx"], fg["boxes"], side)
        loss_mask = mask_rcnn_loss(coarse, classes, gt_coarse.reshape(-1, side, side), valid)
        coords = get_uncertain_point_coords_with_randomness(
            coarse.detach(), classes, self.train_num_points, self.oversample_ratio, self.importance_sample_ratio, generator
        )
        fine, abs_coords = self._fine(feats, boxes, batch_idx, coords)
        point_logits = self.mask_head.point_head(fine, point_sample(coarse, coords))
        loss_point = roi_mask_point_loss(point_logits, classes, gt_point_labels(targets, fg, abs_coords), valid)
        return {"loss_mask": loss_mask, "loss_mask_point": loss_point}

    def _mask_predictor(self, feats, boxes, batch_idx):
        """``coords [R, P, 2] -> point logits [R, P, C]`` of the boxes."""
        coarse = self.mask_head.coarse_head(self._coarse_pool(feats, boxes, batch_idx), False)
        return lambda coords: self.mask_head.point_head(self._fine(feats, boxes, batch_idx, coords)[0],
                                                        point_sample(coarse, coords))

    def _forward_mask_inference(self, feats, boxes, batch_idx, classes):
        """The subdivision loop: probabilities ``[R, M, M]``, M the initial
        resolution times ``2 ** subdivision_steps``. Only each roi's class
        channel is carried (the JAX loop carries every class: the upsample
        treats channels apart and only the class channel is read, so the
        numbers are the same, at 1/C of the memory: Implicit PointRend's
        224x224 logits of 80 classes at 1600 rois are a ``[1600, 224, 224,
        80]`` float32 tensor, 25.7 GB)."""
        boxes = boxes.float()
        predict = self._mask_predictor(feats, boxes, batch_idx)
        R, init = boxes.shape[0], self.subdivision_init_resolution
        point_logits = _class_logits(predict(generate_regular_grid_point_coords(R, init, boxes.device)), classes)
        logits = point_logits.reshape(R, init, init, 1)  # the grid is row-major
        for _ in range(self.subdivision_steps):
            logits = upsample_bilinear(logits, 2)
            H, W = logits.shape[1:3]
            idx, coords = get_uncertain_point_coords_on_grid(-logits[..., 0].abs(), self.subdivision_num_points)
            flat = logits.reshape(R, H * W).scatter(1, idx, _class_logits(predict(coords), classes))
            logits = flat.reshape(R, H, W, 1)
        return torch.sigmoid(logits[..., 0])


@ROI_HEADS_REGISTRY.register()
class ImplicitPointRendROIHeads(PointRendROIHeads):
    def __init__(self, *, params_l2_regularizer: float, **kwargs):
        super().__init__(**kwargs)
        self.params_l2_regularizer = params_l2_regularizer

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec], **kwargs) -> "ImplicitPointRendROIHeads":
        args = cls._point_args(cfg, input_shape)
        init_res = int(cfg.MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS**0.5)
        assert init_res**2 == cfg.MODEL.POINT_HEAD.SUBDIVISION_NUM_POINTS
        args.update(subdivision_init_resolution=init_res, subdivision_steps=cfg.MODEL.POINT_HEAD.SUBDIVISION_STEPS,
                     params_l2_regularizer=cfg.MODEL.IMPLICIT_POINTREND.PARAMS_L2_REGULARIZER)
        if cfg.MODEL.MASK_ON and "mask_head" not in kwargs:
            coarse_ch = sum(input_shape[f].channels for f in args["coarse_in_features"])
            point_head = ImplicitPointHead.from_config(cfg, sum(input_shape[f].channels for f in args["point_in_features"]))
            kwargs["mask_head"] = ImplicitPointRendMaskHead(
                ImplicitParameterHead.from_config(cfg, coarse_ch, point_head.num_params), point_head
            )
        args.update(kwargs)
        return StandardROIHeads.from_config.__func__(cls, cfg, input_shape, **args)

    def _params_and_l2(self, feats, boxes, batch_idx, valid):
        params = self.mask_head.parameter_head(self._coarse_pool(feats, boxes, batch_idx), True)
        w = valid.float()[:, None]
        loss = self.params_l2_regularizer * (params**2 * w).sum() / (w.sum() * params.shape[1]).clamp_min(1.0)
        return params, loss

    def _forward_mask_train(self, feats, fg, targets, generator=None):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4).float()
        batch_idx = _batch_index(B, Rf, boxes.device)
        classes, valid = fg["gt_classes"].reshape(-1), fg["valid"].reshape(-1)
        params, loss_l2 = self._params_and_l2(feats, boxes, batch_idx, valid)
        coords = point_features.point_draws((boxes.shape[0], self.train_num_points, 2), generator, boxes.device)
        fine, abs_coords = self._fine(feats, boxes, batch_idx, coords)
        point_logits = self.mask_head.point_head(fine, coords, params)
        loss_point = roi_mask_point_loss(point_logits, classes, gt_point_labels(targets, fg, abs_coords), valid)
        return {"loss_mask_point": loss_point, "loss_l2": loss_l2}

    def _mask_predictor(self, feats, boxes, batch_idx):
        params = self.mask_head.parameter_head(self._coarse_pool(feats, boxes, batch_idx), False)
        return lambda coords: self.mask_head.point_head(self._fine(feats, boxes, batch_idx, coords)[0], coords, params)
