"""ROI heads whose mask branch trains from point annotations (counterpart of
the JAX package's ``projects/point_sup/roi_heads.py``), registered in
``ROI_HEADS_REGISTRY``.

- ``PointSupROIHeads``: the standard heads and mask head; the mask loss is
  the binary cross entropy of the predicted mask, bilinear at the matched
  gt's annotated points in the slot's box frame, of the slot's class: a mean
  over the points that are annotated (label 0 or 1), inside the box and of
  a valid slot.
- ``ImplicitPointRendPointSupROIHeads``: Implicit PointRend whose point
  loss is taken at those points instead of uniform ones; no gt mask is read.

d2 names PointSup's mask head ``MaskRCNNConvUpsamplePointSupHead`` under
``StandardROIHeads`` (``configs/PointSup/mask_rcnn_*``);
``build_roi_heads`` gives that pair ``PointSupROIHeads`` (ROADMAP C,
correction 19: the JAX package refuses the name).
"""

import torch

from detectron2_tpu_torch.layers.losses import binary_cross_entropy_with_logits
from detectron2_tpu_torch.modeling.roi_heads.mask_head import MaskRCNNConvUpsampleHead
from detectron2_tpu_torch.modeling.roi_heads.roi_heads import ROI_HEADS_REGISTRY, StandardROIHeads, _batch_index
from detectron2_tpu_torch.projects.point_rend.point_features import point_sample
from detectron2_tpu_torch.projects.point_rend.roi_heads import ImplicitPointRendROIHeads, _class_logits
from detectron2_tpu_torch.projects.point_sup.point_utils import get_point_coords_from_point_annotation

__all__ = ["PointSupROIHeads", "ImplicitPointRendPointSupROIHeads"]


def _annotated_points(targets, fg, boxes: torch.Tensor):
    """The slots' matched gt points in their box frames: (coords ``[R, P,
    2]``, {0, 1} labels ``[R, P]``, weights ``[R, P]``), invalid slots
    weighted 0."""
    assert "gt_point_coords" in targets, "point supervision needs gt_point_coords / gt_point_labels in the batch"
    B, Rf = fg["idx"].shape
    P = targets["gt_point_coords"].shape[2]
    gt_idx = fg["gt_idx"]
    pc = torch.gather(targets["gt_point_coords"].float(), 1, gt_idx[..., None, None].expand(-1, -1, P, 2))
    pl = torch.gather(targets["gt_point_labels"], 1, gt_idx[..., None].expand(-1, -1, P))
    coords, labels, weights = get_point_coords_from_point_annotation(boxes, pc.reshape(B * Rf, P, 2), pl.reshape(B * Rf, P))
    return coords, labels, weights * fg["valid"].reshape(-1, 1).float()


def _point_bce(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    bce = binary_cross_entropy_with_logits(logits, labels)
    return (bce * weights).sum() / weights.sum().clamp_min(1.0)


@ROI_HEADS_REGISTRY.register()
class PointSupROIHeads(StandardROIHeads):
    @classmethod
    def from_config(cls, cfg, input_shape, **kwargs) -> "PointSupROIHeads":
        # d2's MaskRCNNConvUpsamplePointSupHead is the standard head's layers
        if cfg.MODEL.MASK_ON and "mask_head" not in kwargs:
            channels = input_shape[cfg.MODEL.ROI_HEADS.IN_FEATURES[0]].channels
            kwargs["mask_head"] = MaskRCNNConvUpsampleHead.from_config(cfg, channels)
        return super().from_config(cfg, input_shape, **kwargs)

    def _forward_mask_train(self, feats, fg, targets, generator=None):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4).float()
        mask_logits = self.mask_head(self.mask_pooler(feats, boxes, _batch_index(B, Rf, boxes.device)), True)
        coords, labels, weights = _annotated_points(targets, fg, boxes)
        # the class channel first: the same numbers as sampling every channel
        channel = torch.gather(
            mask_logits, 3, fg["gt_classes"].reshape(-1).clamp(0, mask_logits.shape[-1] - 1).long()[:, None, None, None]
            .expand(*mask_logits.shape[:3], 1)
        )
        return {"loss_mask": _point_bce(point_sample(channel, coords)[..., 0], labels, weights)}


@ROI_HEADS_REGISTRY.register()
class ImplicitPointRendPointSupROIHeads(ImplicitPointRendROIHeads):
    def _forward_mask_train(self, feats, fg, targets, generator=None):
        B, Rf = fg["idx"].shape
        boxes = fg["boxes"].reshape(-1, 4).float()
        batch_idx = _batch_index(B, Rf, boxes.device)
        params, loss_l2 = self._params_and_l2(feats, boxes, batch_idx, fg["valid"].reshape(-1))
        coords, labels, weights = _annotated_points(targets, fg, boxes)
        fine, _ = self._fine(feats, boxes, batch_idx, coords)
        logits = _class_logits(self.mask_head.point_head(fine, coords, params), fg["gt_classes"].reshape(-1))
        return {"loss_mask_point": _point_bce(logits, labels, weights), "loss_l2": loss_l2}
