"""Box delta encode/decode and the dense regression loss (counterpart of
``detectron2_tpu/modeling/box_regression.py``)."""

import math
from typing import Tuple

import torch

from detectron2_tpu_torch.layers.losses import IOU_LOSSES, smooth_l1_loss

__all__ = ["Box2BoxTransform", "Box2BoxTransformLinear", "_dense_box_regression_loss"]

# dw/dh are clamped so exp() cannot overflow: a box grows at most 1000/16
# times per decode
_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


class Box2BoxTransform:
    """The (dx, dy, dw, dh) parameterization of Faster R-CNN."""

    def __init__(self, weights: Tuple[float, float, float, float], scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """Encode ``target_boxes`` relative to ``src_boxes``: ``[..., 4]`` ->
        ``[..., 4]``. Zero-size source rows (padding) are guarded; callers
        mask their outputs."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h
        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        safe_w = src_w.clamp_min(1e-6)
        safe_h = src_h.clamp_min(1e-6)
        dx = wx * (tgt_cx - src_cx) / safe_w
        dy = wy * (tgt_cy - src_cy) / safe_h
        dw = ww * torch.log(tgt_w.clamp_min(1e-6) / safe_w)
        dh = wh * torch.log(tgt_h.clamp_min(1e-6) / safe_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Decode ``deltas [..., k*4]`` against ``boxes [..., 4]`` -> ``[..., k*4]``."""
        boxes = boxes.to(deltas.dtype)
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp_max(d[..., 2] / ww, self.scale_clamp)
        dh = torch.clamp_max(d[..., 3] / wh, self.scale_clamp)

        pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
        pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]
        out = torch.stack(
            [
                pred_ctr_x - 0.5 * pred_w,
                pred_ctr_y - 0.5 * pred_h,
                pred_ctr_x + 0.5 * pred_w,
                pred_ctr_y + 0.5 * pred_h,
            ],
            dim=-1,
        )
        return out.reshape(shape)


class Box2BoxTransformLinear:
    """The distance-to-edges (l, t, r, b) parameterization of FCOS, measured
    from the source boxes' centres and, with ``normalize_by_size``, divided
    by their width and height (the point anchors' stride)."""

    def __init__(self, normalize_by_size: bool = True):
        self.normalize_by_size = normalize_by_size

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """``[..., 4]`` distances from each source centre to the target's
        edges, divided by ``max(stride, 1e-6)``."""
        src_cx = 0.5 * (src_boxes[..., 0] + src_boxes[..., 2])
        src_cy = 0.5 * (src_boxes[..., 1] + src_boxes[..., 3])
        deltas = torch.stack(
            [
                src_cx - target_boxes[..., 0],
                src_cy - target_boxes[..., 1],
                target_boxes[..., 2] - src_cx,
                target_boxes[..., 3] - src_cy,
            ],
            dim=-1,
        )
        if self.normalize_by_size:
            stride_w = src_boxes[..., 2] - src_boxes[..., 0]
            stride_h = src_boxes[..., 3] - src_boxes[..., 1]
            strides = torch.stack([stride_w, stride_h, stride_w, stride_h], dim=-1)
            deltas = deltas / strides.clamp_min(1e-6)
        return deltas

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Decode ``relu(deltas) [..., k*4]`` around the centres of ``boxes
        [..., 4]`` (a negative distance means nothing)."""
        deltas = torch.relu(deltas)
        boxes = boxes.to(deltas.dtype)
        ctr_x = 0.5 * (boxes[..., 0] + boxes[..., 2])
        ctr_y = 0.5 * (boxes[..., 1] + boxes[..., 3])
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 4))
        if self.normalize_by_size:
            stride_w = (boxes[..., 2] - boxes[..., 0])[..., None]
            stride_h = (boxes[..., 3] - boxes[..., 1])[..., None]
            d = torch.stack(
                [d[..., 0] * stride_w, d[..., 1] * stride_h, d[..., 2] * stride_w, d[..., 3] * stride_h], dim=-1
            )
        out = torch.stack(
            [
                ctr_x[..., None] - d[..., 0],
                ctr_y[..., None] - d[..., 1],
                ctr_x[..., None] + d[..., 2],
                ctr_y[..., None] + d[..., 3],
            ],
            dim=-1,
        )
        return out.reshape(shape)


def _dense_box_regression_loss(
    anchors: torch.Tensor,
    box2box_transform,
    pred_anchor_deltas: torch.Tensor,
    gt_boxes: torch.Tensor,
    fg_mask: torch.Tensor,
    box_reg_loss_type: str = "smooth_l1",
    smooth_l1_beta: float = 0.0,
) -> torch.Tensor:
    """Sum of the box loss over foreground positions, as a product with the
    mask: anchors, deltas and matched gt boxes ``[..., 4]``, ``fg_mask``
    ``[...]``. ``"smooth_l1"`` compares the deltas with the gt's encoding,
    ``"giou"``, ``"diou"`` and ``"ciou"`` the decoded boxes with the gt
    boxes."""
    fg = fg_mask.float()
    if box_reg_loss_type == "smooth_l1":
        gt_deltas = box2box_transform.get_deltas(anchors, gt_boxes).detach()
        loss = smooth_l1_loss(pred_anchor_deltas, gt_deltas, beta=smooth_l1_beta)
        return (loss.sum(dim=-1) * fg).sum()
    if box_reg_loss_type in IOU_LOSSES:
        pred_boxes = box2box_transform.apply_deltas(pred_anchor_deltas, anchors)
        return (IOU_LOSSES[box_reg_loss_type](pred_boxes, gt_boxes) * fg).sum()
    raise ValueError(f"Invalid dense box regression loss type {box_reg_loss_type!r}")
