"""Box delta encode/decode and the dense regression loss (counterpart of
``detectron2_tpu/modeling/box_regression.py``)."""

import math
from typing import Tuple

import torch

from detectron2_tpu_torch.layers.losses import smooth_l1_loss

__all__ = ["Box2BoxTransform", "_dense_box_regression_loss"]

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


def _dense_box_regression_loss(
    anchors: torch.Tensor,
    box2box_transform: Box2BoxTransform,
    pred_anchor_deltas: torch.Tensor,
    gt_boxes: torch.Tensor,
    fg_mask: torch.Tensor,
    box_reg_loss_type: str = "smooth_l1",
    smooth_l1_beta: float = 0.0,
) -> torch.Tensor:
    """Sum of the smooth-L1 loss over foreground positions: anchors, deltas
    and matched gt boxes ``[..., 4]``, ``fg_mask`` ``[...]``. The other loss
    types of the JAX package come with the heads that use them."""
    if box_reg_loss_type != "smooth_l1":
        raise NotImplementedError(f"box regression loss {box_reg_loss_type!r} is not ported yet")
    gt_deltas = box2box_transform.get_deltas(anchors, gt_boxes).detach()
    loss = smooth_l1_loss(pred_anchor_deltas, gt_deltas, beta=smooth_l1_beta)
    return (loss.sum(dim=-1) * fg_mask.float()).sum()
