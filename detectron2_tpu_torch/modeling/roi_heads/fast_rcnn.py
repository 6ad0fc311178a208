"""Fast R-CNN output layers, their losses and padded inference (counterpart
of ``detectron2_tpu/modeling/roi_heads/fast_rcnn.py``: FastRCNNOutputLayers,
``losses`` :211, ``fast_rcnn_inference_padded`` :63).

Inference is fixed-shape: score-threshold masking, a static pool of the
``candidate_topk`` best (proposal, class) pairs per image, class-batched
greedy NMS, then exactly ``topk_per_image`` output slots.
"""

from typing import Dict

import torch
from torch import nn

from detectron2_tpu_torch.layers.losses import cross_entropy, smooth_l1_loss
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform
from detectron2_tpu_torch.ops.nms import batched_nms_padded
from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["FastRCNNOutputLayers", "fast_rcnn_inference_padded"]


def fast_rcnn_inference_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    proposal_valid: torch.Tensor,
    image_sizes: torch.Tensor,
    score_thresh: float,
    nms_thresh: float,
    topk_per_image: int,
    candidate_topk: int = 2048,
) -> Dict[str, torch.Tensor]:
    """
    Args:
        boxes: ``[B, P, K, 4]`` per-class decoded boxes (K = classes or 1).
        scores: ``[B, P, C+1]`` probabilities, background last.
        proposal_valid: ``[B, P]``.
        image_sizes: ``[B, 2]`` (h, w).

    Returns:
        pred_boxes ``[B, D, 4]``, scores ``[B, D]`` (0 on padding),
        pred_classes ``[B, D]``, box_idx ``[B, D]`` (source proposal), valid
        ``[B, D]``, with D = ``topk_per_image``.
    """
    B, P, Cp1 = scores.shape
    C = Cp1 - 1
    K = boxes.shape[2]
    s = scores[..., :C]
    h = image_sizes[:, 0].to(boxes.dtype)[:, None, None]
    w = image_sizes[:, 1].to(boxes.dtype)[:, None, None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    b = torch.stack(
        [
            torch.minimum(torch.maximum(boxes[..., 0], zero), w),
            torch.minimum(torch.maximum(boxes[..., 1], zero), h),
            torch.minimum(torch.maximum(boxes[..., 2], zero), w),
            torch.minimum(torch.maximum(boxes[..., 3], zero), h),
        ],
        dim=-1,
    )
    if K == 1:
        b = b.expand(B, P, C, 4)
    finite = torch.isfinite(b).all(dim=-1)
    keep = (s > score_thresh) & proposal_valid[..., None] & finite & torch.isfinite(s)

    neg_inf = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    flat_scores = torch.where(keep, s, neg_inf).reshape(B, -1)
    cand = min(candidate_topk, flat_scores.shape[1])
    top_s, top_idx = top_k(flat_scores, cand)
    prop_idx = top_idx // C
    cls_idx = top_idx % C
    cand_boxes = torch.gather(b.reshape(B, -1, 4), 1, top_idx[..., None].expand(-1, -1, 4))
    cand_valid = torch.isfinite(top_s)

    nms_keep = batched_nms_padded(cand_boxes, top_s, cls_idx, nms_thresh, valid=cand_valid)
    final_scores = torch.where(nms_keep, top_s, neg_inf)
    D = min(topk_per_image, cand)
    out_s, out_i = top_k(final_scores, D)
    out_valid = torch.isfinite(out_s)
    out_boxes = torch.gather(cand_boxes, 1, out_i[..., None].expand(-1, -1, 4))
    out_cls = torch.gather(cls_idx, 1, out_i)
    out_prop = torch.gather(prop_idx, 1, out_i)
    if D < topk_per_image:
        pad = topk_per_image - D
        F = torch.nn.functional
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_s = F.pad(out_s, (0, pad), value=float("-inf"))
        out_cls = F.pad(out_cls, (0, pad))
        out_prop = F.pad(out_prop, (0, pad))
        out_valid = F.pad(out_valid, (0, pad))
    return {
        "pred_boxes": out_boxes,
        "scores": torch.where(out_valid, out_s, torch.zeros_like(out_s)),
        "pred_classes": out_cls,
        "box_idx": out_prop,
        "valid": out_valid,
    }


class FastRCNNOutputLayers(nn.Module):
    """Classification scores and per-class box deltas, in float32."""

    def __init__(
        self,
        input_dim: int,
        num_classes: int,
        box2box_weights=(10.0, 10.0, 5.0, 5.0),
        cls_agnostic_bbox_reg: bool = False,
        test_score_thresh: float = 0.05,
        test_nms_thresh: float = 0.5,
        test_topk_per_image: int = 100,
        smooth_l1_beta: float = 0.0,
        loss_weight_box: float = 1.0,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = nn.Linear(input_dim, num_classes + 1)
        num_bbox_reg_classes = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = nn.Linear(input_dim, num_bbox_reg_classes * 4)
        self.box2box_transform = Box2BoxTransform(box2box_weights)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.smooth_l1_beta = smooth_l1_beta
        self.loss_weight_box = loss_weight_box

    def forward(self, x: torch.Tensor):
        """x: ``[R, D]`` -> (scores ``[R, C+1]``, deltas ``[R, k*4]``)."""
        x = x.reshape(x.shape[0], -1).float()
        return self.cls_score(x), self.bbox_pred(x)

    def losses(
        self, predictions, proposal_boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_classes: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """Masked losses over the sampled slots: ``proposal_boxes`` and the
        matched ``gt_boxes`` ``[R, 4]``, ``gt_classes`` ``[R]`` in ``[0, C]``
        (C background, -1 padding). Cross entropy averaged over the valid
        slots; smooth-L1 of the gt class's deltas summed over the foreground
        slots and divided by the same count."""
        scores, deltas = predictions
        R = scores.shape[0]
        valid = gt_classes >= 0
        fg = valid & (gt_classes < self.num_classes)
        num_valid = valid.sum().clamp_min(1)
        labels = torch.where(valid, gt_classes, torch.full_like(gt_classes, -100))
        loss_cls = cross_entropy(scores, labels, reduction="sum", ignore_index=-100) / num_valid

        k = deltas.shape[1] // 4
        deltas_k = deltas.reshape(R, k, 4)
        if k == 1:
            sel = deltas_k[:, 0]
        else:
            cls = torch.where(fg, gt_classes, torch.zeros_like(gt_classes)).long()
            sel = torch.gather(deltas_k, 1, cls[:, None, None].expand(R, 1, 4))[:, 0]
        gt_deltas = self.box2box_transform.get_deltas(proposal_boxes, gt_boxes).detach()
        reg = smooth_l1_loss(sel, gt_deltas, beta=self.smooth_l1_beta).sum(dim=-1)
        loss_box = (reg * fg.float()).sum() / num_valid
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box * self.loss_weight_box}

    def predict_boxes(self, predictions, proposal_boxes: torch.Tensor) -> torch.Tensor:
        """``[R, k*4]`` deltas decoded against ``[R, 4]`` proposals -> ``[R, k, 4]``."""
        _, deltas = predictions
        out = self.box2box_transform.apply_deltas(deltas, proposal_boxes)
        return out.reshape(deltas.shape[0], -1, 4)

    def predict_probs(self, predictions) -> torch.Tensor:
        scores, _ = predictions
        return torch.softmax(scores, dim=-1)

    def inference(self, predictions, proposal_boxes, proposal_valid, image_sizes):
        B, P = proposal_boxes.shape[:2]
        boxes = self.predict_boxes(predictions, proposal_boxes.reshape(-1, 4)).reshape(B, P, -1, 4)
        probs = self.predict_probs(predictions).reshape(B, P, -1)
        return fast_rcnn_inference_padded(
            boxes, probs, proposal_valid, image_sizes,
            self.test_score_thresh, self.test_nms_thresh, self.test_topk_per_image,
        )
