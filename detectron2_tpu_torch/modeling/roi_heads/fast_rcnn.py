"""Fast R-CNN output layers, their losses and padded inference (counterpart
of ``detectron2_tpu/modeling/roi_heads/fast_rcnn.py``: FastRCNNOutputLayers,
``losses`` :211, ``fast_rcnn_inference_padded`` :63, ``fed_loss_class_mask``
:28).

Inference is fixed-shape: score-threshold masking, a static pool of the
``candidate_topk`` best (proposal, class) pairs per image, class-batched
greedy NMS, then exactly ``topk_per_image`` output slots.

The classification loss is softmax cross entropy, or with
``use_sigmoid_ce`` a per-class sigmoid cross entropy (LVIS), optionally
restricted by the federated loss to the classes that appear among the
sampled proposals and ``fed_loss_num_classes`` drawn by frequency. The box
loss is smooth-L1 on the deltas, or GIoU, DIoU or CIoU on the boxes decoded
against the proposals.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers.losses import (
    IOU_LOSSES,
    binary_cross_entropy_with_logits,
    cross_entropy,
    smooth_l1_loss,
)
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform
from detectron2_tpu_torch.ops.nms import batched_nms_padded
from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["FastRCNNOutputLayers", "fast_rcnn_inference_padded", "fed_loss_class_mask", "gumbel_draws"]


def gumbel_draws(num_classes: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The federated loss's ``[num_classes]`` standard Gumbel draws,
    ``-log(-log(u))`` of uniform ``u`` in [tiny, 1). One function, so that a
    test can supply them."""
    u = torch.rand(num_classes, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def fed_loss_class_mask(
    gumbel: torch.Tensor,
    gt_classes: torch.Tensor,
    valid: torch.Tensor,
    num_classes: int,
    num_fed_loss_classes: int,
    weights: torch.Tensor,
) -> torch.Tensor:
    """``[C]`` bool: the classes whose sigmoid CE counts in the federated
    loss. Every class among the valid ``gt_classes`` (``[R]`` in ``[0, C]``,
    C background) is kept; the appeared classes are counted with the
    background, and ``max(num_fed_loss_classes - n_appeared, 0)`` more are
    drawn without replacement from the others with probability proportional
    to ``weights`` ``[C]`` (none of weight 0), as a Gumbel top-k on the
    ``gumbel`` draws ``[C]``: the same distribution as d2's
    ``torch.multinomial`` without replacement."""
    C = num_classes
    idx = torch.where(valid, gt_classes, torch.full_like(gt_classes, C + 1)).long()
    appeared = torch.zeros(C + 2, dtype=torch.bool, device=gt_classes.device).index_fill_(0, idx, True)[: C + 1]
    n_appeared = appeared.sum()

    prob = torch.where(appeared[:C], torch.zeros_like(weights, dtype=torch.float32), weights.float())
    neg_inf = torch.tensor(float("-inf"), device=prob.device)
    scores = torch.where(prob > 0, torch.log(prob.clamp_min(1e-30)) + gumbel, neg_inf)
    order = torch.argsort(-scores, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(C, device=order.device))  # 0 = best
    n_neg = (num_fed_loss_classes - n_appeared).clamp_min(0)
    sampled = (rank < n_neg) & (prob > 0)
    return appeared[:C] | sampled


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
        box_reg_loss_type: str = "smooth_l1",
        loss_weight_cls: float = 1.0,
        loss_weight_box: float = 1.0,
        use_sigmoid_ce: bool = False,
        use_fed_loss: bool = False,
        fed_loss_num_classes: int = 50,
        fed_loss_cls_weights: Optional[Sequence[float]] = None,
    ):
        super().__init__()
        if use_fed_loss and not use_sigmoid_ce:
            raise ValueError("use_fed_loss needs use_sigmoid_ce")
        if use_fed_loss and (fed_loss_cls_weights is None or len(fed_loss_cls_weights) != num_classes):
            raise ValueError(f"use_fed_loss needs {num_classes} fed_loss_cls_weights")
        if box_reg_loss_type != "smooth_l1" and box_reg_loss_type not in IOU_LOSSES:
            raise ValueError(f"Invalid bbox reg loss type {box_reg_loss_type!r}")
        self.num_classes = num_classes
        self.cls_score = nn.Linear(input_dim, num_classes + 1)
        num_bbox_reg_classes = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = nn.Linear(input_dim, num_bbox_reg_classes * 4)
        self.box2box_transform = Box2BoxTransform(box2box_weights)
        self.test_score_thresh = test_score_thresh
        self.test_nms_thresh = test_nms_thresh
        self.test_topk_per_image = test_topk_per_image
        self.smooth_l1_beta = smooth_l1_beta
        self.box_reg_loss_type = box_reg_loss_type
        self.loss_weight_cls = loss_weight_cls
        self.loss_weight_box = loss_weight_box
        self.use_sigmoid_ce = use_sigmoid_ce
        self.use_fed_loss = use_fed_loss
        self.fed_loss_num_classes = fed_loss_num_classes
        if use_fed_loss:  # on the model's device, outside the state dict
            weights = torch.as_tensor(np.asarray(fed_loss_cls_weights, dtype=np.float32))
            self.register_buffer("fed_loss_weights", weights, persistent=False)

    def forward(self, x: torch.Tensor):
        """x: ``[R, D]`` -> (scores ``[R, C+1]``, deltas ``[R, k*4]``)."""
        x = x.reshape(x.shape[0], -1).float()
        return self.cls_score(x), self.bbox_pred(x)

    def losses(
        self,
        predictions,
        proposal_boxes: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_classes: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Masked losses over the sampled slots: ``proposal_boxes`` and the
        matched ``gt_boxes`` ``[R, 4]``, ``gt_classes`` ``[R]`` in ``[0, C]``
        (C background, -1 padding). Cross entropy (softmax, or sigmoid summed
        over the classes, masked by the federated loss whose draws come from
        ``generator``) averaged over the valid slots; the box loss of the gt
        class's deltas (smooth-L1 against the gt's encoding, or an IoU loss of
        the boxes they decode to) summed over the foreground slots and divided
        by the same count."""
        scores, deltas = predictions
        R = scores.shape[0]
        C = self.num_classes
        valid = gt_classes >= 0
        fg = valid & (gt_classes < C)
        num_valid = valid.sum().clamp_min(1)
        if self.use_sigmoid_ce:
            onehot = F.one_hot(torch.where(valid, gt_classes, torch.full_like(gt_classes, C)).long(), C + 1)[:, :C]
            ce = binary_cross_entropy_with_logits(scores[:, :C], onehot.to(scores.dtype))
            if self.use_fed_loss:
                cls_mask = fed_loss_class_mask(
                    gumbel_draws(C, generator, scores.device), gt_classes, valid, C, self.fed_loss_num_classes,
                    self.fed_loss_weights,
                )
                ce = ce * cls_mask[None, :].to(ce.dtype)
            loss_cls = (ce.sum(dim=-1) * valid.to(ce.dtype)).sum() / num_valid
        else:
            labels = torch.where(valid, gt_classes, torch.full_like(gt_classes, -100))
            loss_cls = cross_entropy(scores, labels, reduction="sum", ignore_index=-100) / num_valid

        k = deltas.shape[1] // 4
        deltas_k = deltas.reshape(R, k, 4)
        if k == 1:
            sel = deltas_k[:, 0]
        else:
            cls = torch.where(fg, gt_classes, torch.zeros_like(gt_classes)).long()
            sel = torch.gather(deltas_k, 1, cls[:, None, None].expand(R, 1, 4))[:, 0]
        if self.box_reg_loss_type == "smooth_l1":
            gt_deltas = self.box2box_transform.get_deltas(proposal_boxes, gt_boxes).detach()
            reg = smooth_l1_loss(sel, gt_deltas, beta=self.smooth_l1_beta).sum(dim=-1)
        else:
            pred = self.box2box_transform.apply_deltas(sel, proposal_boxes)
            reg = IOU_LOSSES[self.box_reg_loss_type](pred, gt_boxes)
        loss_box = (reg * fg.float()).sum() / num_valid
        return {"loss_cls": loss_cls * self.loss_weight_cls, "loss_box_reg": loss_box * self.loss_weight_box}

    def predict_boxes(self, predictions, proposal_boxes: torch.Tensor) -> torch.Tensor:
        """``[R, k*4]`` deltas decoded against ``[R, 4]`` proposals -> ``[R, k, 4]``."""
        _, deltas = predictions
        out = self.box2box_transform.apply_deltas(deltas, proposal_boxes)
        return out.reshape(deltas.shape[0], -1, 4)

    def predict_probs(self, predictions) -> torch.Tensor:
        """Each class's probability, background last: sigmoids of the logits
        with ``use_sigmoid_ce``, else their softmax."""
        scores, _ = predictions
        if self.use_sigmoid_ce:
            return torch.sigmoid(scores)
        return torch.softmax(scores, dim=-1)

    def inference(self, predictions, proposal_boxes, proposal_valid, image_sizes):
        B, P = proposal_boxes.shape[:2]
        boxes = self.predict_boxes(predictions, proposal_boxes.reshape(-1, 4)).reshape(B, P, -1, 4)
        probs = self.predict_probs(predictions).reshape(B, P, -1)
        return fast_rcnn_inference_padded(
            boxes, probs, proposal_valid, image_sizes,
            self.test_score_thresh, self.test_nms_thresh, self.test_topk_per_image,
        )
