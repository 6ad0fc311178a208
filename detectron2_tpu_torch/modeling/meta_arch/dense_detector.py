"""The shared machinery of the one-stage detectors (counterpart of
``detectron2_tpu/modeling/meta_arch/dense_detector.py``).

Per-level head outputs are reshaped to ``[B, HWA, K]``; inference takes a
per-level top-k of the flattened ``[B, HWA*C]`` scores, decodes only the
selected anchors, and runs class-batched NMS over the union of the levels
on boxes that are not clipped (clipping happens in ``detector_postprocess``).
Every top-k is exact with the lower index first on ties (``ops.topk``).
"""

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, get_norm
from detectron2_tpu_torch.modeling.meta_arch.rcnn import _DTYPES
from detectron2_tpu_torch.ops.nms import batched_nms_padded
from detectron2_tpu_torch.ops.topk import top_k

__all__ = ["DenseDetector", "permute_to_N_HWA_K", "decode_dense_predictions_padded", "HeadTower"]


def permute_to_N_HWA_K(tensor: torch.Tensor, K: int) -> torch.Tensor:
    """``[B, H, W, A*K]`` (NHWC head output) -> ``[B, H*W*A, K]``."""
    return tensor.reshape(tensor.shape[0], -1, K)


class HeadTower(nn.Sequential):
    """A dense head's tower as d2 names it: ``(conv, [norm], ReLU) * n`` in
    one ``nn.Sequential``, so that a d2 state dict loads by name (convs at
    indices 0, 2, 4, ... or, with a norm, 0, 3, 6, ...). Each norm is one
    module that the head applies to every level in turn, as the JAX head's
    shared ``Conv2d(norm=...)`` is: a norm with batch statistics folds each
    level's statistics into its running ones, in level order."""

    def __init__(self, in_channels: int, conv_dims: Sequence[int], norm=""):
        layers = []
        for d in conv_dims:
            layers.append(Conv2d(in_channels, d, 3, padding=1))
            n = get_norm(norm, d)
            if n is not None:
                layers.append(n)
            layers.append(nn.ReLU())
            in_channels = d
        super().__init__(*layers)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        for m in self:
            x = m(x) if isinstance(m, nn.ReLU) else m(x, train)
        return x


def decode_dense_predictions_padded(
    box2box_transform,
    anchors: List[torch.Tensor],
    pred_scores: List[torch.Tensor],
    pred_deltas: List[torch.Tensor],
    score_thresh: float,
    topk_candidates: int,
    nms_thresh: float,
    max_detections: int,
) -> Dict[str, torch.Tensor]:
    """The one-stage decode, padded.

    Args:
        anchors: per level ``[HWA, 4]``.
        pred_scores: per level ``[B, HWA, C]`` class scores (after the sigmoid).
        pred_deltas: per level ``[B, HWA, 4]``.

    Per level: the top ``topk_candidates`` of the flattened scores, then the
    threshold (strictly greater; a slot that fails it gets ``-inf``), then
    the selected anchors decoded. Over the union: class-batched NMS on the
    unclipped boxes, and the top ``max_detections`` kept slots. Returns
    pred_boxes ``[B, D, 4]``, scores (0 in padding), pred_classes and
    valid ``[B, D]``.
    """
    B, C = pred_scores[0].shape[0], pred_scores[0].shape[-1]
    all_scores, all_boxes, all_classes = [], [], []
    for anchors_l, scores_l, deltas_l in zip(anchors, pred_scores, pred_deltas):
        HWA = anchors_l.shape[0]
        k = min(topk_candidates, HWA * C)
        top_scores, top_idx = top_k(scores_l.reshape(B, HWA * C), k)
        anchor_idx = top_idx // C
        sel_deltas = torch.gather(deltas_l, 1, anchor_idx[..., None].expand(-1, -1, 4))
        boxes = box2box_transform.apply_deltas(sel_deltas.reshape(-1, 4), anchors_l[anchor_idx].reshape(-1, 4))
        all_scores.append(torch.where(top_scores > score_thresh, top_scores, torch.full_like(top_scores, float("-inf"))))
        all_boxes.append(boxes.reshape(B, k, 4))
        all_classes.append(top_idx % C)
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    classes = torch.cat(all_classes, dim=1)

    keep = batched_nms_padded(boxes, scores, classes, nms_thresh, valid=torch.isfinite(scores))
    final = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    D = min(max_detections, final.shape[1])
    out_scores, idx = top_k(final, D)
    valid = torch.isfinite(out_scores)
    out = {
        "pred_boxes": torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(valid, out_scores, torch.zeros_like(out_scores)),
        "pred_classes": torch.gather(classes, 1, idx),
        "valid": valid,
    }
    pad = max_detections - D
    if pad:
        out = {k: torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1) for k, v in out.items()}
    return out


class DenseDetector(nn.Module):
    """A backbone and a head shared by the levels ``head_in_features``.

    The forward takes the JAX package's padded batch dict (as
    :class:`~detectron2_tpu_torch.modeling.meta_arch.rcnn.GeneralizedRCNN`)
    and normalizes inside the model, casting to the compute dtype.
    ``loss_normalizer`` is the EMA of the number of foreground anchors that
    divides the losses (the JAX package's ``meters`` variable): a float32
    buffer starting at 100, saved in checkpoints, updated as ``0.9 * old +
    0.1 * num_fg`` in every forward with ``train=True`` and nowhere else;
    the losses divide by ``max(updated value, 1)``.
    """

    def __init__(
        self,
        *,
        backbone: nn.Module,
        head: nn.Module,
        head_in_features: Sequence[str],
        pixel_mean,
        pixel_std,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.head_in_features = tuple(head_in_features)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.register_buffer("loss_normalizer", torch.tensor(100.0, dtype=torch.float32))
        self.input_format = input_format
        self.compute_dtype = _DTYPES[compute_dtype]

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def preprocess_image(self, image: torch.Tensor) -> torch.Tensor:
        """(x - mean) / std in float32, then the compute dtype."""
        return ((image.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def train_target_sizes(self) -> Dict[str, int]:
        """Boxes and classes only: no masks, no keypoints."""
        return {"mask_size": 0, "num_keypoints": 0}

    def _features(self, batch: Dict, train: bool, generator: Optional[torch.Generator]) -> List[torch.Tensor]:
        image = torch.as_tensor(batch["image"], device=self.device)
        features = self.backbone(self.preprocess_image(image), train=train, generator=generator)
        return [features[f] for f in self.head_in_features]

    def _targets(self, batch: Dict):
        return tuple(torch.as_tensor(batch[k], device=self.device) for k in ("gt_boxes", "gt_classes", "gt_valid"))

    def _ema_loss_normalizer(self, num_fg: torch.Tensor) -> torch.Tensor:
        """Fold ``num_fg`` into the buffer; returns ``max(new value, 1)``,
        outside the graph."""
        with torch.no_grad():
            self.loss_normalizer.mul_(0.9).add_(num_fg.float() * 0.1)
            return self.loss_normalizer.clamp_min(1.0)

    def forward(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None, raw: bool = False):
        """``train=True``: the loss dict (``generator`` is accepted for the
        trainers' signature; nothing here draws). Otherwise, under
        ``torch.inference_mode``, the padded detections dict, or with
        ``raw`` the per-level head outputs ``[B, HWA, K]`` in float32."""
        if train:
            return self.forward_train(batch, generator)
        with torch.inference_mode():
            return self.forward_inference(batch, raw)
