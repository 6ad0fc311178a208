"""Keypoint R-CNN head, its loss and its inference (counterpart of
``detectron2_tpu/modeling/roi_heads/keypoint_head.py``:
KRCNNConvDeconvUpsampleHead :27, ``keypoint_rcnn_loss`` :50,
``keypoint_rcnn_inference`` :73, ``build_keypoint_head`` :86)."""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ConvTranspose2d, nchw, nhwc
from detectron2_tpu_torch.layers.losses import cross_entropy
from detectron2_tpu_torch.structures.keypoints import _keypoints_to_heatmap, heatmaps_to_keypoints
from detectron2_tpu_torch.utils.registry import Registry

ROI_KEYPOINT_HEAD_REGISTRY = Registry("ROI_KEYPOINT_HEAD")

__all__ = [
    "ROI_KEYPOINT_HEAD_REGISTRY",
    "KRCNNConvDeconvUpsampleHead",
    "keypoint_rcnn_loss",
    "keypoint_rcnn_inference",
    "build_keypoint_head",
]


@ROI_KEYPOINT_HEAD_REGISTRY.register()
class KRCNNConvDeconvUpsampleHead(nn.Module):
    """``conv_fcn{i}`` 3x3 convs with ReLU, the 4x4 stride-2 ``score_lowres``
    deconv (padding 1: 14 -> 28) and a fixed 2x bilinear upsample. Runs in
    the input's dtype; returns float32 logits, NHWC."""

    def __init__(self, in_channels: int, num_keypoints: int = 17, conv_dims=(512,) * 8):
        super().__init__()
        self.conv_dims = tuple(conv_dims)
        cin = in_channels
        for i, dim in enumerate(self.conv_dims):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(cin, dim, 3, padding=1, activation=F.relu))
            cin = dim
        self.score_lowres = ConvTranspose2d(cin, num_keypoints, kernel_size=4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[R, h, w, C]`` -> keypoint logits ``[R, 4h, 4w, K]`` float32."""
        x = nchw(x)
        for i in range(len(self.conv_dims)):
            x = getattr(self, f"conv_fcn{i + 1}")(x)
        x = self.score_lowres(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return nhwc(x).float()


def keypoint_rcnn_loss(
    pred_keypoint_logits: torch.Tensor,
    proposal_boxes: torch.Tensor,
    gt_keypoints: torch.Tensor,
    fg_valid: torch.Tensor,
    normalizer: Optional[float] = None,
) -> torch.Tensor:
    """Softmax cross entropy over the ``S x S`` heatmap of every labeled
    keypoint inside its roi, summed and divided by ``normalizer`` (the
    number of such keypoints, at least 1, when None).

    Args:
        pred_keypoint_logits: ``[R, S, S, K]``.
        proposal_boxes: ``[R, 4]``.
        gt_keypoints: ``[R, K, 3]``, each roi's matched gt keypoints.
        fg_valid: ``[R]`` bool, the rois that count.
    """
    R, S, _, K = pred_keypoint_logits.shape
    heatmaps, valid = _keypoints_to_heatmap(gt_keypoints, proposal_boxes, S)
    valid = (valid & fg_valid[:, None]).reshape(R * K)
    logits = pred_keypoint_logits.reshape(R, S * S, K).transpose(1, 2).reshape(R * K, S * S)
    heatmaps = heatmaps.reshape(R * K)
    targets = torch.where(valid, heatmaps, torch.full_like(heatmaps, -100))
    ce = cross_entropy(logits, targets, reduction="sum", ignore_index=-100)
    if normalizer is None:
        return ce / valid.sum().clamp_min(1)
    return ce / normalizer


def keypoint_rcnn_inference(pred_keypoint_logits: torch.Tensor, pred_boxes: torch.Tensor) -> torch.Tensor:
    """``[R, S, S, K]`` logits and their ``[R, 4]`` boxes -> ``[R, K, 4]``
    (x, y, logit, prob) keypoints in the boxes' frame."""
    return heatmaps_to_keypoints(pred_keypoint_logits.permute(0, 3, 1, 2), pred_boxes)


def build_keypoint_head(cfg, in_channels: int) -> nn.Module:
    h = cfg.MODEL.ROI_KEYPOINT_HEAD
    if h.NAME == "KRCNNConvDeconvUpsampleHead":
        return KRCNNConvDeconvUpsampleHead(in_channels, h.NUM_KEYPOINTS, h.CONV_DIMS)
    return ROI_KEYPOINT_HEAD_REGISTRY.get(h.NAME)(cfg, in_channels)
