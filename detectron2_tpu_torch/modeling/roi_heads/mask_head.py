"""Mask R-CNN mask head, its loss and inference (counterpart of
``detectron2_tpu/modeling/roi_heads/mask_head.py``: MaskRCNNConvUpsampleHead
:29, ``mask_rcnn_loss`` :71, ``mask_rcnn_inference`` :93). Heads are named
by ``MODEL.ROI_MASK_HEAD.NAME`` in ``ROI_MASK_HEAD_REGISTRY``; PointRend's
``CoarseMaskHead`` registers when its project is imported, here on first
use."""

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ConvTranspose2d, get_norm, nchw, nhwc
from detectron2_tpu_torch.layers.losses import binary_cross_entropy_with_logits
from detectron2_tpu_torch.utils.registry import Registry

__all__ = ["ROI_MASK_HEAD_REGISTRY", "MaskRCNNConvUpsampleHead", "mask_rcnn_loss", "mask_rcnn_inference", "build_mask_head"]

ROI_MASK_HEAD_REGISTRY = Registry("ROI_MASK_HEAD")


@ROI_MASK_HEAD_REGISTRY.register()
class MaskRCNNConvUpsampleHead(nn.Module):
    """``num_conv`` 3x3 convs, a 2x2 stride-2 deconv and a 1x1 predictor.
    Runs in the input's dtype and returns its logits, NHWC, in that dtype:
    the loss and the inference take each roi's class channel first and cast
    only that to float32 (at LVIS's 1203 classes and 4800 detections a
    batch, every channel in float32 would be 18.1 GB; the cast from bf16 is
    exact, so the results keep their bits)."""

    def __init__(self, in_channels: int, num_classes: int, conv_dim: int, num_conv: int,
                 conv_norm: str = "", cls_agnostic: bool = False):
        super().__init__()
        self.num_conv = num_conv
        cin = in_channels
        for i in range(num_conv):
            self.add_module(
                f"mask_fcn{i + 1}",
                Conv2d(cin, conv_dim, 3, padding=1, bias=not conv_norm,
                       norm=get_norm(conv_norm, conv_dim), activation=F.relu),
            )
            cin = conv_dim
        self.deconv = ConvTranspose2d(cin, conv_dim, kernel_size=2, stride=2)
        self.predictor = Conv2d(conv_dim, 1 if cls_agnostic else num_classes, 1)

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "MaskRCNNConvUpsampleHead":
        h = cfg.MODEL.ROI_MASK_HEAD
        return cls(in_channels, cfg.MODEL.ROI_HEADS.NUM_CLASSES, h.CONV_DIM, h.NUM_CONV, h.NORM, h.CLS_AGNOSTIC_MASK)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x: ``[R, h, w, C]`` -> mask logits ``[R, 2h, 2w, num_classes (or
        1)]``; ``train`` selects batch statistics in the convs' norms (over
        every roi of ``x``: the foreground budget's slots, padding included)."""
        x = nchw(x)
        for i in range(self.num_conv):
            x = getattr(self, f"mask_fcn{i + 1}")(x, train)
        x = F.relu(self.deconv(x))
        return nhwc(self.predictor(x, train))


def _class_channel(pred_mask_logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """``[R, M, M, C or 1]`` logits -> ``[R, M, M]`` float32, each roi's
    class channel."""
    C = pred_mask_logits.shape[-1]
    if C == 1:
        return pred_mask_logits[..., 0].float()
    cls = classes.clamp(0, C - 1).long()
    R, M = pred_mask_logits.shape[:2]
    return torch.gather(pred_mask_logits, 3, cls[:, None, None, None].expand(R, M, M, 1))[..., 0].float()


def mask_rcnn_loss(
    pred_mask_logits: torch.Tensor, gt_classes: torch.Tensor, gt_mask_targets: torch.Tensor, fg_valid: torch.Tensor
) -> torch.Tensor:
    """Mean binary cross entropy over every pixel of the valid foreground
    rois: logits ``[R, M, M, C or 1]``, classes ``[R]``, {0, 1} targets
    ``[R, M, M]``, ``fg_valid`` ``[R]``."""
    M = pred_mask_logits.shape[1]
    bce = binary_cross_entropy_with_logits(_class_channel(pred_mask_logits, gt_classes), gt_mask_targets.float())
    w = fg_valid.float()[:, None, None]
    denom = (w.sum() * M * M).clamp_min(1.0)
    return (bce * w).sum() / denom


def mask_rcnn_inference(pred_mask_logits: torch.Tensor, pred_classes: torch.Tensor) -> torch.Tensor:
    """Each detection's class channel, through a sigmoid: ``[R, M, M]``."""
    return torch.sigmoid(_class_channel(pred_mask_logits, pred_classes))


def build_mask_head(cfg, in_channels: int) -> nn.Module:
    """The head ``MODEL.ROI_MASK_HEAD.NAME`` over ``in_channels``; a name
    registered nowhere is refused."""
    name = cfg.MODEL.ROI_MASK_HEAD.NAME
    if name == "CoarseMaskHead":
        import detectron2_tpu_torch.projects.point_rend  # noqa: F401
    if name not in ROI_MASK_HEAD_REGISTRY:
        raise NotImplementedError(f"mask head {name!r} is not ported yet (ROADMAP A10)")
    return ROI_MASK_HEAD_REGISTRY.get(name).from_config(cfg, in_channels)
