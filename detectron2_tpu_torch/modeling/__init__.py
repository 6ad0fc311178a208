"""Model construction: :func:`build_model` and seeded random weights."""

import math
from typing import Optional, Union

import torch
from torch import nn

from detectron2_tpu_torch.layers import FrozenBatchNorm2d
from detectron2_tpu_torch.modeling.backbone import build_backbone
from detectron2_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tpu_torch.modeling.proposal_generator import build_rpn
from detectron2_tpu_torch.modeling.roi_heads import build_roi_heads

__all__ = ["build_model", "init_weights", "calibrate_frozen_bn", "GeneralizedRCNN"]


def build_model(cfg, device: Optional[Union[str, torch.device]] = None) -> GeneralizedRCNN:
    """The model of ``cfg.MODEL.META_ARCHITECTURE`` on ``device`` (default
    ``cfg.MODEL.DEVICE``, which is ``"cuda"``), in eval mode. Parameters are
    torch's default init until weights are loaded or :func:`init_weights` runs."""
    if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise NotImplementedError(f"meta architecture {cfg.MODEL.META_ARCHITECTURE!r} is not ported yet")
    backbone = build_backbone(cfg)
    shapes = backbone.output_shape()
    model = GeneralizedRCNN(
        backbone=backbone,
        proposal_generator=build_rpn(cfg, shapes),
        roi_heads=build_roi_heads(cfg, shapes),
        pixel_mean=cfg.MODEL.PIXEL_MEAN,
        pixel_std=cfg.MODEL.PIXEL_STD,
        input_format=cfg.INPUT.FORMAT,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        mask_paste_in_graph=cfg.TPU.PASTE_MASKS_IN_GRAPH,
    )
    return model.to(torch.device(device or cfg.MODEL.DEVICE)).eval()


def _normal(w, std, gen):
    w.normal_(0.0, std, generator=gen)


def _msra(w, gen, transposed=False):
    """c2_msra_fill: normal(sqrt(2 / fan_out))."""
    out_ch = w.shape[1] if transposed else w.shape[0]
    _normal(w, math.sqrt(2.0 / (out_ch * w[0, 0].numel())), gen)


def _xavier(w, gen):
    """c2_xavier_fill: uniform(+-sqrt(3 / fan_in))."""
    bound = math.sqrt(3.0 / w[0].numel())
    w.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator`` (on the model's device) with
    d2's initializers: msra for the ResNet, pyramid, box-head and mask-head
    convs, xavier for the FPN convs and box-head fcs, normal(0.01) for the
    RPN head, normal(0.001) for ``bbox_pred`` and the mask predictor, d2's
    ``trunc_normal_(std=0.02)`` for a ViT's linears and position table (its
    bounds of +-2 are absolute, so in effect a normal); zero biases. ``cls_score`` is normal(0.05), not d2's 0.01, so that
    random-weight class scores spread past the 0.05 test threshold, and a
    ViT's relative-position tables are normal(0.02), not d2's zeros, so that
    the attention bias is exercised. FrozenBN keeps its identity statistics:
    see :func:`calibrate_frozen_bn`; LayerNorm keeps ones and zeros."""
    for name, p in model.named_parameters():
        if name.endswith((".rel_pos_h", ".rel_pos_w")):
            _normal(p, 0.02, generator)
        elif name.endswith(".pos_embed"):
            nn.init.trunc_normal_(p, std=0.02, generator=generator)
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        w = m.weight
        if ".blocks." in name and isinstance(m, nn.Linear):
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
        elif name.endswith("cls_score"):
            _normal(w, 0.05, generator)
        elif name.endswith(("bbox_pred", "mask_head.predictor")):
            _normal(w, 0.001, generator)
        elif name.startswith("proposal_generator.rpn_head"):
            _normal(w, 0.01, generator)
        elif name.startswith("backbone.fpn_") or isinstance(m, nn.Linear):
            _xavier(w, generator)
        else:
            _msra(w, generator, transposed=isinstance(m, nn.ConvTranspose2d))
        if m.bias is not None:
            m.bias.zero_()


@torch.no_grad()
def calibrate_frozen_bn(model: nn.Module, batch) -> None:
    """Set every FrozenBatchNorm2d's statistics to the per-channel mean and
    variance of its input on ``batch``, in forward order. With random
    weights and identity statistics the ResNet's activations grow by orders
    of magnitude and every proposal decodes off the image; calibrated, they
    stay at unit scale, as with trained weights."""

    def set_stats(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [
        m.register_forward_pre_hook(set_stats) for m in model.modules() if isinstance(m, FrozenBatchNorm2d)
    ]
    try:
        model(batch)
    finally:
        for h in handles:
            h.remove()
