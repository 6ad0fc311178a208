"""Model construction: :func:`build_model` and seeded random weights."""

import math
from typing import Optional, Union

import torch
from torch import nn

from detectron2_tpu_torch.layers import BatchNorm2d, DeformConv, FrozenBatchNorm2d, GroupNorm
from detectron2_tpu_torch.modeling.backbone import build_backbone
from detectron2_tpu_torch.modeling.meta_arch.fcos import FCOS
from detectron2_tpu_torch.modeling.meta_arch.panoptic_fpn import PanopticFPN
from detectron2_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN, ProposalNetwork
from detectron2_tpu_torch.modeling.meta_arch.retinanet import RetinaNet
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import SemanticSegmentor
from detectron2_tpu_torch.modeling.proposal_generator import build_proposal_generator, build_rpn
from detectron2_tpu_torch.modeling.roi_heads import build_roi_heads

__all__ = [
    "build_model",
    "init_weights",
    "calibrate_frozen_bn",
    "GeneralizedRCNN",
    "ProposalNetwork",
    "RetinaNet",
    "FCOS",
    "PanopticFPN",
    "SemanticSegmentor",
    "META_ARCHITECTURES",
]


def _build_generalized_rcnn(cfg) -> GeneralizedRCNN:
    backbone = build_backbone(cfg)
    shapes = backbone.output_shape()
    return GeneralizedRCNN(
        backbone=backbone,
        proposal_generator=build_proposal_generator(cfg, shapes),
        roi_heads=build_roi_heads(cfg, shapes),
        pixel_mean=cfg.MODEL.PIXEL_MEAN,
        pixel_std=cfg.MODEL.PIXEL_STD,
        input_format=cfg.INPUT.FORMAT,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        mask_paste_in_graph=cfg.TPU.PASTE_MASKS_IN_GRAPH,
    )


def _build_proposal_network(cfg) -> ProposalNetwork:
    backbone = build_backbone(cfg)
    return ProposalNetwork(
        backbone=backbone,
        proposal_generator=build_rpn(cfg, backbone.output_shape()),
        pixel_mean=cfg.MODEL.PIXEL_MEAN,
        pixel_std=cfg.MODEL.PIXEL_STD,
        input_format=cfg.INPUT.FORMAT,
        compute_dtype=cfg.TPU.COMPUTE_DTYPE,
    )


def _build_panoptic_deeplab(cfg):
    from detectron2_tpu_torch.projects.panoptic_deeplab import PanopticDeepLab  # the project imports this package

    return PanopticDeepLab.from_config(cfg)


def _build_tensormask(cfg):
    from detectron2_tpu_torch.projects.tensormask import TensorMask  # the project imports this package

    return TensorMask.from_config(cfg)


META_ARCHITECTURES = {
    "GeneralizedRCNN": _build_generalized_rcnn,
    "ProposalNetwork": _build_proposal_network,
    "RetinaNet": RetinaNet.from_config,
    "FCOS": FCOS.from_config,
    "PanopticFPN": PanopticFPN.from_config,
    "SemanticSegmentor": SemanticSegmentor.from_config,
    "PanopticDeepLab": _build_panoptic_deeplab,
    "TensorMask": _build_tensormask,
}


def build_model(cfg, device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """The model of ``cfg.MODEL.META_ARCHITECTURE`` (``GeneralizedRCNN``,
    ``ProposalNetwork``, ``RetinaNet``, ``FCOS``, ``PanopticFPN``,
    ``SemanticSegmentor``, ``PanopticDeepLab`` or ``TensorMask``) on ``device`` (default
    ``cfg.MODEL.DEVICE``, which is ``"cuda"``), in eval mode. Parameters are
    torch's default init until weights are loaded or :func:`init_weights` runs."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCHITECTURES:
        raise ValueError(f"meta architecture {name!r} is registered by neither package")
    model = META_ARCHITECTURES[name](cfg)
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
    d2's initializers: msra for the ResNet, pyramid, box-head, mask-head
    and sem-seg head convs, xavier for the FPN convs and box-head fcs, normal(0.01) for the
    RPN head, normal(0.001) for ``bbox_pred`` and the mask predictor, d2's
    ``trunc_normal_(std=0.02)`` for the linears of a ViT's, MViT's or Swin's
    blocks, the position table and Swin's bias tables (its bounds of +-2 are
    absolute, so in effect a normal); zero biases. A deformable block's
    ``conv2_offset`` is zero, as d2 initializes it. ``cls_score`` is normal(0.05), not d2's 0.01, so that
    random-weight class scores spread past the 0.05 test threshold, and a
    ViT's relative-position tables are normal(0.02), not d2's zeros, so that
    the attention bias is exercised. FrozenBN keeps its identity statistics:
    see :func:`calibrate_frozen_bn`; LayerNorm keeps ones and zeros.

    A dense detector's ``head`` (RetinaNet, FCOS) takes d2's initializers as
    they are: normal(0.01) for its towers, ``cls_score``, ``bbox_pred`` and
    ``ctrness``, zero biases but ``cls_score``'s, which is ``-log((1 -
    prior_prob) / prior_prob)``, and ones and zeros for its norms; the
    top block's p6 and p7 are xavier.

    PointRend's heads as d2 draws them: the coarse and parameter heads'
    ``prediction`` and the point head's ``predictor`` normal(0.001), the
    point head's ``Conv1d`` layers msra, the Implicit point head's Gaussian
    matrix normal(1)."""
    for name, p in model.named_parameters():
        if name.endswith((".rel_pos_h", ".rel_pos_w")):
            _normal(p, 0.02, generator)
        elif name.endswith((".pos_embed", ".relative_position_bias_table")):
            nn.init.trunc_normal_(p, std=0.02, generator=generator)
    for name, b in model.named_buffers():
        if name.endswith(".positional_encoding_gaussian_matrix"):
            _normal(b, 1.0, generator)
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.Conv1d, DeformConv)):
            continue
        w = m.weight
        if name.endswith("conv2_offset"):  # a deformable block starts as a plain conv, as d2's
            w.zero_()
            m.bias.zero_()
            continue
        if name.startswith("head."):
            _normal(w, 0.01, generator)
            if m.bias is not None:
                prior = model.head.prior_prob
                m.bias.fill_(-math.log((1 - prior) / prior) if name == "head.cls_score" else 0.0)
            continue
        if ".blocks." in name and isinstance(m, nn.Linear):
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
        elif name.endswith("cls_score"):
            _normal(w, 0.05, generator)
        elif name.endswith(("bbox_pred", "mask_head.predictor", "point_head.predictor", "_head.prediction")):
            _normal(w, 0.001, generator)
        elif name.startswith("proposal_generator.rpn_head"):
            _normal(w, 0.01, generator)
        elif name.startswith(("backbone.fpn_", "backbone.top_block.")) or isinstance(m, nn.Linear):
            _xavier(w, generator)
        else:
            _msra(w, generator, transposed=isinstance(m, nn.ConvTranspose2d))
        if m.bias is not None:
            m.bias.zero_()
    for name, m in model.named_modules():
        if name.startswith("head.") and isinstance(m, (BatchNorm2d, GroupNorm)):
            m.weight.fill_(1.0)
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
