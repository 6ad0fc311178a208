"""The DeepLabV3 and DeepLabV3+ semantic heads (counterpart of the JAX
package's ``projects/deeplab/semantic_seg.py``), registered in
``SEM_SEG_HEADS_REGISTRY``.

Both keep the sem-seg head contract of ``SemSegFPNHead``:
``forward(features, targets, train, generator)`` returns ``(None, losses)``
in training and ``(logits [B, H, W, C] float32 at the input's stride, {})``
otherwise. d2's names: V3's ``aspp`` and ``predictor``; V3+'s
``decoder.<f>.project_conv`` (the ASPP for the deepest feature, a 1x1 conv
for the others) and ``decoder.<f>.fuse_conv`` (two 3x3 convs, ``.0`` and
``.1``, or one 5x5 :class:`DepthwiseSeparableConv2d` with
``USE_DEPTHWISE_SEPARABLE_CONV``), then ``predictor``.

Every resize is :func:`resize_bilinear`, ``jax.image.resize(...,
"bilinear")`` for the integer upsamples these heads make: half-pixel
centres, edges clamped, both axes in one call.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, get_norm, nchw, nhwc
from detectron2_tpu_torch.layers.aspp import ASPP
from detectron2_tpu_torch.layers.blocks import DepthwiseSeparableConv2d
from detectron2_tpu_torch.layers.losses import cross_entropy
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import SEM_SEG_HEADS_REGISTRY
from detectron2_tpu_torch.projects.deeplab.loss import hard_pixel_mining_ce

__all__ = ["DeepLabV3Head", "DeepLabV3PlusHead", "fuse_tower", "head_kwargs", "head_tower", "resize_bilinear", "run_tower"]


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW ``x`` to ``h`` x ``w``, bilinear with half-pixel centres and
    clamped edges (``jax.image.resize``'s upsample), in ``x``'s dtype."""
    if tuple(x.shape[2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def _conv3x3s(pairs, norm: str) -> nn.Sequential:
    return nn.Sequential(*(
        Conv2d(cin, cout, 3, padding=1, bias=not norm, norm=get_norm(norm, cout), activation=F.relu)
        for cin, cout in pairs
    ))


def _dsconv5(in_channels: int, out_channels: int, norm: str) -> DepthwiseSeparableConv2d:
    return DepthwiseSeparableConv2d(in_channels, out_channels, 5, padding=2, norm1=norm, activation1=F.relu,
                                    norm2=norm, activation2=F.relu)


def fuse_tower(in_channels: int, out_channels: int, norm: str, depthwise_separable: bool) -> nn.Module:
    """The V3+ decoder's fuse: two 3x3 convs ``in -> out -> out`` with norm
    and ReLU (d2's ``nn.Sequential`` indices 0 and 1), or one 5x5
    depthwise-separable conv of the same receptive field."""
    if depthwise_separable:
        return _dsconv5(in_channels, out_channels, norm)
    return _conv3x3s(((in_channels, out_channels), (out_channels, out_channels)), norm)


def head_tower(in_channels: int, out_channels: int, norm: str, depthwise_separable: bool) -> nn.Module:
    """Panoptic-DeepLab's tower before a predictor: two 3x3 convs ``in ->
    in -> out`` with norm and ReLU, or one 5x5 depthwise-separable conv."""
    if depthwise_separable:
        return _dsconv5(in_channels, out_channels, norm)
    return _conv3x3s(((in_channels, in_channels), (in_channels, out_channels)), norm)


def run_tower(tower: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A :func:`fuse_tower` or :func:`head_tower` on NCHW ``x``."""
    if isinstance(tower, nn.Sequential):
        for conv in tower:
            x = conv(x, train)
        return x
    return tower(x, train)


def sem_seg_loss(logits: torch.Tensor, targets: torch.Tensor, loss_type: str, top_k: float, ignore_value: int,
                 loss_weight: float) -> Dict[str, torch.Tensor]:
    """``loss_sem_seg``: the plain or hard-pixel-mining cross entropy of
    the float32 logits ``[B, H, W, C]`` (resized to the targets' frame)."""
    up = nhwc(resize_bilinear(nchw(logits), targets.shape[1], targets.shape[2]))
    if loss_type == "cross_entropy":
        loss = cross_entropy(up, targets, reduction="mean", ignore_index=ignore_value)
    elif loss_type == "hard_pixel_mining":
        loss = hard_pixel_mining_ce(up, targets, ignore_index=ignore_value, top_k_percent=top_k)
    else:
        raise ValueError(f"Unexpected loss type: {loss_type}")
    return {"loss_sem_seg": loss * loss_weight}


def head_kwargs(h, in_features, input_shape: Dict[str, ShapeSpec]) -> dict:
    """The constructor arguments every DeepLab head reads from its config
    node ``h`` (``SEM_SEG_HEAD`` or ``INS_EMBED_HEAD``)."""
    return dict(
        in_features=in_features,
        feature_strides=[input_shape[f].stride for f in in_features],
        feature_channels=[input_shape[f].channels for f in in_features],
        aspp_channels=h.ASPP_CHANNELS,
        aspp_dilations=tuple(h.ASPP_DILATIONS),
        aspp_dropout=h.ASPP_DROPOUT,
        conv_dims=h.CONVS_DIM,
        norm=h.NORM,
    )


@SEM_SEG_HEADS_REGISTRY.register()
class DeepLabV3Head(nn.Module):
    """The ASPP on the one (dilated) input feature, a 1x1 predictor, the
    float32 logits upsampled by the feature's stride."""

    def __init__(
        self,
        *,
        in_features: Sequence[str],
        feature_strides: Sequence[int],
        feature_channels: Sequence[int],
        aspp_channels: int = 256,
        aspp_dilations: Sequence[int] = (6, 12, 18),
        aspp_dropout: float = 0.1,
        num_classes: int = 19,
        conv_dims: int = 256,
        norm: str = "GN",
        loss_weight: float = 1.0,
        loss_type: str = "cross_entropy",
        loss_top_k: float = 0.2,
        ignore_value: int = 255,
    ):
        super().__init__()
        assert len(in_features) == 1, "DeepLabV3Head takes one (dilated) feature"
        self.in_features = tuple(in_features)
        self.stride = feature_strides[0]
        self.loss_weight, self.loss_type, self.loss_top_k = loss_weight, loss_type, loss_top_k
        self.ignore_value = ignore_value
        self.aspp = ASPP(feature_channels[0], aspp_channels, aspp_dilations, norm=norm, dropout=aspp_dropout)
        self.predictor = Conv2d(aspp_channels, num_classes, 1)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "DeepLabV3Head":
        h = cfg.MODEL.SEM_SEG_HEAD
        return cls(**head_kwargs(h, tuple(h.IN_FEATURES), input_shape), num_classes=h.NUM_CLASSES,
                   loss_weight=h.LOSS_WEIGHT, loss_type=h.LOSS_TYPE, loss_top_k=h.LOSS_TOP_K,
                   ignore_value=h.IGNORE_VALUE)

    def forward(self, features: Dict[str, torch.Tensor], targets: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.aspp(nchw(features[self.in_features[0]]), train, generator)
        logits = self.predictor(x, train).float()
        logits = nhwc(resize_bilinear(logits, logits.shape[2] * self.stride, logits.shape[3] * self.stride))
        if train:
            assert targets is not None, "training needs gt_sem_seg"
            return None, sem_seg_loss(logits, targets, self.loss_type, self.loss_top_k, self.ignore_value,
                                      self.loss_weight)
        return logits, {}


@SEM_SEG_HEADS_REGISTRY.register()
class DeepLabV3PlusHead(nn.Module):
    """The ASPP on the deepest feature (the last of ``in_features``), then
    for each shallower feature, deepest first: its 1x1 projection, the map
    so far resized to it and concatenated before it, the fuse convs; a 1x1
    predictor, the float32 logits upsampled by the shallowest stride.
    ``num_classes`` None builds the decoder alone (Panoptic-DeepLab's
    heads add their own towers and predictors)."""

    def __init__(
        self,
        *,
        in_features: Sequence[str],
        feature_strides: Sequence[int],
        feature_channels: Sequence[int],
        project_channels: Sequence[int],
        aspp_channels: int = 256,
        aspp_dilations: Sequence[int] = (6, 12, 18),
        aspp_dropout: float = 0.1,
        num_classes: Optional[int] = 19,
        conv_dims: int = 256,
        norm: str = "GN",
        loss_weight: float = 1.0,
        loss_type: str = "cross_entropy",
        loss_top_k: float = 0.2,
        ignore_value: int = 255,
        use_depthwise_separable_conv: bool = False,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.stride = feature_strides[0]
        self.conv_dims = conv_dims
        self.loss_weight, self.loss_type, self.loss_top_k = loss_weight, loss_type, loss_top_k
        self.ignore_value = ignore_value
        self.decoder = nn.ModuleDict()
        deepest = self.in_features[-1]
        self.decoder[deepest] = nn.ModuleDict({"project_conv": ASPP(
            feature_channels[-1], aspp_channels, aspp_dilations, norm=norm, dropout=aspp_dropout,
            use_depthwise_separable_conv=use_depthwise_separable_conv,
        )})
        channels = aspp_channels
        for f, cin, cproj in reversed(list(zip(self.in_features[:-1], feature_channels[:-1], project_channels))):
            self.decoder[f] = nn.ModuleDict({
                "project_conv": Conv2d(cin, cproj, 1, bias=not norm, norm=get_norm(norm, cproj), activation=F.relu),
                "fuse_conv": fuse_tower(channels + cproj, conv_dims, norm, use_depthwise_separable_conv),
            })
            channels = conv_dims
        if num_classes is not None:
            self.predictor = Conv2d(conv_dims, num_classes, 1)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "DeepLabV3PlusHead":
        h = cfg.MODEL.SEM_SEG_HEAD
        in_features = tuple(h.IN_FEATURES)
        assert in_features[:-1] == tuple(h.PROJECT_FEATURES), (
            "PROJECT_FEATURES must be IN_FEATURES minus the last (ASPP) feature"
        )
        return cls(**head_kwargs(h, in_features, input_shape), project_channels=tuple(h.PROJECT_CHANNELS),
                   num_classes=h.NUM_CLASSES, loss_weight=h.LOSS_WEIGHT, loss_type=h.LOSS_TYPE,
                   loss_top_k=h.LOSS_TOP_K, ignore_value=h.IGNORE_VALUE,
                   use_depthwise_separable_conv=h.USE_DEPTHWISE_SEPARABLE_CONV)

    def decode(self, features: Dict[str, torch.Tensor], train: bool,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The NHWC features -> the decoder's NCHW map at the shallowest
        stride (``conv_dims`` channels)."""
        y = self.decoder[self.in_features[-1]]["project_conv"](nchw(features[self.in_features[-1]]), train, generator)
        for f in reversed(self.in_features[:-1]):
            stage = self.decoder[f]
            low = stage["project_conv"](nchw(features[f]), train)
            y = resize_bilinear(y, low.shape[2], low.shape[3])
            y = run_tower(stage["fuse_conv"], torch.cat([y, low], dim=1), train)
        return y

    def upsampled(self, x: torch.Tensor, predictor: nn.Module, train: bool) -> torch.Tensor:
        """``predictor`` on NCHW ``x``, cast to float32 and upsampled by the
        stride: NCHW."""
        out = predictor(x, train).float()
        return resize_bilinear(out, out.shape[2] * self.stride, out.shape[3] * self.stride)

    def forward(self, features: Dict[str, torch.Tensor], targets: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        logits = nhwc(self.upsampled(self.decode(features, train, generator), self.predictor, train))
        if train:
            assert targets is not None, "training needs gt_sem_seg"
            return None, sem_seg_loss(logits, targets, self.loss_type, self.loss_top_k, self.ignore_value,
                                      self.loss_weight)
        return logits, {}

