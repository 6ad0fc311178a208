"""DensePose heads, the chart predictor and the FPN decoder (counterpart of
``detectron2_tpu/projects/densepose/densepose_head.py``).

Parameters keep d2's names, so a d2 DensePose ``.pkl`` loads by name:

- ``DensePoseV1ConvXHead``: ``body_conv_fcn{i}``, 3x3 convs with ReLU, no
  upsampling;
- ``DensePoseDeepLabHead``: a GN ASPP (``ASPP.convs.{0..4}`` with the conv,
  GN at index 1 (2 in the pooling branch), ``ASPP.project.0``) at rates 6,
  12 and 56, then the ``body_conv_fcn{i}`` tower, GN when
  ``DEEPLAB.NORM`` is "GN";
- ``DensePoseChartPredictor``: one stride-2 transposed conv per output
  (``ann_index_lowres``, ``index_uv_lowres``, ``u_lowres``, ``v_lowres``
  and, with confidences, ``sigma_2_lowres``, ``kappa_{u,v}_lowres``,
  ``{fine,coarse}_segm_confidence_lowres``), each upsampled bilinearly by
  ``UP_SCALE`` as ``jax.image.resize`` does (the width, then the height);
- ``DensePoseDecoder``: per FPN level ``decoder.{f}``, an ``nn.Sequential``
  of conv (index 2k) and 2x upsample steps down to the common stride, the
  levels summed, then the 1x1 ``decoder.predictor``.

- ``DensePoseEmbeddingPredictor`` (CSE): ``coarse_segm_lowres`` and
  ``embed_lowres``, the same transposed convs and upsampling, giving the
  coarse segmentation and a ``EMBED_SIZE``-dim embedding per pixel.

Maps are NHWC in the compute dtype; the predictor's outputs are float32.
"""

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ConvTranspose2d, GroupNorm, get_norm, nchw, nhwc
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import _Upsample2x, upsample_bilinear

__all__ = [
    "DensePoseV1ConvXHead",
    "DensePoseDeepLabHead",
    "DensePoseChartPredictor",
    "DensePoseEmbeddingPredictor",
    "DensePoseDecoder",
    "build_densepose_head",
    "build_densepose_predictor",
]


def _run(ops, x: torch.Tensor, train: bool) -> torch.Tensor:
    """An ``nn.Sequential`` of the port's convs (which take ``train``) and
    parameterless or norm steps."""
    for op in ops:
        x = op(x, train) if isinstance(op, Conv2d) else op(x)
    return x


def _body(in_channels: int, conv_dims: int, num_convs: int, kernel: int, norm: str) -> List[Conv2d]:
    return [
        Conv2d(
            in_channels if i == 0 else conv_dims, conv_dims, kernel, padding=kernel // 2, bias=not norm,
            norm=get_norm(norm, conv_dims), activation=F.relu,
        )
        for i in range(num_convs)
    ]


class DensePoseV1ConvXHead(nn.Module):
    """``num_convs`` 3x3 convs of ``conv_dims`` channels with ReLU:
    ``[R, h, w, C]`` -> ``[R, h, w, conv_dims]``."""

    def __init__(self, in_channels: int, conv_dims: int = 512, num_convs: int = 8, kernel: int = 3):
        super().__init__()
        self.num_convs = num_convs
        for i, conv in enumerate(_body(in_channels, conv_dims, num_convs, kernel, "")):
            self.add_module(f"body_conv_fcn{i + 1}", conv)

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "DensePoseV1ConvXHead":
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        return cls(in_channels, h.CONV_HEAD_DIM, h.NUM_STACKED_CONVS, h.CONV_HEAD_KERNEL)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return nhwc(_tower(self, nchw(x), train))


def _tower(head: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    for i in range(head.num_convs):
        x = getattr(head, f"body_conv_fcn{i + 1}")(x, train)
    return x


class _GlobalMean(nn.Module):
    """The ASPP pooling branch's pool: the mean over the map, kept 1x1 (the
    1x1 result broadcasts back, as d2's upsample of a 1x1 map does)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=True)


class _ASPP(nn.Module):
    """d2's DensePose ASPP: a 1x1 branch, three atrous 3x3 branches and the
    image pooling branch, each with GN (32 groups) and ReLU, concatenated
    and projected by a bias-free 1x1 + ReLU; ``in_channels`` channels
    throughout."""

    def __init__(self, channels: int, rates: Sequence[int]):
        super().__init__()

        def branch(kernel, rate):
            conv = Conv2d(channels, channels, kernel, padding=rate if kernel == 3 else 0, dilation=rate, bias=False)
            return [conv, GroupNorm(channels), nn.ReLU()]

        self.convs = nn.ModuleList(
            [nn.Sequential(*branch(1, 1))]
            + [nn.Sequential(*branch(3, r)) for r in rates]
            + [nn.Sequential(_GlobalMean(), *branch(1, 1))]
        )
        self.project = nn.Sequential(Conv2d(5 * channels, channels, 1, bias=False), nn.ReLU())

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        branches = [_run(seq, x, train) for seq in self.convs]
        branches[-1] = branches[-1].expand_as(branches[0])
        return _run(self.project, torch.cat(branches, dim=1), train)


class DensePoseDeepLabHead(nn.Module):
    """DeepLabV3-style DensePose head: the GN ASPP at rates (6, 12, 56),
    then the ``body_conv_fcn`` tower (GN with ``DEEPLAB.NORM`` "GN"). d2's
    optional non-local block is used by no config and refuses."""

    def __init__(
        self, in_channels: int, conv_dims: int = 512, num_convs: int = 8, kernel: int = 3, norm: str = "GN",
        aspp_rates: Sequence[int] = (6, 12, 56),
    ):
        super().__init__()
        self.num_convs = num_convs
        self.ASPP = _ASPP(in_channels, aspp_rates)
        for i, conv in enumerate(_body(in_channels, conv_dims, num_convs, kernel, norm)):
            self.add_module(f"body_conv_fcn{i + 1}", conv)

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "DensePoseDeepLabHead":
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        if h.DEEPLAB.NONLOCAL_ON:
            raise NotImplementedError("ROI_DENSEPOSE_HEAD.DEEPLAB.NONLOCAL_ON: no config uses it and neither package has it")
        return cls(in_channels, h.CONV_HEAD_DIM, h.NUM_STACKED_CONVS, h.CONV_HEAD_KERNEL, h.DEEPLAB.NORM)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return nhwc(_tower(self, self.ASPP(nchw(x), train), train))


class DensePoseChartPredictor(nn.Module):
    """Chart (IUV) predictor: one stride-2 transposed conv per output from
    the head's map, each upsampled by ``up_scale``. ``uv_confidence``
    ("iid_iso" or "indep_aniso") adds ``sigma_2`` (and ``kappa_u`` /
    ``kappa_v``); ``segm_confidence`` scales the segmentation logits by
    ``softplus(conf) + epsilon`` per pixel (the *M configs)."""

    def __init__(
        self,
        in_channels: int,
        num_patches: int = 24,
        num_coarse_segm_channels: int = 2,
        deconv_kernel: int = 4,
        up_scale: int = 2,
        uv_confidence: str = "none",
        segm_confidence: bool = False,
        segm_confidence_epsilon: float = 0.01,
    ):
        super().__init__()
        self.up_scale = up_scale
        self.uv_confidence = uv_confidence
        self.segm_confidence = segm_confidence
        self.segm_confidence_epsilon = segm_confidence_epsilon
        K = num_patches + 1
        outputs = {"ann_index": num_coarse_segm_channels, "index_uv": K, "u": K, "v": K}
        if uv_confidence != "none":
            outputs["sigma_2"] = K
            if uv_confidence == "indep_aniso":
                outputs.update(kappa_u=K, kappa_v=K)
        if segm_confidence:
            outputs.update(fine_segm_confidence=1, coarse_segm_confidence=1)
        for name, channels in outputs.items():
            self.add_module(
                f"{name}_lowres",
                ConvTranspose2d(in_channels, channels, deconv_kernel, stride=2, padding=deconv_kernel // 2 - 1),
            )

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "DensePoseChartPredictor":
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        return cls(
            in_channels,
            num_patches=h.NUM_PATCHES,
            num_coarse_segm_channels=h.NUM_COARSE_SEGM_CHANNELS,
            deconv_kernel=h.DECONV_KERNEL,
            up_scale=h.UP_SCALE,
            uv_confidence=h.UV_CONFIDENCE.TYPE if h.UV_CONFIDENCE.ENABLED else "none",
            segm_confidence=h.SEGM_CONFIDENCE.ENABLED,
            segm_confidence_epsilon=h.SEGM_CONFIDENCE.EPSILON,
        )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[R, h, w, C]`` -> float32 maps ``[R, 2 * up * h, 2 * up * w, *]``."""
        x = nchw(x)

        def out(name):
            return upsample_bilinear(nhwc(getattr(self, f"{name}_lowres")(x)), self.up_scale)

        res = {"coarse_segm": out("ann_index"), "fine_segm": out("index_uv"), "u": out("u"), "v": out("v")}
        if self.uv_confidence != "none":
            res["sigma_2"] = out("sigma_2")
            if self.uv_confidence == "indep_aniso":
                res.update(kappa_u=out("kappa_u"), kappa_v=out("kappa_v"))
        if self.segm_confidence:
            eps = self.segm_confidence_epsilon
            fconf = F.softplus(out("fine_segm_confidence")) + eps
            cconf = F.softplus(out("coarse_segm_confidence")) + eps
            res.update(fine_segm_confidence=fconf, coarse_segm_confidence=cconf)
            res["fine_segm"] = res["fine_segm"] * fconf
            res["coarse_segm"] = res["coarse_segm"] * cconf
        return {k: v.float() for k, v in res.items()}


class DensePoseEmbeddingPredictor(nn.Module):
    """CSE predictor (d2's ``predictors/cse.py``): the coarse segmentation
    and the per-pixel embedding, each a stride-2 transposed conv upsampled
    by ``up_scale``. d2's "WithConfidence" variant adds layers only when a
    confidence is enabled, which no CSE config does: one class."""

    def __init__(
        self, in_channels: int, embed_size: int = 16, num_coarse_segm_channels: int = 2, deconv_kernel: int = 4,
        up_scale: int = 2,
    ):
        super().__init__()
        self.up_scale = up_scale
        for name, channels in (("coarse_segm", num_coarse_segm_channels), ("embed", embed_size)):
            self.add_module(
                f"{name}_lowres",
                ConvTranspose2d(in_channels, channels, deconv_kernel, stride=2, padding=deconv_kernel // 2 - 1),
            )

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "DensePoseEmbeddingPredictor":
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        return cls(in_channels, h.CSE.EMBED_SIZE, h.NUM_COARSE_SEGM_CHANNELS, h.DECONV_KERNEL, h.UP_SCALE)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[R, h, w, C]`` -> float32 ``coarse_segm`` and ``embedding``
        ``[R, 2 * up * h, 2 * up * w, *]``."""
        x = nchw(x)
        return {
            key: upsample_bilinear(nhwc(getattr(self, f"{name}_lowres")(x)), self.up_scale).float()
            for key, name in (("coarse_segm", "coarse_segm"), ("embedding", "embed"))
        }


class DensePoseDecoder(nn.Module):
    """The FPN decoder ahead of the DensePose pool: per level
    ``max(1, log2(stride / common_stride))`` conv (+ norm) + ReLU steps, each
    followed by a 2x upsample while the level is coarser than the common
    stride; the levels summed in order, then a 1x1 predictor. NHWC levels
    -> ``[B, H / cs, W / cs, num_classes]`` in the compute dtype."""

    def __init__(
        self,
        in_features: Sequence[str],
        feature_strides: Sequence[int],
        feature_channels: Sequence[int],
        conv_dims: int = 256,
        num_classes: int = 256,
        common_stride: int = 4,
        norm: str = "",
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        for f, stride, channels in zip(self.in_features, feature_strides, feature_channels):
            ops = []
            for k in range(max(1, int(math.log2(stride) - math.log2(common_stride)))):
                ops.append(
                    Conv2d(
                        channels if k == 0 else conv_dims, conv_dims, 3, padding=1, bias=not norm,
                        norm=get_norm(norm, conv_dims), activation=F.relu,
                    )
                )
                if stride != common_stride:
                    ops.append(_Upsample2x())
            self.add_module(f, nn.Sequential(*ops))
        self.predictor = Conv2d(conv_dims, num_classes, 1)

    @classmethod
    def from_config(cls, cfg, input_shape, in_features) -> "DensePoseDecoder":
        h = cfg.MODEL.ROI_DENSEPOSE_HEAD
        return cls(
            in_features,
            [input_shape[f].stride for f in in_features],
            [input_shape[f].channels for f in in_features],
            conv_dims=h.DECODER_CONV_DIMS,
            num_classes=h.DECODER_NUM_CLASSES,
            common_stride=h.DECODER_COMMON_STRIDE,
            norm=h.DECODER_NORM,
        )

    def forward(self, features: Sequence[torch.Tensor], train: bool) -> torch.Tensor:
        out = None
        for f, x in zip(self.in_features, features):
            x = _run(getattr(self, f), nchw(x), train)
            out = x if out is None else out + x
        return nhwc(self.predictor(out, train))


_HEADS = {"DensePoseV1ConvXHead": DensePoseV1ConvXHead, "DensePoseDeepLabHead": DensePoseDeepLabHead}
# d2's "WithConfidence" predictor is the chart predictor with the confidence
# layers the config enables: one class here, as in the JAX package
_PREDICTORS = {
    "DensePoseChartPredictor": DensePoseChartPredictor,
    "DensePoseChartWithConfidencePredictor": DensePoseChartPredictor,
    "DensePoseEmbeddingPredictor": DensePoseEmbeddingPredictor,
    "DensePoseEmbeddingWithConfidencePredictor": DensePoseEmbeddingPredictor,
}


def build_densepose_head(cfg, in_channels: int) -> nn.Module:
    name = cfg.MODEL.ROI_DENSEPOSE_HEAD.NAME
    if name not in _HEADS:
        raise NotImplementedError(f"DensePose head {name!r} is not ported yet (ROADMAP A10)")
    return _HEADS[name].from_config(cfg, in_channels)


def build_densepose_predictor(cfg, in_channels: int) -> nn.Module:
    name = cfg.MODEL.ROI_DENSEPOSE_HEAD.PREDICTOR_NAME
    if name not in _PREDICTORS:
        raise NotImplementedError(f"DensePose predictor {name!r} is in neither package")
    return _PREDICTORS[name].from_config(cfg, in_channels)
