"""Semantic segmentation: ``SemanticSegmentor`` and the FPN head
``SemSegFPNHead`` (counterpart of ``detectron2_tpu/modeling/meta_arch/
semantic_seg.py:24-148``).

The head keeps d2's parameter names: each input level ``p*`` is one
``nn.Sequential`` of conv (+GN+ReLU) and 2x bilinear upsample steps, so
conv ``k`` sits at index ``2k`` (``sem_seg_head.p4.2.weight``), and the
1x1 ``predictor``. The JAX upsample is ``jax.image.resize(...,
"bilinear")``: half-pixel centres, taps past the border dropped and the
rest renormalized, which for an integer factor is the clamped source
coordinate of ``F.interpolate(mode="bilinear", align_corners=False)``; it
contracts the width, then the height, each result in the input's dtype, so
the port interpolates one axis at a time in that order (in bfloat16 the
same bits on the CPU).

Inference returns ``{"sem_seg": [B, H, W, C]}`` float32 logits at the
padded network frame, as the JAX model does (not d2's per-image dicts at
the original size; :func:`~detectron2_tpu_torch.modeling.postprocessing.
sem_seg_postprocess` makes those). Training returns ``loss_sem_seg``: the
cross entropy of the 4x-upsampled logits, cropped to the targets, over the
pixels that are not ``IGNORE_VALUE``.
"""

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, get_norm, nchw, nhwc
from detectron2_tpu_torch.layers.losses import cross_entropy
from detectron2_tpu_torch.utils.registry import Registry

__all__ = ["SEM_SEG_HEADS_REGISTRY", "SemSegFPNHead", "SemanticSegmentor", "build_sem_seg_head", "upsample_bilinear"]

SEM_SEG_HEADS_REGISTRY = Registry("SEM_SEG_HEADS")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _upsample_nchw(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW bilinear upsample by ``factor``: the width, then the height."""
    x = F.interpolate(x, scale_factor=(1, factor), mode="bilinear", align_corners=False)
    return F.interpolate(x, scale_factor=(factor, 1), mode="bilinear", align_corners=False)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, factor*H, factor*W, C]`` as
    ``jax.image.resize(x, ..., "bilinear")``, in ``x``'s dtype."""
    return nhwc(_upsample_nchw(nchw(x), factor))


class _Upsample2x(nn.Module):
    """The parameterless step between two convs of a level, at the index
    of d2's ``nn.Upsample``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _upsample_nchw(x, 2)


def build_sem_seg_head(cfg, input_shape: Dict[str, ShapeSpec]) -> nn.Module:
    """``MODEL.SEM_SEG_HEAD.NAME`` of ``SEM_SEG_HEADS_REGISTRY``
    (``PointRendSemSegHead`` registers when its project is imported, here on
    first use)."""
    if cfg.MODEL.SEM_SEG_HEAD.NAME == "PointRendSemSegHead":
        import detectron2_tpu_torch.projects.point_rend  # noqa: F401
    return SEM_SEG_HEADS_REGISTRY.get(cfg.MODEL.SEM_SEG_HEAD.NAME).from_config(cfg, input_shape)


@SEM_SEG_HEADS_REGISTRY.register()
class SemSegFPNHead(nn.Module):
    """Each level: ``max(1, log2(stride / common_stride))`` conv+norm+ReLU
    steps, each followed by a 2x upsample while the stride is above
    ``common_stride``; the levels are summed, a 1x1 predictor runs in the
    input's dtype and the logits are cast to float32."""

    def __init__(
        self,
        *,
        in_features: Sequence[str],
        feature_strides: Sequence[int],
        feature_channels: Sequence[int],
        num_classes: int = 54,
        conv_dims: int = 128,
        common_stride: int = 4,
        norm: str = "GN",
        loss_weight: float = 1.0,
        ignore_value: int = 255,
    ):
        super().__init__()
        self.in_features = tuple(in_features)
        self.common_stride = common_stride
        self.loss_weight = loss_weight
        self.ignore_value = ignore_value
        for f, stride, channels in zip(self.in_features, feature_strides, feature_channels):
            head_length = max(1, int(math.log2(stride) - math.log2(common_stride)))
            ops = []
            for k in range(head_length):
                ops.append(
                    Conv2d(
                        channels if k == 0 else conv_dims,
                        conv_dims,
                        kernel_size=3,
                        padding=1,
                        bias=not norm,
                        norm=get_norm(norm, conv_dims),
                        activation=F.relu,
                    )
                )
                if stride != common_stride:
                    ops.append(_Upsample2x())
            self.add_module(f, nn.Sequential(*ops))
        self.predictor = Conv2d(conv_dims, num_classes, kernel_size=1)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "SemSegFPNHead":
        h = cfg.MODEL.SEM_SEG_HEAD
        in_features = tuple(h.IN_FEATURES)
        return cls(
            in_features=in_features,
            feature_strides=[input_shape[f].stride for f in in_features],
            feature_channels=[input_shape[f].channels for f in in_features],
            num_classes=h.NUM_CLASSES,
            conv_dims=h.CONVS_DIM,
            common_stride=h.COMMON_STRIDE,
            norm=h.NORM,
            loss_weight=h.LOSS_WEIGHT,
            ignore_value=h.IGNORE_VALUE,
        )

    def layers(self, features: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The NHWC levels -> float32 logits ``[B, H/cs, W/cs, C]``."""
        outs = []
        for f in self.in_features:
            x = nchw(features[f])
            for op in getattr(self, f):
                x = op(x, train) if isinstance(op, Conv2d) else op(x)
            outs.append(x)
        x = sum(outs)
        return nhwc(self.predictor(x, train)).float()

    def losses(self, logits: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Cross entropy of the 4x-upsampled logits cropped to ``targets``
        ``[B, th, tw]``, ``ignore_value`` left out of the mean."""
        up = upsample_bilinear(logits, self.common_stride)[:, : targets.shape[1], : targets.shape[2]]
        loss = cross_entropy(up, targets, reduction="mean", ignore_index=self.ignore_value)
        return {"loss_sem_seg": loss * self.loss_weight}

    def forward(self, features: Dict[str, torch.Tensor], targets: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``(None, losses)`` in training, else ``(4x-upsampled logits, {})``;
        this head draws nothing from ``generator``."""
        logits = self.layers(features, train)
        if train:
            assert targets is not None, "training needs gt_sem_seg"
            return None, self.losses(logits, targets)
        return upsample_bilinear(logits, self.common_stride), {}


class SemanticSegmentor(nn.Module):
    """A backbone and a per-pixel head. ``forward(batch, train, generator)``
    takes the padded batch dict (``image``, ``image_sizes``; in training
    ``gt_sem_seg`` ``[B, H, W]``) and returns the losses, or under
    ``torch.inference_mode`` ``{"sem_seg": [B, H, W, C]}``."""

    def __init__(
        self,
        *,
        backbone: nn.Module,
        sem_seg_head: nn.Module,
        pixel_mean,
        pixel_std,
        input_format: str = "BGR",
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.input_format = input_format  # the channel order pixel_mean is in
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.compute_dtype = _DTYPES[compute_dtype]

    @classmethod
    def from_config(cls, cfg) -> "SemanticSegmentor":
        from detectron2_tpu_torch.modeling.backbone import build_backbone

        backbone = build_backbone(cfg)
        return cls(
            backbone=backbone,
            sem_seg_head=build_sem_seg_head(cfg, backbone.output_shape()),
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
        )

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def train_target_sizes(self) -> Dict:
        """Per-pixel labels only: no boxes' masks or keypoints."""
        return {"mask_size": 0, "num_keypoints": 0, "with_sem_seg": True, "sem_seg_ignore_value": self.sem_seg_head.ignore_value}

    def preprocess_image(self, image: torch.Tensor) -> torch.Tensor:
        return ((image.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def forward(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None):
        if not train:
            return self._inference(batch)
        image = torch.as_tensor(batch["image"], device=self.device)
        features = self.backbone(self.preprocess_image(image), train=True, generator=generator)
        targets = torch.as_tensor(batch["gt_sem_seg"], device=self.device)
        return self.sem_seg_head(features, targets, train=True, generator=generator)[1]

    @torch.inference_mode()
    def _inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(batch["image"], device=self.device)
        logits, _ = self.sem_seg_head(self.backbone(self.preprocess_image(image)))
        return {"sem_seg": logits}
