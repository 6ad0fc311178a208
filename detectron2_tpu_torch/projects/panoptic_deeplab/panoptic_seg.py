"""Panoptic-DeepLab: its two heads and the meta architecture (counterpart of
the JAX package's ``projects/panoptic_deeplab/panoptic_seg.py``).

The semantic head is the DeepLabV3+ decoder, a head tower (``head``: two
3x3 convs, or one 5x5 depthwise-separable conv) and ``predictor``; its loss
is the hard-pixel-mining cross entropy, with no pixel weights (ROADMAP C).
The instance branch has a decoder of its own, the center tower (always two
3x3 convs) with ``center_predictor``, and the offset tower (as the
semantic one) with ``offset_predictor``; the offsets are scaled by the
stride. d2's names throughout (``sem_seg_head.head.0``,
``ins_embed_head.center_head.1``, ``ins_embed_head.offset_predictor``).

Training batch: ``image``, ``image_sizes``, ``gt_sem_seg`` ``[B, H, W]``,
``gt_center`` ``[B, H, W]``, ``gt_offset`` ``[B, H, W, 2]`` and the weight
maps ``gt_center_weights`` / ``gt_offset_weights`` (optional), as
:class:`PanopticDeepLabTargetGenerator` makes them on the host. Inference
returns the padded frame's ``sem_seg`` ``[B, H, W, C]``, ``center`` ``[B,
H, W]`` and ``offset`` ``[B, H, W, 2]``, all float32; the fusion is
:func:`post_processing.panoptic_deeplab_postprocess`, which the predictor
and the evaluation loop run (``panoptic_outputs``).
"""

from typing import Dict, List, Optional

import torch
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, ShapeSpec, nchw, nhwc
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import SEM_SEG_HEADS_REGISTRY
from detectron2_tpu_torch.projects.deeplab.loss import hard_pixel_mining_ce
from detectron2_tpu_torch.projects.deeplab.semantic_seg import (
    DeepLabV3PlusHead,
    head_kwargs,
    head_tower,
    resize_bilinear,
    run_tower,
)
from detectron2_tpu_torch.projects.panoptic_deeplab.post_processing import panoptic_deeplab_postprocess
from detectron2_tpu_torch.utils.registry import Registry

__all__ = [
    "INS_EMBED_BRANCHES_REGISTRY",
    "PanopticDeepLab",
    "PanopticDeepLabInsEmbedHead",
    "PanopticDeepLabSemSegHead",
    "panoptic_outputs",
]

INS_EMBED_BRANCHES_REGISTRY = Registry("INS_EMBED_BRANCHES")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@SEM_SEG_HEADS_REGISTRY.register()
class PanopticDeepLabSemSegHead(DeepLabV3PlusHead):
    """The V3+ decoder, the ``head`` tower (``conv_dims -> head_channels``)
    and ``predictor``; the loss is always the hard-pixel-mining cross
    entropy at ``loss_top_k``."""

    def __init__(self, *, head_channels: int = 256, num_classes: int = 19, **kwargs):
        super().__init__(num_classes=None, **kwargs)
        depthwise_separable = kwargs.get("use_depthwise_separable_conv", False)
        self.head = head_tower(self.conv_dims, head_channels, kwargs.get("norm", "GN"), depthwise_separable)
        self.predictor = Conv2d(head_channels, num_classes, 1)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "PanopticDeepLabSemSegHead":
        h = cfg.MODEL.SEM_SEG_HEAD
        in_features = tuple(h.IN_FEATURES)
        assert in_features[:-1] == tuple(h.PROJECT_FEATURES), (
            "PROJECT_FEATURES must be IN_FEATURES minus the last (ASPP) feature"
        )
        return cls(**head_kwargs(h, in_features, input_shape), project_channels=tuple(h.PROJECT_CHANNELS),
                   head_channels=h.HEAD_CHANNELS, num_classes=h.NUM_CLASSES, loss_weight=h.LOSS_WEIGHT,
                   loss_top_k=h.LOSS_TOP_K, ignore_value=h.IGNORE_VALUE,
                   use_depthwise_separable_conv=h.USE_DEPTHWISE_SEPARABLE_CONV)

    def forward(self, features: Dict[str, torch.Tensor], targets: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        y = run_tower(self.head, self.decode(features, train, generator), train)
        logits = nhwc(self.upsampled(y, self.predictor, train))
        if train:
            assert targets is not None, "training needs gt_sem_seg"
            up = nhwc(resize_bilinear(nchw(logits), targets.shape[1], targets.shape[2]))
            loss = hard_pixel_mining_ce(up, targets, ignore_index=self.ignore_value, top_k_percent=self.loss_top_k)
            return None, {"loss_sem_seg": loss * self.loss_weight}
        return logits, {}


@INS_EMBED_BRANCHES_REGISTRY.register()
class PanopticDeepLabInsEmbedHead(DeepLabV3PlusHead):
    """The instance branch: its V3+ decoder, the center tower and
    predictor (1 channel, MSE loss weighted by ``gt_center_weights`` over
    their sum), the offset tower and predictor (2 channels times the
    stride, L1 loss weighted by ``gt_offset_weights``)."""

    def __init__(self, *, head_channels: int = 32, center_loss_weight: float = 200.0,
                 offset_loss_weight: float = 0.01, **kwargs):
        super().__init__(num_classes=None, **kwargs)
        norm = kwargs.get("norm", "GN")
        self.center_loss_weight, self.offset_loss_weight = center_loss_weight, offset_loss_weight
        self.center_head = head_tower(self.conv_dims, head_channels, norm, False)
        self.center_predictor = Conv2d(head_channels, 1, 1)
        self.offset_head = head_tower(self.conv_dims, head_channels, norm, kwargs.get("use_depthwise_separable_conv", False))
        self.offset_predictor = Conv2d(head_channels, 2, 1)

    @classmethod
    def from_config(cls, cfg, input_shape: Dict[str, ShapeSpec]) -> "PanopticDeepLabInsEmbedHead":
        h = cfg.MODEL.INS_EMBED_HEAD
        in_features = tuple(h.IN_FEATURES)
        return cls(**head_kwargs(h, in_features, input_shape), project_channels=tuple(h.PROJECT_CHANNELS),
                   head_channels=h.HEAD_CHANNELS, center_loss_weight=h.CENTER_LOSS_WEIGHT,
                   offset_loss_weight=h.OFFSET_LOSS_WEIGHT,
                   # the semantic head's flag, as the JAX package and d2 read it
                   use_depthwise_separable_conv=cfg.MODEL.SEM_SEG_HEAD.USE_DEPTHWISE_SEPARABLE_CONV)

    def forward(self, features: Dict[str, torch.Tensor], center_targets: Optional[torch.Tensor] = None,
                offset_targets: Optional[torch.Tensor] = None, center_weights: Optional[torch.Tensor] = None,
                offset_weights: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """``(None, None, losses)`` in training, else ``(center [B, H, W],
        offset [B, H, W, 2], {})``."""
        y = self.decode(features, train, generator)
        center = self.upsampled(run_tower(self.center_head, y, train), self.center_predictor, train)[:, 0]
        offset = nhwc(self.upsampled(run_tower(self.offset_head, y, train), self.offset_predictor, train)) * self.stride
        if not train:
            return center, offset, {}
        assert center_targets is not None and offset_targets is not None, "training needs gt_center and gt_offset"
        cw = torch.ones_like(center) if center_weights is None else center_weights
        ow = torch.ones_like(center) if offset_weights is None else offset_weights
        loss_center = ((center - center_targets) ** 2 * cw).sum() / cw.sum().clamp(min=1.0)
        loss_offset = ((offset - offset_targets).abs().sum(-1) * ow).sum() / ow.sum().clamp(min=1.0)
        return None, None, {"loss_center": loss_center * self.center_loss_weight,
                            "loss_offset": loss_offset * self.offset_loss_weight}


class PanopticDeepLab(nn.Module):
    """The backbone, ``sem_seg_head`` and ``ins_embed_head``.
    ``forward(batch, train, generator)``: the losses in training (the ASPP
    dropouts draw from ``generator``), else the raw outputs under
    ``torch.inference_mode``. The fusion's parameters (``stuff_area``,
    ``center_threshold``, ``nms_kernel``, ``top_k_instances``) and the name
    of the dataset whose metadata gives its thing ids and
    ``label_divisor`` (``DATASETS.TRAIN[0]``, as d2's model reads it) are
    kept for :func:`panoptic_outputs`."""

    def __init__(self, *, backbone: nn.Module, sem_seg_head: nn.Module, ins_embed_head: nn.Module, pixel_mean,
                 pixel_std, input_format: str = "RGB", compute_dtype: str = "bfloat16", stuff_area: int = 2048,
                 center_threshold: float = 0.1, nms_kernel: int = 7, top_k_instances: int = 200,
                 metadata_name: Optional[str] = None):
        super().__init__()
        self.backbone = backbone
        self.sem_seg_head = sem_seg_head
        self.ins_embed_head = ins_embed_head
        self.input_format = input_format
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32), False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32), False)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.stuff_area, self.center_threshold = stuff_area, center_threshold
        self.nms_kernel, self.top_k_instances = nms_kernel, top_k_instances
        self.metadata_name = metadata_name

    @classmethod
    def from_config(cls, cfg) -> "PanopticDeepLab":
        from detectron2_tpu_torch.modeling.backbone import build_backbone
        from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import build_sem_seg_head

        backbone = build_backbone(cfg)
        shapes = backbone.output_shape()
        p = cfg.MODEL.PANOPTIC_DEEPLAB
        return cls(
            backbone=backbone,
            sem_seg_head=build_sem_seg_head(cfg, shapes),
            ins_embed_head=INS_EMBED_BRANCHES_REGISTRY.get(cfg.MODEL.INS_EMBED_HEAD.NAME).from_config(cfg, shapes),
            pixel_mean=cfg.MODEL.PIXEL_MEAN,
            pixel_std=cfg.MODEL.PIXEL_STD,
            input_format=cfg.INPUT.FORMAT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            stuff_area=p.STUFF_AREA,
            center_threshold=p.CENTER_THRESHOLD,
            nms_kernel=p.NMS_KERNEL,
            top_k_instances=p.TOP_K_INSTANCE,
            metadata_name=cfg.DATASETS.TRAIN[0] if len(cfg.DATASETS.TRAIN) else None,
        )

    @property
    def device(self) -> torch.device:
        return self.pixel_mean.device

    def preprocess_image(self, image: torch.Tensor) -> torch.Tensor:
        return ((image.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)

    def forward(self, batch: Dict, train: bool = False, generator: Optional[torch.Generator] = None):
        if not train:
            return self._inference(batch)
        get = lambda k: None if batch.get(k) is None else torch.as_tensor(batch[k], device=self.device)  # noqa: E731
        features = self.backbone(self.preprocess_image(get("image")), train=True, generator=generator)
        _, sem_losses = self.sem_seg_head(features, get("gt_sem_seg"), train=True, generator=generator)
        _, _, ins_losses = self.ins_embed_head(features, get("gt_center"), get("gt_offset"), get("gt_center_weights"),
                                               get("gt_offset_weights"), train=True, generator=generator)
        return {**sem_losses, **ins_losses}

    @torch.inference_mode()
    def _inference(self, batch: Dict) -> Dict[str, torch.Tensor]:
        features = self.backbone(self.preprocess_image(torch.as_tensor(batch["image"], device=self.device)))
        sem, _ = self.sem_seg_head(features)
        center, offset, _ = self.ins_embed_head(features)
        return {"sem_seg": sem, "center": center, "offset": offset}


def panoptic_outputs(model: PanopticDeepLab, outputs: Dict, image_sizes, out_sizes) -> List:
    """``(panoptic [h, w] int32, segments_info)`` of each image of a
    batch's raw outputs at its ``out_sizes`` (h, w) entry, fused on the
    outputs' device with the model's parameters and the thing ids
    (``thing_dataset_id_to_contiguous_id``'s values) and ``label_divisor``
    of the model's metadata. Where ``out_sizes`` is the image's size in the
    batch (``image_sizes``) the fields are cropped to it, as the JAX
    ``panoptic_deeplab_postprocess`` does; otherwise the logits, the heatmap
    and the offsets are first resized to it (``sem_seg_postprocess``), as
    d2 fuses at the original resolution."""
    from detectron2_tpu_torch.data import MetadataCatalog
    from detectron2_tpu_torch.modeling.postprocessing import sem_seg_postprocess

    if model.metadata_name is None:
        raise ValueError("a PanopticDeepLab's fusion reads DATASETS.TRAIN[0]'s metadata; the config names no train set")
    meta = MetadataCatalog.get(model.metadata_name)
    thing_ids = list(meta.thing_dataset_id_to_contiguous_id.values())
    results = []
    for i, (hw, (h, w)) in enumerate(zip(torch.as_tensor(image_sizes).tolist(), out_sizes)):
        sem, center, offset = outputs["sem_seg"][i], outputs["center"][i], outputs["offset"][i]
        if (int(h), int(w)) != tuple(hw):
            sem = sem_seg_postprocess(sem, hw, h, w)
            center = sem_seg_postprocess(center[..., None], hw, h, w)[..., 0]
            offset = sem_seg_postprocess(offset, hw, h, w)
        results.append(panoptic_deeplab_postprocess(sem, center, offset, (h, w), thing_ids, meta.label_divisor,
                                                    model.stuff_area, model.center_threshold, model.nms_kernel,
                                                    model.top_k_instances))
    return results
