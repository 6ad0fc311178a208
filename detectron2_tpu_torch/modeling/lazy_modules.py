"""Model constructors that take the JAX modules' keyword arguments, for lazy
configs (``L(FastRCNNConvFCHead)(conv_dims=..., fc_dims=...)`` in
``configs/common/models/mask_rcnn_fpn.py``).

Flax modules infer their input widths; torch modules need them. So a
constructor of a module whose width comes from its parent returns a
:class:`Deferred`, which the parent calls with that width when it is built:
``generalized_rcnn`` hands the backbone's output shapes to the RPN and the
ROI heads, the heads hand the pooled width to the box, mask and keypoint
heads and the box head's output width to the predictor, the FPN hands its
top block the width of the feature it reads, and a dense detector hands its
head the width of its levels. The backbones (ViT, SimpleFeaturePyramid,
ResNet, FPN) know their widths and are built at once.
:func:`detectron2_tpu_torch.model_zoo.build_mask_rcnn_vitdet` builds through
these same constructors. Options the port does not implement raise
``NotImplementedError`` naming them, when the model is built.
"""

import inspect
from typing import Callable, Dict, Optional, Sequence

from torch import nn

from detectron2_tpu_torch.layers import ShapeSpec

__all__ = [
    "Deferred",
    "generalized_rcnn",
    "rpn",
    "standard_rpn_head",
    "standard_roi_heads",
    "cascade_roi_heads",
    "fast_rcnn_conv_fc_head",
    "fast_rcnn_output_layers",
    "mask_rcnn_conv_upsample_head",
    "krcnn_conv_deconv_upsample_head",
    "resnet",
    "last_level_p6p7",
    "retinanet",
    "fcos",
    "fcos_head",
]


class Deferred:
    """A module constructor waiting for the widths its parent knows."""

    def __init__(self, build: Callable, name: str):
        self._build = build
        self.name = name

    def __call__(self, *args, **kwargs) -> nn.Module:
        return self._build(*args, **kwargs)

    def __repr__(self) -> str:
        return f"Deferred({self.name})"


def _build(x, *args):
    return x(*args) if isinstance(x, Deferred) else x


def _refuse(**options) -> None:
    for name, on in options.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP A7's second part)")


def generalized_rcnn(
    *,
    backbone: nn.Module,
    proposal_generator,
    roi_heads,
    pixel_mean,
    pixel_std,
    input_format: str = "BGR",
    compute_dtype: str = "bfloat16",
    vis_period: int = 0,
    mask_paste_in_graph: bool = False,
):
    """``GeneralizedRCNN`` from the JAX fields, on the CPU in eval mode; the
    RPN and the heads get the backbone's output shapes. ``vis_period`` is
    accepted and unused (no visualizer in the port's trainer)."""
    from detectron2_tpu_torch.modeling.meta_arch.rcnn import GeneralizedRCNN

    shapes = backbone.output_shape()
    return GeneralizedRCNN(
        backbone=backbone,
        proposal_generator=_build(proposal_generator, shapes),
        roi_heads=_build(roi_heads, shapes),
        pixel_mean=tuple(pixel_mean),
        pixel_std=tuple(pixel_std),
        input_format=input_format,
        compute_dtype=compute_dtype,
        mask_paste_in_graph=mask_paste_in_graph,
    ).eval()


def _generalized_rcnn_from_config(cfg):
    """The model of a yacs ``cfg``, on the CPU (config-file builders call
    ``GeneralizedRCNN.from_config(cfg)``)."""
    from detectron2_tpu_torch.modeling import build_model

    return build_model(cfg, device="cpu")


generalized_rcnn.from_config = _generalized_rcnn_from_config


def standard_rpn_head(*, num_anchors: int, conv_dims=(-1,), box_dim: int = 4, in_channels: int = 256):
    """``StandardRPNHead``; its width is checked against the backbone's."""

    def build(shapes: Dict[str, ShapeSpec], in_features):
        from detectron2_tpu_torch.modeling.proposal_generator import StandardRPNHead

        channels = {shapes[f].channels for f in in_features}
        assert channels == {in_channels}, f"RPN head in_channels {in_channels} != backbone's {channels}"
        return StandardRPNHead(in_channels, num_anchors, box_dim, tuple(conv_dims))

    return Deferred(build, "StandardRPNHead")


def rpn(
    *,
    in_features,
    head,
    anchor_generator,
    box2box_weights=(1.0, 1.0, 1.0, 1.0),
    anchor_matcher_cfg=((0.3, 0.7), (0, -1, 1), True),
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    pre_nms_topk_train: int = 12000,
    pre_nms_topk_test: int = 6000,
    post_nms_topk_train: int = 2000,
    post_nms_topk_test: int = 1000,
    nms_thresh: float = 0.7,
    min_box_size: float = 0.0,
    anchor_boundary_thresh: float = -1.0,
    loss_weight_cls: float = 1.0,
    loss_weight_loc: float = 1.0,
    box_reg_loss_type: str = "smooth_l1",
    smooth_l1_beta: float = 0.0,
):
    """``RPN`` from the JAX fields; ``anchor_matcher_cfg`` is (thresholds,
    labels, allow_low_quality_matches)."""
    _refuse(**{f"RPN box_reg_loss_type={box_reg_loss_type!r}": box_reg_loss_type != "smooth_l1"})

    def build(shapes: Dict[str, ShapeSpec]):
        from detectron2_tpu_torch.modeling.matcher import Matcher
        from detectron2_tpu_torch.modeling.proposal_generator import RPN

        thresholds, labels, low_quality = anchor_matcher_cfg
        return RPN(
            in_features=tuple(in_features),
            head=_build(head, shapes, in_features),
            anchor_generator=anchor_generator,
            anchor_matcher=Matcher(list(thresholds), list(labels), allow_low_quality_matches=low_quality),
            box2box_weights=tuple(box2box_weights),
            batch_size_per_image=batch_size_per_image,
            positive_fraction=positive_fraction,
            pre_nms_topk_train=pre_nms_topk_train,
            pre_nms_topk_test=pre_nms_topk_test,
            post_nms_topk_train=post_nms_topk_train,
            post_nms_topk_test=post_nms_topk_test,
            nms_thresh=nms_thresh,
            min_box_size=min_box_size,
            anchor_boundary_thresh=anchor_boundary_thresh,
            loss_weight_cls=loss_weight_cls,
            loss_weight_loc=loss_weight_loc,
            smooth_l1_beta=smooth_l1_beta,
        )

    return Deferred(build, "RPN")


def fast_rcnn_conv_fc_head(*, conv_dims=(), fc_dims=(1024, 1024), conv_norm: str = ""):
    """``FastRCNNConvFCHead``, built with the pooled width and resolution."""

    def build(in_channels: int, resolution: int):
        from detectron2_tpu_torch.modeling.roi_heads import FastRCNNConvFCHead

        return FastRCNNConvFCHead(in_channels, resolution, tuple(fc_dims), tuple(conv_dims), conv_norm)

    return Deferred(build, "FastRCNNConvFCHead")


def fast_rcnn_output_layers(
    *,
    num_classes: int,
    box2box_weights=(10.0, 10.0, 5.0, 5.0),
    cls_agnostic_bbox_reg: bool = False,
    smooth_l1_beta: float = 0.0,
    test_score_thresh: float = 0.05,
    test_nms_thresh: float = 0.5,
    test_topk_per_image: int = 100,
    box_reg_loss_type: str = "smooth_l1",
    loss_weight_cls: float = 1.0,
    loss_weight_box: float = 1.0,
    use_sigmoid_ce: bool = False,
    use_fed_loss: bool = False,
    fed_loss_num_classes: int = 50,
    fed_loss_cls_weights=None,
    box_dim: int = 4,
):
    """``FastRCNNOutputLayers``, built with the box head's output width."""

    def build(input_dim: int):
        from detectron2_tpu_torch.modeling.roi_heads import FastRCNNOutputLayers

        _refuse(
            **{
                f"box_reg_loss_type={box_reg_loss_type!r}": box_reg_loss_type != "smooth_l1",
                "use_sigmoid_ce": use_sigmoid_ce,
                "use_fed_loss": use_fed_loss,
                f"loss_weight_cls={loss_weight_cls}": loss_weight_cls != 1.0,
                f"box_dim={box_dim}": box_dim != 4,
            }
        )
        return FastRCNNOutputLayers(
            input_dim,
            num_classes,
            box2box_weights=tuple(box2box_weights),
            cls_agnostic_bbox_reg=cls_agnostic_bbox_reg,
            test_score_thresh=test_score_thresh,
            test_nms_thresh=test_nms_thresh,
            test_topk_per_image=test_topk_per_image,
            smooth_l1_beta=smooth_l1_beta,
            loss_weight_box=loss_weight_box,
        )

    return Deferred(build, "FastRCNNOutputLayers")


def mask_rcnn_conv_upsample_head(*, num_classes: int, conv_dims=(256, 256, 256, 256), conv_norm: str = "", cls_agnostic: bool = False):
    """``MaskRCNNConvUpsampleHead``: ``conv_dims[:-1]`` are the 3x3 convs,
    ``conv_dims[-1]`` the deconv, as in the JAX package."""
    if len(set(conv_dims)) != 1:
        raise NotImplementedError("the mask head takes one width for its convs and its deconv")

    def build(in_channels: int):
        from detectron2_tpu_torch.modeling.roi_heads import MaskRCNNConvUpsampleHead

        return MaskRCNNConvUpsampleHead(
            in_channels, num_classes, conv_dims[-1], len(conv_dims) - 1, conv_norm, cls_agnostic
        )

    return Deferred(build, "MaskRCNNConvUpsampleHead")


def krcnn_conv_deconv_upsample_head(*, num_keypoints: int = 17, conv_dims=(512,) * 8):
    """``KRCNNConvDeconvUpsampleHead``, built with the pooled width."""

    def build(in_channels: int):
        from detectron2_tpu_torch.modeling.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead

        return KRCNNConvDeconvUpsampleHead(in_channels, num_keypoints, tuple(conv_dims))

    return Deferred(build, "KRCNNConvDeconvUpsampleHead")


def _roi_heads_args(
    shapes,
    *,
    in_features=("p2", "p3", "p4", "p5"),
    num_classes: int = 80,
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    matcher_thresholds=(0.5,),
    matcher_labels=(0, 1),
    proposal_append_gt: bool = True,
    box_pooler_resolution: int = 7,
    pooler_scales=(0.25, 0.125, 0.0625, 0.03125),
    pooler_sampling_ratio: int = 0,
    pooler_type: str = "ROIAlignV2",
    mask_head=None,
    mask_pooler_resolution: int = 14,
    keypoint_head=None,
    keypoint_pooler_resolution: int = 14,
    normalize_kpt_loss_by_visible: bool = True,
    keypoint_loss_weight: float = 1.0,
    train_on_pred_boxes: bool = False,
):
    """The JAX ``StandardROIHeads`` fields (with their defaults) as the
    port's constructor arguments, without the box head and predictor;
    returns (arguments, pooled width, box pooler resolution)."""
    from detectron2_tpu_torch.modeling.matcher import Matcher
    from detectron2_tpu_torch.modeling.poolers import ROIPooler

    _refuse(train_on_pred_boxes=train_on_pred_boxes)
    channels = {shapes[f].channels for f in in_features}
    assert len(channels) == 1, f"the pooled levels differ in width: {channels}"
    channels = channels.pop()

    def pool(res):
        return ROIPooler(res, tuple(pooler_scales), pooler_sampling_ratio, pooler_type)

    return dict(
        in_features=tuple(in_features),
        box_pooler=pool(box_pooler_resolution),
        proposal_matcher=Matcher(list(matcher_thresholds), list(matcher_labels), allow_low_quality_matches=False),
        mask_pooler=pool(mask_pooler_resolution) if mask_head is not None else None,
        mask_head=_build(mask_head, channels),
        keypoint_pooler=pool(keypoint_pooler_resolution) if keypoint_head is not None else None,
        keypoint_head=_build(keypoint_head, channels),
        num_classes=num_classes,
        batch_size_per_image=batch_size_per_image,
        positive_fraction=positive_fraction,
        proposal_append_gt=proposal_append_gt,
        normalize_kpt_loss_by_visible=normalize_kpt_loss_by_visible,
        keypoint_loss_weight=keypoint_loss_weight,
    ), channels, box_pooler_resolution


def _check_roi_heads_kwargs(kwargs) -> None:
    """Refuse an argument the JAX heads do not take when the config is
    instantiated, not later when the model is built."""
    inspect.signature(_roi_heads_args).bind(None, **kwargs)


def standard_roi_heads(*, box_head, box_predictor, **kwargs):
    """``StandardROIHeads`` from the JAX fields (``_roi_heads_args``), built
    with the backbone's output shapes."""
    _check_roi_heads_kwargs(kwargs)

    def build(shapes: Dict[str, ShapeSpec]):
        from detectron2_tpu_torch.modeling.roi_heads import StandardROIHeads

        args, channels, res = _roi_heads_args(shapes, **kwargs)
        head = _build(box_head, channels, res)
        return StandardROIHeads(box_head=head, box_predictor=_build(box_predictor, head.output_dim), **args)

    return Deferred(build, "StandardROIHeads")


def cascade_roi_heads(
    *,
    box_head: Sequence,
    box_predictor: Sequence,
    cascade_ious=(0.5, 0.6, 0.7),
    cascade_bbox_reg_weights=((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0)),
    **kwargs,
):
    """``CascadeROIHeads``: one box head and predictor per stage. Each
    predictor decodes with its own ``box2box_weights``, which must equal the
    stage's ``cascade_bbox_reg_weights``."""
    _check_roi_heads_kwargs(kwargs)
    assert len(box_head) == len(box_predictor) == len(cascade_ious) == len(cascade_bbox_reg_weights)

    def build(shapes: Dict[str, ShapeSpec]):
        from detectron2_tpu_torch.modeling.roi_heads.cascade_rcnn import CascadeROIHeads

        args, channels, res = _roi_heads_args(shapes, **kwargs)
        heads = [_build(h, channels, res) for h in box_head]
        predictors = [_build(p, h.output_dim) for p, h in zip(box_predictor, heads)]
        for p, w in zip(predictors, cascade_bbox_reg_weights):
            if tuple(p.box2box_transform.weights) != tuple(float(x) for x in w):
                raise NotImplementedError("a cascade stage's predictor weights differ from cascade_bbox_reg_weights")
        return CascadeROIHeads(
            box_head=nn.ModuleList(heads), box_predictor=nn.ModuleList(predictors), cascade_ious=tuple(cascade_ious), **args
        )

    return Deferred(build, "CascadeROIHeads")


def resnet(
    *,
    stage_specs,
    stem_out_channels: int = 64,
    norm: str = "FrozenBN",
    out_features=("res4",),
    freeze_at: int = 0,
    num_classes: Optional[int] = None,
    stem_class=None,
):
    """``ResNet`` from per-block constructor kwargs
    (:func:`~detectron2_tpu_torch.modeling.backbone.resnet.make_stage_specs`),
    up to the deepest stage in ``out_features``."""
    from detectron2_tpu_torch.modeling.backbone.resnet import BasicStem, ResNet, build_stages

    if num_classes is not None or stem_class is not None:
        raise NotImplementedError("ResNet num_classes / stem_class are not ported yet")
    stages = build_stages(stage_specs, out_features)
    return ResNet(BasicStem(3, stem_out_channels, norm), stages, out_features, freeze_at=freeze_at)


def last_level_p6p7(*, out_channels: int, in_feature: str = "res5", num_levels: int = 2):
    """``LastLevelP6P7``, built by the FPN with the width of ``in_feature``
    (``res5``'s for RetinaNet, ``p5``'s for FCOS)."""
    if num_levels != 2:
        raise NotImplementedError("LastLevelP6P7 makes two levels")

    def build(in_channels: int):
        from detectron2_tpu_torch.modeling.backbone.fpn import LastLevelP6P7

        return LastLevelP6P7(in_channels, out_channels, in_feature)

    deferred = Deferred(build, "LastLevelP6P7")
    deferred.in_feature = in_feature  # the FPN reads it to find the width
    return deferred


def _head_width(backbone: nn.Module, head_in_features) -> int:
    shapes = backbone.output_shape()
    channels = {shapes[f].channels for f in head_in_features}
    assert len(channels) == 1, f"the head's levels differ in width: {channels}"
    return channels.pop()


_PIXEL_MEAN, _PIXEL_STD = (103.53, 116.28, 123.675), (1.0, 1.0, 1.0)


def retinanet(
    *,
    backbone: nn.Module,
    head,
    head_in_features,
    anchor_generator,
    box2box_weights=(1.0, 1.0, 1.0, 1.0),
    matcher_cfg=((0.4, 0.5), (0, -1, 1), True),
    num_classes: int = 80,
    focal_loss_alpha: float = 0.25,
    focal_loss_gamma: float = 2.0,
    smooth_l1_beta: float = 0.1,
    box_reg_loss_type: str = "smooth_l1",
    test_score_thresh: float = 0.05,
    test_topk_candidates: int = 1000,
    test_nms_thresh: float = 0.5,
    max_detections_per_image: int = 100,
    topk_recall_target: float = 0.99,
    exact_topk: bool = False,
    pixel_mean=_PIXEL_MEAN,
    pixel_std=_PIXEL_STD,
    compute_dtype: str = "bfloat16",
):
    """``RetinaNet`` from the JAX fields, on the CPU in eval mode; a
    deferred head gets the levels' width. ``matcher_cfg`` is (thresholds,
    labels, allow_low_quality_matches); the TPU top-k options are accepted
    and unused (the port's top-k is exact)."""
    from detectron2_tpu_torch.modeling.matcher import Matcher
    from detectron2_tpu_torch.modeling.meta_arch.retinanet import RetinaNet

    thresholds, labels, low_quality = matcher_cfg
    return RetinaNet(
        backbone=backbone,
        head=_build(head, _head_width(backbone, head_in_features)),
        head_in_features=tuple(head_in_features),
        anchor_generator=anchor_generator,
        anchor_matcher=Matcher(list(thresholds), list(labels), allow_low_quality_matches=low_quality),
        box2box_weights=tuple(box2box_weights),
        num_classes=num_classes,
        focal_loss_alpha=focal_loss_alpha,
        focal_loss_gamma=focal_loss_gamma,
        smooth_l1_beta=smooth_l1_beta,
        box_reg_loss_type=box_reg_loss_type,
        test_score_thresh=test_score_thresh,
        test_topk_candidates=test_topk_candidates,
        test_nms_thresh=test_nms_thresh,
        max_detections_per_image=max_detections_per_image,
        pixel_mean=tuple(pixel_mean),
        pixel_std=tuple(pixel_std),
        compute_dtype=compute_dtype,
    ).eval()


def _retinanet_from_config(cfg):
    """The RetinaNet of a yacs ``cfg``, on the CPU (config-file builders call
    ``RetinaNet.from_config(cfg)``)."""
    from detectron2_tpu_torch.modeling.meta_arch.retinanet import RetinaNet

    return RetinaNet.from_config(cfg).eval()


retinanet.from_config = _retinanet_from_config


def fcos_head(*, num_classes: int, conv_dims=(256, 256, 256, 256), norm: str = "GN", prior_prob: float = 0.01):
    """``FCOSHead``, built by the detector with the levels' width."""

    def build(in_channels: int):
        from detectron2_tpu_torch.modeling.meta_arch.fcos import FCOSHead

        return FCOSHead(in_channels=in_channels, num_classes=num_classes, conv_dims=tuple(conv_dims), norm=norm, prior_prob=prior_prob)

    return Deferred(build, "FCOSHead")


def fcos(
    *,
    backbone: nn.Module,
    head,
    head_in_features,
    num_classes: int = 80,
    center_sampling_radius: float = 1.5,
    focal_loss_alpha: float = 0.25,
    focal_loss_gamma: float = 2.0,
    test_score_thresh: float = 0.2,
    test_topk_candidates: int = 1000,
    test_nms_thresh: float = 0.6,
    max_detections_per_image: int = 100,
    strides=(8, 16, 32, 64, 128),
    topk_recall_target: float = 0.99,
    exact_topk: bool = False,
    pixel_mean=_PIXEL_MEAN,
    pixel_std=_PIXEL_STD,
    compute_dtype: str = "bfloat16",
):
    """``FCOS`` from the JAX fields, on the CPU in eval mode (the TPU top-k
    options are accepted and unused)."""
    from detectron2_tpu_torch.modeling.meta_arch.fcos import FCOS

    return FCOS(
        backbone=backbone,
        head=_build(head, _head_width(backbone, head_in_features)),
        head_in_features=tuple(head_in_features),
        num_classes=num_classes,
        center_sampling_radius=center_sampling_radius,
        focal_loss_alpha=focal_loss_alpha,
        focal_loss_gamma=focal_loss_gamma,
        test_score_thresh=test_score_thresh,
        test_topk_candidates=test_topk_candidates,
        test_nms_thresh=test_nms_thresh,
        max_detections_per_image=max_detections_per_image,
        strides=tuple(strides),
        pixel_mean=tuple(pixel_mean),
        pixel_std=tuple(pixel_std),
        compute_dtype=compute_dtype,
    ).eval()


def _fcos_from_config(cfg):
    """The FCOS of a yacs ``cfg``, on the CPU (``configs/COCO-Detection/
    fcos_R_50_FPN_1x.py`` calls ``FCOS.from_config(cfg)``, then ``.clone``)."""
    from detectron2_tpu_torch.modeling.meta_arch.fcos import FCOS

    return FCOS.from_config(cfg).eval()


fcos.from_config = _fcos_from_config
