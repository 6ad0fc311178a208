"""The port's model zoo: the yaml configs of ``configs/`` by their zoo path
(:func:`get_config`, :func:`get`, counterparts of
``detectron2_tpu/model_zoo/model_zoo.py:122-176``), the main path's config
built in code, and the lazy-config models as hyperparameter dicts with a
function that builds them."""

import copy
import os
from typing import Optional, Union

import torch

from detectron2_tpu_torch.config import CfgNode, get_cfg

__all__ = [
    "get_config_file",
    "get_config",
    "get",
    "mask_rcnn_R_50_FPN_3x_config",
    "mask_rcnn_vitdet_b_hyperparameters",
    "build_mask_rcnn_vitdet",
    "mask_rcnn_vitdet_b",
]


def get_config_file(config_path: str) -> str:
    """The path of a zoo config, ``config_path`` relative to ``configs/``
    (e.g. ``"COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"``)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_file = os.path.join(root, "configs", config_path)
    if not os.path.exists(cfg_file):
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return cfg_file


def get_config(config_path: str, trained: bool = False) -> CfgNode:
    """The ``CfgNode`` of a yaml zoo config (its ``_BASE_`` merged), as the
    file says: ``MODEL.WEIGHTS`` stays the file's ImageNet-init path. The
    trained zoo weights are a download, so ``trained=True`` raises; LazyConfig
    ``.py`` configs wait for ROADMAP A8."""
    cfg_file = get_config_file(config_path)
    if not cfg_file.endswith(".yaml"):
        raise NotImplementedError(f"{config_path}: LazyConfig .py configs are not ported yet (ROADMAP A8)")
    if trained:
        raise NotImplementedError(
            f"{config_path}: trained=True needs the zoo checkpoint, a download; set MODEL.WEIGHTS to a local d2 .pkl"
        )
    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    return cfg


def get(config_path: str, trained: bool = False, device: Optional[Union[str, torch.device]] = None):
    """The model of a yaml zoo config, as ``nn.Module`` on ``device`` (default
    the config's ``MODEL.DEVICE``, ``"cuda"``), in eval mode, with torch's
    default init (``modeling.init_weights`` or a loaded checkpoint replace
    it). ``trained=True`` raises, as in :func:`get_config`."""
    from detectron2_tpu_torch.modeling import build_model

    return build_model(get_config(config_path, trained), device=device)


def mask_rcnn_R_50_FPN_3x_config() -> CfgNode:
    """``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml`` over
    ``configs/Base-RCNN-FPN.yaml``, on every key the port reads.
    ``MODEL.WEIGHTS`` stays empty: the zoo checkpoint is a download."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.MASK_ON = True
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TRAIN = 2000
    m.RPN.PRE_NMS_TOPK_TEST = 1000
    m.RPN.POST_NMS_TOPK_TRAIN = 1000
    m.RPN.POST_NMS_TOPK_TEST = 1000
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    m.ROI_MASK_HEAD.NUM_CONV = 4
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    cfg.DATASETS.TRAIN = ("coco_2017_train",)
    cfg.DATASETS.TEST = ("coco_2017_val",)
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.STEPS = (210000, 250000)
    cfg.SOLVER.MAX_ITER = 270000
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    return cfg


# configs/common/models/mask_rcnn_vitdet.py over configs/common/models/mask_rcnn_fpn.py,
# key by key (the ``model`` node of configs/ViTDet/mask_rcnn_vitdet_b_100ep.py)
_MASK_RCNN_VITDET_B = {
    "backbone": {
        "net": {
            "img_size": 1024,
            "patch_size": 16,
            "embed_dim": 768,
            "depth": 12,
            "num_heads": 12,
            "mlp_ratio": 4.0,
            "qkv_bias": True,
            "use_abs_pos": True,
            "use_rel_pos": True,
            "drop_path_rate": 0.1,
            "window_size": 14,
            # global attention every 3rd block
            "window_block_indexes": (0, 1, 3, 4, 6, 7, 9, 10),
            "out_feature": "last_feat",
        },
        "in_feature": "last_feat",
        "out_channels": 256,
        "scale_factors": (4.0, 2.0, 1.0, 0.5),
        "top_block_levels": 1,
        "norm": "LN",
    },
    "proposal_generator": {
        "in_features": ("p2", "p3", "p4", "p5", "p6"),
        "head": {"num_anchors": 3, "in_channels": 256, "conv_dims": (-1, -1)},
        "anchor_generator": {
            "sizes": [[32], [64], [128], [256], [512]],
            "aspect_ratios": [0.5, 1.0, 2.0],
            "strides": [4, 8, 16, 32, 64],
            "offset": 0.0,
        },
        "anchor_matcher_cfg": ((0.3, 0.7), (0, -1, 1), True),
        "box2box_weights": (1.0, 1.0, 1.0, 1.0),
        "batch_size_per_image": 256,
        "positive_fraction": 0.5,
        "pre_nms_topk_train": 2000,
        "pre_nms_topk_test": 1000,
        "post_nms_topk_train": 1000,
        "post_nms_topk_test": 1000,
        "nms_thresh": 0.7,
    },
    "roi_heads": {
        "num_classes": 80,
        "batch_size_per_image": 512,
        "positive_fraction": 0.25,
        "matcher_thresholds": (0.5,),
        "matcher_labels": (0, 1),
        "in_features": ("p2", "p3", "p4", "p5"),
        "pooler_scales": (1.0 / 4, 1.0 / 8, 1.0 / 16, 1.0 / 32),
        "box_pooler_resolution": 7,
        "pooler_sampling_ratio": 0,
        "pooler_type": "ROIAlignV2",
        "box_head": {"conv_dims": (256, 256, 256, 256), "fc_dims": (1024,), "conv_norm": "LN"},
        "box_predictor": {
            "num_classes": 80,
            "box2box_weights": (10.0, 10.0, 5.0, 5.0),
            "test_score_thresh": 0.05,
        },
        "mask_pooler_resolution": 14,
        # the last entry is the deconv's width, the others the 3x3 convs
        "mask_head": {"num_classes": 80, "conv_dims": (256, 256, 256, 256, 256), "conv_norm": "LN"},
    },
    "pixel_mean": (123.675, 116.28, 103.53),
    "pixel_std": (58.395, 57.12, 57.375),
    "input_format": "RGB",
}


def mask_rcnn_vitdet_b_hyperparameters() -> dict:
    """The ``model`` node of ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py`` as a
    nested dict with the lazy config's own keys (a fresh copy: edit it and
    hand it to :func:`build_mask_rcnn_vitdet` for another size)."""
    return copy.deepcopy(_MASK_RCNN_VITDET_B)


def build_mask_rcnn_vitdet(
    hp: dict,
    device: Optional[Union[str, torch.device]] = None,
    compute_dtype: str = "bfloat16",
    mask_paste_in_graph: bool = False,
):
    """Mask R-CNN with a ViT + SimpleFeaturePyramid backbone from a
    hyperparameter dict laid out as :func:`mask_rcnn_vitdet_b_hyperparameters`,
    on ``device`` (default ``"cuda"``), in eval mode."""
    from detectron2_tpu_torch.modeling import GeneralizedRCNN
    from detectron2_tpu_torch.modeling.anchor_generator import DefaultAnchorGenerator
    from detectron2_tpu_torch.modeling.backbone import SimpleFeaturePyramid, ViT
    from detectron2_tpu_torch.modeling.matcher import Matcher
    from detectron2_tpu_torch.modeling.poolers import ROIPooler
    from detectron2_tpu_torch.modeling.proposal_generator import RPN, StandardRPNHead
    from detectron2_tpu_torch.modeling.roi_heads import (
        FastRCNNConvFCHead,
        FastRCNNOutputLayers,
        MaskRCNNConvUpsampleHead,
        StandardROIHeads,
    )

    bb = hp["backbone"]
    backbone = SimpleFeaturePyramid(net=ViT(**bb["net"]), **{k: v for k, v in bb.items() if k != "net"})
    channels = bb["out_channels"]

    pg = dict(hp["proposal_generator"])
    head = pg.pop("head")
    anchors = pg.pop("anchor_generator")
    thresholds, labels, low_quality = pg.pop("anchor_matcher_cfg")
    proposal_generator = RPN(
        head=StandardRPNHead(head["in_channels"], head["num_anchors"], conv_dims=tuple(head["conv_dims"])),
        anchor_generator=DefaultAnchorGenerator(**anchors),
        anchor_matcher=Matcher(list(thresholds), list(labels), allow_low_quality_matches=low_quality),
        **pg,
    )

    rh = hp["roi_heads"]
    bh, mh = rh["box_head"], rh["mask_head"]
    pool = lambda res: ROIPooler(res, rh["pooler_scales"], rh["pooler_sampling_ratio"], rh["pooler_type"])  # noqa: E731
    box_head = FastRCNNConvFCHead(
        channels, rh["box_pooler_resolution"], bh["fc_dims"], bh["conv_dims"], bh["conv_norm"]
    )
    mask_convs = tuple(mh["conv_dims"][:-1])
    if len(set(mh["conv_dims"])) != 1:
        raise NotImplementedError("the mask head takes one width for its convs and its deconv")
    roi_heads = StandardROIHeads(
        in_features=rh["in_features"],
        box_pooler=pool(rh["box_pooler_resolution"]),
        box_head=box_head,
        box_predictor=FastRCNNOutputLayers(box_head.output_dim, **rh["box_predictor"]),
        proposal_matcher=Matcher(
            list(rh["matcher_thresholds"]), list(rh["matcher_labels"]), allow_low_quality_matches=False
        ),
        mask_pooler=pool(rh["mask_pooler_resolution"]),
        mask_head=MaskRCNNConvUpsampleHead(
            channels, mh["num_classes"], mh["conv_dims"][-1], len(mask_convs), mh["conv_norm"]
        ),
        num_classes=rh["num_classes"],
        batch_size_per_image=rh["batch_size_per_image"],
        positive_fraction=rh["positive_fraction"],
    )
    model = GeneralizedRCNN(
        backbone=backbone,
        proposal_generator=proposal_generator,
        roi_heads=roi_heads,
        pixel_mean=hp["pixel_mean"],
        pixel_std=hp["pixel_std"],
        input_format=hp["input_format"],
        compute_dtype=compute_dtype,
        mask_paste_in_graph=mask_paste_in_graph,
    )
    return model.to(torch.device(device or "cuda")).eval()


def mask_rcnn_vitdet_b(device: Optional[Union[str, torch.device]] = None, **model_kwargs):
    """Mask R-CNN ViTDet-B (``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py``): 12
    blocks of width 768, 14x14 windows with 4 global blocks, on 1024x1024
    inputs. Weights are torch's defaults until a checkpoint is loaded or
    ``modeling.init_weights`` runs."""
    return build_mask_rcnn_vitdet(mask_rcnn_vitdet_b_hyperparameters(), device, **model_kwargs)
