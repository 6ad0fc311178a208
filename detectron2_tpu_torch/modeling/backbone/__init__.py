from detectron2_tpu_torch.modeling.backbone.fpn import (
    FPN,
    LastLevelMaxPool,
    LastLevelP6P7,
    build_resnet_fpn_backbone,
    build_retinanet_resnet_fpn_backbone,
)
from detectron2_tpu_torch.modeling.backbone.mvit import MViT
from detectron2_tpu_torch.modeling.backbone.regnet import RegNet
from detectron2_tpu_torch.modeling.backbone.resnet import (
    BasicBlock,
    BasicStem,
    BottleneckBlock,
    ResNet,
    build_resnet_backbone,
)
from detectron2_tpu_torch.modeling.backbone.swin import SwinTransformer
from detectron2_tpu_torch.modeling.backbone.vit import SimpleFeaturePyramid, ViT, get_vit_lr_decay_rate

__all__ = [
    "FPN",
    "LastLevelMaxPool",
    "LastLevelP6P7",
    "build_resnet_fpn_backbone",
    "build_retinanet_resnet_fpn_backbone",
    "BasicBlock",
    "BasicStem",
    "BottleneckBlock",
    "ResNet",
    "build_resnet_backbone",
    "MViT",
    "RegNet",
    "SwinTransformer",
    "SimpleFeaturePyramid",
    "ViT",
    "get_vit_lr_decay_rate",
    "build_backbone",
    "padding_constraints",
]


def padding_constraints(backbone) -> dict:
    """How a batch for ``backbone`` must be padded: ``size_divisibility`` and,
    for backbones that need fixed square inputs (ViT), ``square_size``. A
    backbone that declares nothing gets the FPN default, multiples of 32
    (what MViT, Swin and RegNet declare, under an FPN or alone)."""
    return dict(getattr(backbone, "padding_constraints", None) or {"size_divisibility": 32})


def build_backbone(cfg):
    """The backbone named by ``cfg.MODEL.BACKBONE.NAME``."""
    builders = {
        "build_resnet_backbone": build_resnet_backbone,
        "build_resnet_fpn_backbone": build_resnet_fpn_backbone,
        "build_retinanet_resnet_fpn_backbone": build_retinanet_resnet_fpn_backbone,
    }
    name = cfg.MODEL.BACKBONE.NAME
    if name in ("build_pose_hrnet_backbone", "build_hrfpn_backbone"):
        # DensePose's HRNet trunk and HRFPN (the project imports the modeling package)
        from detectron2_tpu_torch.projects.densepose import hrfpn, hrnet

        builders.update(build_pose_hrnet_backbone=hrnet.build_pose_hrnet_backbone, build_hrfpn_backbone=hrfpn.build_hrfpn_backbone)
    if name not in builders:
        raise NotImplementedError(f"backbone {name!r} is not ported yet (ROADMAP A10)")
    return builders[name](cfg, len(cfg.MODEL.PIXEL_MEAN))
