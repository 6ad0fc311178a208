"""How the names a config file imports from ``detectron2_tpu`` (the JAX
package) resolve in the port: one explicit table.

Each entry maps a JAX import path (``detectron2_tpu.modeling.backbone.vit.ViT``)
to the JAX package's dotted ``_target_`` name for that object (the shortest
module prefix that locates it, as ``detectron2_tpu.utils.registry.
_convert_target_to_string`` computes it: ``detectron2_tpu.modeling.backbone.ViT``)
and to the port's object:

- a port class or function that takes the JAX object's arguments (the model
  constructors of :mod:`detectron2_tpu_torch.modeling.lazy_modules` where
  flax inferred widths a torch module needs);
- or, for what the port has not ported, an :class:`Unported` stand-in that
  loads and raises ``NotImplementedError`` naming the ROADMAP item when it
  is called (at ``instantiate``).

A name missing from the table raises ``ImportError`` naming it, as do
``jax``, ``optax`` and ``flax``: nothing is stubbed silently. Functions
defined in a config file are matched by name and parameter names in
:data:`CONFIG_CALLABLES` (the ViTDet ``make_optimizer``, whose body imports
jax and optax, runs the port's layer-wise AdamW instead).
"""

import importlib
import inspect
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "Unported",
    "TABLE",
    "CONFIG_CALLABLES",
    "resolve",
    "target_name",
    "import_module",
    "is_resolved_root",
    "config_callable_counterpart",
]


class Unported:
    """A stand-in for a JAX-package name the port has not ported: a config
    that imports it loads; calling it, or reading an attribute of it,
    raises ``NotImplementedError`` naming the ROADMAP item."""

    def __init__(self, name: str, roadmap: str):
        self.name = name
        self.roadmap = roadmap

    def _refuse(self):
        raise NotImplementedError(f"{self.name} is not ported yet ({self.roadmap})")

    def __call__(self, *args, **kwargs):
        self._refuse()

    def __getattr__(self, attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        self._refuse()

    def __repr__(self) -> str:
        return f"Unported({self.name!r}, {self.roadmap!r})"


# JAX import path -> (JAX dotted _target_ name, port object as "module:attr" or a stand-in)
TABLE: Dict[str, Tuple[str, Any]] = {
    # config
    "detectron2_tpu.config.LazyCall": ("detectron2_tpu.config.LazyCall", "detectron2_tpu_torch.config.lazy:LazyCall"),
    "detectron2_tpu.config.DictConfig": ("detectron2_tpu.config.DictConfig", "detectron2_tpu_torch.config.lazy:DictConfig"),
    "detectron2_tpu.config.get_cfg": ("detectron2_tpu.config.get_cfg", "detectron2_tpu_torch.config.defaults:get_cfg"),
    # data
    "detectron2_tpu.data.DatasetMapper": ("detectron2_tpu.data.DatasetMapper", "detectron2_tpu_torch.data.dataset_mapper:DatasetMapper"),
    "detectron2_tpu.data.build_detection_train_loader": (
        "detectron2_tpu.data.build_detection_train_loader", "detectron2_tpu_torch.data.build:build_detection_train_loader"),
    "detectron2_tpu.data.build_detection_test_loader": (
        "detectron2_tpu.data.build_detection_test_loader", "detectron2_tpu_torch.data.build:build_detection_test_loader"),
    "detectron2_tpu.data.get_detection_dataset_dicts": (
        "detectron2_tpu.data.get_detection_dataset_dicts", "detectron2_tpu_torch.data.build:get_detection_dataset_dicts"),
    "detectron2_tpu.data.detection_utils.create_keypoint_hflip_indices": (
        "detectron2_tpu.data.detection_utils.create_keypoint_hflip_indices",
        "detectron2_tpu_torch.data.detection_utils:create_keypoint_hflip_indices"),
    "detectron2_tpu.data.detection_utils.get_fed_loss_cls_weights": (
        "detectron2_tpu.data.detection_utils.get_fed_loss_cls_weights",
        "detectron2_tpu_torch.data.detection_utils:get_fed_loss_cls_weights"),
    "detectron2_tpu.data.samplers.RepeatFactorTrainingSampler": (
        "detectron2_tpu.data.samplers.RepeatFactorTrainingSampler",
        "detectron2_tpu_torch.data.samplers:RepeatFactorTrainingSampler"),
    "detectron2_tpu.data.samplers.RepeatFactorTrainingSampler.repeat_factors_from_category_frequency": (
        "detectron2_tpu.data.samplers.RepeatFactorTrainingSampler.repeat_factors_from_category_frequency",
        "detectron2_tpu_torch.data.samplers:RepeatFactorTrainingSampler.repeat_factors_from_category_frequency"),
    "detectron2_tpu.data.transforms.AugmentationList": (
        "detectron2_tpu.data.transforms.AugmentationList", "detectron2_tpu_torch.data.transforms:AugmentationList"),
    "detectron2_tpu.data.transforms.FixedSizeCrop": (
        "detectron2_tpu.data.transforms.FixedSizeCrop", "detectron2_tpu_torch.data.transforms:FixedSizeCrop"),
    "detectron2_tpu.data.transforms.RandomApply": (
        "detectron2_tpu.data.transforms.RandomApply", "detectron2_tpu_torch.data.transforms:RandomApply"),
    "detectron2_tpu.data.transforms.RandomCrop": (
        "detectron2_tpu.data.transforms.RandomCrop", "detectron2_tpu_torch.data.transforms:RandomCrop"),
    "detectron2_tpu.data.transforms.RandomFlip": (
        "detectron2_tpu.data.transforms.RandomFlip", "detectron2_tpu_torch.data.transforms:RandomFlip"),
    "detectron2_tpu.data.transforms.ResizeScale": (
        "detectron2_tpu.data.transforms.ResizeScale", "detectron2_tpu_torch.data.transforms:ResizeScale"),
    "detectron2_tpu.data.transforms.ResizeShortestEdge": (
        "detectron2_tpu.data.transforms.ResizeShortestEdge", "detectron2_tpu_torch.data.transforms:ResizeShortestEdge"),
    # evaluation
    "detectron2_tpu.evaluation.COCOEvaluator": (
        "detectron2_tpu.evaluation.COCOEvaluator", "detectron2_tpu_torch.evaluation:COCOEvaluator"),
    "detectron2_tpu.evaluation.DatasetEvaluators": (
        "detectron2_tpu.evaluation.DatasetEvaluators", "detectron2_tpu_torch.evaluation:DatasetEvaluators"),
    "detectron2_tpu.evaluation.LVISEvaluator": ("detectron2_tpu.evaluation.LVISEvaluator", "detectron2_tpu_torch.evaluation:LVISEvaluator"),
    "detectron2_tpu.evaluation.PascalVOCDetectionEvaluator": (
        "detectron2_tpu.evaluation.PascalVOCDetectionEvaluator", "detectron2_tpu_torch.evaluation:PascalVOCDetectionEvaluator"),
    "detectron2_tpu.evaluation.COCOPanopticEvaluator": (
        "detectron2_tpu.evaluation.COCOPanopticEvaluator", "detectron2_tpu_torch.evaluation:COCOPanopticEvaluator"),
    "detectron2_tpu.evaluation.SemSegEvaluator": ("detectron2_tpu.evaluation.SemSegEvaluator", "detectron2_tpu_torch.evaluation:SemSegEvaluator"),
    # layers: the norms with batch statistics take the JAX modules' arguments
    # (``features``, ``eps``, ``momentum``); get_norm returns the module
    "detectron2_tpu.layers.BatchNorm": ("detectron2_tpu.layers.BatchNorm", "detectron2_tpu_torch.layers.batch_norm:BatchNorm2d"),
    "detectron2_tpu.layers.SyncBatchNorm": (
        "detectron2_tpu.layers.SyncBatchNorm", "detectron2_tpu_torch.layers.batch_norm:SyncBatchNorm"),
    "detectron2_tpu.layers.NaiveSyncBatchNorm": (
        "detectron2_tpu.layers.SyncBatchNorm", "detectron2_tpu_torch.layers.batch_norm:NaiveSyncBatchNorm"),
    "detectron2_tpu.layers.get_norm": ("detectron2_tpu.layers.get_norm", "detectron2_tpu_torch.layers.batch_norm:get_norm"),
    "detectron2_tpu.layers.batch_norm.SyncBatchNorm": (
        "detectron2_tpu.layers.SyncBatchNorm", "detectron2_tpu_torch.layers.batch_norm:SyncBatchNorm"),
    # modeling: the R-CNN and ViTDet families, the FPN's top blocks
    "detectron2_tpu.modeling.GeneralizedRCNN": (
        "detectron2_tpu.modeling.GeneralizedRCNN", "detectron2_tpu_torch.modeling.lazy_modules:generalized_rcnn"),
    "detectron2_tpu.modeling.StandardROIHeads": (
        "detectron2_tpu.modeling.StandardROIHeads", "detectron2_tpu_torch.modeling.lazy_modules:standard_roi_heads"),
    "detectron2_tpu.modeling.anchor_generator.DefaultAnchorGenerator": (
        "detectron2_tpu.modeling.DefaultAnchorGenerator", "detectron2_tpu_torch.modeling.anchor_generator:DefaultAnchorGenerator"),
    "detectron2_tpu.modeling.backbone.FPN": ("detectron2_tpu.modeling.FPN", "detectron2_tpu_torch.modeling.backbone.fpn:FPN"),
    "detectron2_tpu.modeling.backbone.LastLevelMaxPool": (
        "detectron2_tpu.modeling.backbone.LastLevelMaxPool", "detectron2_tpu_torch.modeling.backbone.fpn:LastLevelMaxPool"),
    "detectron2_tpu.modeling.backbone.fpn.LastLevelP6P7": (
        "detectron2_tpu.modeling.backbone.LastLevelP6P7", "detectron2_tpu_torch.modeling.lazy_modules:last_level_p6p7"),
    "detectron2_tpu.modeling.backbone.resnet.ResNet": ("detectron2_tpu.modeling.ResNet", "detectron2_tpu_torch.modeling.lazy_modules:resnet"),
    "detectron2_tpu.modeling.backbone.resnet.BottleneckBlock": (
        "detectron2_tpu.modeling.backbone.BottleneckBlock", "detectron2_tpu_torch.modeling.backbone.resnet:BottleneckBlock"),
    "detectron2_tpu.modeling.backbone.resnet.BasicBlock": (
        "detectron2_tpu.modeling.backbone.BasicBlock", "detectron2_tpu_torch.modeling.backbone.resnet:BasicBlock"),
    "detectron2_tpu.modeling.backbone.resnet.make_stage_specs": (
        "detectron2_tpu.modeling.backbone.resnet.make_stage_specs", "detectron2_tpu_torch.modeling.backbone.resnet:make_stage_specs"),
    "detectron2_tpu.modeling.backbone.resnet.build_resnet_backbone": (
        "detectron2_tpu.modeling.build_resnet_backbone", "detectron2_tpu_torch.modeling.backbone.resnet:build_resnet_backbone"),
    "detectron2_tpu.modeling.backbone.mvit.MViT": ("detectron2_tpu.modeling.backbone.MViT", "detectron2_tpu_torch.modeling.backbone.mvit:MViT"),
    "detectron2_tpu.modeling.backbone.regnet.RegNet": (
        "detectron2_tpu.modeling.backbone.RegNet", "detectron2_tpu_torch.modeling.backbone.regnet:RegNet"),
    "detectron2_tpu.modeling.backbone.swin.SwinTransformer": (
        "detectron2_tpu.modeling.backbone.SwinTransformer", "detectron2_tpu_torch.modeling.backbone.swin:SwinTransformer"),
    "detectron2_tpu.modeling.backbone.vit.ViT": ("detectron2_tpu.modeling.backbone.ViT", "detectron2_tpu_torch.modeling.backbone.vit:ViT"),
    "detectron2_tpu.modeling.backbone.vit.SimpleFeaturePyramid": (
        "detectron2_tpu.modeling.backbone.SimpleFeaturePyramid", "detectron2_tpu_torch.modeling.backbone.vit:SimpleFeaturePyramid"),
    "detectron2_tpu.modeling.backbone.vit.get_vit_lr_decay_rate": (
        "detectron2_tpu.modeling.backbone.get_vit_lr_decay_rate", "detectron2_tpu_torch.modeling.backbone.vit:get_vit_lr_decay_rate"),
    "detectron2_tpu.modeling.proposal_generator.RPN": ("detectron2_tpu.modeling.RPN", "detectron2_tpu_torch.modeling.lazy_modules:rpn"),
    "detectron2_tpu.modeling.proposal_generator.StandardRPNHead": (
        "detectron2_tpu.modeling.proposal_generator.StandardRPNHead", "detectron2_tpu_torch.modeling.lazy_modules:standard_rpn_head"),
    "detectron2_tpu.modeling.roi_heads.CascadeROIHeads": (
        "detectron2_tpu.modeling.roi_heads.CascadeROIHeads", "detectron2_tpu_torch.modeling.lazy_modules:cascade_roi_heads"),
    "detectron2_tpu.modeling.roi_heads.FastRCNNConvFCHead": (
        "detectron2_tpu.modeling.roi_heads.FastRCNNConvFCHead", "detectron2_tpu_torch.modeling.lazy_modules:fast_rcnn_conv_fc_head"),
    "detectron2_tpu.modeling.roi_heads.FastRCNNOutputLayers": (
        "detectron2_tpu.modeling.FastRCNNOutputLayers", "detectron2_tpu_torch.modeling.lazy_modules:fast_rcnn_output_layers"),
    "detectron2_tpu.modeling.roi_heads.MaskRCNNConvUpsampleHead": (
        "detectron2_tpu.modeling.roi_heads.MaskRCNNConvUpsampleHead",
        "detectron2_tpu_torch.modeling.lazy_modules:mask_rcnn_conv_upsample_head"),
    "detectron2_tpu.modeling.roi_heads.KRCNNConvDeconvUpsampleHead": (
        "detectron2_tpu.modeling.roi_heads.KRCNNConvDeconvUpsampleHead",
        "detectron2_tpu_torch.modeling.lazy_modules:krcnn_conv_deconv_upsample_head"),
    # modeling: the one-stage detectors
    "detectron2_tpu.modeling.meta_arch.retinanet.RetinaNet": (
        "detectron2_tpu.modeling.meta_arch.RetinaNet", "detectron2_tpu_torch.modeling.lazy_modules:retinanet"),
    "detectron2_tpu.modeling.meta_arch.fcos.FCOS": (
        "detectron2_tpu.modeling.meta_arch.FCOS", "detectron2_tpu_torch.modeling.lazy_modules:fcos"),
    "detectron2_tpu.modeling.meta_arch.fcos.FCOSHead": (
        "detectron2_tpu.modeling.meta_arch.FCOSHead", "detectron2_tpu_torch.modeling.lazy_modules:fcos_head"),
    # modeling: panoptic segmentation (``PanopticFPN.from_config``, which ``build_panoptic_fpn`` in the config calls)
    "detectron2_tpu.modeling.meta_arch.panoptic_fpn.PanopticFPN": (
        "detectron2_tpu.modeling.meta_arch.PanopticFPN", "detectron2_tpu_torch.modeling.meta_arch.panoptic_fpn:PanopticFPN"),
    "detectron2_tpu.modeling.backbone.resnet.DeformBottleneckBlock": (
        "detectron2_tpu.modeling.backbone.DeformBottleneckBlock",
        "detectron2_tpu_torch.modeling.backbone.resnet:DeformBottleneckBlock"),
    # solver
    "detectron2_tpu.solver.build.adamw_with_param_groups": (
        "detectron2_tpu.solver.build.adamw_with_param_groups", "detectron2_tpu_torch.solver.build:adamw_with_param_groups"),
    "detectron2_tpu.solver.build.sgd_with_param_groups": (
        "detectron2_tpu.solver.sgd_with_param_groups", "detectron2_tpu_torch.solver.build:sgd_with_param_groups"),
    "detectron2_tpu.solver.lr_scheduler.LRMultiplier": (
        "detectron2_tpu.solver.LRMultiplier", "detectron2_tpu_torch.solver.lr_scheduler:LazyLRMultiplier"),
    "detectron2_tpu.solver.lr_scheduler.MultiStepParamScheduler": (
        "detectron2_tpu.solver.MultiStepParamScheduler", "detectron2_tpu_torch.solver.lr_scheduler:MultiStepParamScheduler"),
    "detectron2_tpu.solver.lr_scheduler.WarmupParamScheduler": (
        "detectron2_tpu.solver.WarmupParamScheduler", "detectron2_tpu_torch.solver.lr_scheduler:WarmupParamScheduler"),
}

# functions defined in config files, by (name, parameter names) -> the port's counterpart
CONFIG_CALLABLES: Dict[Tuple[str, Tuple[str, ...]], str] = {
    # configs/ViTDet/mask_rcnn_vitdet_b_100ep.py:39, whose body builds an optax chain
    ("make_optimizer", ("params", "base_lr", "weight_decay", "lr_decay_rate", "num_layers")): (
        "detectron2_tpu_torch.solver.build:vit_layerwise_adamw"
    ),
}

_REFUSED_ROOTS = ("jax", "optax", "flax")
_resolved: Dict[str, Any] = {}
_names: Optional[Dict[int, Tuple[Any, str]]] = None
_by_target: Optional[Dict[str, str]] = None


def _load(spec) -> Any:
    if not isinstance(spec, str):
        return spec
    if spec not in _resolved:
        module, attr = spec.split(":")
        obj = importlib.import_module(module)
        for part in attr.split("."):
            obj = getattr(obj, part)
        _resolved[spec] = obj
    return _resolved[spec]


def _target_index() -> Dict[str, str]:
    global _by_target
    if _by_target is None:
        _by_target = {}
        for path, (target, _) in TABLE.items():
            _by_target[path] = path
            _by_target.setdefault(target, path)
    return _by_target


def resolve(name: str) -> Any:
    """The port's object for a JAX import path or dotted ``_target_`` name."""
    path = _target_index().get(name)
    if path is None:
        raise ImportError(
            f"{name} is not in the port's table of config names (detectron2_tpu_torch/config/lazy_targets.py)"
        )
    return _load(TABLE[path][1])


def target_name(obj: Any) -> Optional[str]:
    """The JAX dotted ``_target_`` name of a port object from the table, or
    None for anything else (a function defined in a config file)."""
    global _names
    if _names is None:
        _names = {}
        for target, spec in TABLE.values():
            o = _load(spec)
            _names[id(o)] = (o, target)
    hit = _names.get(id(obj))
    return hit[1] if hit is not None and hit[0] is obj else None


def is_resolved_root(name: str) -> bool:
    """Whether an absolute import from a config file goes through the table
    (``detectron2_tpu``) or is refused (``jax``, ``optax``, ``flax``)."""
    root = name.split(".")[0]
    return root == "detectron2_tpu" or root in _REFUSED_ROOTS


class _TableModule:
    """A module-like view of the table under a dotted prefix."""

    def __init__(self, prefix: str):
        self.__name__ = prefix

    def __getattr__(self, attr: str):
        if attr.startswith("__"):
            raise AttributeError(attr)
        path = f"{self.__name__}.{attr}"
        if path in TABLE:
            return _load(TABLE[path][1])
        if any(k.startswith(path + ".") for k in TABLE):
            return _TableModule(path)
        raise ImportError(
            f"{path} is not in the port's table of config names (detectron2_tpu_torch/config/lazy_targets.py)"
        )


def import_module(name: str, fromlist) -> Any:
    """``__import__`` of ``name`` from a config file."""
    root = name.split(".")[0]
    if root in _REFUSED_ROOTS:
        raise ImportError(f"the config imports {name}: the port does not use {root}")
    if not any(k == name or k.startswith(name + ".") for k in TABLE):
        raise ImportError(
            f"{name} is not in the port's table of config names (detectron2_tpu_torch/config/lazy_targets.py)"
        )
    return _TableModule(name if fromlist else root)


def config_callable_counterpart(fn) -> Optional[Any]:
    """The port's counterpart of a function defined in a config file, by its
    name and parameter names, or None."""
    params = tuple(inspect.signature(fn).parameters)
    spec = CONFIG_CALLABLES.get((fn.__name__, params))
    return None if spec is None else _load(spec)
