"""The port's LazyConfig, instantiate and table of config names against the
JAX package, on the CPU.

- The JAX package's own ``tests/config/test_lazy_config.py`` cases, run on
  the port's ``LazyCall`` / ``LazyConfig`` / ``instantiate``.
- Each of the 56 ``.py`` configs under ``configs/`` (not ``common/``),
  loaded by the port in a process where ``jax``, ``flax``, ``optax`` and
  ``detectron2_tpu`` cannot be imported: either its tree equals
  ``detectron2_tpu.config.LazyConfig.load``'s (``_target_`` names, classes
  and functions compared by their dotted names, functions defined in a
  config by name), or it raises the error that ROADMAP lists for it
  (``_UNLOADABLE``). The ViTDet configs and the ported R-CNN families load.
- Every entry of the table carries the JAX package's dotted name of its
  object and resolves to a port object; a name missing from the table, and
  ``jax`` itself, raise ``ImportError`` naming it.
- ``instantiate`` of the ViTDet-B model equals ``model_zoo.mask_rcnn_vitdet_b()``
  in parameter names and shapes, and its names are the JAX model's through
  ``jax_params``' name map; the R50-FPN model node equals the yacs-built
  model; a config-defined builder that uses only table names runs as it is;
  a config function that imports optax and has no counterpart raises naming
  itself.
- The hierarchical backbones' configs (MViTv2, Swin, RegNet) instantiate
  with the JAX model's parameter names and shapes, and the smallest of each
  family carries the zoo's stages, widths, norms and DropPath rates.
- The dense detectors' configs (RetinaNet, FCOS through ``FCOS.clone``,
  the SyncBN-head RetinaNet) instantiate, RetinaNet's and FCOS's with the
  JAX model's parameter names and sizes (``meters`` included) through
  ``jax_params``' name map; the RetinaNet and RPN-only zoo yamls build.
- A config saved by either package loads and instantiates in the other.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap
from collections import abc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_tpu.config import LazyConfig as JaxLazyConfig
from detectron2_tpu.config import instantiate as jax_instantiate
from detectron2_tpu.utils.registry import _convert_target_to_string, locate
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.checkpoint.jax_params import flax_path_to_d2_name
from detectron2_tpu_torch.config import LazyCall as L
from detectron2_tpu_torch.config import LazyConfig, get_cfg, instantiate, lazy_targets
from detectron2_tpu_torch.config.lazy import DictConfig
from detectron2_tpu_torch.testing import config_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(f, os.path.join(ROOT, "configs"))
    for f in glob.glob(os.path.join(ROOT, "configs", "**", "*.py"), recursive=True)
    if "/common/" not in f
)
# the configs whose load needs what the port does not use (ROADMAP A8 lists them)
_UNLOADABLE = {
    "Rethinking-BatchNorm/mask_rcnn_BNhead_batch_stats.py": ("ImportError", "the config imports jax: the port does not use jax"),
    "Rethinking-BatchNorm/mask_rcnn_BNhead_shuffle.py": ("ImportError", "the config imports jax: the port does not use jax"),
    "Rethinking-BatchNorm/retinanet_SyncBNhead_SharedTraining.py": (
        "ImportError", "the config imports jax.numpy: the port does not use jax"),
}
# the norms with batch statistics (ROADMAP A4): these build a model too
_A4_CONFIGS = [
    f"new_baselines/mask_rcnn_R_{depth}_FPN_{ep}ep_LSJ.py"
    for depth, eps in ((50, (50, 100, 200, 400)), (101, (100, 200, 400)))
    for ep in eps
] + ["Rethinking-BatchNorm/mask_rcnn_BNhead.py", "Rethinking-BatchNorm/mask_rcnn_SyncBNhead.py"]
# the one-stage detectors (ROADMAP A7's first part)
_DENSE_CONFIGS = [
    "COCO-Detection/retinanet_R_50_FPN_1x.py",
    "COCO-Detection/fcos_R_50_FPN_1x.py",
    "Rethinking-BatchNorm/retinanet_SyncBNhead.py",
]
_MUST_LOAD = [c for c in CONFIGS if c.startswith("ViTDet/")] + [
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.py",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.py",
    "COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.py",
] + _A4_CONFIGS + _DENSE_CONFIGS
_CFG_MODULE = "detectron2_tpu._cfg_loader"


class ShapeSpecLike:
    def __init__(self, channels=0, stride=1):
        self.channels = channels
        self.stride = stride


# -- the JAX package's tests/config/test_lazy_config.py, on the port


def test_lazycall_basic():
    cfg = L(dict)(a=1, b=2)
    assert cfg["_target_"].endswith("dict")
    assert instantiate(cfg) == {"a": 1, "b": 2}


def test_lazycall_modify_then_instantiate():
    cfg = L(ShapeSpecLike)(channels=32)
    cfg.channels = 64
    obj = instantiate(cfg)
    assert obj.channels == 64 and obj.stride == 1


def test_instantiate_recursive():
    cfg = L(dict)(inner=L(ShapeSpecLike)(channels=8), items=[L(ShapeSpecLike)(channels=1)])
    obj = instantiate(cfg)
    assert obj["inner"].channels == 8 and obj["items"][0].channels == 1


def test_load_py_file(tmp_path):
    f = tmp_path / "cfg.py"
    f.write_text(
        "from detectron2_tpu.config import LazyCall as L\n"
        "model = L(dict)(x=1)\n"
        "train = dict(max_iter=100)\n"
        "_private = dict(hidden=1)\n"
        "some_int = 3\n"
    )
    cfg = LazyConfig.load(str(f))
    assert cfg.model["_target_"].endswith("dict")
    assert cfg.train.max_iter == 100
    assert "_private" not in cfg and "some_int" not in cfg


def test_relative_import(tmp_path):
    (tmp_path / "base_cfg.py").write_text("base_model = dict(depth=50)\n")
    child = tmp_path / "child_cfg.py"
    child.write_text("from .base_cfg import base_model\nmodel = base_model\nmodel['depth'] = 101\n")
    assert LazyConfig.load(str(child)).model.depth == 101
    assert LazyConfig.load(str(tmp_path / "base_cfg.py")).base_model.depth == 50


def test_apply_overrides():
    cfg = DictConfig({"model": {"depth": 50, "name": "resnet"}, "train": {"lr": 0.1}})
    LazyConfig.apply_overrides(cfg, ["model.depth=101", "train.lr=0.02", "model.name=x50"])
    assert (cfg.model.depth, cfg.train.lr, cfg.model.name) == (101, 0.02, "x50")


def test_save_yaml(tmp_path):
    out = tmp_path / "out.yaml"
    LazyConfig.save(DictConfig({"train": {"max_iter": 100}}), str(out))
    assert LazyConfig.load(str(out)).train.max_iter == 100


def test_to_py():
    s = LazyConfig.to_py(L(ShapeSpecLike)(channels=32))
    assert "ShapeSpecLike" in s and "channels=32" in s


# -- the 56 configs


def _jax_name(x):
    if (getattr(x, "__globals__", {}).get("__package__") or "").startswith(_CFG_MODULE):
        return x.__qualname__
    return _convert_target_to_string(x)


_PORT_SIDE = textwrap.dedent(
    """
    import json, sys
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "detectron2_tpu"):
                raise ImportError(f"blocked: {name}")
    sys.meta_path.insert(0, _Block())
    from detectron2_tpu_torch.config import LazyConfig, lazy_targets
    from detectron2_tpu_torch.config.lazy import is_config_namespace
    from detectron2_tpu_torch.testing import config_tree

    def name_of(x):
        if is_config_namespace(getattr(x, "__globals__", None)):
            return x.__qualname__
        return lazy_targets.target_name(x) or f"{x.__module__}.{x.__qualname__}"

    out = {}
    for c in json.loads(sys.argv[2]):
        try:
            out[c] = ["ok", config_tree(LazyConfig.load(f"{sys.argv[1]}/configs/{c}"), name_of)]
        except Exception as e:
            out[c] = [type(e).__name__, str(e)]
    json.dump(out, open(sys.argv[3], "w"))
    """
)


@pytest.fixture(scope="module")
def port_trees(tmp_path_factory):
    """Every config loaded by the port with jax and the JAX package blocked."""
    out = tmp_path_factory.mktemp("lazy") / "trees.json"
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run(
        [sys.executable, "-c", _PORT_SIDE, ROOT, json.dumps(CONFIGS), str(out)],
        check=True, env=env, cwd=ROOT, timeout=300,
    )
    return json.loads(out.read_text())


def test_the_config_set():
    assert len(CONFIGS) == 56 and len(_MUST_LOAD) == 37 and set(_A4_CONFIGS + _DENSE_CONFIGS) <= set(CONFIGS)
    assert not set(_UNLOADABLE) & set(_MUST_LOAD)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_loads_in_the_port_as_in_the_jax_package(config, port_trees):
    outcome, payload = port_trees[config]
    if config in _UNLOADABLE:
        assert [outcome, payload] == list(_UNLOADABLE[config])
        return
    assert outcome == "ok", payload
    ref = json.loads(json.dumps(config_tree(JaxLazyConfig.load(os.path.join(ROOT, "configs", config)), _jax_name)))
    assert payload == ref


def test_every_table_entry_names_the_jax_object_and_resolves():
    for path, (target, spec) in lazy_targets.TABLE.items():
        assert _convert_target_to_string(locate(path)) == target, path
        obj = lazy_targets.resolve(target)
        assert obj is lazy_targets.resolve(path)
        if isinstance(obj, lazy_targets.Unported):
            assert "ROADMAP A" in obj.roadmap
            with pytest.raises(NotImplementedError, match=r"not ported yet \(ROADMAP A\d"):
                obj()
        else:
            assert callable(obj) and lazy_targets.target_name(obj) == target, path


def test_missing_names_and_jax_raise_import_errors_naming_them(tmp_path):
    for line, name in (
        ("from detectron2_tpu.modeling import NotAModule", "detectron2_tpu.modeling.NotAModule"),
        ("from detectron2_tpu.nothing import x", "detectron2_tpu.nothing"),
        ("import optax", "optax"),
        ("import jax.numpy as jnp", "jax.numpy"),
    ):
        f = tmp_path / "cfg.py"
        f.write_text(line + "\nmodel = dict(x=1)\n")
        with pytest.raises(ImportError, match=name.replace(".", r"\.")):
            LazyConfig.load(str(f))


@pytest.mark.parametrize(
    "config, family",
    [
        ("ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py", "SwinTransformer"),
        ("ViTDet/cascade_mask_rcnn_mvitv2_b_in21k_100ep.py", "MViT"),
        ("COCO-InstanceSegmentation/mask_rcnn_regnetx_4gf_dds_fpn_1x.py", "RegNet"),
        ("ViTDet/LVIS/cascade_mask_rcnn_mvitv2_b_in21k_100ep.py", "MViT"),
    ],
)
def test_unported_models_load_and_raise_at_instantiate(config, family):
    """The hierarchical backbones' configs, which raised naming ROADMAP A8
    before the port had MViT, Swin and RegNet, now instantiate: the state
    dict's names and shapes are ``convert_jax_params`` of the JAX model's
    ``eval_shape`` (FrozenBN statistics included)."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    path = os.path.join(ROOT, "configs", config)
    model = instantiate(LazyConfig.load(path).model)
    assert type(model.backbone.bottom_up).__name__ == family and str(model.device) == "cpu"
    jm = jax_instantiate(JaxLazyConfig.load(path).model)
    batch = {"image": jnp.zeros((1, 256, 256, 3)), "image_sizes": jnp.asarray([[256, 256]], jnp.int32)}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch))
    converted = convert_jax_params(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes))
    assert {k: tuple(v.shape) for k, v in converted.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}


# the smallest config of each hierarchical family: (backbone class, blocks a
# stage, stage widths, the last block's DropPath rate, the backbone's norm
# class or None for a transformer, the FPN's norm class or None)
_A8_CONFIGS = {
    "MViTv2/mask_rcnn_mvitv2_t_3x.py": ("MViT", (1, 2, 5, 2), (96, 192, 384, 768), 0.2, None, None),
    "ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py": ("SwinTransformer", (2, 2, 18, 2), (128, 256, 512, 1024), 0.4, None, "LayerNorm"),
    "COCO-InstanceSegmentation/mask_rcnn_regnetx_4gf_dds_fpn_1x.py": (
        "RegNet", (2, 5, 14, 2), (80, 240, 560, 1360), None, "FrozenBatchNorm2d", None),
    "new_baselines/mask_rcnn_regnety_4gf_dds_FPN_100ep_LSJ.py": (
        "RegNet", (2, 6, 12, 2), (128, 192, 512, 1088), None, "SyncBatchNorm", "SyncBatchNorm"),
}


@pytest.mark.parametrize("config", sorted(_A8_CONFIGS))
def test_the_hierarchical_backbone_configs_instantiate(config):
    """MViTv2-T, Swin-B, RegNetX-4GF and RegNetY-4GF LSJ as the zoo has them:
    the stages, widths and DropPath rates reach the port's modules, the
    batch is padded to multiples of 32, and the RegNets' builders (which
    call ``GeneralizedRCNN.from_config(cfg).clone(backbone=...)``) give
    RegNetY its SE in every block. The MViTv2 files carry no optimizer: the
    bare ``make_optimizer`` is no lazy node, so the load drops it, in both
    packages, and training them takes ``--recipe-from``."""
    from detectron2_tpu_torch.modeling.backbone import padding_constraints

    family, depths, widths, rate, norm, fpn_norm = _A8_CONFIGS[config]
    cfg = LazyConfig.load(os.path.join(ROOT, "configs", config))
    model = instantiate(cfg.model)
    net = model.backbone.bottom_up
    assert type(net).__name__ == family and padding_constraints(model.backbone) == {"size_divisibility": 32}
    assert [s.channels for s in net.output_shape().values()] == list(widths)
    assert [s.stride for s in net.output_shape().values()] == [4, 8, 16, 32]
    if family == "MViT":
        assert net.depths == depths and len(net.blocks) == sum(depths)
    elif family == "SwinTransformer":
        assert tuple(len(layer.blocks) for layer in net.layers) == depths
    else:
        assert tuple(len(list(getattr(net, s).children())) for s in net.stage_names) == depths
        bns = [m for n, m in net.named_modules() if n.endswith(("bn", "_bn"))]
        assert {type(m).__name__ for m in bns} == {norm}
        has_se = [b.f.se is not None for s in net.stage_names for b in getattr(net, s).children()]
        assert all(has_se) if "regnety" in config else not any(has_se)
        assert tuple(model.pixel_std.tolist()) == pytest.approx((57.375, 57.120, 58.395))
    if rate is not None:
        rates = [m.rate for m in net.modules() if type(m).__name__ == "DropPath"]
        assert rates[-1] == pytest.approx(rate) and rates[0] == 0.0
    lateral = model.backbone.fpn_lateral2.norm
    assert (type(lateral).__name__ if lateral is not None else None) == fpn_norm
    assert ("optimizer" in cfg) == (not config.startswith("MViTv2/"))
    if config.startswith("MViTv2/"):
        assert "optimizer" not in JaxLazyConfig.load(os.path.join(ROOT, "configs", config))


def test_a_config_function_that_imports_optax_raises_naming_itself(tmp_path):
    """MViTv2's ``make_optimizer(params, base_lr, weight_decay)`` has no
    counterpart (the table matches ViTDet's by its parameter names)."""
    f = tmp_path / "cfg.py"
    f.write_text(
        "from detectron2_tpu.config import LazyCall as L\n"
        "def make_optimizer(params, base_lr=1.6e-4, weight_decay=0.1):\n"
        "    import optax\n"
        "    return optax.adamw(base_lr, weight_decay=weight_decay)\n"
        "optimizer = L(make_optimizer)(params=None)\n"
    )
    cfg = LazyConfig.load(str(f))
    with pytest.raises(NotImplementedError, match="make_optimizer, defined in .*cfg.py, imports jax/optax/flax"):
        instantiate(cfg.optimizer)


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_vitdet_b_instantiates_as_model_zoo_and_the_jax_names():
    cfg = LazyConfig.load(os.path.join(ROOT, "configs", "ViTDet/mask_rcnn_vitdet_b_100ep.py"))
    model = instantiate(cfg.model)
    assert _shapes(model) == _shapes(model_zoo.mask_rcnn_vitdet_b(device="cpu"))
    assert str(model.device) == "cpu" and model.compute_dtype == torch.bfloat16
    assert model.backbone.net.blocks[11].drop_path.rate == pytest.approx(0.1)
    jm = jax_instantiate(JaxLazyConfig.load(os.path.join(ROOT, "configs", "ViTDet/mask_rcnn_vitdet_b_100ep.py")).model)
    batch = {"image": jnp.zeros((1, 1024, 1024, 3)), "image_sizes": jnp.asarray([[1024, 1024]], jnp.int32)}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch))
    names = set()
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: names.add(flax_path_to_d2_name(tuple(k.key for k in p[1:]))), shapes
    )
    assert names == {k for k, _ in model.named_parameters()}


def test_the_r50_fpn_node_builds_the_yacs_model_and_config_builders_run():
    cfg = LazyConfig.load(os.path.join(ROOT, "configs", "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.py"))
    model = instantiate(cfg.model)
    yacs = model_zoo.get("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml", device="cpu")
    assert _shapes(model) == _shapes(yacs)
    assert [p.requires_grad for p in model.parameters()] == [p.requires_grad for p in yacs.parameters()]
    # build_mask_rcnn_c4, defined in configs/common/models/mask_rcnn_c4.py, runs as it is
    c4 = LazyConfig.load(os.path.join(ROOT, "configs", "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.py"))
    assert c4.model._target_.__name__ == "build_mask_rcnn_c4"
    model = instantiate(c4.model)
    assert type(model.roi_heads).__name__ == "Res5ROIHeads"
    assert set(model_zoo.get_config("ViTDet/mask_rcnn_vitdet_b_100ep.py")) == {"dataloader", "lr_multiplier", "model", "optimizer", "train"}


def test_a_config_saved_by_either_package_loads_in_the_other(tmp_path):
    port = LazyConfig.load(os.path.join(ROOT, "configs", "ViTDet/mask_rcnn_vitdet_b_100ep.py"))
    ref = JaxLazyConfig.load(os.path.join(ROOT, "configs", "ViTDet/mask_rcnn_vitdet_b_100ep.py"))
    LazyConfig.save(DictConfig({"dataloader": port.dataloader}), str(tmp_path / "port.yaml"))
    JaxLazyConfig.save({"dataloader": ref.dataloader}, str(tmp_path / "jax.yaml"))
    from_port = JaxLazyConfig.load(str(tmp_path / "port.yaml"))
    from_jax = LazyConfig.load(str(tmp_path / "jax.yaml"))
    assert config_tree(from_port, str) == config_tree(from_jax, str) == config_tree({"dataloader": ref.dataloader}, _jax_name)
    mapper = instantiate(from_jax.dataloader.train.mapper)
    assert type(mapper).__module__ == "detectron2_tpu_torch.data.dataset_mapper"
    assert [type(a).__name__ for a in mapper.augmentations.augs] == ["RandomFlip", "ResizeScale", "FixedSizeCrop"]


def test_builtin_keypoint_flip_indices_and_get_cfg():
    cfg = LazyConfig.load(os.path.join(ROOT, "configs", "COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.py"))
    flip = cfg.dataloader.train.mapper.keypoint_hflip_indices
    assert flip.tolist() == [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
    assert lazy_targets.resolve("detectron2_tpu.config.get_cfg") is get_cfg


@pytest.mark.parametrize("config", _A4_CONFIGS)
def test_the_batch_norm_configs_instantiate(config):
    """Every conv norm of the recipe is the port's SyncBN / BN, which keeps
    batch statistics; the LSJ recipes train the whole backbone from scratch."""
    from detectron2_tpu_torch.layers import BatchNorm2d, SyncBatchNorm, get_bn_modules

    cfg = LazyConfig.load(os.path.join(ROOT, "configs", config))
    model = instantiate(cfg.model)
    bns = {name for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    heads = {name for name in bns if name.startswith("roi_heads.")}
    assert len(heads) == 8  # 4 box-head convs, 4 mask-head convs
    if config.startswith("new_baselines/"):
        assert all(type(m) is SyncBatchNorm for m in get_bn_modules(model))
        assert all(p.requires_grad for p in model.parameters())
        depth = 50 if "_R_50_" in config else 101
        assert len(bns) == {50: 53, 101: 104}[depth] + 8 + 8  # ResNet, FPN (4 lateral + 4 output), heads
        assert cfg.train.init_checkpoint == "" and cfg.dataloader.train.total_batch_size == 64
    else:
        kind = SyncBatchNorm if "SyncBN" in config else BatchNorm2d
        assert bns == heads and all(type(m) is kind for m in get_bn_modules(model))


def test_the_lsj_recipe_instantiates_with_the_jax_names():
    """``new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py``: the JAX model's
    ``params`` and ``batch_stats`` name the port's parameters and buffers
    through ``jax_params``' name map, and the recipe's settings reach the
    port's modules as the JAX builder reads them (STRIDE_IN_1X1 False,
    FREEZE_AT 0, a 2-conv RPN head, PIXEL_STD)."""
    path = os.path.join(ROOT, "configs", "new_baselines/mask_rcnn_R_50_FPN_100ep_LSJ.py")
    model = instantiate(LazyConfig.load(path).model)
    assert str(model.device) == "cpu" and model.compute_dtype == torch.bfloat16
    jm = jax_instantiate(JaxLazyConfig.load(path).model)
    batch = {"image": jnp.zeros((1, 1024, 1024, 3)), "image_sizes": jnp.asarray([[1024, 1024]], jnp.int32)}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch))
    names = {}
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: names.__setitem__(flax_path_to_d2_name(tuple(k.key for k in p[1:])), int(np.prod(leaf.shape))), shapes
    )
    assert set(shapes) == {"params", "batch_stats"}
    assert names == {k: v.numel() for k, v in model.state_dict().items()}
    res2 = model.backbone.bottom_up.res2[0]
    assert res2.conv1.stride == (1, 1) and model.backbone.bottom_up.res3[0].conv2.stride == (2, 2)  # stride in the 3x3
    assert all(p.requires_grad for p in model.backbone.parameters())  # FREEZE_AT 0
    assert len(model.proposal_generator.rpn_head.conv) == 2
    assert tuple(model.pixel_std.tolist()) == pytest.approx((57.375, 57.120, 58.395))
    assert (jm.pixel_std, jm.backbone.bottom_up.freeze_at) == ((57.375, 57.120, 58.395), 0)


@pytest.mark.parametrize("config", ["Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml", "Misc/scratch_mask_rcnn_R_50_FPN_9x_syncbn.yaml"])
def test_the_syncbn_yamls_build(config):
    """``get_cfg().merge_from_file`` + ``build_model``: SyncBN in the ResNet,
    the FPN and the 4conv1fc box and mask heads; the 3x yaml freezes the
    stem and res2 (their BNs still keep batch statistics, as in the JAX
    package), the scratch yaml nothing."""
    from detectron2_tpu_torch.layers import SyncBatchNorm, get_bn_modules
    from detectron2_tpu_torch.modeling import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    model = build_model(cfg, device="cpu")
    bns = get_bn_modules(model)
    assert len(bns) == 53 + 8 + 8 and all(type(m) is SyncBatchNorm for m in bns)
    assert cfg.TEST.PRECISE_BN.ENABLED
    frozen = {k.split(".")[2] for k, p in model.named_parameters() if not p.requires_grad}
    assert frozen == ({"stem", "res2"} if "3x" in config else set())


@pytest.mark.parametrize("config", _DENSE_CONFIGS)
def test_the_dense_configs_instantiate(config):
    """``common/models/retinanet.py`` builds from ``get_cfg()``'s anchor
    sizes, one list of 5 broadcast to every level: 15 anchors a location,
    as the JAX package builds it (d2's common config has 3 octaves, 9);
    the SyncBN head's config sets the 9. FCOS's P6 reads ``p5`` (256 in),
    RetinaNet's ``res5`` (2048 in); FCOS's head is GN."""
    from detectron2_tpu_torch.layers import GroupNorm, SyncBatchNorm

    model = instantiate(LazyConfig.load(os.path.join(ROOT, "configs", config)).model)
    assert str(model.device) == "cpu" and model.compute_dtype == torch.bfloat16
    assert model.head_in_features == ("p3", "p4", "p5", "p6", "p7")
    top = model.backbone.top_block
    assert type(top).__name__ == "LastLevelP6P7" and model.loss_normalizer.item() == 100.0
    if "fcos" in config:
        assert type(model).__name__ == "FCOS" and (top.in_feature, top.p6.in_channels) == ("p5", 256)
        assert isinstance(model.head.cls_subnet[1], GroupNorm) and model.strides == (8, 16, 32, 64, 128)
        return
    assert type(model).__name__ == "RetinaNet" and (top.in_feature, top.p6.in_channels) == ("res5", 2048)
    anchors = 9 if "SyncBN" in config else 15
    assert model.anchor_generator.num_anchors == [anchors] * 5 and model.head.cls_score.out_channels == anchors * 80
    norms = [m for m in model.head.modules() if isinstance(m, SyncBatchNorm)]
    assert len(norms) == (8 if "SyncBN" in config else 0)


@pytest.mark.parametrize("config", _DENSE_CONFIGS[:2])
def test_the_dense_models_instantiate_with_the_jax_names(config):
    """The JAX model's ``params`` and ``meters`` name the port's parameters
    and buffers (the towers at d2's Sequential indices, with GN at 3i + 1
    in FCOS), with the same sizes."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    path = os.path.join(ROOT, "configs", config)
    model = instantiate(LazyConfig.load(path).model)
    jm = jax_instantiate(JaxLazyConfig.load(path).model)
    batch = {
        "image": jnp.zeros((1, 128, 128, 3)), "image_sizes": jnp.asarray([[128, 128]], jnp.int32),
        "gt_boxes": jnp.zeros((1, 2, 4)), "gt_classes": jnp.zeros((1, 2), jnp.int32), "gt_valid": jnp.ones((1, 2), bool),
    }
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch, train=True))
    assert set(shapes) == {"params", "meters"}
    names = {k: v.numel() for k, v in convert_jax_params(jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), shapes)).items()}
    assert names == {k: v.numel() for k, v in model.state_dict().items()}


@pytest.mark.parametrize(
    "config, meta",
    [
        ("COCO-Detection/retinanet_R_50_FPN_1x.yaml", "RetinaNet"),
        ("COCO-Detection/retinanet_R_50_FPN_3x.yaml", "RetinaNet"),
        ("COCO-Detection/retinanet_R_101_FPN_3x.yaml", "RetinaNet"),
        ("COCO-Detection/rpn_R_50_FPN_1x.yaml", "ProposalNetwork"),
        ("COCO-Detection/rpn_R_50_C4_1x.yaml", "ProposalNetwork"),
    ],
)
def test_the_retinanet_and_rpn_yamls_build(config, meta):
    """``get_cfg().merge_from_file`` + ``build_model``: the yaml RetinaNet
    has 3 octave sizes a level (9 anchors) and an L1 box loss (beta 0)."""
    from detectron2_tpu_torch.modeling import build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    model = build_model(cfg, device="cpu")
    assert type(model).__name__ == meta
    if meta == "RetinaNet":
        assert model.anchor_generator.num_anchors == [9] * 5 and model.smooth_l1_beta == 0.0
        assert model.backbone.bottom_up.res5[0].conv1.in_channels == 1024
        assert len(model.backbone.bottom_up.res4) == (23 if "101" in config else 6)
    else:
        assert set(model.train_target_sizes().values()) == {0}
        assert model.proposal_generator.in_features == (("res4",) if "C4" in config else ("p2", "p3", "p4", "p5", "p6"))
