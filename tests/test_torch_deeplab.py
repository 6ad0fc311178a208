"""The port's DeepLab (V3, V3+) against the JAX package's, in float32 on the
CPU, weights carried across by ``convert_jax_params``.

- ``DepthwiseSeparableConv2d`` (norm "BN", "" and None: the JAX bias rule),
  ``ASPP`` plain and depthwise-separable, ``DeepLabStem`` and the DeepLab
  ResNet (depth 50 at narrow widths, res5 dilated with multi-grid, and
  res4 dilated too, 64x64): forwards within 1e-5 * max|ref| + 1e-6; in
  training (batch statistics, dropout 0) the loss of a fixed positive
  projection of the (ReLU) outputs within 1e-5 relative and every
  parameter's gradient within 1e-4 of its max (+ 1e-6 of the largest
  gradient: gradients that are zero but for rounding), the ResNet's in float64 on both sides (BN with
  batch statistics over 16 blocks moves float32 gradients by ~1% in either
  package).
- ``DeepLabV3Head`` and ``DeepLabV3PlusHead`` (plain and
  depthwise-separable) on seeded features: the logits, and the losses of
  both loss types and every gradient; a tiny V3+ SemanticSegmentor (the
  trunk above with the head): the logits and the training loss.
- ``hard_pixel_mining_ce`` with ignored pixels at ``top_k`` 0.2 and 1.0,
  and its gradient.
- ``WarmupPolyLR`` at several iterations, exactly; ``SOLVER.OPTIMIZER``
  "ADAM": two AdamW steps over d2's parameter groups against the JAX
  ``build_optimizer``'s optax chain, within 1e-6, plain and with the
  gradients clipped by their global norm.
- ``tests/goldens/e2e_deeplab_r50.npz`` through the d2 loader, at its
  parity test's bounds; the two DeepLab yamls on the meta device.
- ``RandomCrop_CategoryAreaConstraint`` under one seed, as the JAX policy
  draws it from numpy's global state.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax._src.config import enable_x64  # a scoped switch; the flag is global otherwise

from _torch_port import (
    jax_inference,
    jax_model,
    jax_module_random_variables,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)
from detectron2_tpu.data.transforms.augmentation_impl import (
    RandomCrop_CategoryAreaConstraint as JaxCategoryAreaCrop,
)
from detectron2_tpu.layers.aspp import ASPP as JaxASPP
from detectron2_tpu.layers.blocks import DepthwiseSeparableConv2d as JaxDSConv
from detectron2_tpu.projects import deeplab as jdl
from detectron2_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint, load_state_dict_report
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.layers import Conv2d, get_norm, nchw, nhwc
from detectron2_tpu_torch.layers.aspp import ASPP
from detectron2_tpu_torch.layers.blocks import DepthwiseSeparableConv2d
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone import build_backbone
from detectron2_tpu_torch.projects import deeplab as dl
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer
from detectron2_tpu_torch.testing import compare_with_deeplab_golden, golden_deeplab_config, golden_state_dict

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = (
    "Cityscapes-SemanticSegmentation/deeplab_v3_R_103_os16_mg124_poly_90k_bs16.yaml",
    "Cityscapes-SemanticSegmentation/deeplab_v3_plus_R_103_os16_mg124_poly_90k_bs16.yaml",
)


def close(ours, ref, rtol=1e-5, atol=1e-6):
    """Within ``rtol * max|ref| + atol``."""
    ours, ref = n(ours).astype(np.float64), np.asarray(ref).astype(np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


def converted(variables, scope=None):
    """``convert_jax_params`` of a JAX module's variables; ``scope`` wraps
    them in a parent scope whose name the mapping reads (the ASPP's) and
    is cut from the names again."""
    tree = jax.tree_util.tree_map(np.asarray, variables)
    if scope:
        tree = {c: {scope: v} for c, v in tree.items()}
    return {k.split(".", 1)[1] if scope else k: v for k, v in convert_jax_params(tree).items()}


def load_module(module, variables, scope=None):
    """:func:`converted` variables into the port's ``module``, every
    tensor loaded."""
    state = converted(variables, scope)
    report = load_state_dict_report(module, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(module.state_dict())} tensors from the checkpoint."], report
    return module


def jax_module_train(module, variables, x, proj, scope=None):
    """The loss ``sum(out * proj)`` of the JAX module in training (batch
    statistics) and its parameter gradients, as the port's names."""

    def loss_fn(params):
        out, _ = module.apply({**variables, "params": params}, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * proj)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), converted({"params": grads}, scope)


def assert_grads_match(model, ref_grads):
    """Every parameter's gradient within 1e-4 of its largest reference
    gradient; a floor of 1e-6 of the model's largest covers gradients that
    are zero but for rounding (the ASPP pool conv's bias, whose shift the
    projection's BN mean takes out: ~1e-9 in float32, ~1e-18 in float64)."""
    floor = 1e-6 * max(np.abs(n(ref_grads[name])).max() for name, _ in model.named_parameters())
    for name, p in model.named_parameters():
        g = n(ref_grads[name]).astype(np.float64)
        err = np.abs(n(p.grad).astype(np.float64) - g).max()
        assert err <= 1e-4 * np.abs(g).max() + floor, (name, err, np.abs(g).max(), floor)


def assert_module_train(module, x_nchw, proj_nhwc, ref_loss, ref_grads):
    out = nhwc(module(x_nchw, True))
    loss = (out * t(proj_nhwc)).sum()
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss), (loss.item(), ref_loss)
    loss.backward()
    assert_grads_match(module, ref_grads)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("norm", ["BN", "", None])
def test_depthwise_separable_conv(norm):
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)
    jm = JaxDSConv(in_channels=8, out_channels=6, kernel_size=5, padding=2, norm1=norm, activation1=jax.nn.relu,
                   norm2=norm, activation2=jax.nn.relu)
    v = jax_module_random_variables(jm, x, seed=1, scale=0.3)
    pm = load_module(DepthwiseSeparableConv2d(8, 6, 5, padding=2, norm1=norm, activation1=F.relu, norm2=norm,
                                              activation2=F.relu), v)
    # the JAX rule: a bias only where the norm is None (d2 has one for "" too)
    assert (pm.depthwise.bias is None) == (norm is not None) and (pm.pointwise.bias is None) == (norm is not None)
    with torch.no_grad():
        close(nhwc(pm(nchw(t(x)), False)), jm.apply(v, jnp.asarray(x), train=False))
    proj = np.abs(rng.standard_normal((2, 12, 10, 6))).astype(np.float32)
    assert_module_train(pm, nchw(t(x)), proj, *jax_module_train(jm, v, x, proj))


@pytest.mark.parametrize("dsconv", [False, True], ids=["plain", "dsconv"])
def test_aspp(dsconv):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 9, 11, 16)).astype(np.float32)
    jm = JaxASPP(in_channels=16, out_channels=8, dilations=(2, 3, 5), norm="BN", dropout=0.0,
                 use_depthwise_separable_conv=dsconv)
    v = jax_module_random_variables(jm, x, seed=3, scale=0.3)
    pm = load_module(ASPP(16, 8, (2, 3, 5), norm="BN", dropout=0.0, use_depthwise_separable_conv=dsconv), v, "aspp")
    assert pm.convs[4][1].bias is not None and pm.convs[4][1].norm is None  # the pooling branch: bias, no norm
    with torch.no_grad():
        close(nhwc(pm(nchw(t(x)), False)), jm.apply(v, jnp.asarray(x), train=False))
    proj = np.abs(rng.standard_normal((2, 9, 11, 8))).astype(np.float32)
    assert_module_train(pm, nchw(t(x)), proj, *jax_module_train(jm, v, x, proj, "aspp"))


def test_aspp_dropout_draws_from_the_generator():
    pm = ASPP(4, 4, (1, 2, 3), norm="", dropout=0.5)
    x = torch.randn(1, 4, 6, 6)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(5)
        outs.append(pm(x, True, g))
    assert torch.equal(outs[0], outs[1]) and (outs[0] == 0).any()
    assert torch.equal(pm(x, False), pm(x, False, torch.Generator().manual_seed(6)))


def test_deeplab_stem():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    jm = jdl.DeepLabStem(out_channels=16, norm="BN")
    v = jax_module_random_variables(jm, x, seed=5, scale=0.3)
    pm = load_module(dl.DeepLabStem(3, 16, "BN"), v)
    with torch.no_grad():
        close(nhwc(pm(nchw(t(x)), False)), jm.apply(v, jnp.asarray(x), train=False))
    proj = np.abs(rng.standard_normal((2, 8, 10, 16))).astype(np.float32)
    assert_module_train(pm, nchw(t(x)), proj, *jax_module_train(jm, v, x, proj))


def backbone_cfg(res4_dilation=1, res5_dilation=2, grid=(1, 2, 4), out=("res2", "res3", "res5"), depth=50):
    cfg = get_cfg()
    dl.add_deeplab_config(cfg)
    r = cfg.MODEL.RESNETS
    r.DEPTH, r.NORM, r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP = depth, "SyncBN", 16, 32, 8
    r.RES4_DILATION, r.RES5_DILATION, r.RES5_MULTI_GRID, r.OUT_FEATURES = res4_dilation, res5_dilation, list(grid), list(out)
    r.STRIDE_IN_1X1 = False
    cfg.MODEL.BACKBONE.NAME = "build_resnet_deeplab_backbone"
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.DEVICE = "cpu"
    return cfg


@pytest.mark.parametrize("dilations", [(1, 2), (2, 4)], ids=["os16", "os8"])
def test_deeplab_backbone(dilations):
    from _torch_port import jax_cfg_from_port

    cfg = backbone_cfg(*dilations)
    jm = jdl.build_resnet_deeplab_backbone(jax_cfg_from_port(cfg))
    pm = build_backbone(cfg)
    assert [b.conv2.dilation[0] for b in pm.res5] == [dilations[1] * g for g in (1, 2, 4)]
    assert pm.output_shape()["res5"].stride == (16 if dilations[1] == 2 else 8)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    v = jax_module_random_variables(jm, x, seed=7, scale=0.2)
    load_module(pm, v)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        out = pm(t(x))
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k])
    if dilations != (1, 2):
        return  # the output stride 16 trunk trains below; this one's forward is held
    projs = {k: np.abs(rng.standard_normal(ref[k].shape)) for k in ref}
    # BN with batch statistics over 16 blocks makes float32 gradients
    # ill-conditioned (~1% of a tensor's largest apart): both sides train in
    # float64
    with enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), v)

        def loss_fn(params):
            outs, _ = jm.apply({**v64, "params": params}, jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            return sum(jnp.sum(outs[k] * projs[k]) for k in outs)

        ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v64["params"])
        ref_grads = convert_jax_params({"params": jax.tree_util.tree_map(np.asarray, grads)})
    pm.double()
    outs = pm(t(x).double(), train=True)
    loss = sum((outs[k] * t(projs[k])).sum() for k in outs)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    loss.backward()
    assert_grads_match(pm, ref_grads)


# ------------------------------------------------------------ the heads
def head_cfg(kind, loss_type="hard_pixel_mining", dsconv=False):
    cfg = backbone_cfg(out=("res2", "res5") if kind != "v3" else ("res5",))
    cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    h = cfg.MODEL.SEM_SEG_HEAD
    h.NAME = "DeepLabV3Head" if kind == "v3" else "DeepLabV3PlusHead"
    h.IN_FEATURES = ["res5"] if kind == "v3" else ["res2", "res5"]
    h.PROJECT_FEATURES, h.PROJECT_CHANNELS = ["res2"], [8]
    h.ASPP_CHANNELS, h.ASPP_DILATIONS, h.ASPP_DROPOUT, h.CONVS_DIM = 16, [2, 3, 4], 0.0, 16
    h.COMMON_STRIDE = 16 if kind == "v3" else 4
    h.NUM_CLASSES, h.NORM, h.LOSS_TYPE, h.LOSS_TOP_K = 5, "SyncBN", loss_type, 0.2
    h.USE_DEPTHWISE_SEPARABLE_CONV = dsconv
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def seg_targets(seed, b=2, h=64, w=64, classes=5):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, classes, (b, h, w))
    gt[rng.rand(b, h, w) < 0.2] = 255
    return gt.astype(np.int64)


FEATURES = {"res2": (32, 4), "res3": (64, 8), "res5": (256, 16)}  # channels, stride (the narrow trunk's)


def head_features(names, seed, b=2, hw=64):
    """Post-ReLU features of a 64x64 batch at the narrow trunk's widths."""
    rng = np.random.RandomState(seed)
    return {f: np.maximum(rng.standard_normal((b, hw // FEATURES[f][1], hw // FEATURES[f][1], FEATURES[f][0])), 0)
            .astype(np.float32) for f in names}


def head_pair(registry_get, jax_registry_get, cfg, names, scope):
    """(port head, JAX head, JAX variables, port names of the variables) of
    ``cfg`` on ``names``' shapes, the port's loaded from the JAX ones."""
    from _torch_port import jax_cfg_from_port
    from detectron2_tpu.layers.shape_spec import ShapeSpec as JaxShapeSpec
    from detectron2_tpu_torch.layers import ShapeSpec

    port_shapes = {f: ShapeSpec(channels=FEATURES[f][0], stride=FEATURES[f][1]) for f in names}
    jax_shapes = {f: JaxShapeSpec(channels=FEATURES[f][0], stride=FEATURES[f][1]) for f in names}
    jh = jax_registry_get(jax_cfg_from_port(cfg), jax_shapes)
    feats = {k: jnp.asarray(v) for k, v in head_features(names, 0).items()}
    shapes = jax.eval_shape(lambda: jh.init({"params": jax.random.PRNGKey(0)}, feats, train=False))
    rng = np.random.RandomState(21)
    v = jax.tree_util.tree_map_with_path(
        lambda path, sds: jnp.asarray(np.abs(rng.standard_normal(sds.shape)) + 0.5 if path[-1].key == "var"
                                      else rng.standard_normal(sds.shape) * 0.2, jnp.float32), shapes)
    ph = load_module(registry_get(cfg, port_shapes), v, scope)
    return ph, jh, v


HEADS = [("v3", "hard_pixel_mining", False), ("v3", "cross_entropy", False), ("v3plus", "hard_pixel_mining", False),
         ("v3plus", "cross_entropy", False), ("v3plus", "hard_pixel_mining", True)]


@pytest.mark.parametrize("case", HEADS, ids=lambda c: "-".join(str(x) for x in c))
def test_semantic_head_forward_loss_and_grads(case):
    from detectron2_tpu.modeling.meta_arch.semantic_seg import SEM_SEG_HEADS_REGISTRY as JAX_HEADS
    from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import build_sem_seg_head

    cfg = head_cfg(*case)
    names = tuple(cfg.MODEL.SEM_SEG_HEAD.IN_FEATURES)
    ph, jh, v = head_pair(build_sem_seg_head, lambda c, s: JAX_HEADS.get(c.MODEL.SEM_SEG_HEAD.NAME).from_config(c, s),
                          cfg, names, "sem_seg_head")
    feats = head_features(names, 22)
    ref, _ = jax.jit(lambda v, f: jh.apply(v, f, train=False))(v, {k: jnp.asarray(x) for k, x in feats.items()})
    with torch.no_grad():
        out, _ = ph({k: t(x) for k, x in feats.items()})
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 64, 64, 5)
    close(out, ref)
    targets = seg_targets(23)

    def loss_fn(params):
        (_, losses), _ = jh.apply({**v, "params": params}, {k: jnp.asarray(x) for k, x in feats.items()},
                                  targets=jnp.asarray(targets), train=True, mutable=["batch_stats"])
        return losses["loss_sem_seg"]

    ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    _, losses = ph({k: t(x) for k, x in feats.items()}, t(targets), train=True)
    assert set(losses) == {"loss_sem_seg"}
    assert abs(losses["loss_sem_seg"].item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    losses["loss_sem_seg"].backward()
    assert_grads_match(ph, converted({"params": grads}, "sem_seg_head"))


def test_head_names_are_d2s():
    names = set(build_model(head_cfg("v3"), device="meta").state_dict())
    assert {"sem_seg_head.aspp.convs.4.1.weight", "sem_seg_head.aspp.project.norm.running_var",
            "sem_seg_head.predictor.bias", "backbone.stem.conv3.norm.weight"} <= names
    names = set(build_model(head_cfg("v3plus", dsconv=True), device="meta").state_dict())
    assert {"sem_seg_head.decoder.res5.project_conv.convs.1.depthwise.weight",
            "sem_seg_head.decoder.res2.fuse_conv.pointwise.norm.weight",
            "sem_seg_head.decoder.res2.project_conv.weight"} <= names


def test_tiny_semantic_segmentor_matches_jax():
    """The whole tiny V3+ model (trunk and head) on a 64x64 batch: the
    logits and the training loss, the JAX side jitted."""
    cfg = head_cfg("v3plus")
    jm = jax_model(cfg)
    v = jax_random_variables(jm, seed=9, scale=0.2)
    model = port_model(cfg, v)
    rng = np.random.RandomState(24)
    batch = {"image": (rng.rand(2, 64, 64, 3) * 255).astype(np.float32), "image_sizes": np.asarray([[64, 64]] * 2, np.int32)}
    ref = jax_inference(jm, v, batch)["sem_seg"]
    close(model({k: t(x) for k, x in batch.items()})["sem_seg"], ref)
    batch["gt_sem_seg"] = seg_targets(25)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    ref_losses, _ = jax.jit(lambda v: jm.apply(v, jb, train=True, mutable=["batch_stats"]))(v)
    losses = model({k: t(x) for k, x in batch.items()}, train=True)
    assert abs(losses["loss_sem_seg"].item() - float(ref_losses["loss_sem_seg"])) <= 1e-5 * float(ref_losses["loss_sem_seg"])


# --------------------------------------------------------------- the loss
@pytest.mark.parametrize("top_k", [0.2, 1.0])
def test_hard_pixel_mining_ce(top_k):
    rng = np.random.RandomState(10)
    logits = (rng.standard_normal((3, 9, 13, 6)) * 3).astype(np.float32)
    targets = rng.randint(0, 6, (3, 9, 13))
    targets[rng.rand(3, 9, 13) < 0.3] = 255
    targets[2] = 255  # an image with nothing valid
    ref, ref_grad = jax.jit(jax.value_and_grad(lambda x: jdl.hard_pixel_mining_ce(x, jnp.asarray(targets), 255, top_k)))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_()
    loss = dl.hard_pixel_mining_ce(x, t(targets), 255, top_k)
    assert abs(loss.item() - float(ref)) <= 1e-5 * float(ref)
    loss.backward()
    close(x.grad, ref_grad, 1e-5, 1e-9)


# ------------------------------------------------------------- the solver
def test_warmup_poly_lr_exactly():
    from detectron2_tpu.solver.build import build_lr_scheduler as jax_build_lr_scheduler
    from _torch_port import jax_cfg_from_port

    cfg = get_cfg()
    dl.add_deeplab_config(cfg)
    cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER, cfg.SOLVER.WARMUP_ITERS = 0.01, 50, 10
    cfg.SOLVER.POLY_LR_CONSTANT_ENDING = 0.05
    ref = jax_build_lr_scheduler(jax_cfg_from_port(cfg))
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.01)
    sched = build_lr_scheduler(cfg, opt)
    for it in range(55):
        assert opt.param_groups[0]["lr"] == ref(it), (it, opt.param_groups[0]["lr"], ref(it))
        opt.step()
        sched.step()


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clipped"])
def test_adam_steps_match_optax(clip):
    from detectron2_tpu_torch.projects.panoptic_deeplab import add_panoptic_deeplab_config
    from detectron2_tpu_torch.solver import AdamWWithGradientClipping
    from _torch_port import jax_cfg_from_port

    cfg = get_cfg()
    add_panoptic_deeplab_config(cfg)
    s = cfg.SOLVER
    s.BASE_LR, s.MAX_ITER, s.WARMUP_ITERS = 0.001, 20, 2
    s.WEIGHT_DECAY, s.WEIGHT_DECAY_NORM, s.WEIGHT_DECAY_BIAS = 1e-2, 0.0, 1e-3
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE, s.CLIP_GRADIENTS.CLIP_VALUE = clip, "norm", 5.0
    assert s.OPTIMIZER == "ADAM"
    rng = np.random.RandomState(11)
    conv = Conv2d(3, 32, 3, padding=1, bias=True, norm=get_norm("GN", 32))
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(t(rng.standard_normal(p.shape).astype(np.float32) * 0.01))
    opt = build_optimizer(cfg, conv)
    assert type(opt) is (AdamWWithGradientClipping if clip else torch.optim.AdamW)
    sched = build_lr_scheduler(cfg, opt)
    jax_tree = lambda w, b, g, beta: {"conv": {"Conv_0": {"kernel": w.transpose(2, 3, 1, 0), "bias": b},  # noqa: E731
                                              "norm": {"GroupNorm_0": {"scale": g, "bias": beta}}}}
    params = jax_tree(*(n(p).copy() for p in (conv.weight, conv.bias, conv.norm.weight, conv.norm.bias)))
    tx = jax_build_optimizer(jax_cfg_from_port(cfg), params)
    state = tx.init(params)
    for _ in range(2):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in (conv.weight, conv.bias, conv.norm.weight,
                                                                           conv.norm.bias)]
        for p, g in zip((conv.weight, conv.bias, conv.norm.weight, conv.norm.bias), grads):
            p.grad = t(g)
        opt.step()
        sched.step()
        updates, state = tx.update(jax_tree(*grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    close(conv.weight, params["conv"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1), 0, 1e-6)
    close(conv.bias, params["conv"]["Conv_0"]["bias"], 0, 1e-6)
    close(conv.norm.weight, params["conv"]["norm"]["GroupNorm_0"]["scale"], 0, 1e-6)
    close(conv.norm.bias, params["conv"]["norm"]["GroupNorm_0"]["bias"], 0, 1e-6)


# ------------------------------------------------------ golden, yamls, data
def test_deeplab_golden_through_the_d2_loader(tmp_path):
    g = load_golden("e2e_deeplab_r50")
    path = tmp_path / "deeplab.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    cfg = golden_deeplab_config()
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    report = load_d2_checkpoint(model, str(path))
    assert report.splitlines() == ["Loaded 319/319 tensors from the checkpoint."], report
    out = model({"image": t(g["image"][None]), "image_sizes": torch.tensor([[256, 256]])})
    errs = compare_with_deeplab_golden(out, g)
    assert errs["sem_seg"] < 5e-3


@pytest.mark.parametrize("yaml", YAMLS, ids=[os.path.basename(y) for y in YAMLS])
def test_deeplab_yamls_build(yaml):
    cfg = get_cfg()
    dl.add_deeplab_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    model = build_model(cfg, device="meta")
    assert type(model.sem_seg_head).__name__ == ("DeepLabV3Head" if "v3_R" in yaml else "DeepLabV3PlusHead")
    assert [b.conv2.dilation[0] for b in model.backbone.res5] == [2, 4, 8]
    assert model.backbone.stem.conv1.weight.shape == (64, 3, 3, 3) and len(model.backbone.res4) == 23
    for name in tuple(cfg.DATASETS.TRAIN) + tuple(cfg.DATASETS.TEST):
        assert name in DatasetCatalog.list(), name
    assert cfg.SOLVER.LR_SCHEDULER_NAME == "WarmupPolyLR"


def test_category_area_crop_draws_as_the_jax_policy():
    rng = np.random.RandomState(12)
    sem = rng.randint(0, 3, (60, 90))
    sem[:40, :70] = 1  # one class dominates most windows
    image = np.zeros((60, 90, 3), np.uint8)
    for max_area in (1.0, 0.6):
        np.random.seed(13)
        ref = JaxCategoryAreaCrop("absolute", (30, 40), max_area, 255).get_transform(image, sem)
        aug = T.RandomCrop_CategoryAreaConstraint("absolute", (30, 40), max_area, 255)
        aug.set_rng(np.random.RandomState(13))
        ours = aug.get_transform(image, sem)
        assert (ours.x0, ours.y0, ours.w, ours.h) == (ref.x0, ref.y0, ref.w, ref.h), max_area
