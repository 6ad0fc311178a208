"""The port's TridentNet against the JAX package's, in float32 on the CPU,
weights carried across by ``convert_jax_params`` (its ``res4_{b}``,
``conv2`` and ``conv2_norm`` scopes).

- ``TridentConv``: one weight for the three dilations, its outputs and the
  gradient of the shared weight (the sum of the branches');
  ``init_weights`` draws it as the JAX initializer does.
- ``TridentBottleneckBlock`` (FrozenBN, and BN with batch statistics): the
  three outputs and, in training, every running statistic after the
  block's norms were called once a branch, in branch order, and every
  gradient.
- ``TridentResNet`` (depth 50 at narrow widths, res3 and res4 out): its
  five outputs.
- ``TridentRPN``: training over the three branch levels (losses and the
  proposals of the union), inference over ``res4`` alone.
- A tiny TridentNet R50-C4 (``Res5ROIHeads``): its detections, and its
  losses and every gradient with both packages' samplers on the same draws.
- ``tests/goldens/e2e_tridentnet_r50.npz`` through the d2 loader at its
  parity test's bounds; the three TridentNet yamls on the meta device.

Tolerances: activations and running statistics within 1e-5 * max|ref| +
1e-6; losses rtol 1e-4; gradients within 1e-4 * max|g_ref| + 1e-6 for the
modules and 1e-3 * max|g_ref| + 1e-6 for the model
(``_torch_port.assert_train_step_matches``); detections as
``_torch_port.assert_detections_match`` (scores rtol 1e-4 atol 1e-5, boxes
1e-3 px, classes and validity equal).
"""

import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_model,
    jax_random_variables,
    jax_train_step,
    load_golden,
    n,
    port_model,
    t,
)
from detectron2_tpu.projects import tridentnet as jtn
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint, load_state_dict_report
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.layers import nchw, nhwc
from detectron2_tpu_torch.modeling import build_model, init_weights
from detectron2_tpu_torch.projects import tridentnet as tn
from detectron2_tpu_torch.testing import (
    compare_with_tridentnet_golden,
    golden_state_dict,
    golden_tridentnet_config,
    synthetic_train_batch,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = (
    "TridentNet/tridentnet_fast_R_50_C4_1x.yaml",
    "TridentNet/tridentnet_fast_R_50_C4_3x.yaml",
    "TridentNet/tridentnet_fast_R_101_C4_3x.yaml",
)
STATS = ("running_mean", "running_var")


def close(ours, ref, rtol=1e-5, atol=1e-6):
    """Within ``rtol * max|ref| + atol``."""
    ours, ref = n(ours).astype(np.float64), np.asarray(ref).astype(np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


def converted(tree):
    return convert_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def load_module(module, variables):
    state = converted(variables)
    report = load_state_dict_report(module, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(module.state_dict())} tensors from the checkpoint."], report
    return module


def assert_grads(module, ref_grads, rtol=1e-4):
    for name, p in module.named_parameters():
        g = n(ref_grads[name]).astype(np.float64)
        err = np.abs(n(p.grad).astype(np.float64) - g).max()
        assert err <= rtol * np.abs(g).max() + 1e-6, (name, err, np.abs(g).max())


def jax_train(module, variables, xs, projs):
    """The JAX module in training: the loss ``sum_i sum(out_i * proj_i)``,
    its parameter gradients and the updated ``batch_stats``, as the port's
    names."""

    def loss_fn(params):
        outs, updated = module.apply({**variables, "params": params}, xs, train=True, mutable=["batch_stats"])
        if isinstance(outs, dict):
            outs = [outs[k] for k in sorted(outs)]
        return sum(jnp.sum(o * p) for o, p in zip(outs, projs)), updated

    (loss, updated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), converted({"params": grads}), converted(updated)


# ------------------------------------------------------------------ modules
def test_trident_conv_shares_one_weight():
    rng = np.random.RandomState(0)
    xs = [rng.standard_normal((2, 11, 9, 4)).astype(np.float32) for _ in range(3)]
    jm = jtn.TridentConv(features=6, kernel_size=3, dilations=(1, 2, 3))
    v = jax.tree_util.tree_map(
        jnp.asarray, {"params": {"kernel": rng.standard_normal((3, 3, 4, 6)).astype(np.float32) * 0.3}})
    pm = tn.TridentConv(4, 6, 3, dilations=(1, 2, 3), bias=False)
    pm.load_state_dict(converted(v))
    assert [k for k, _ in pm.named_parameters()] == ["weight"]
    ref = jm.apply(v, [jnp.asarray(x) for x in xs])
    outs = pm([nchw(t(x)) for x in xs], False)
    for o, r in zip(outs, ref):
        assert tuple(o.shape) == (2, 6, 11, 9)
        close(nhwc(o), r)
    projs = [rng.standard_normal((2, 11, 9, 6)).astype(np.float32) for _ in range(3)]
    grads = jax.grad(lambda p: sum(jnp.sum(o * q) for o, q in zip(jm.apply({"params": p}, [jnp.asarray(x) for x in xs]),
                                                               projs)))(v["params"])
    sum((nhwc(o) * t(q)).sum() for o, q in zip(pm([nchw(t(x)) for x in xs], False), projs)).backward()
    assert_grads(pm, converted({"params": grads}))
    # its own initializer, the JAX kernel's variance_scaling(2, fan_out,
    # truncated normal); init_weights draws it as every ResNet conv (msra)
    torch.manual_seed(0)
    w = tn.TridentConv(256, 256, 3, bias=False).weight.detach()
    std = np.sqrt(2.0 / (256 * 9))
    assert abs(w.std().item() - std) < 0.02 * std and w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    seeded = [tn.TridentConv(256, 256, 3, bias=False) for _ in range(2)]
    for m in seeded:
        init_weights(m, torch.Generator().manual_seed(0))
    assert torch.equal(seeded[0].weight, seeded[1].weight)
    assert abs(seeded[0].weight.std().item() - std) < 0.02 * std and seeded[0].weight.abs().max().item() > 3 * std


@pytest.mark.parametrize("norm", ["FrozenBN", "BN"])
def test_trident_bottleneck_block(norm):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 10, 12, 16)).astype(np.float32)
    xs = [x, x * 0.5, -x]
    kw = dict(in_channels=16, out_channels=32, bottleneck_channels=8, stride=2, norm=norm, stride_in_1x1=True)
    jm = jtn.TridentBottleneckBlock(dilations=(1, 2, 3), **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(a) for a in xs], train=False))
    leaf = lambda path, s: jnp.asarray(  # noqa: E731
        np.abs(rng.standard_normal(s.shape)) * 0.2 + 0.5 if getattr(path[-1], "key", "") in ("var", "running_var")
        else rng.standard_normal(s.shape) * 0.3, jnp.float32)
    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    pm = load_module(tn.TridentBottleneckBlock(kw.pop("in_channels"), kw.pop("out_channels"), dilations=(1, 2, 3), **kw), v)
    assert [d for d in pm.conv2.dilations] == [1, 2, 3] and pm.conv2.norm is not None
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(v, [jnp.asarray(a) for a in xs])
    with torch.no_grad():
        outs = pm([nchw(t(a)) for a in xs], False)
    for o, r in zip(outs, ref):
        close(nhwc(o), r)
    projs = [np.abs(rng.standard_normal(np.shape(r))).astype(np.float32) for r in ref]
    loss, grads, updated = jax_train(jm, v, [jnp.asarray(a) for a in xs], projs)
    outs = pm([nchw(t(a)) for a in xs], True)
    total = sum((nhwc(o) * t(p)).sum() for o, p in zip(outs, projs))
    assert abs(total.item() - loss) <= 1e-5 * abs(loss)
    total.backward()
    assert_grads(pm, grads)
    state = pm.state_dict()
    stats = [k for k in state if k.endswith(STATS)]
    assert len(stats) == 2 * 4
    for k in stats:  # BN: three updates a norm, branch 0 first; FrozenBN: unchanged
        close(state[k], updated[k] if norm == "BN" else converted(v)[k])


def backbone_cfg(norm="FrozenBN", out=("res3", "res4")):
    cfg = get_cfg()
    tn.add_tridentnet_config(cfg)
    r = cfg.MODEL.RESNETS
    r.DEPTH, r.NORM, r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP = 50, norm, 16, 32, 8
    r.OUT_FEATURES = list(out)
    cfg.MODEL.BACKBONE.NAME = "build_trident_resnet_backbone"
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.DEVICE = "cpu"
    return cfg


# ---------------------------------------------------------------- the RPN
def tiny_cfg():
    cfg = backbone_cfg()
    m = cfg.MODEL
    m.PROPOSAL_GENERATOR.NAME = "TridentRPN"
    m.ANCHOR_GENERATOR.SIZES = [[32, 64, 128]]
    m.RPN.IN_FEATURES = ["res4_b0", "res4_b1", "res4_b2"]
    m.RPN.PRE_NMS_TOPK_TRAIN, m.RPN.POST_NMS_TOPK_TRAIN, m.RPN.PRE_NMS_TOPK_TEST, m.RPN.POST_NMS_TOPK_TEST = 64, 32, 64, 32
    m.ROI_HEADS.NAME = "Res5ROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["res4"]
    m.ROI_HEADS.NUM_CLASSES = 4
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_trident_rpn_levels(train):
    """Training runs over the three branch levels, inference over ``res4``
    alone: the same proposals (and losses) as the JAX TridentRPN, and
    inference does not read the other branches."""
    from detectron2_tpu.layers.shape_spec import ShapeSpec as JaxShapeSpec
    from detectron2_tpu.modeling.proposal_generator.build import build_proposal_generator as jax_build_rpn
    from detectron2_tpu_torch.layers import ShapeSpec
    from detectron2_tpu_torch.modeling.proposal_generator import build_rpn

    cfg = tiny_cfg()
    names = ("res4", "res4_b0", "res4_b1", "res4_b2")
    jr = jax_build_rpn(jax_cfg_from_port(cfg), {k: JaxShapeSpec(channels=32, stride=16) for k in names})
    pr = build_rpn(cfg, {k: ShapeSpec(channels=32, stride=16) for k in names})
    assert type(pr) is tn.TridentRPN and pr.trident_fast
    assert pr._select_in_features(train) == (("res4_b0", "res4_b1", "res4_b2") if train else ("res4",))
    rng = np.random.RandomState(4)
    feats = {k: rng.standard_normal((2, 6, 8, 32)).astype(np.float32) for k in names[1:]}
    feats["res4"] = feats["res4_b1"]
    sizes = np.asarray([[96, 128], [90, 120]], np.int32)
    batch = synthetic_train_batch(B=2, H=96, W=128, num_classes=4, seed=5)
    jf = {k: jnp.asarray(x) for k, x in feats.items()}
    shapes = jax.eval_shape(lambda: jr.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, jf,
                                            jnp.asarray(sizes), train=False))
    v = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape) * 0.1, jnp.float32), shapes)
    pr.load_state_dict({k[len("proposal_generator."):]: x for k, x in
                        converted({c: {"proposal_generator": d} for c, d in v.items()}).items()})
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=6).patch(mp)
        if train:
            (ref, ref_losses) = jax.jit(lambda v: jr.apply(
                v, jf, jnp.asarray(sizes), jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["gt_valid"]), train=True,
                rngs={"sampling": jax.random.PRNGKey(0)}))(v)
            out, losses = pr.forward_train({k: t(x) for k, x in feats.items()}, t(sizes), t(batch["gt_boxes"]),
                                           t(batch["gt_valid"]))
            assert set(losses) == set(ref_losses) == {"loss_rpn_cls", "loss_rpn_loc"}
            for k in losses:
                assert abs(losses[k].item() - float(ref_losses[k])) <= 1e-4 * abs(float(ref_losses[k])), k
        else:
            ref, _ = jax.jit(lambda v: jr.apply(v, jf, jnp.asarray(sizes), train=False))(v)
            with torch.no_grad():
                out = pr({k: t(x) for k, x in feats.items()}, t(sizes))
                moved = pr({**{k: t(x) for k, x in feats.items()}, "res4_b0": t(feats["res4_b0"] * 3.0)}, t(sizes))
            for a, b in zip(out, moved):
                assert torch.equal(a, b)  # the other branches are not read
    np.testing.assert_array_equal(n(out[2]), np.asarray(ref[2]))
    close(torch.where(out[2][..., None], out[0], torch.zeros_like(out[0])),
          np.where(np.asarray(ref[2])[..., None], np.asarray(ref[0]), 0.0), 0, 1e-3)
    close(torch.where(out[2], out[1], torch.zeros_like(out[1])), np.where(np.asarray(ref[2]), np.asarray(ref[1]), 0.0))


# ------------------------------------------------------ golden, yamls
def test_tridentnet_golden_through_the_d2_loader(tmp_path):
    """d2's ``res4.{b}.conv2.weight`` and ``res4.{b}.conv2.norm.*`` load by
    name into the trident conv and its norm."""
    g = load_golden("e2e_tridentnet_r50")
    path = tmp_path / "tridentnet.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    cfg = golden_tridentnet_config()
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    report = load_d2_checkpoint(model, str(path))
    assert report.splitlines() == ["Loaded 275/275 tensors from the checkpoint."], report
    assert "backbone.res4.0.conv2.norm.running_var" in golden_state_dict(g)
    features = {}
    model.backbone.register_forward_hook(lambda m, args, out: features.update(out))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # the plain RoIAlign of 100 rois over 1024 channels is most of this forward
    try:
        out = model({"image": t(g["image"][None].astype(np.float32)), "image_sizes": torch.tensor([[320, 320]])})
    finally:
        torch.set_num_threads(threads)
    errs = compare_with_tridentnet_golden(features, out, g)
    assert errs["matched"] >= 25


@pytest.mark.parametrize("yaml", YAMLS, ids=[os.path.basename(y) for y in YAMLS])
def test_tridentnet_yamls_build(yaml):
    from detectron2_tpu_torch.modeling.roi_heads.roi_heads import Res5ROIHeads

    cfg = get_cfg()
    tn.add_tridentnet_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    model = build_model(cfg, device="meta")
    assert type(model.backbone) is tn.TridentResNet and type(model.proposal_generator) is tn.TridentRPN
    assert type(model.roi_heads) is Res5ROIHeads and model.proposal_generator.in_features == ("res4_b0", "res4_b1", "res4_b2")
    assert len(model.backbone.res4) == (23 if "R_101" in yaml else 6)
    assert model.backbone.res4[0].conv2.weight.shape == (256, 256, 3, 3)
    assert not cfg.MODEL.MASK_ON and model.roi_heads.mask_head is None


# ------------------------------------------------------------ the model
def tiny_batches():
    rng = np.random.RandomState(0)
    batch = {"image": (rng.rand(2, 64, 64, 3) * 255).astype(np.float32), "image_sizes": np.asarray([[64, 64]] * 2, np.int32)}
    return batch, synthetic_train_batch(B=2, H=64, W=64, num_classes=4, seed=2)


def _jax_reference():
    """The tiny TridentNet R50-C4's JAX side, run once, jitted: its seeded
    variables, the detections of one batch with the backbone's outputs
    captured on the way, and the losses and gradients of one training
    batch (samplers on ``SameDraws(4)``); as numpy."""
    jm = jax_model(tiny_cfg())
    v = jax_random_variables(jm, seed=0, scale=0.1)
    batch, train_batch = tiny_batches()
    trunk = lambda module, method: isinstance(module, jtn.TridentResNet) and method == "__call__"  # noqa: E731
    with ThreadPoolExecutor(2) as pool, pytest.MonkeyPatch.context() as mp:  # the two compile side by side
        forward = pool.submit(jax.jit(lambda v, b: jm.apply(v, b, train=False, capture_intermediates=trunk)),
                              v, {k: jnp.asarray(x) for k, x in batch.items()})
        SameDraws(seed=4).patch(mp)
        losses, grads = jax_train_step(jm, v, train_batch)
        ref, state = forward.result()
    return {"variables": jax.tree_util.tree_map(np.asarray, v), "ref": jax.tree_util.tree_map(np.asarray, ref),
            "features": jax.tree_util.tree_map(np.asarray, state["intermediates"]["backbone"]["__call__"][0]),
            "losses": losses, "grads": {k: n(g) for k, g in grads.items()}}


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """``_jax_reference`` in a process of its own, started with the module:
    the tests before the model's run beside it."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def tiny(jax_reference):
    """The tiny TridentNet R50-C4 and its batches, beside the JAX side's
    variables and results."""
    batch, train_batch = tiny_batches()
    return {"cfg": tiny_cfg(), "batch": batch, "train_batch": train_batch, **jax_reference.result()}


def test_trident_resnet_five_outputs(tiny):
    """res3, the three branches and ``res4`` (the middle one), each as the
    JAX trunk gives it in the tiny model's forward."""
    model = port_model(tiny["cfg"], tiny["variables"])
    pm = model.backbone
    assert pm.size_divisibility == 16 and pm.test_branch_idx == 1
    assert set(pm.output_shape()) == {"res2", "res3", "res4", "res4_b0", "res4_b1", "res4_b2"}
    assert [b.conv2.dilations for b in pm.res4] == [(1, 2, 3)] * 6
    with torch.no_grad():
        out = pm(model.preprocess_image(t(tiny["batch"]["image"])))
    ref = tiny["features"]
    assert sorted(out) == sorted(ref) == ["res3", "res4", "res4_b0", "res4_b1", "res4_b2"]
    for k in ref:
        close(out[k], ref[k])
    assert out["res4"] is out["res4_b1"]


def test_tiny_tridentnet_detections_match_jax(tiny):
    model = port_model(tiny["cfg"], tiny["variables"])
    assert type(model.proposal_generator) is tn.TridentRPN and type(model.backbone) is tn.TridentResNet
    out = model({k: t(x) for k, x in tiny["batch"].items()})
    ref = tiny["ref"]
    assert "pred_masks" not in out
    assert set(out) == set(ref) and ref["valid"].sum() >= 10
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)


def test_tiny_tridentnet_losses_and_gradients_match_jax(tiny):
    model = port_model(tiny["cfg"], tiny["variables"])
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=4).patch(mp)
        losses = assert_train_step_matches(model.train(), tiny["train_batch"], tiny["losses"], tiny["grads"])
    assert set(losses) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    # the shared weight's gradient gathers all three branches' (training reads every branch level)
    assert model.backbone.res4[0].conv2.weight.grad.abs().sum() > 0
