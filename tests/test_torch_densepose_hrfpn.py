"""HRNet and HRFPN in the port against the JAX package, on the CPU in
float32, with the JAX variables carried across by ``convert_jax_params``:

- the two blocks (with the projected shortcut), one HighResolutionModule
  (three branches, the whole fuse mesh) and the whole HRNet + HRFPN, in
  eval (running statistics) and in train mode (batch statistics, the
  running statistics moved as flax moves them): outputs and input
  gradients (a seeded cotangent) within 1e-5 * max|ref| for a block or a
  module and 1e-4 * max|ref| for the whole backbone (its input gradient
  in float64 in both packages, see the test). The backbone's input,
  72x136 and 136x200, is no multiple of 64: every crop (the fuse mesh's,
  the concat's and the levels') cuts rows or columns;
- the HRFPN golden (``tests/goldens/hrfpn_backbone.npz``, d2's names)
  through the d2 ``.pkl`` loader, within 5e-3 (the JAX test's bound);
- the four HRFPN yamls build on the meta device, with five box-pool levels.

The tiny HRFPN DensePose R-CNN is ``tests/test_torch_densepose_hrfpn_rcnn.py``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.config import enable_x64  # a scoped switch; the flag is global otherwise

from _torch_port import (
    jax_module_random_variables,
    load_golden,
    load_jax_variables,
    n,
    t,
)

from detectron2_tpu.projects.densepose.hrfpn import HRFPN as JaxHRFPN
from detectron2_tpu.projects.densepose.hrnet import _HighResolutionModule as JaxModule
from detectron2_tpu.projects.densepose.hrnet import _HRBasicBlock as JaxBasic
from detectron2_tpu.projects.densepose.hrnet import _HRBottleneck as JaxBottleneck
from detectron2_tpu_torch.checkpoint import DetectionCheckpointer, convert_jax_params
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.layers import nchw, nhwc
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone import build_backbone, padding_constraints
from detectron2_tpu_torch.projects.densepose import add_densepose_config
from detectron2_tpu_torch.projects.densepose.hrfpn import HRFPN
from detectron2_tpu_torch.projects.densepose.hrnet import HighResolutionModule, HRBasicBlock, HRBottleneck
from detectron2_tpu_torch.testing import golden_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_RTOL, BACKBONE_RTOL = 1e-5, 1e-4


def hrnet_cfg(widths=(8, 16, 32, 64), levels=5, out=32, blocks=1):
    """A narrow HRNet + HRFPN config: one module a stage, ``blocks`` BASIC
    blocks a branch."""
    cfg = get_cfg()
    add_densepose_config(cfg)
    h = cfg.MODEL.HRNET
    for k, stage in enumerate((h.STAGE2, h.STAGE3, h.STAGE4), start=2):
        stage.NUM_MODULES = 1
        stage.NUM_BLOCKS = [blocks] * k
        stage.NUM_CHANNELS = list(widths[:k])
    h.HRFPN.OUT_CHANNELS = out
    cfg.MODEL.BACKBONE.NAME = "build_hrfpn_backbone"
    cfg.MODEL.ROI_HEADS.IN_FEATURES = [f"p{i + 1}" for i in range(levels)]
    return cfg


def _pytree(x, fn):
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [fn(v) for v in x]
    return fn(x)


def _leaves(x):
    return list(x.values()) if isinstance(x, dict) else list(x) if isinstance(x, (list, tuple)) else [x]


def jax_forward(module, variables, x, train):
    """The JAX module's outputs on ``x`` and, when ``train``, its moved
    running statistics (jitted)."""
    if train:
        f = jax.jit(lambda v, a: module.apply(v, a, train=True, mutable=["batch_stats"]))
        out, updates = f(variables, jnp.asarray(x))
    else:
        out, updates = jax.jit(lambda v, a: module.apply(v, a, train=False))(variables, jnp.asarray(x)), {}
    return _pytree(out, np.asarray), jax.tree_util.tree_map(np.asarray, updates)


def jax_forward_and_vjp(module, variables, x, train, seed):
    """The JAX module's outputs on ``x`` (an NHWC array or a list of them),
    its moved running statistics when ``train``, and the input gradient of
    ``sum(out * cot)`` for a seeded normal cotangent ``cot``."""
    args = _pytree(x, jnp.asarray)

    def f(a):
        if train:
            return module.apply(variables, a, train=True, mutable=["batch_stats"])
        return module.apply(variables, a, train=False), {}

    out, vjp, updates = jax.vjp(jax.jit(f), args, has_aux=True)
    rng = np.random.RandomState(seed)
    cot = _pytree(out, lambda o: rng.standard_normal(o.shape).astype(o.dtype))
    (grad,) = vjp(_pytree(cot, jnp.asarray))
    return _pytree(out, np.asarray), jax.tree_util.tree_map(np.asarray, updates), _pytree(grad, np.asarray), cot


def assert_close(ours, ref, rtol, what):
    assert tuple(ours.shape) == ref.shape, (what, tuple(ours.shape), ref.shape)
    err = np.abs(n(ours) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def assert_running_stats(model, updates, rtol=1e-5):
    stats = convert_jax_params(updates)
    own = model.state_dict()
    assert len(stats) == 2 * sum(1 for k in own if k.endswith("running_mean")), len(stats)
    for name, value in stats.items():
        np.testing.assert_allclose(n(own[name]), n(value), rtol=rtol, atol=1e-6, err_msg=name)


def run_port(model, x, cot, train, nhwc_io):
    """The port module's outputs on ``x`` and the input gradient of
    ``sum(out * cot)``; block-level modules work on NCHW maps
    (``nhwc_io`` False) and get the NHWC arrays through views."""
    leaves = [t(v).requires_grad_(True) for v in _leaves(x)]
    inp = leaves[0] if not isinstance(x, (list, tuple)) else leaves
    if not nhwc_io:
        inp = _pytree(inp, nchw)
    out = model(inp, train)
    if not nhwc_io:
        out = _pytree(out, nhwc)
    total = sum((o * t(c)).sum() for o, c in zip(_leaves(out), _leaves(cot)))
    total.backward()
    return out, [leaf.grad for leaf in leaves]


BLOCKS = [
    ("basic", lambda: JaxBasic(planes=16, downsample=True), lambda: HRBasicBlock(8, 16, downsample=True), (2, 12, 20, 8)),
    ("basic_identity", lambda: JaxBasic(planes=8), lambda: HRBasicBlock(8, 8), (2, 12, 20, 8)),
    ("bottleneck", lambda: JaxBottleneck(planes=8, downsample=True), lambda: HRBottleneck(16, 8, downsample=True),
     (2, 12, 20, 16)),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name, jax_block, port_block, shape", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_blocks_match_jax(name, jax_block, port_block, shape, train):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jm = jax_block()
    variables = jax_module_random_variables(jm, x, seed=2, scale=0.3)
    ref, updates, grad, cot = jax_forward_and_vjp(jm, variables, x, train, seed=3)
    model = load_jax_variables(port_block(), variables)
    out, (g,) = run_port(model, x, cot, train, nhwc_io=False)
    assert_close(out, ref, BLOCK_RTOL, "out")
    assert_close(g, grad, BLOCK_RTOL, "grad")
    if train:
        assert_running_stats(model, updates)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_high_resolution_module_matches_jax(train):
    rng = np.random.RandomState(4)
    # 17x23 at the finest branch: the coarser ones are 9x12 and 5x6, so the
    # upsampled maps overhang the finer ones and are cropped
    xs = [rng.randn(2, 17, 23, 8).astype(np.float32), rng.randn(2, 9, 12, 16).astype(np.float32),
          rng.randn(2, 5, 6, 32).astype(np.float32)]
    jm = JaxModule(block="BASIC", num_blocks=(1, 2, 1), in_channels=(8, 16, 32), num_channels=(8, 16, 32))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, [jnp.asarray(a) for a in xs]))
    vrng = np.random.RandomState(5)

    def leaf(path, sds):
        v = vrng.standard_normal(sds.shape).astype(np.float32) * 0.3
        return jnp.asarray(np.abs(v) + 0.5 if getattr(path[-1], "key", None) == "var" else v)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    ref, updates, grad, cot = jax_forward_and_vjp(jm, variables, xs, train, seed=6)
    model = load_jax_variables(HighResolutionModule("BASIC", (1, 2, 1), (8, 16, 32), (8, 16, 32)), variables)
    assert [type(m).__name__ for m in model.fuse_layers[2][0]] == ["Sequential", "Sequential"]
    out, grads = run_port(model, xs, cot, train, nhwc_io=False)
    for k, (o, r) in enumerate(zip(out, ref)):
        assert_close(o, r, BLOCK_RTOL, f"out{k}")
    for k, (g, r) in enumerate(zip(grads, grad)):
        assert_close(g, r, BLOCK_RTOL, f"grad{k}")
    if train:
        assert_running_stats(model, updates)


@pytest.mark.parametrize("hw, train", [((72, 136), False), ((136, 200), True)], ids=["72x136-eval", "136x200-train"])
def test_hrnet_hrfpn_backbone_matches_jax(hw, train):
    cfg = hrnet_cfg(levels=5 if hw[0] >= 128 else 4)
    x = np.random.RandomState(7).randn(2, *hw, 3)
    jm = JaxHRFPN.from_config(cfg)
    variables = jax_module_random_variables(jm, x.astype(np.float32), seed=8, scale=0.3)
    ref, updates = jax_forward(jm, variables, x.astype(np.float32), train)
    model = load_jax_variables(build_backbone(cfg), variables)
    assert isinstance(model, HRFPN) and padding_constraints(model) == {"size_divisibility": 32}
    with torch.no_grad():
        out = model(t(x.astype(np.float32)), train)
    assert set(out) == set(ref) == set(model.output_shape())
    # every level is 2^i times the deepest, short of the input's /4 map
    deepest = ref[f"p{len(ref)}"].shape[1:3]
    for i, key in enumerate(sorted(ref)):
        assert ref[key].shape[1:3] == tuple(d * 2 ** (len(ref) - 1 - i) for d in deepest)
        assert_close(out[key], ref[key], BACKBONE_RTOL, key)
    assert ref["p1"].shape[1] < hw[0] // 4
    if train:
        assert_running_stats(model, updates, BACKBONE_RTOL)
    # the input gradient in float64 in both packages: in float32 a ReLU input
    # within rounding of zero flips its derivative, and BN over the deepest
    # levels' few values per channel amplifies rounding, which moves the
    # float32 gradient of either package by up to 8% of its largest value
    # from the float64 one at some seeds
    with enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v), jnp.float64), variables)
        _, _, grad, cot = jax_forward_and_vjp(jm, v64, x, train, seed=9)
    model64 = load_jax_variables(build_backbone(cfg), variables).double()
    _, (g,) = run_port(model64, x, cot, train, nhwc_io=True)
    assert g.dtype == torch.float64
    assert_close(g, grad, BACKBONE_RTOL, "grad")


def test_hrfpn_reproduces_the_golden_through_the_d2_loader(tmp_path):
    golden = load_golden("hrfpn_backbone")
    cfg = hrnet_cfg(widths=(16, 32, 64, 128), out=64, blocks=2)
    cfg.MODEL.HRNET.STAGE3.NUM_MODULES = 2
    model = build_backbone(cfg)
    path = tmp_path / "hrfpn.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "golden"}, f)
    checkpointer = DetectionCheckpointer(model)
    checkpointer.load(str(path))
    assert checkpointer.last_report.splitlines() == [
        f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."
    ], checkpointer.last_report
    with torch.no_grad():
        out = model(t(golden["image"][None].astype(np.float32)))
    for i in range(5):
        ref = golden[f"feat_p{i + 1}"].transpose(0, 2, 3, 1)
        assert tuple(out[f"p{i + 1}"].shape) == ref.shape
        err = np.abs(n(out[f"p{i + 1}"]) - ref).max()
        assert err < 5e-3, (i, err)


HRFPN_YAMLS = [
    "densepose_rcnn_HRFPN_HRNet_w32_s1x.yaml",
    "densepose_rcnn_HRFPN_HRNet_w40_s1x.yaml",
    "densepose_rcnn_HRFPN_HRNet_w48_s1x.yaml",
    "quick_schedules/densepose_rcnn_HRFPN_HRNet_w32_instant_test.yaml",
]


@pytest.mark.parametrize("yaml", HRFPN_YAMLS)
def test_hrfpn_yamls_build(yaml):
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, "configs", "DensePose", yaml))
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert isinstance(model.backbone, HRFPN)
    assert list(model.backbone.output_shape()) == ["p1", "p2", "p3", "p4", "p5"]
    assert len(model.roi_heads.box_pooler.scales) == 5
    widths = {"w32": 32, "w40": 40, "w48": 48}[yaml.split("HRNet_")[1][:3]]
    assert model.backbone.in_channels == [widths * 2**i for i in range(4)]
