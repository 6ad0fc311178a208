"""The port's norms with batch statistics against the JAX package's
(``detectron2_tpu/layers/batch_norm.py``: ``BatchNorm`` over flax's
``nn.BatchNorm``, ``SyncBatchNorm``, ``CycleBatchNormList``, ``get_norm``),
on seeded numpy inputs on the CPU.

- Train mode (batch statistics): the output, the gradients of the input,
  weight and bias, and the updated running statistics, in float32 and
  bfloat16; eval mode (running statistics): the output. The running variance
  is flax's biased one, not ``torch.nn.BatchNorm2d``'s unbiased one.
- ``get_norm`` for every name of the JAX table, a callable and an unknown
  name; the train flag (not ``nn.Module.training``) selects the mode; d2's
  names; SyncBN refuses more than one process (ROADMAP A6).

Tolerances: float32 outputs and gradients max|diff| <= 2e-5 * max|ref| +
1e-6 (reductions over N, H, W in another order), running statistics <=
1e-5 * max|ref| + 1e-7. bfloat16 outputs and input gradients: both sides
compute in float32 and round once, so they differ by at most one bf16 ulp,
2^-7 * max|ref|; statistics and parameter gradients (float32) as above.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_port import n, t

from detectron2_tpu.layers import batch_norm as jax_bn
from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.layers import (
    BatchNorm2d,
    Conv2d,
    CycleBatchNormList,
    FrozenBatchNorm2d,
    GroupNorm,
    LayerNorm,
    NaiveSyncBatchNorm,
    SyncBatchNorm,
    get_bn_modules,
    get_norm,
)

torch.set_num_threads(1)

N, H, W, C = 4, 6, 5, 8
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((N, H, W, C)) * 2.0 + rng.standard_normal(C) * 3.0).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
    mean = rng.standard_normal(C).astype(np.float32)
    var = (np.abs(rng.standard_normal(C)) + 0.5).astype(np.float32)
    g = rng.standard_normal((N, H, W, C)).astype(np.float32)
    return x, scale, bias, mean, var, g


def _jax_variables(scale, bias, mean, var):
    return {"params": {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
            "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}}


def _port_bn(cls, scale, bias, mean, var):
    bn = cls(C)
    with torch.no_grad():
        bn.weight.copy_(t(scale))
        bn.bias.copy_(t(bias))
        bn.running_mean.copy_(t(mean))
        bn.running_var.copy_(t(var))
    return bn


def _nchw(x_nhwc, dtype):
    """NHWC numpy -> the port's channels_last NCHW tensor."""
    return t(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def _close(out, ref, rtol, atol=1e-6):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


@pytest.mark.parametrize("name", ["BatchNorm", "SyncBatchNorm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_mode_matches_flax(name, dtype):
    """Output, gradients and running statistics after one train call."""
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, mean, var, g = _inputs()
    jm = getattr(jax_bn, name)(features=C)
    variables = _jax_variables(scale, bias, mean, var)

    def f(params, xx):
        y, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx, train=True,
                          mutable=["batch_stats"])
        return y, upd

    xj = jnp.asarray(x).astype(jdt)
    y_ref, vjp_fn = jax.vjp(lambda p, xx: f(p, xx)[0], variables["params"], xj)
    gp_ref, gx_ref = vjp_fn(jnp.asarray(g).astype(y_ref.dtype))
    _, upd = f(variables["params"], xj)
    stats = upd["batch_stats"]["BatchNorm_0"]

    bn = _port_bn({"BatchNorm": BatchNorm2d, "SyncBatchNorm": SyncBatchNorm}[name], scale, bias, mean, var)
    xt = _nchw(x, tdt).requires_grad_(True)
    y = bn(xt, train=True)
    assert y.dtype == tdt and y.is_contiguous(memory_format=torch.channels_last)
    y.backward(_nchw(g, tdt))
    y_rtol = 2e-5 if dtype == "float32" else 2.0**-7
    _close(n(y.float().permute(0, 2, 3, 1)), np.asarray(y_ref, np.float32), y_rtol)
    _close(n(xt.grad.float().permute(0, 2, 3, 1)), np.asarray(gx_ref, np.float32), y_rtol)
    _close(n(bn.weight.grad), gp_ref["BatchNorm_0"]["scale"], 2e-5)
    _close(n(bn.bias.grad), gp_ref["BatchNorm_0"]["bias"], 2e-5)
    _close(n(bn.running_mean), stats["mean"], 1e-5, 1e-7)
    _close(n(bn.running_var), stats["var"], 1e-5, 1e-7)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_mode_matches_flax(dtype):
    tdt, jdt = DTYPES[dtype]
    x, scale, bias, mean, var, _ = _inputs(1)
    ref = jax_bn.BatchNorm(features=C).apply(_jax_variables(scale, bias, mean, var), jnp.asarray(x).astype(jdt), train=False)
    bn = _port_bn(BatchNorm2d, scale, bias, mean, var)
    y = bn(_nchw(x, tdt), train=False)
    assert y.dtype == tdt
    _close(n(y.float().permute(0, 2, 3, 1)), np.asarray(ref, np.float32), 2e-5 if dtype == "float32" else 2.0**-7)
    assert torch.equal(bn.running_mean, t(mean)) and torch.equal(bn.running_var, t(var))


def test_running_variance_is_flax_biased_not_torch_unbiased():
    """flax folds the biased batch variance into the running one;
    ``torch.nn.BatchNorm2d`` the unbiased n/(n-1) one. The port is flax's."""
    x, scale, bias, mean, var, _ = _inputs(2)
    bn = _port_bn(BatchNorm2d, scale, bias, mean, var)
    bn(_nchw(x, torch.float32), train=True)
    biased = x.reshape(-1, C).var(axis=0)
    np.testing.assert_allclose(n(bn.running_var), 0.9 * var + 0.1 * biased, rtol=1e-5)
    np.testing.assert_allclose(n(bn.running_mean), 0.9 * mean + 0.1 * x.reshape(-1, C).mean(axis=0), rtol=1e-5, atol=1e-6)
    rm, rv = t(mean).clone(), t(var).clone()
    F.batch_norm(_nchw(x, torch.float32), rm, rv, t(scale), t(bias), training=True, momentum=0.1, eps=1e-5)
    m = N * H * W
    assert np.abs(n(rv) - n(bn.running_var)).min() > 0
    np.testing.assert_allclose(n(rv) - n(bn.running_var), 0.1 * biased / (m - 1), rtol=1e-3)


def test_a_constant_channel_clamps_its_variance_at_zero():
    x = np.random.RandomState(3).standard_normal((N, C, H, W)).astype(np.float32)
    x[:, 2] = 7.25
    bn = BatchNorm2d(C)
    y = bn(torch.from_numpy(x), train=True)
    assert torch.isfinite(y).all() and bn.running_var[2] >= 0.9 and (y[:, 2] == 0).all()


@pytest.mark.parametrize("name", ["BN", "SyncBN", "nnSyncBN", "naiveSyncBN", "FrozenBN", "GN", "LN"])
def test_get_norm_follows_the_jax_table(name):
    """Each name builds the port's counterpart of the JAX module, with its
    eps; a BN's momentum is flax's 0.9 on the kept value."""
    expected = {"BatchNorm": BatchNorm2d, "SyncBatchNorm": SyncBatchNorm, "FrozenBatchNorm2d": FrozenBatchNorm2d,
                "GroupNorm": GroupNorm, "LayerNorm": LayerNorm}
    jax_factory = jax_bn.get_norm(name, 64)
    module = get_norm(name, 64)
    assert type(module) is expected[jax_factory.func.__name__]
    jax_module = jax_factory()
    assert module.eps == jax_module.eps
    if isinstance(module, BatchNorm2d):
        assert module.momentum == jax_module.momentum == 0.9 and module.num_features == 64
    assert sum(p.numel() for p in module.parameters()) + sum(b.numel() for b in module.buffers()) in (2 * 64, 4 * 64)


def test_get_norm_empty_callable_and_unknown():
    assert get_norm("", 8) is None and get_norm(None, 8) is None
    assert jax_bn.get_norm("", 8) is None and jax_bn.get_norm(None, 8) is None
    module = get_norm(lambda c: BatchNorm2d(c, eps=1e-3), 8)
    assert isinstance(module, BatchNorm2d) and module.eps == 1e-3 and module.num_features == 8
    for fn in (get_norm, jax_bn.get_norm):
        with pytest.raises(KeyError, match="Unknown norm type: XYZ"):
            fn("XYZ", 8)
    assert NaiveSyncBatchNorm is SyncBatchNorm and jax_bn.NaiveSyncBatchNorm is jax_bn.SyncBatchNorm


def test_the_train_flag_not_module_training_selects_batch_statistics():
    """``model.train()`` / ``.eval()`` change nothing; ``train=`` does. A BN
    called without the flag fails instead of guessing."""
    torch.manual_seed(0)
    conv = Conv2d(3, C, 3, padding=1, bias=False, norm=get_norm("SyncBN", C))
    x = torch.randn(2, 3, 7, 7)
    outs = {}
    start = {k: v.clone() for k, v in conv.state_dict().items()}
    for mode in ("train", "eval"):
        conv.load_state_dict(start)
        getattr(conv, mode)()
        before = conv.norm.running_mean.clone()
        outs[mode, False] = conv(x, train=False)
        assert torch.equal(conv.norm.running_mean, before)
        outs[mode, True] = conv(x, train=True)
        assert not torch.equal(conv.norm.running_mean, before)
    assert torch.equal(outs["train", False], outs["eval", False])
    assert torch.equal(outs["train", True], outs["eval", True])
    assert not torch.allclose(outs["eval", False], outs["eval", True])
    # batch statistics: each channel of the output has mean 0 and variance 1
    y = outs["eval", True]
    np.testing.assert_allclose(n(y.mean(dim=(0, 2, 3))), 0, atol=1e-5)
    np.testing.assert_allclose(n(y.var(dim=(0, 2, 3), unbiased=False)), 1, atol=1e-3)
    with pytest.raises(TypeError):
        conv.norm(x.new_zeros(2, C, 3, 3))
    with pytest.raises(TypeError):
        conv(x)


def _flag_takers():
    """Every layer that hands the train flag to a norm, carrying a SyncBN
    where it can, with an input of its shape."""
    from detectron2_tpu_torch.modeling.backbone.resnet import BasicBlock, BasicStem, BottleneckBlock
    from detectron2_tpu_torch.modeling.backbone.vit import _Stage
    from detectron2_tpu_torch.modeling.proposal_generator.rpn import StandardRPNHead
    from detectron2_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
    from detectron2_tpu_torch.modeling.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead
    from detectron2_tpu_torch.modeling.roi_heads.mask_head import MaskRCNNConvUpsampleHead

    nchw_in, nhwc_in = torch.randn(2, C, 8, 8), torch.randn(2, 8, 8, C)
    return {
        "Conv2d": (Conv2d(C, C, 3, padding=1, norm=get_norm("SyncBN", C)), nchw_in),
        "CycleBatchNormList": (CycleBatchNormList(2, C), nchw_in),
        "BasicStem": (BasicStem(C, C, norm="SyncBN"), nchw_in),
        "BasicBlock": (BasicBlock(C, 2 * C, stride=2, norm="SyncBN"), nchw_in),
        "BottleneckBlock": (BottleneckBlock(C, 2 * C, bottleneck_channels=C, stride=2, norm="SyncBN"), nchw_in),
        "simfp stage": (_Stage([(get_norm("SyncBN", C), True), (torch.nn.GELU(), False)]), nchw_in),
        "StandardRPNHead": (StandardRPNHead(C, 3, conv_dims=(-1, -1)), [nhwc_in]),
        "box head": (FastRCNNConvFCHead(C, 8, fc_dims=(16,), conv_dims=(C, C), conv_norm="SyncBN"), nhwc_in),
        "mask head": (MaskRCNNConvUpsampleHead(C, 3, conv_dim=C, num_conv=2, conv_norm="SyncBN"), nhwc_in),
        "keypoint head": (KRCNNConvDeconvUpsampleHead(C, 4, conv_dims=(C,)), nhwc_in),
    }


@pytest.mark.parametrize("name", ["Conv2d", "CycleBatchNormList", "BasicStem", "BasicBlock", "BottleneckBlock",
                                  "simfp stage", "StandardRPNHead", "box head", "mask head", "keypoint head"])
def test_every_layer_on_the_way_to_a_norm_needs_the_train_flag(name):
    """No default: a call without ``train`` raises instead of normalizing
    training batches with the running statistics; with the flag the BNs
    below update their running statistics in training only."""
    module, x = _flag_takers()[name]
    with pytest.raises(TypeError):
        module(x)
    start = {k: v.clone() for k, v in module.state_dict().items() if k.endswith("running_mean")}
    module(x, False)
    assert all(torch.equal(module.state_dict()[k], v) for k, v in start.items())
    module(x, True)
    assert all(not torch.equal(module.state_dict()[k], v) for k, v in start.items())


def test_convert_jax_params_keeps_float64_and_makes_the_rest_float32():
    """The dtype follows the JAX arrays: a float64 run stays float64,
    float32 and bfloat16 weights load as float32."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    rng = np.random.RandomState(0)
    kernel = rng.standard_normal((3, 2))
    for src, dtype in ((np.float64, torch.float64), (np.float32, torch.float32), (jnp.bfloat16, torch.float32)):
        tree = {"params": {"fc1": {"kernel": np.asarray(kernel.astype(src)), "bias": np.asarray(kernel[0].astype(src))}}}
        state = convert_jax_params(tree)
        assert set(state) == {"fc1.weight", "fc1.bias"}
        assert state["fc1.weight"].dtype == state["fc1.bias"].dtype == dtype
        np.testing.assert_array_equal(n(state["fc1.weight"].double()), np.asarray(kernel.astype(src).T, np.float64))


def test_d2_names_and_a_d2_checkpoint_with_num_batches_tracked():
    bn = BatchNorm2d(C)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    ref = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(ref, k).copy_(torch.rand(C) + 0.5)
    d2 = {k: v.numpy() for k, v in ref.state_dict().items()}
    assert "num_batches_tracked" in d2
    report = load_state_dict_report(bn, d2)
    assert report == "Loaded 4/4 tensors from the checkpoint.", report
    assert all(torch.equal(bn.state_dict()[k], ref.state_dict()[k]) for k in bn.state_dict())


def test_get_bn_modules_lists_only_norms_with_batch_statistics():
    a, b = BatchNorm2d(C), SyncBatchNorm(C)
    model = torch.nn.Sequential(a, FrozenBatchNorm2d(C), GroupNorm(32), b, LayerNorm(C))
    assert get_bn_modules(model) == [a, b]


def test_sync_bn_refuses_more_than_one_process(monkeypatch):
    bn = SyncBatchNorm(C)
    x = torch.randn(2, C, 3, 3)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        bn(x, train=True)
    bn(x, train=False)  # the running statistics need no reduction
    BatchNorm2d(C)(x, train=True)  # plain BN is per process by definition
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    bn(x, train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        SyncBatchNorm(C, axis_name="data")


def test_cycle_batch_norm_list_matches_the_jax_module():
    """Every layer is applied (and updates its statistics); ``index`` picks
    the output. Layer i is the JAX module's ``BatchNorm_i``."""
    x, *_ = _inputs(4)
    jm = jax_bn.CycleBatchNormList(length=3, features=C)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(lambda v: jnp.asarray(np.abs(rng.standard_normal(v.shape)).astype(np.float32) + 0.5), variables)
    ref, upd = jm.apply(variables, jnp.asarray(x), index=1, train=True, mutable=["batch_stats"])
    port = CycleBatchNormList(3, C)
    with torch.no_grad():
        for i, bn in enumerate(port):
            p, s = variables["params"][f"BatchNorm_{i}"]["BatchNorm_0"], variables["batch_stats"][f"BatchNorm_{i}"]["BatchNorm_0"]
            bn.weight.copy_(t(p["scale"]))
            bn.bias.copy_(t(p["bias"]))
            bn.running_mean.copy_(t(s["mean"]))
            bn.running_var.copy_(t(s["var"]))
    y = port(_nchw(x, torch.float32), True, index=1)
    _close(n(y.permute(0, 2, 3, 1)), np.asarray(ref), 2e-5)
    for i, bn in enumerate(port):
        s = upd["batch_stats"][f"BatchNorm_{i}"]["BatchNorm_0"]
        _close(n(bn.running_mean), s["mean"], 1e-5, 1e-7)
        _close(n(bn.running_var), s["var"], 1e-5, 1e-7)
