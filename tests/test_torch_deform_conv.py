"""Deformable convolution in the port against the JAX package, float32:
``deform_conv2d`` and its gradients (x, offset, mask, weight) against the
JAX op and ``jax.vjp``, the layers, a narrow ResNet-50 + FPN with
deformable c3-c5 through ``convert_jax_params``, and the four ``Misc``
dconv yamls building.

Every case draws offsets that are fractional, a few pixels long and put
some samples outside the map: a deformable conv with zero offsets is a plain
conv and would never reach the bilinear path.

Tolerances: the op 1e-5 absolute + 1e-5 relative (gradients relative to
each gradient's largest value); the backbone 1e-4 of each map's largest
value, as ``tests/test_torch_backbone.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_model, jax_random_variables, n, port_model, t

from detectron2_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.layers import DeformConv, ModulatedDeformConv
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone.resnet import DeformBottleneckBlock
from detectron2_tpu_torch.ops.deform_conv import deform_conv2d

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# (deformable groups, groups, stride, dilation, modulated, bias)
CASES = [
    (1, 1, 1, 1, False, False),
    (2, 1, 1, 1, True, True),
    (1, 4, 2, 1, True, False),
    (2, 4, 1, 2, False, True),
    (2, 2, 2, 2, True, True),
]


def _inputs(dg, groups, stride, dilation, modulated, bias, seed=0, B=2, H=9, W=11, C=8, Cout=12):
    rng = np.random.RandomState(seed)
    Ho = (H + 2 * dilation - dilation * 2 - 1) // stride + 1
    Wo = (W + 2 * dilation - dilation * 2 - 1) // stride + 1
    out = {
        "x": rng.standard_normal((B, H, W, C)).astype(np.float32),
        # a few pixels, fractional; taps near the border land outside
        "offset": rng.uniform(-3.0, 3.0, (B, Ho, Wo, 2 * dg * 9)).astype(np.float32),
        "weight": (rng.standard_normal((3, 3, C // groups, Cout)) * 0.2).astype(np.float32),
        "mask": rng.uniform(0.0, 1.0, (B, Ho, Wo, dg * 9)).astype(np.float32) if modulated else None,
        "bias": rng.standard_normal(Cout).astype(np.float32) if bias else None,
    }
    kw = dict(stride=stride, padding=dilation, dilation=dilation, groups=groups, deformable_groups=dg)
    return out, kw


def jax_grouped_layout(w, groups):
    """The HWIO weight on which the JAX op's grouped product (a reshape to
    ``[K, groups, C / groups, Cout / groups]``, ROADMAP C) computes what the
    port's computes on ``w``, d2's grouping."""
    kh, kw, cin_g, cout = w.shape
    return w.reshape(kh, kw, cin_g, groups, cout // groups).swapaxes(2, 3).reshape(kh, kw, cin_g, cout)


def _outside_fraction(offset, H, W, stride, dilation, dg):
    B, Ho, Wo, _ = offset.shape
    off = offset.reshape(B, Ho, Wo, dg, 9, 2)
    ky, kx = np.meshgrid(np.arange(3) * dilation, np.arange(3) * dilation, indexing="ij")
    y = np.arange(Ho)[:, None, None] * stride - dilation + ky.reshape(1, 1, 9)
    x = np.arange(Wo)[None, :, None] * stride - dilation + kx.reshape(1, 1, 9)
    sy = y[None, :, :, None, :] + off[..., 0]
    sx = x[None, :, :, None, :] + off[..., 1]
    return ((sy <= -1) | (sy >= H) | (sx <= -1) | (sx >= W)).mean()


@pytest.mark.parametrize("dg, groups, stride, dilation, modulated, bias", CASES)
def test_deform_conv2d_and_gradients_match_jax(dg, groups, stride, dilation, modulated, bias):
    a, kw = _inputs(dg, groups, stride, dilation, modulated, bias)
    assert 0.02 < _outside_fraction(a["offset"], 9, 11, stride, dilation, dg) < 0.5
    names = [k for k in ("x", "offset", "weight", "mask", "bias") if a[k] is not None]

    def jax_fn(*args):
        d = dict(zip(names, args))
        w = jax_grouped_layout(d["weight"], groups)
        return jax_deform_conv2d(d["x"], d["offset"], w, mask=d.get("mask"), bias=d.get("bias"), **kw)

    ref, vjp = jax.vjp(jax_fn, *[jnp.asarray(a[k]) for k in names])
    ref = np.asarray(ref)
    cot = np.random.RandomState(1).standard_normal(ref.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(cot))

    tens = {k: t(a[k]).requires_grad_(True) for k in names}
    out = deform_conv2d(tens["x"], tens["offset"], tens["weight"], mask=tens.get("mask"), bias=tens.get("bias"), **kw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(n(out), ref, rtol=1e-5, atol=1e-5)
    out.backward(t(cot))
    for k, g in zip(names, ref_grads):
        g = np.asarray(g)
        err = np.abs(n(tens[k].grad) - g).max()
        assert err <= 1e-5 * np.abs(g).max() + 1e-5, (k, err, np.abs(g).max())


def test_deform_conv2d_zero_offsets_is_a_convolution():
    """With zero offsets the op is d2's grouped convolution; the JAX op is
    that only on the weight laid out by ``jax_grouped_layout`` (its grouped
    product mixes the groups of the plain layout, ROADMAP C)."""
    a, kw = _inputs(1, 4, 2, 1, False, True)
    x, w = t(a["x"]), t(a["weight"])
    zero = np.zeros_like(a["offset"])
    out = deform_conv2d(x, t(zero), w, bias=t(a["bias"]), **kw)
    ref = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), t(a["bias"]), stride=2, padding=1, groups=4
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(n(out), n(ref), rtol=1e-5, atol=1e-5)
    jax_plain = jax_deform_conv2d(jnp.asarray(a["x"]), jnp.asarray(zero), jnp.asarray(a["weight"]), bias=jnp.asarray(a["bias"]), **kw)
    assert np.abs(np.asarray(jax_plain) - n(ref)).max() > 0.1
    jax_laid_out = jax_deform_conv2d(
        jnp.asarray(a["x"]), jnp.asarray(zero), jnp.asarray(jax_grouped_layout(a["weight"], 4)), bias=jnp.asarray(a["bias"]), **kw
    )
    np.testing.assert_allclose(np.asarray(jax_laid_out), n(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("modulated", [False, True])
def test_layers_match_the_op_with_d2_layout(modulated):
    a, kw = _inputs(2, 2, 1, 1, modulated, True, seed=3)
    cls = ModulatedDeformConv if modulated else DeformConv
    layer = cls(8, 12, 3, padding=1, groups=2, deformable_groups=2, bias=True)
    assert tuple(layer.weight.shape) == (12, 4, 3, 3) and sorted(layer.state_dict()) == ["bias", "weight"]
    with torch.no_grad():
        layer.weight.copy_(t(a["weight"]).permute(3, 2, 0, 1))
        layer.bias.copy_(t(a["bias"]))
        args = (t(a["x"]), t(a["offset"])) + ((t(a["mask"]),) if modulated else ())
        out = layer(*args, False)
    ref = jax_deform_conv2d(
        jnp.asarray(a["x"]), jnp.asarray(a["offset"]), jnp.asarray(jax_grouped_layout(a["weight"], 2)),
        mask=None if a["mask"] is None else jnp.asarray(a["mask"]), bias=jnp.asarray(a["bias"]), **kw,
    )
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _dconv_cfg(variant):
    cfg = get_cfg()
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.RESNETS.DEFORM_ON_PER_STAGE = [False, True, True, True]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 5
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    if variant == "modulated":  # the dconv yamls' shape at 1/8 width, v2
        m.RESNETS.STEM_OUT_CHANNELS = 16
        m.RESNETS.WIDTH_PER_GROUP = 8
        m.RESNETS.RES2_OUT_CHANNELS = 32
        m.RESNETS.DEFORM_MODULATED = True
        m.FPN.OUT_CHANNELS = 32
    else:  # the GN / X-152 yamls' options: GN, stride in the 3x3, grouped convs, 2 deformable groups
        m.RESNETS.NORM = "GN"
        m.RESNETS.STRIDE_IN_1X1 = False
        m.RESNETS.STEM_OUT_CHANNELS = 32
        m.RESNETS.NUM_GROUPS = 2
        m.RESNETS.WIDTH_PER_GROUP = 16
        m.RESNETS.RES2_OUT_CHANNELS = 64
        m.RESNETS.DEFORM_NUM_GROUPS = 2
        m.FPN.NORM = "GN"
        m.FPN.OUT_CHANNELS = 32
    return cfg


def _offset_scales(model, images):
    """Each deformable block's offset std on ``images``."""
    stds, handles = {}, []
    for name, mod in model.backbone.bottom_up.named_modules():
        if isinstance(mod, DeformBottleneckBlock):
            def hook(m, args, out, name=name, k2=18 * mod.conv2.deformable_groups):
                stds[name] = out[:, :k2].std().item()
            handles.append(mod.conv2_offset.register_forward_hook(hook))
    with torch.no_grad():
        model.backbone(images)
    for h in handles:
        h.remove()
    return stds


@pytest.mark.parametrize("variant", ["modulated", "gn_grouped"])
def test_dconv_resnet_fpn_matches_jax(variant):
    cfg = _dconv_cfg(variant)
    jm = jax_model(cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax_random_variables(jm, seed=5))
    rng = np.random.RandomState(5)
    images = rng.uniform(-2, 2, (1, 64, 96, 3)).astype(np.float32)
    # scale every conv2_offset so that its offsets have a std of ~2 px
    model = port_model(cfg, variables)
    stds = _offset_scales(model, t(images))
    assert len(stds) == 4 + 6 + 3, sorted(stds)
    for name, std in stds.items():
        stage, block = name.split(".")
        scope = variables["params"]["backbone"]["bottom_up"][f"{stage}_{block}"]["conv2_offset"]
        scope["kernel"] = scope["kernel"] * (2.0 / std)
        scope["bias"] = scope["bias"] * (2.0 / std)
    model = port_model(cfg, variables)
    assert all(1.5 < s < 2.5 for s in _offset_scales(model, t(images)).values())
    groups = cfg.MODEL.RESNETS.NUM_GROUPS
    if groups > 1:  # the port's conv2 weight that computes the JAX block's function
        with torch.no_grad():
            for name, block in model.backbone.bottom_up.named_modules():
                if isinstance(block, DeformBottleneckBlock):
                    stage, b = name.split(".")
                    k = variables["params"]["backbone"]["bottom_up"][f"{stage}_{b}"]["conv2_kernel"]
                    w = k.reshape(3, 3, groups, k.shape[2], -1).swapaxes(2, 3).reshape(k.shape)
                    np.testing.assert_array_equal(jax_grouped_layout(w, groups), k)
                    block.conv2.weight.copy_(t(w).permute(3, 2, 0, 1))

    ref = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: m.backbone(x)))(variables, jnp.asarray(images))
    with torch.no_grad():
        out = model.backbone(t(images))
    assert sorted(out) == ["p2", "p3", "p4", "p5", "p6"] == sorted(ref)
    for k in out:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(n(out[k]), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("yaml", sorted(f for f in os.listdir(os.path.join(ROOT, "configs", "Misc")) if "dconv" in f))
def test_dconv_yamls_build(yaml):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "Misc", yaml))
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    r = cfg.MODEL.RESNETS
    for stage, on in zip(("res2", "res3", "res4", "res5"), r.DEFORM_ON_PER_STAGE):
        blocks = list(getattr(model.backbone.bottom_up, stage))
        assert all(isinstance(b, DeformBottleneckBlock) == on for b in blocks), (yaml, stage)
    block = model.backbone.bottom_up.res3[0]
    assert isinstance(block.conv2, ModulatedDeformConv) == r.DEFORM_MODULATED
    assert block.conv2.groups == r.NUM_GROUPS and tuple(block.conv2_offset.weight.shape[:2]) == (
        (27 if r.DEFORM_MODULATED else 18) * r.DEFORM_NUM_GROUPS, r.NUM_GROUPS * r.WIDTH_PER_GROUP * 2)
