"""The port's plain attention (what its kernels are held to on the card)
against the JAX package: the exact formulation ``_attn_xla`` / ``_attn_xla_t``
and the Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are those of ``tests/ops/test_flash_attention.py``: float32
rtol = atol = 2e-5 (sum order), bfloat16 3e-2 (roundings fall at other
places in the two frameworks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_tpu.ops.attention import _attn_xla, _attn_xla_t
from detectron2_tpu.ops.pallas.flash_attention import flash_attention, flash_attention_v2_t
from detectron2_tpu_torch.ops import attention as port_attn
from detectron2_tpu_torch.testing import attention_bf16_bounds

from _torch_port import n, t

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
# (B, S, D, Hk, Wk, bias): the JAX tests' shapes
CASES = {
    "S256-16x16": (2, 256, 64, 16, 16, True),
    "S196-14x14": (3, 196, 64, 14, 14, True),
    "S256-nobias": (2, 256, 64, 16, 16, False),
}


def _inputs(case, seed=0):
    B, S, D, Hk, Wk, bias = CASES[case]
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, D).astype(np.float32) for _ in range(3))
    rel_h = (r.randn(B, S, Hk) * 0.2).astype(np.float32) if bias else None
    rel_w = (r.randn(B, S, Wk) * 0.2).astype(np.float32) if bias else None
    return q, k, v, rel_h, rel_w, D**-0.5


def _jnp(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x, dtype)


def _t(x, dtype=torch.float32):
    return None if x is None else t(x).to(dtype)


def _swap(x):
    return None if x is None else np.ascontiguousarray(x.swapaxes(1, 2))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_attn_xla_and_the_pallas_kernel(case):
    *arrs, scale = _inputs(case)
    out = n(port_attn.attention_plain(*(_t(a) for a in arrs), scale))
    np.testing.assert_allclose(out, np.asarray(_attn_xla(*(_jnp(a) for a in arrs), scale)), **F32)
    # S = 196 is one block of the TPU kernel; the others walk 4 x 4 blocks
    blocks = {} if CASES[case][1] == 196 else dict(block_q=64, block_k=64)
    kern = flash_attention(*(_jnp(a) for a in arrs), scale=scale, interpret=True, **blocks)
    np.testing.assert_allclose(out, np.asarray(kern), **F32)


@pytest.mark.parametrize("case", CASES)
def test_plain_t_matches_attn_xla_t_and_the_v2_kernel(case):
    q, k, v, rel_h, rel_w, scale = _inputs(case, seed=1)
    arrs = (q, k, v, _swap(rel_h), _swap(rel_w))
    out = n(port_attn.attention_plain_t(*(_t(a) for a in arrs), scale))
    np.testing.assert_allclose(out, np.asarray(_attn_xla_t(*(_jnp(a) for a in arrs), scale)), **F32)
    if case != "S196-14x14":  # one key block and 14 rows of 14: the TPU's v2 plan refuses it
        kern = flash_attention_v2_t(
            *(_jnp(a) for a in arrs), scale=scale, block_q=64, block_k=128, interpret=True
        )
        np.testing.assert_allclose(out, np.asarray(kern), **F32)
    # both layouts are one function
    std = n(port_attn.attention_plain(*(_t(a) for a in (q, k, v, rel_h, rel_w)), scale))
    np.testing.assert_array_equal(out, std)


# ViT-H's head dim (1280 / 16 heads): a windowed block and a global one
D80 = {"windowed-S196": (2, 196, 80, 14, 14), "global-S1024": (1, 1024, 80, 32, 32)}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("case", D80)
def test_plain_matches_attn_xla_at_head_dim_80(case, bias):
    B, S, D, Hk, Wk = D80[case]
    r = np.random.RandomState(3)
    q, k, v = (r.randn(B, S, D).astype(np.float32) for _ in range(3))
    rel_h = (r.randn(B, S, Hk) * 0.2).astype(np.float32) if bias else None
    rel_w = (r.randn(B, S, Wk) * 0.2).astype(np.float32) if bias else None
    scale = D**-0.5
    out = n(port_attn.attention_plain(*(_t(a) for a in (q, k, v, rel_h, rel_w)), scale))
    np.testing.assert_allclose(out, np.asarray(_attn_xla(*(_jnp(a) for a in (q, k, v, rel_h, rel_w)), scale)), **F32)
    arrs_t = (q, k, v, _swap(rel_h), _swap(rel_w))
    out_t = n(port_attn.attention_plain_t(*(_t(a) for a in arrs_t), scale))
    np.testing.assert_allclose(out_t, np.asarray(_attn_xla_t(*(_jnp(a) for a in arrs_t), scale)), **F32)
    # and the entry point on the CPU is the plain version in both layouts
    entry = port_attn.attention_with_rel_pos(*(_t(a) for a in arrs_t), scale=scale, factors_transposed=True)
    np.testing.assert_array_equal(n(entry), out_t)


@pytest.mark.parametrize("case", CASES)
def test_plain_bfloat16_matches_jax(case):
    *arrs, scale = _inputs(case, seed=2)
    out = port_attn.attention_plain(*(_t(a, torch.bfloat16) for a in arrs), scale)
    assert out.dtype == torch.bfloat16
    jargs = [_jnp(a, jnp.bfloat16) for a in arrs]
    np.testing.assert_allclose(n(out.float()), np.asarray(_attn_xla(*jargs, scale), np.float32), **BF16)
    kern = flash_attention(*jargs, scale=scale, interpret=True)
    np.testing.assert_allclose(n(out.float()), np.asarray(kern, np.float32), **BF16)
    # and the float32 result is within the same bound
    ref = port_attn.attention_plain(*(_t(a) for a in arrs), scale)
    np.testing.assert_allclose(n(out.float()), n(ref), **BF16)


def test_q_is_scaled_in_its_own_dtype():
    """bfloat16 q times a scale that bf16 cannot hold: the scale is rounded
    to bf16 first, as ``q * scale`` is in the JAX package."""
    q = np.random.RandomState(3).randn(1, 8, 32).astype(np.float32)
    scale = 32**-0.5
    ours = port_attn._scores(_t(q, torch.bfloat16), _t(q, torch.bfloat16), scale)
    qj = _jnp(q, jnp.bfloat16)
    ref = jnp.einsum("bqc,bkc->bqk", qj * scale, qj, preferred_element_type=jnp.float32)
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_entry_point_runs_the_plain_version_on_the_cpu_in_both_layouts():
    q, k, v, rel_h, rel_w, scale = _inputs("S196-14x14", seed=4)
    args = [_t(a) for a in (q, k, v, rel_h, rel_w)]
    before = (port_attn.flash_attention_cuda.launches, port_attn.flash_attention_t_cuda.launches)
    out = port_attn.attention_with_rel_pos(*args, scale=scale)
    out_t = port_attn.attention_with_rel_pos(
        *args[:3], _t(_swap(rel_h)), _t(_swap(rel_w)), scale=scale, factors_transposed=True
    )
    assert (port_attn.flash_attention_cuda.launches, port_attn.flash_attention_t_cuda.launches) == before
    np.testing.assert_array_equal(n(out), n(port_attn.attention_plain(*args, scale)))
    np.testing.assert_array_equal(n(out), n(out_t))
    none = port_attn.attention_with_rel_pos(*args[:3], scale=scale)
    np.testing.assert_allclose(n(none), np.asarray(_attn_xla(*(_jnp(a) for a in (q, k, v)), None, None, scale)), **F32)


def test_layout_switch_is_the_jax_package_environment_variable(monkeypatch):
    monkeypatch.delenv("D2T_FLASH_V2", raising=False)
    assert not port_attn.use_transposed_factors()
    monkeypatch.setenv("D2T_FLASH_V2", "1")
    assert port_attn.use_transposed_factors()
    monkeypatch.setenv("D2T_FLASH_V2", "0")
    assert not port_attn.use_transposed_factors()


@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_gradient_matches_jax_grad_of_attn_xla(transposed):
    B, S, D, Hk, Wk = 2, 48, 32, 6, 8
    r = np.random.RandomState(5)
    q, k, v = (r.randn(B, S, D).astype(np.float32) for _ in range(3))
    rel_h, rel_w = (r.randn(B, S, m).astype(np.float32) * 0.3 for m in (Hk, Wk))
    g = r.randn(B, S, D).astype(np.float32)
    scale = D**-0.5
    ref = jax.grad(lambda *a: (_attn_xla(*a, scale) * g).sum(), argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (q, k, v, rel_h, rel_w))
    )
    if transposed:
        rel_h, rel_w = _swap(rel_h), _swap(rel_w)
    args = [t(a).requires_grad_(True) for a in (q, k, v, rel_h, rel_w)]
    out = port_attn.attention_with_rel_pos(*args, scale=scale, factors_transposed=transposed)
    grads = torch.autograd.grad(out, args, t(g))
    for i, (ours, theirs) in enumerate(zip(grads, ref)):
        theirs = np.asarray(theirs)
        if transposed and i >= 3:
            theirs = theirs.swapaxes(1, 2)
        np.testing.assert_allclose(n(ours), theirs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_gradcheck_in_float64(transposed, bias):
    r = np.random.RandomState(6)
    q, k, v = (t(r.randn(2, 12, 8)).requires_grad_(True) for _ in range(3))
    factors = ()
    if bias:
        shapes = ((2, 3, 12), (2, 4, 12)) if transposed else ((2, 12, 3), (2, 12, 4))
        factors = tuple(t(r.randn(*s)).requires_grad_(True) for s in shapes)
    fn = lambda *a: port_attn.attention_with_rel_pos(*a, scale=0.3, factors_transposed=transposed)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v, *factors))


def _as_the_bf16_kernel(q, k, v, rel_h, rel_w, scale, fault=None):
    """The bfloat16 CUDA kernel's arithmetic in plain torch: scores and bias
    in float32, probabilities rounded to bf16 for the p.v product, their
    unrounded sum, the division last. ``fault`` breaks it as a kernel could
    be broken: the last 4 keys (the tail of S = 196 past three 64-key tiles)
    or one 64-key tile left out, or the bias ignored."""
    s = port_attn._scores(q, k, scale)
    if fault != "no_bias":
        B, S, _ = q.shape
        s = s + (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(B, S, S)
    if fault == "tail_keys":
        s[:, :, -4:] = -float("inf")
    if fault == "one_tile":
        s[:, :, 64:128] = -float("inf")
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    out = torch.einsum("bqk,bkc->bqc", p.bfloat16().float(), v.float()) / p.sum(-1, keepdim=True)
    return out.bfloat16()


@pytest.mark.parametrize("fault", [None, "tail_keys", "one_tile", "no_bias"])
@pytest.mark.parametrize("bias_std", [0.02, 0.5], ids=["small-bias", "large-bias"])
def test_bf16_bounds_pass_the_kernels_arithmetic_and_fail_a_broken_one(fault, bias_std):
    """The bounds the card holds the bf16 kernel to (chip_smoke.py and
    tests/test_torch_attention_cuda.py), on a bf16 kernel emulated on the CPU
    at the windowed main-path shape: right arithmetic passes both bounds, a
    dropped key tile, dropped tail keys or an ignored bias does not pass the
    float32-reference one, and the bound lies below a typical |ref|."""
    B, S, D, Hk, Wk = 6, 196, 64, 14, 14
    r = np.random.RandomState(7)
    q, k, v = (_t(r.randn(B, S, D).astype(np.float32), torch.bfloat16) for _ in range(3))
    rel_h, rel_w = (_t((r.randn(B, S, m) * bias_std).astype(np.float32), torch.bfloat16) for m in (Hk, Wk))
    scale = D**-0.5
    out = _as_the_bf16_kernel(q, k, v, rel_h, rel_w, scale, fault).float()
    args32 = [a.float() for a in (q * scale, k, v, rel_h, rel_w)]
    ref32 = port_attn.attention_plain(*args32, 1.0)
    args32[2] = args32[2].abs()
    weight = port_attn.attention_plain(*args32, 1.0)
    bias_max = rel_h.float().abs().max().item() + rel_w.float().abs().max().item()
    tol32, tol16 = attention_bf16_bounds(ref32, weight, v.float().abs().max().item(), bias_max)
    assert (ref32.abs() > tol32).float().mean().item() > 0.5
    ok32 = bool(((out - ref32).abs() <= tol32).all())
    if fault is None:
        ref16 = port_attn.attention_plain(q, k, v, rel_h, rel_w, scale).float()
        assert ok32 and ((out - ref16).abs() <= tol16).all()
    else:
        assert not ok32
