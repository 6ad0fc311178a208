"""The attention CUDA kernels, both factor layouts, against their plain
versions, on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit (``tests/conftest.py``
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention_cuda.py -q

Without a card every test skips. Tolerances: float32 2e-5 of the largest |v|
(sum order and the exponential only; an output is a convex combination of v's
rows); bfloat16 per element, scaled by the output and by A = softmax @ |v|
(``testing.attention_bf16_bounds``): 2^-9 A + 2^-8 |ref| + 2e-5 max|v| against
the plain version run in float32 on the same inputs, and a wider bound
against the plain version in bfloat16, which also rounds the summed bias. The
float32-reference bound must lie below |ref| at more than half of the
elements, so that a kernel that skipped keys or the bias could not pass.
"""

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.ops import attention as port_attn
from detectron2_tpu_torch.testing import attention_bf16_bounds

ENTRY = {
    False: (port_attn.flash_attention_cuda, port_attn.attention_plain),
    True: (port_attn.flash_attention_t_cuda, port_attn.attention_plain_t),
}
# (B, S, D, Hk, Wk): tails in queries and keys, one tile, many tiles, every
# head dim, a non-square grid, and the two ViTDet-B main-path shapes
SMALL = [
    (3, 196, 64, 14, 14),
    (2, 256, 64, 16, 16),
    (2, 64, 32, 8, 8),
    (5, 70, 32, 7, 10),
    (1, 1000, 64, 25, 40),
    (2, 130, 128, 13, 10),
    (2, 1, 64, 1, 1),
]
MAIN = [(96, 4096, 64, 64, 64), (2400, 196, 64, 14, 14)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, transposed, bias=True, seed=0):
    B, S, D, Hk, Wk = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(B, S, D, generator=gen, device=device).to(dtype) for _ in range(3))
    if not bias:
        return q, k, v, None, None
    rel_h = (torch.randn(B, S, Hk, generator=gen, device=device) * 0.5).to(dtype)
    rel_w = (torch.randn(B, S, Wk, generator=gen, device=device) * 0.5).to(dtype)
    if transposed:
        rel_h, rel_w = rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous()
    return q, k, v, rel_h, rel_w


def _plain_chunked(plain, args, scale, chunk):
    """The plain version over slices of the batch-heads: its scores take
    B * S * S * 4 bytes."""
    B = args[0].shape[0]
    outs = []
    for s in range(0, B, chunk):
        outs.append(plain(*(None if a is None else a[s : s + chunk] for a in args), scale))
    return torch.cat(outs)


def _check(shape, dtype, transposed, bias, device, chunk=None):
    kernel, plain = ENTRY[transposed]
    args = _inputs(shape, dtype, device, transposed, bias)
    scale = shape[2] ** -0.5
    before = kernel.launches
    out = kernel(*args, scale=scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.shape == args[0].shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    chunk = chunk or shape[0]
    q, v = args[0], args[2]
    vmax = v.float().abs().max().item()
    # q scaled in its own dtype, as the kernel and the plain version scale it
    args32 = [(q * torch.tensor(scale, dtype=dtype, device=device)).float()] + [None if a is None else a.float() for a in args[1:]]
    ref32 = _plain_chunked(plain, args32, 1.0, chunk)
    diff = (out.float() - ref32).abs()
    if dtype == torch.float32:
        assert ref32.square().mean().sqrt().item() > 2e-5 * vmax  # the comparison is not of zeros
        assert diff.max().item() <= 2e-5 * vmax, (diff.max().item(), vmax)
        return
    args32[2] = args32[2].abs()
    weight = _plain_chunked(plain, args32, 1.0, chunk)
    bias_max = args[3].float().abs().max().item() + args[4].float().abs().max().item() if bias else 0.0
    tol32, tol16 = attention_bf16_bounds(ref32, weight, vmax, bias_max)
    assert (ref32.abs() > tol32).float().mean().item() > 0.5  # a wrong kernel could not pass
    assert (diff <= tol32).all(), (diff / tol32).max().item()
    diff16 = (out.float() - _plain_chunked(plain, args, scale, chunk).float()).abs()
    assert (diff16 <= tol16).all(), (diff16 / tol16).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_kernel_matches_plain_on_the_card(cuda, shape, dtype, transposed, bias):
    _check(shape, dtype, transposed, bias, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAIN, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_kernel_matches_plain_at_the_main_path_shapes(cuda, shape, dtype, transposed):
    _check(shape, dtype, transposed, True, cuda, chunk=24 if shape[1] > 1000 else 600)


@pytest.mark.cuda
def test_both_layouts_agree_bitwise(cuda):
    q, k, v, rel_h, rel_w = _inputs((4, 196, 64, 14, 14), torch.bfloat16, cuda, False)
    a = port_attn.flash_attention_cuda(q, k, v, rel_h, rel_w, scale=0.125)
    b = port_attn.flash_attention_t_cuda(
        q, k, v, rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous(), scale=0.125
    )
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_entry_point_takes_the_kernel_and_differentiates(cuda):
    args = _inputs((2, 70, 32, 7, 10), torch.float32, cuda, False)
    args = tuple(a.requires_grad_(True) for a in args)
    before = port_attn.flash_attention_cuda.launches
    out = port_attn.attention_with_rel_pos(*args, scale=0.3)
    assert port_attn.flash_attention_cuda.launches == before + 1
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, args, g)
    ref = port_attn.attention_plain(*args, 0.3)
    for a, b in zip(grads, torch.autograd.grad(ref, args, g)):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, rel_h, rel_w = _inputs((2, 64, 32, 8, 8), torch.float32, cuda, False)
    with pytest.raises(ValueError, match="bfloat16"):
        port_attn.flash_attention_cuda(q.half(), k.half(), v.half(), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        port_attn.flash_attention_cuda(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        port_attn.flash_attention_cuda(q[..., :24].contiguous(), k[..., :24].contiguous(), v[..., :24].contiguous(), scale=1.0)
    with pytest.raises(ValueError, match="expected"):
        port_attn.flash_attention_t_cuda(q, k, v, rel_h, rel_w, scale=1.0)
    with pytest.raises(ValueError, match="both factors"):
        port_attn.flash_attention_cuda(q, k, v, rel_h, None, scale=1.0)
    with pytest.raises(ValueError, match="expected cuda"):
        port_attn.flash_attention_cuda(q.cpu(), k.cpu(), v.cpu(), scale=1.0)
