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
# head dim, a non-square grid, and the two ViTDet-B main-path shapes; run in
# float32 and bfloat16
SMALL = [
    (3, 196, 64, 14, 14),
    (2, 256, 64, 16, 16),
    (2, 64, 32, 8, 8),
    (5, 70, 32, 7, 10),
    (1, 1000, 64, 25, 40),
    (2, 130, 128, 13, 10),
    (2, 1, 64, 1, 1),
    (3, 70, 48, 7, 10),
    (2, 130, 96, 13, 10),
    (3, 70, 112, 7, 10),
]
MAIN = [(96, 4096, 64, 64, 64), (2400, 196, 64, 14, 14)]
# ViT-H's head dim, 1280 / 16 heads = 80, at one image's windowed and global
# blocks (16 heads x 25 windows of 14x14 tokens; 16 heads x 64x64 tokens)
VITH = [(16, 4096, 80, 64, 64), (400, 196, 80, 14, 14)]
# the edges of the bfloat16 D = 64 kernels: whole windows up to S = 208 with
# the bias folded in (one pass up to 128 keys, two halves beyond; even and odd
# Wk; B = 1 and odd B), the wgmma kernel from there on and wherever Hk + Wk
# exceeds 32 (one tile, a ragged last tile, w terms in registers for Wk of 32
# and 64, indexed factors for any other Wk), factors too wide for the wgmma
# kernel's shared memory, and the other head dims
EDGES = [
    (1, 63, 64, 7, 9),
    (3, 64, 64, 8, 8),
    (5, 65, 64, 5, 13),
    (2, 128, 64, 8, 16),
    (7, 196, 64, 14, 14),
    (1, 196, 64, 14, 14),
    (3, 200, 64, 10, 20),
    (3, 200, 64, 8, 25),
    (2, 208, 64, 16, 13),
    (2, 209, 64, 11, 19),
    (2, 128, 64, 2, 64),
    (2, 100, 64, 1, 100),
    (1, 2048, 64, 2, 1024),
    (3, 256, 64, 8, 32),
    (1, 1000, 64, 40, 25),
    (2, 1024, 64, 32, 32),
    (2, 1024, 64, 16, 64),
    (1, 4160, 64, 65, 64),
    (1, 4160, 64, 64, 65),
    (1, 4224, 64, 33, 128),
    (2, 196, 32, 14, 14),
    (2, 196, 128, 14, 14),
    (3, 70, 80, 7, 10),
    (1, 1000, 80, 25, 40),
    (2, 196, 48, 14, 14),
    (2, 196, 112, 14, 14),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, transposed, bias=True, seed=0, bias_std=0.5):
    B, S, D, Hk, Wk = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(B, S, D, generator=gen, device=device).to(dtype) for _ in range(3))
    if not bias:
        return q, k, v, None, None
    rel_h = (torch.randn(B, S, Hk, generator=gen, device=device) * bias_std).to(dtype)
    rel_w = (torch.randn(B, S, Wk, generator=gen, device=device) * bias_std).to(dtype)
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


def _check(shape, dtype, transposed, bias, device, chunk=None, entry=None):
    kernel, plain = entry or ENTRY[transposed]
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
@pytest.mark.parametrize("shape", VITH, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_head_dim_80_matches_plain_at_the_vit_h_shapes(cuda, shape, dtype, transposed):
    _check(shape, dtype, transposed, True, cuda, chunk=8 if shape[1] > 1000 else 400)
    want = "simt_f32" if dtype == torch.float32 else "mma_tiled"
    assert ENTRY[transposed][0].last_path == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_bf16_kernels_match_plain_at_their_edges(cuda, shape, transposed, bias):
    _check(shape, torch.bfloat16, transposed, bias, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(2, 196, 64, 14, 14), (2, 256, 64, 16, 16), (2, 1024, 64, 16, 64), (2, 1024, 64, 32, 32)],
    ids=lambda s: "x".join(map(str, s)),
)
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_bias_terms_far_above_the_scores_do_not_overflow(cuda, shape, transposed):
    """Bias terms of +-100 and more: 2^(bias log2 e) overflows float32 unless
    every term of the bias is under the running maximum that is subtracted.
    One key then dominates each row, where a probability's rounding to
    bfloat16 reaches its worst case, 2^-8 relative (2^-9 is the worst case
    only at the top of a binade), so the bound here is 2^-8 (A + |ref|) +
    2e-5 max|v| against the plain version in float32."""
    kernel, plain = ENTRY[transposed]
    args = _inputs(shape, torch.bfloat16, cuda, transposed, bias_std=30.0)
    scale = shape[2] ** -0.5
    out = kernel(*args, scale=scale).float()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    q, v = args[0], args[2]
    args32 = [(q * torch.tensor(scale, dtype=q.dtype, device=cuda)).float()] + [a.float() for a in args[1:]]
    ref32 = plain(*args32, 1.0)
    args32[2] = args32[2].abs()
    weight = plain(*args32, 1.0)
    tol = 2.0**-8 * (weight + ref32.abs()) + 2e-5 * v.float().abs().max().item()
    assert (ref32.abs() > tol).float().mean().item() > 0.5
    assert ((out - ref32).abs() <= tol).all(), ((out - ref32).abs() / tol).max().item()


# Which kernel of csrc/flash_attention.cu a launch of the entry point takes
# (its choose_path), as the wrapper reports it. Hk = Wk = 0: no bias.
PATH_TABLE = [
    # dtype, S, D, Hk, Wk, kernel
    (torch.float32, 196, 64, 14, 14, "simt_f32"),
    (torch.float32, 4096, 128, 64, 64, "simt_f32"),
    (torch.bfloat16, 196, 64, 14, 14, "mma_window"),
    (torch.bfloat16, 196, 64, 0, 0, "mma_window"),
    (torch.bfloat16, 1, 64, 1, 1, "mma_window"),
    (torch.bfloat16, 208, 64, 13, 16, "mma_window"),
    (torch.bfloat16, 209, 64, 11, 19, "wgmma"),
    (torch.bfloat16, 200, 64, 8, 25, "wgmma"),  # Hk + Wk = 33 does not fit the folded bias
    (torch.bfloat16, 200, 64, 10, 20, "mma_window"),
    (torch.bfloat16, 128, 64, 2, 64, "wgmma"),  # one tile
    (torch.bfloat16, 4096, 64, 64, 64, "wgmma"),
    (torch.bfloat16, 4096, 64, 0, 0, "wgmma"),
    (torch.bfloat16, 4160, 64, 65, 64, "wgmma"),
    (torch.bfloat16, 2048, 64, 8, 256, "wgmma"),  # indexed factors of 128 queries: 67 KB, they fit
    (torch.bfloat16, 2048, 64, 2, 1024, "mma_tiled"),  # 263 KB: they do not
    (torch.bfloat16, 2048, 64, 0, 0, "wgmma"),
    (torch.bfloat16, 196, 32, 14, 14, "mma_tiled"),
    (torch.bfloat16, 4096, 128, 64, 64, "mma_tiled"),
    (torch.bfloat16, 196, 80, 14, 14, "mma_tiled"),
    (torch.bfloat16, 4096, 80, 64, 64, "mma_tiled"),
    (torch.float32, 196, 80, 14, 14, "simt_f32"),
    (torch.bfloat16, 196, 48, 14, 14, "mma_tiled"),
    (torch.bfloat16, 196, 96, 14, 14, "mma_tiled"),
    (torch.bfloat16, 196, 112, 14, 14, "mma_tiled"),
    (torch.float32, 196, 48, 14, 14, "simt_f32"),
    (torch.float32, 196, 112, 14, 14, "simt_f32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("row", PATH_TABLE, ids=lambda r: f"{str(r[0]).split('.')[-1]}-S{r[1]}-D{r[2]}-{r[3]}x{r[4]}")
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_attention_path_is_chosen_by_dtype_and_shape(cuda, row, transposed):
    dtype, S, D, Hk, Wk, path = row
    kernel, _ = ENTRY[transposed]
    args = _inputs((1, S, D, max(Hk, 1), max(Wk, 1)), dtype, cuda, transposed, bias=Hk > 0)
    before = kernel.launches
    port_attn.attention_with_rel_pos(*args, scale=D**-0.5, factors_transposed=transposed)
    torch.cuda.synchronize()
    assert kernel.last_path == path
    assert kernel.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [24, 40, 144])
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_entry_point_refuses_a_head_dim_no_kernel_takes(cuda, D, transposed):
    kernel, _ = ENTRY[transposed]
    args = _inputs((1, 196, D, 14, 14), torch.bfloat16, cuda, transposed, bias=True)
    before = kernel.launches
    with pytest.raises(ValueError, match="head dim"):
        port_attn.attention_with_rel_pos(*args, scale=D**-0.5, factors_transposed=transposed)
    assert kernel.launches == before


@pytest.mark.cuda
def test_the_main_path_shapes_take_the_redesigned_kernels(cuda):
    for shape, path in zip(MAIN, ("wgmma", "mma_window")):
        q, k, v, rel_h, rel_w = _inputs((2,) + shape[1:], torch.bfloat16, cuda, False)
        port_attn.flash_attention_cuda(q, k, v, rel_h, rel_w, scale=0.125)
        assert port_attn.flash_attention_cuda.last_path == path
        port_attn.flash_attention_t_cuda(
            q, k, v, rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous(), scale=0.125
        )
        assert port_attn.flash_attention_t_cuda.last_path == path


@pytest.mark.cuda
@pytest.mark.parametrize("Hk", [64, 63, 17, 2, 1])
def test_folded_bias_kernel_matches_plain(cuda, Hk):
    """The wgmma kernel with the bias folded into the first product: whole
    tiles, a last tile half past S (odd Hk), h channels from every 16-channel
    step, a single tile."""
    folded = port_attn.flash_attention_folded_cuda
    _check((2, Hk * 64, 64, Hk, 64), torch.bfloat16, False, True, cuda, entry=(folded, port_attn.attention_plain))
    assert folded.last_path == "wgmma_folded"


@pytest.mark.cuda
def test_folded_bias_kernel_refuses_other_shapes(cuda):
    q, k, v, rel_h, rel_w = _inputs((2, 256, 64, 8, 32), torch.bfloat16, cuda, False)
    with pytest.raises(ValueError, match="Hk <= 64"):
        port_attn.flash_attention_folded_cuda(q, k, v, rel_h, rel_w, scale=0.125)
    q, k, v, rel_h, rel_w = _inputs((1, 65 * 64, 64, 65, 64), torch.bfloat16, cuda, False)
    with pytest.raises(ValueError, match="Hk <= 64"):
        port_attn.flash_attention_folded_cuda(q, k, v, rel_h, rel_w, scale=0.125)
    q, k, v, rel_h, rel_w = _inputs((1, 128, 64, 2, 64), torch.float32, cuda, False)
    with pytest.raises(ValueError, match="bfloat16"):
        port_attn.flash_attention_folded_cuda(q, k, v, rel_h, rel_w, scale=0.125)


@pytest.mark.cuda
def test_both_layouts_agree_bitwise(cuda):
    q, k, v, rel_h, rel_w = _inputs((4, 196, 64, 14, 14), torch.bfloat16, cuda, False)
    a = port_attn.flash_attention_cuda(q, k, v, rel_h, rel_w, scale=0.125)
    b = port_attn.flash_attention_t_cuda(
        q, k, v, rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous(), scale=0.125
    )
    assert torch.equal(a, b)
    q, k, v, rel_h, rel_w = _inputs((2, 1024, 64, 16, 64), torch.bfloat16, cuda, False)
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
