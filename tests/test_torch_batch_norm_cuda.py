"""The port's BN with batch statistics on the card against itself on the CPU
(the CPU version is held to flax's by ``tests/test_torch_batch_norm.py``):
the output, the input, weight and bias gradients and the running statistics
of a train call, and the output of an eval call, in float32 and bfloat16, on
a channels_last map as the conv towers give it. The BN is plain PyTorch on
both devices (no kernel: the JAX package computes it in XLA).

Tolerances: float32 max|diff| <= 1e-5 * max|cpu| + 1e-6 (reductions in
another order; TF32 off); bfloat16 outputs and input gradients one bf16 ulp
of the max, 2^-7 * max|cpu|, the float32 statistics and parameter gradients
as in float32.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit (``tests/conftest.py``
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_batch_norm_cuda.py -q

Without a card every test skips.
"""

import pytest
import torch

from detectron2_tpu_torch.layers import BatchNorm2d, SyncBatchNorm

SHAPES = [(8, 64, 32, 48), (512, 256, 7, 7), (3, 16, 5, 9)]  # a stem-like map, a box head's rois, an odd one


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, rtol):
    err = (out.float().cpu() - ref.float()).abs().max().item()
    assert err <= rtol * ref.float().abs().max().item() + 1e-6, (err, ref.float().abs().max().item())


def _bn(cls, c, gen):
    bn = cls(c)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cls", [BatchNorm2d, SyncBatchNorm])
def test_train_call_on_the_card_matches_the_cpu(cuda, cls, dtype, shape):
    gen = torch.Generator().manual_seed(0)
    n, c, h, w = shape
    x = (torch.randn(shape, generator=gen) * 2 + torch.randn(1, c, 1, 1, generator=gen) * 3).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen).to(dtype).contiguous(memory_format=torch.channels_last)
    cpu = _bn(cls, c, gen)
    card = _bn(cls, c, torch.Generator().manual_seed(0))
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    xs, xc = x.clone().requires_grad_(True), x.to(cuda).requires_grad_(True)
    ys, yc = cpu(xs, train=True), card(xc, train=True)
    assert yc.dtype == dtype and yc.is_contiguous(memory_format=torch.channels_last)
    ys.backward(g)
    yc.backward(g.to(cuda))
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    _close(yc, ys, tol)
    _close(xc.grad, xs.grad, tol)
    for name in ("weight", "bias"):
        _close(getattr(card, name).grad, getattr(cpu, name).grad, 1e-5)
    for name in ("running_mean", "running_var"):
        _close(getattr(card, name), getattr(cpu, name), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_call_on_the_card_matches_the_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(SHAPES[0], generator=gen).to(dtype).contiguous(memory_format=torch.channels_last)
    cpu = _bn(BatchNorm2d, SHAPES[0][1], gen)
    card = BatchNorm2d(SHAPES[0][1])
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    with torch.no_grad():
        _close(card(x.to(cuda), train=False), cpu(x, train=False), 1e-5 if dtype == torch.float32 else 2.0**-7)
    assert torch.equal(card.running_mean.cpu(), cpu.running_mean)
