"""The RoIAlign CUDA kernels, forward and backward, against their plain
versions, on the card.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit (``tests/conftest.py``
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_roi_align_cuda.py -q

Without a card every test skips. Forward tolerance: 1e-5 absolute in
float32 (sum order only); in bfloat16 the kernel's one output rounding, half
a bf16 ulp (2^-8 relative) of the plain version run in float32 on the same
inputs. Backward: per element 1e-5 * A + 1e-7, A the plain backward of |g|
(the atomics' sum order), plus half a bf16 ulp in bfloat16.
"""

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.ops import roi_align as port_ra

SCALES = (0.25, 0.125, 0.0625)
LEVEL_HW = ((40, 56), (20, 28), (10, 14))


def _inputs(device, dtype, seed=0, R=48, C=64):
    """Rois partly and fully off the map, zero-area and padded rows."""
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.standard_normal((2, h, w, C)).astype(np.float32)) for h, w in LEVEL_HW]
    xy = rng.uniform(-40, 230, (R, 2)).astype(np.float32)
    wh = rng.uniform(0, 150, (R, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[3, 2:] = boxes[3, :2]
    boxes[4, 2] = boxes[4, 0]
    boxes[-6:] = 0
    boxes[7] = [-80, -60, -50, -20]
    bidx = rng.randint(0, 2, R).astype(np.int32)
    lvl = rng.randint(0, 3, R).astype(np.int32)
    return (
        [f.to(device, dtype) for f in feats],
        torch.from_numpy(boxes).to(device),
        torch.from_numpy(bidx).to(device),
        torch.from_numpy(lvl).to(device),
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_kernel_matches_plain_on_the_card(cuda, dtype, aligned, sampling_ratio):
    feats, boxes, bidx, lvl = _inputs(cuda, dtype)
    args = (feats, boxes, bidx, lvl, SCALES, (7, 7), sampling_ratio, aligned)
    before = port_ra.roi_align_multilevel_cuda.launches
    out = port_ra.roi_align_multilevel(*args)
    torch.cuda.synchronize()
    assert port_ra.roi_align_multilevel_cuda.launches == before + 1
    ref = port_ra.roi_align_multilevel_plain([f.float() for f in feats], *args[1:])
    tol = 1e-5 + (2.0**-8 * ref.abs() if dtype == torch.bfloat16 else 0)
    assert ((out.float() - ref).abs() <= tol).all()


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    feats, boxes, bidx, lvl = _inputs(cuda, torch.float32, R=8)
    with pytest.raises(ValueError, match="bfloat16"):
        port_ra.roi_align_multilevel_cuda([f.half() for f in feats], boxes, bidx, lvl, SCALES, 7)
    with pytest.raises(ValueError, match="int32"):
        port_ra.roi_align_multilevel_cuda(feats, boxes, bidx.long(), lvl, SCALES, 7)
    with pytest.raises(ValueError, match="contiguous"):
        port_ra.roi_align_multilevel_cuda([f.transpose(1, 2) for f in feats], boxes, bidx, lvl, SCALES, 7)


def _bwd_tolerance(ref32, bound, dtype):
    """float32: atomics reorder each sum, whose error A = the backward of |g|
    bounds; bfloat16: plus half a bf16 ulp of the float32 result (one rounding)."""
    tol = 1e-5 * bound + 1e-7
    return tol + 2.0**-8 * ref32.abs() if dtype == torch.bfloat16 else tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
def test_backward_kernel_matches_plain_on_the_card(cuda, dtype, aligned, sampling_ratio):
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=1)
    shapes = [tuple(f.shape) for f in feats]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    g = torch.randn((boxes.shape[0], 7, 7, feats[0].shape[-1]), generator=gen, device=cuda).to(dtype)
    args = (shapes, boxes, bidx, lvl, SCALES, (7, 7), sampling_ratio, aligned)
    before = port_ra.roi_align_multilevel_backward_cuda.launches
    out = port_ra.roi_align_multilevel_backward_cuda(g, *args)
    torch.cuda.synchronize()
    assert port_ra.roi_align_multilevel_backward_cuda.launches == before + 1
    ref = port_ra.roi_align_multilevel_backward_plain(g.float(), *args)
    bound = port_ra.roi_align_multilevel_backward_plain(g.float().abs(), *args)
    for o, r, a in zip(out, ref, bound):
        assert o.dtype == dtype and o.shape == r.shape
        assert ((o.float() - r).abs() <= _bwd_tolerance(r, a, dtype)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_runs_both_kernels_on_the_card(cuda, dtype):
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=2)
    feats = [f.requires_grad_(True) for f in feats]
    fwd0 = port_ra.roi_align_multilevel_cuda.launches
    bwd0 = port_ra.roi_align_multilevel_backward_cuda.launches
    out = port_ra.roi_align_multilevel(feats, boxes, bidx, lvl, SCALES, (14, 14), 0, True)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert port_ra.roi_align_multilevel_cuda.launches == fwd0 + 1
    assert port_ra.roi_align_multilevel_backward_cuda.launches == bwd0 + 1
    args = ([tuple(f.shape) for f in feats], boxes, bidx, lvl, SCALES, (14, 14), 0, True)
    ref = port_ra.roi_align_multilevel_backward_plain(g.float(), *args)
    bound = port_ra.roi_align_multilevel_backward_plain(g.float().abs(), *args)
    for f, r, a in zip(feats, ref, bound):
        assert f.grad.dtype == dtype
        assert ((f.grad.float() - r).abs() <= _bwd_tolerance(r, a, dtype)).all()


@pytest.mark.cuda
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    feats, boxes, bidx, lvl = _inputs(cuda, torch.float32, R=8)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.zeros((8, 7, 7, 64), device=cuda)
    with pytest.raises(ValueError, match="grad"):
        port_ra.roi_align_multilevel_backward_cuda(g[:, :5], shapes, boxes, bidx, lvl, SCALES, 7)
    with pytest.raises(ValueError, match="contiguous"):
        port_ra.roi_align_multilevel_backward_cuda(g.transpose(1, 2), shapes, boxes, bidx, lvl, SCALES, 7)
    with pytest.raises(ValueError, match="bfloat16"):
        port_ra.roi_align_multilevel_backward_cuda(g.half(), shapes, boxes, bidx, lvl, SCALES, 7)
