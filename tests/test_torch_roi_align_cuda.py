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
(the kernel sums each bin's sample weights before it multiplies, and adds
rois in tile-list order: another order than the plain version's), plus half
a bf16 ulp in bfloat16; two launches on the same inputs agree bit for bit.
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
    if R >= 8:
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


def _forward_matches_plain(feats, boxes, bidx, lvl, scales, size, dtype):
    out = port_ra.roi_align_multilevel_cuda(feats, boxes, bidx, lvl, scales, size, 0, True)
    torch.cuda.synchronize()
    ref = port_ra.roi_align_multilevel_plain([f.float() for f in feats], boxes, bidx, lvl, scales, size, 0, True)
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 1e-5 + (2.0**-8 * ref.abs() if dtype == torch.bfloat16 else 0)
    assert ((out.float() - ref).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [8, 64, 256, 260, 4])
@pytest.mark.parametrize("R", [1, 37, 200])
@pytest.mark.parametrize("size", [7, 14])
def test_forward_kernel_at_the_edges_of_its_paths(cuda, dtype, C, R, size):
    """Whole 16-byte words of channels and not (the one-channel path), one
    roi, roi counts that split a roi's output rows over several blocks."""
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=3, R=R, C=C)
    _forward_matches_plain(feats, boxes, bidx, lvl, SCALES, size, dtype)
    assert port_ra.roi_align_multilevel_cuda.last_path == ("vector" if C % (16 // feats[0].element_size()) == 0 else "scalar")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_kernel_on_one_level_thin_levels_and_no_roi(cuda, dtype):
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=4, C=64)
    # one level only
    _forward_matches_plain(feats[:1], boxes, bidx, torch.zeros_like(lvl), SCALES[:1], 7, dtype)
    # levels one pixel high and one pixel wide
    thin = [feats[0][:, :1].contiguous(), feats[1][:, :, :1].contiguous(), feats[2]]
    _forward_matches_plain(thin, boxes, bidx, lvl, SCALES, 7, dtype)
    # no roi: nothing launches
    before = port_ra.roi_align_multilevel_cuda.launches
    out = port_ra.roi_align_multilevel_cuda(feats, boxes[:0], bidx[:0], lvl[:0], SCALES, 7)
    assert out.shape == (0, 7, 7, 64) and port_ra.roi_align_multilevel_cuda.launches == before
    # an offset view of the features: the pointers are no longer 16-byte aligned
    if dtype == torch.bfloat16:
        shifted = [torch.empty(f.numel() + 1, dtype=dtype, device=cuda)[1:].view(f.shape).copy_(f) for f in feats]
        _forward_matches_plain(shifted, boxes, bidx, lvl, SCALES, 7, dtype)
        assert port_ra.roi_align_multilevel_cuda.last_path == "scalar"


def _image_rois(rng, R, B, H, W):
    """Rois over B images of H x W pixels, partly off the image, with
    zero-area rows."""
    xy = rng.uniform(-0.1, 1.0, (R, 2)) * (W, H)
    wh = np.exp(rng.uniform(np.log(2), np.log(900), (R, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[::17, 2] = boxes[::17, 0]
    return boxes, rng.randint(0, B, R).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R", [1, 37, 1000])
@pytest.mark.parametrize("aligned,sampling_ratio", [(True, 0), (False, 2)], ids=["aligned-s0", "v1-s2"])
def test_forward_kernel_at_the_c4_pool_shape(cuda, dtype, R, aligned, sampling_ratio):
    """The C4 heads' pool: one level (res4 of 800x1344 images at stride
    16), 1024 channels, 14x14 bins of 2x2 samples, on the 16-byte path."""
    rng = np.random.RandomState(R)
    feats = [torch.from_numpy(rng.standard_normal((2, 50, 84, 1024)).astype(np.float32)).to(cuda, dtype)]
    boxes, bidx = _image_rois(rng, R, 2, 800, 1344)
    boxes, bidx = torch.from_numpy(boxes).to(cuda), torch.from_numpy(bidx).to(cuda)
    lvl = torch.zeros(R, dtype=torch.int32, device=cuda)
    args = (feats, boxes, bidx, lvl, (1 / 16,), (14, 14), sampling_ratio, aligned)
    out = port_ra.roi_align_multilevel_cuda(*args)
    torch.cuda.synchronize()
    assert port_ra.roi_align_multilevel_cuda.last_path == "vector"
    ref = port_ra.roi_align_multilevel_plain([f.float() for f in feats], *args[1:])
    assert out.shape == ref.shape == (R, 14, 14, 1024) and out.dtype == dtype
    tol = 1e-5 + (2.0**-8 * ref.abs() if dtype == torch.bfloat16 else 0)
    assert ((out.float() - ref).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_kernel_at_the_keypoint_pool_shape(cuda, dtype):
    """The keypoint head's pool: 14x14 over p2-p5 of 800x1344 images at 256
    channels, rois assigned to levels by their size."""
    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    rng = np.random.RandomState(5)
    feats = [
        torch.from_numpy(rng.standard_normal((2, 800 // s, 1344 // s, 256)).astype(np.float32)).to(cuda, dtype)
        for s in (4, 8, 16, 32)
    ]
    boxes, bidx = _image_rois(rng, 200, 2, 800, 1344)
    boxes, bidx = torch.from_numpy(boxes).to(cuda), torch.from_numpy(bidx).to(cuda)
    lvl = assign_boxes_to_levels(boxes, 2, 5)
    assert len(torch.unique(lvl)) == 4
    _forward_matches_plain(feats, boxes, bidx, lvl, (1 / 4, 1 / 8, 1 / 16, 1 / 32), 14, dtype)
    assert port_ra.roi_align_multilevel_cuda.last_path == "vector"


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
    """float32: the kernel's sum order differs from the plain version's, whose
    error A = the backward of |g| bounds; bfloat16: plus half a bf16 ulp of
    the float32 result (one rounding)."""
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


def _backward_matches_plain(g, shapes, boxes, bidx, lvl, scales, size, sampling_ratio=0, aligned=True):
    """The kernel against the plain version in float32 within
    ``_bwd_tolerance``, on a tolerance that does not cover |ref| everywhere
    (where a kernel writing zeros would pass); returns the kernel's output."""
    args = (shapes, boxes, bidx, lvl, scales, size, sampling_ratio, aligned)
    out = port_ra.roi_align_multilevel_backward_cuda(g, *args)
    torch.cuda.synchronize()
    ref = port_ra.roi_align_multilevel_backward_plain(g.float(), *args)
    bound = port_ra.roi_align_multilevel_backward_plain(g.float().abs(), *args)
    margin = float("-inf")
    for o, r, a in zip(out, ref, bound):
        assert o.dtype == g.dtype and o.shape == r.shape
        tol = _bwd_tolerance(r, a, g.dtype)
        assert ((o.float() - r).abs() <= tol).all()
        margin = max(margin, (r.abs() - tol).max().item())
    if boxes.shape[0]:
        assert margin > 0, "the tolerance covers |ref| everywhere"
    return out


def _cotangent(cuda, R, size, C, dtype, seed=0):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return torch.randn((R, size, size, C), generator=gen, device=cuda).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "v1"])
def test_backward_kernel_is_bitwise_reproducible(cuda, dtype, aligned):
    """Every (pixel, channel) has one owner and every sum one order: two
    launches on the same inputs give the same bits, with many rois stacked
    on the same pixels."""
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=5, R=300)
    boxes[:100] = boxes[0]
    shapes = [tuple(f.shape) for f in feats]
    g = _cotangent(cuda, 300, 7, 64, dtype)
    args = (shapes, boxes, bidx, lvl, SCALES, (7, 7), 0, aligned)
    a = port_ra.roi_align_multilevel_backward_cuda(g, *args)
    b = port_ra.roi_align_multilevel_backward_cuda(g, *args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 4, 8, 64, 256, 260])
@pytest.mark.parametrize("R", [0, 1, 37, 4096])
def test_backward_kernel_at_the_edges_of_its_paths(cuda, dtype, C, R):
    """Whole 16-byte words of channels and not (the one-channel path), no
    roi (every pixel written as zero by the same kernels), one roi, many."""
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=6, R=max(R, 1), C=C)
    boxes[0] = torch.tensor([30.0, 20.0, 120.0, 90.0])  # on the map: a lone roi must leave a gradient
    boxes, bidx, lvl = boxes[:R].contiguous(), bidx[:R].contiguous(), lvl[:R].contiguous()
    shapes = [tuple(f.shape) for f in feats]
    before = port_ra.roi_align_multilevel_backward_cuda.launches
    out = _backward_matches_plain(_cotangent(cuda, R, 7, C, dtype), shapes, boxes, bidx, lvl, SCALES, (7, 7))
    assert port_ra.roi_align_multilevel_backward_cuda.launches == before + 1
    word = 16 // feats[0].element_size()
    assert port_ra.roi_align_multilevel_backward_cuda.last_path == ("vector" if C % word == 0 else "scalar")
    if R == 0:
        assert all(o.eq(0).all() for o in out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sampling_ratio", [0, 1, 3])
def test_backward_kernel_on_one_level_thin_levels_and_unaligned_pointers(cuda, dtype, sampling_ratio):
    feats, boxes, bidx, lvl = _inputs(cuda, dtype, seed=7, C=64)
    shapes = [tuple(f.shape) for f in feats]
    g = _cotangent(cuda, boxes.shape[0], 14, 64, dtype)
    # one level only
    _backward_matches_plain(g, shapes[:1], boxes, bidx, torch.zeros_like(lvl), SCALES[:1], (14, 14), sampling_ratio)
    # levels one pixel high and one pixel wide
    thin = [(2, 1, 56, 64), (2, 20, 1, 64), shapes[2]]
    _backward_matches_plain(g, thin, boxes, bidx, lvl, SCALES, (14, 14), sampling_ratio, False)
    assert port_ra.roi_align_multilevel_backward_cuda.last_path == "vector"
    # an offset view of the cotangent: no longer 16-byte aligned
    shifted = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:].view(g.shape).copy_(g)
    _backward_matches_plain(shifted, shapes, boxes, bidx, lvl, SCALES, (14, 14), sampling_ratio)
    assert port_ra.roi_align_multilevel_backward_cuda.last_path == "scalar"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_on_hot_tiles_and_a_roi_over_a_whole_p5(cuda, dtype):
    """500 rois stacked on one 16x16 tile (one list walked 500 times), and
    rois spanning the whole of a 25x42 p5 (every tile of it lists them), on
    the train step's four levels at 1/8 of its size, C = 256."""
    shapes = [(2, 100 // s, 168 // s, 256) for s in (1, 2, 4, 8)]
    scales = (0.25, 0.125, 0.0625, 0.03125)
    rng = np.random.RandomState(8)
    xy = rng.uniform(8, 20, (500, 2)).astype(np.float32)
    stacked = np.concatenate([xy, xy + rng.uniform(0, 40, (500, 2)).astype(np.float32)], 1)
    boxes = torch.from_numpy(stacked).to(cuda)
    lvl = torch.zeros(500, dtype=torch.int32, device=cuda)
    bidx = torch.ones(500, dtype=torch.int32, device=cuda)
    for size in (7, 14):
        _backward_matches_plain(_cotangent(cuda, 500, size, 256, dtype), shapes, boxes, bidx, lvl, scales, (size, size))
    whole = torch.tensor([[0.0, 0.0, 1344.0, 800.0], [-20.0, -30.0, 1400.0, 850.0], [600.0, 0.0, 610.0, 800.0]], device=cuda)
    shapes5 = [(1, 200, 336, 256), (1, 100, 168, 256), (1, 50, 84, 256), (1, 25, 42, 256)]
    lvl3 = torch.full((3,), 3, dtype=torch.int32, device=cuda)
    bidx3 = torch.zeros(3, dtype=torch.int32, device=cuda)
    for size in (7, 14):
        for aligned in (True, False):
            _backward_matches_plain(_cotangent(cuda, 3, size, 256, dtype), shapes5, whole, bidx3, lvl3, scales, (size, size), 0, aligned)


@pytest.mark.cuda
def test_backward_kernel_needs_no_memory_beyond_its_output(cuda):
    """Above its inputs, one call holds the output and the int32 scratch
    (axis tables, tile lists): at most max(16 MiB, 1% of the output) more
    than the output, at the train step's levels and the box pool's 4096
    rois; the float32 accumulator over all levels is gone."""
    shapes = [(8, 800 // s, 1344 // s, 256) for s in (4, 8, 16, 32)]
    scales = (0.25, 0.125, 0.0625, 0.03125)
    rng = np.random.RandomState(9)
    xy = rng.uniform(0, 1200, (4096, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(2, 300, (4096, 2)).astype(np.float32)], 1)).to(cuda)
    bidx = torch.from_numpy(rng.randint(0, 8, 4096).astype(np.int32)).to(cuda)
    lvl = torch.from_numpy(rng.randint(0, 4, 4096).astype(np.int32)).to(cuda)
    g = _cotangent(cuda, 4096, 7, 256, torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = port_ra.roi_align_multilevel_backward_cuda(g, shapes, boxes, bidx, lvl, scales, (7, 7))
    torch.cuda.synchronize()
    out_bytes = sum(o.numel() * o.element_size() for o in out)
    extra = torch.cuda.max_memory_allocated() - base - out_bytes
    assert extra <= max(16 * 2**20, out_bytes // 100), (extra, out_bytes)
