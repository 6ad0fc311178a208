"""The port's RoIAlign backward: the plain version against ``jax.vjp`` of the
JAX package's exact formulation (``_roi_align_multilevel_xla``, the function
the JAX package differentiates on the CPU), the autograd Function through
``torch.autograd.gradcheck`` in float64, and the separable crop of the mask
targets. The CUDA kernel's own tests, which need the card, are in
``test_torch_roi_align_cuda.py``.

Tolerance, float32: per element |port - jax| <= 1e-5 * A + 1e-7, A the same
backward of |g|: the two add the same terms in another order, and A bounds
the rounding error of such a sum.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import n, t

from detectron2_tpu.ops.roi_align import _roi_align_multilevel_xla, roi_align_separable as jax_separable
from detectron2_tpu_torch.ops import roi_align as port_ra

torch.set_num_threads(1)

SCALES = (0.25, 0.125, 0.0625)
LEVEL_HW = ((40, 56), (20, 28), (10, 14))
NAMES = ("0", "1", "2")


def _inputs(seed=0, R=48, C=8):
    """Rois partly and fully off the map, zero-area, zero-width and padded rows."""
    rng = np.random.RandomState(seed)
    shapes = [(2, h, w, C) for h, w in LEVEL_HW]
    xy = rng.uniform(-40, 230, (R, 2)).astype(np.float32)
    wh = rng.uniform(0, 150, (R, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[3, 2:] = boxes[3, :2]
    boxes[4, 2] = boxes[4, 0]
    boxes[-6:] = 0
    boxes[7] = [-80, -60, -50, -20]
    bidx = rng.randint(0, 2, R).astype(np.int32)
    lvl = rng.randint(0, 3, R).astype(np.int32)
    return shapes, boxes, bidx, lvl


def _jax_vjp(shapes, boxes, bidx, lvl, g, output_size, sr, aligned):
    feats = {name: jnp.zeros(s, jnp.float32) for name, s in zip(NAMES, shapes)}

    def fwd(f):
        return _roi_align_multilevel_xla(
            f, jnp.asarray(boxes), jnp.asarray(bidx), jnp.asarray(lvl), NAMES, SCALES, output_size, sr, aligned
        )

    _, vjp = jax.vjp(fwd, feats)
    (d,) = vjp(jnp.asarray(g))
    return [np.asarray(d[name]) for name in NAMES]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("output_size", [(7, 7), (5, 3)])
def test_plain_backward_matches_jax_vjp(aligned, sampling_ratio, output_size):
    shapes, boxes, bidx, lvl = _inputs()
    g = np.random.RandomState(1).standard_normal((len(boxes),) + output_size + (8,)).astype(np.float32)
    ref = _jax_vjp(shapes, boxes, bidx, lvl, g, output_size, sampling_ratio, aligned)
    args = (shapes, t(boxes), t(bidx), t(lvl), SCALES, output_size, sampling_ratio, aligned)
    out = port_ra.roi_align_multilevel_backward_plain(t(g), *args)
    bound = port_ra.roi_align_multilevel_backward_plain(t(np.abs(g)), *args)
    assert [tuple(o.shape) for o in out] == [tuple(s) for s in shapes]
    assert all(o.dtype == torch.float32 for o in out)
    for o, r, a in zip(out, ref, bound):
        assert (np.abs(n(o) - r) <= 1e-5 * n(a) + 1e-7).all()
    # every level received gradient and the fully-outside roi none
    assert all(np.abs(r).sum() > 0 for r in ref)


def test_autograd_function_gradcheck_float64():
    rng = np.random.RandomState(3)
    shapes = [(2, 6, 7, 3), (2, 3, 4, 3)]
    feats = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True) for s in shapes]
    boxes = torch.tensor([[2.0, 3.0, 20.0, 17.0], [-4.0, -2.0, 9.0, 30.0], [5.0, 5.0, 5.0, 9.0], [0, 0, 0, 0]])
    bidx = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    lvl = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    for aligned, sr in ((True, 0), (False, 2)):
        fn = lambda *f: port_ra.roi_align_multilevel(list(f), boxes, bidx, lvl, (0.25, 0.125), (2, 3), sr, aligned)  # noqa: E731
        assert torch.autograd.gradcheck(fn, tuple(feats), eps=1e-6, atol=1e-8)


def test_autograd_backward_equals_plain_backward_and_leaves_boxes_without_gradient():
    shapes, boxes, bidx, lvl = _inputs(seed=4, R=20)
    rng = np.random.RandomState(5)
    feats = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True) for s in shapes]
    tb = t(boxes).requires_grad_(True)
    out = port_ra.roi_align_multilevel(feats, tb, t(bidx), t(lvl), SCALES, 7, 0, True)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    out.backward(g)
    ref = port_ra.roi_align_multilevel_backward_plain(g, shapes, t(boxes), t(bidx), t(lvl), SCALES, 7, 0, True)
    for f, r in zip(feats, ref):
        torch.testing.assert_close(f.grad, r, rtol=0, atol=0)
    assert tb.grad is None


def test_inference_mode_forward_is_unchanged():
    shapes, boxes, bidx, lvl = _inputs(seed=6, R=16)
    rng = np.random.RandomState(7)
    feats = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    args = (t(boxes), t(bidx), t(lvl), SCALES, 7, 0, True)
    with torch.inference_mode():
        out = port_ra.roi_align_multilevel(feats, *args)
    assert not out.requires_grad
    torch.testing.assert_close(out, port_ra.roi_align_multilevel_plain(feats, *args), rtol=0, atol=0)


def test_cuda_backward_wrapper_refuses_cpu_tensors():
    shapes, boxes, bidx, lvl = _inputs(R=8)
    g = torch.zeros((8, 7, 7, 8))
    with pytest.raises(ValueError, match="expected cuda"):
        port_ra.roi_align_multilevel_backward_cuda(g, shapes, t(boxes), t(bidx), t(lvl), SCALES, 7)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 2, 3])
def test_roi_align_separable_matches_jax(aligned, sampling_ratio):
    rng = np.random.RandomState(8)
    maps = (rng.rand(6, 28, 28) > 0.5).astype(np.float32)
    xy = rng.uniform(-8, 30, (40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(0, 30, (40, 2)).astype(np.float32)], 1)
    boxes[5, 2:] = boxes[5, :2]
    src = rng.randint(0, 6, 40).astype(np.int32)
    ref = jax_separable(jnp.asarray(maps), jnp.asarray(boxes), jnp.asarray(src), (28, 28), sampling_ratio, aligned)
    out = port_ra.roi_align_separable(t(maps), t(boxes), t(src), (28, 28), sampling_ratio, aligned)
    assert out.shape == (40, 28, 28) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=0, atol=1e-6)
