"""The port's NMS and top-k against the JAX package's (``ops/nms.py``
``nms_padded`` and ``batched_nms_padded``, ``lax.top_k``): the keep masks
must be identical, including ties, zero-area boxes and padding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import n, t

from detectron2_tpu.ops.nms import batched_nms_padded as jax_batched_nms
from detectron2_tpu.ops.nms import nms_padded as jax_nms
from detectron2_tpu_torch.ops.nms import batched_nms_padded, nms_padded
from detectron2_tpu_torch.ops.topk import top_k

torch.set_num_threads(1)


def _boxes(rng, K, span=100.0):
    xy = rng.uniform(0, span, (K, 2))
    wh = rng.uniform(1, span / 3, (K, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_jax(seed, thresh):
    rng = np.random.RandomState(seed)
    K = 300
    boxes = _boxes(rng, K)
    # coarse scores: many exact ties, broken by lower index first
    scores = np.round(rng.uniform(0, 1, K), 1).astype(np.float32)
    valid = rng.uniform(size=K) > 0.1
    boxes[5] = boxes[6]  # identical boxes, tied or not
    boxes[7, 2:] = boxes[7, :2]  # zero-area boxes are kept and never suppress
    boxes[8] = boxes[7]
    ref = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, valid=jnp.asarray(valid)))
    out = n(nms_padded(t(boxes), t(scores), thresh, valid=t(valid)))
    np.testing.assert_array_equal(out, ref)
    assert out[7] == (valid[7] and True) and out[8] == valid[8]


def test_nms_all_padded_and_neg_inf_scores():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 40)
    scores = np.full(40, -np.inf, np.float32)
    assert not n(nms_padded(t(boxes), t(scores), 0.5)).any()
    valid = np.zeros(40, bool)
    assert not n(nms_padded(t(boxes), t(rng.uniform(size=40).astype(np.float32)), 0.5, valid=t(valid))).any()


def test_nms_batched_over_leading_dims_matches_per_row():
    rng = np.random.RandomState(4)
    boxes = np.stack([_boxes(rng, 64) for _ in range(3)])
    scores = rng.uniform(size=(3, 64)).astype(np.float32)
    out = n(nms_padded(t(boxes), t(scores), 0.5))
    for i in range(3):
        ref = np.asarray(jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5))
        np.testing.assert_array_equal(out[i], ref)


@pytest.mark.parametrize("block", [1, 7 * 64, 3 * 300 * 64])
def test_nms_in_row_blocks_equals_one_block(monkeypatch, block):
    """The suppression edges built a few rows at a time (as a training RPN
    level of 16 x 12000 boxes needs) give the same keep masks as one block,
    and as the JAX package."""
    import detectron2_tpu_torch.ops.nms as port_nms

    rng = np.random.RandomState(5)
    boxes = np.stack([_boxes(rng, 300) for _ in range(3)])
    scores = np.round(rng.uniform(size=(3, 300)), 1).astype(np.float32)
    whole = n(nms_padded(t(boxes), t(scores), 0.5))
    monkeypatch.setattr(port_nms, "_IOU_BLOCK_ELEMENTS", block)
    np.testing.assert_array_equal(n(nms_padded(t(boxes), t(scores), 0.5)), whole)
    for i in range(3):
        np.testing.assert_array_equal(whole[i], np.asarray(jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_matches_jax(seed):
    rng = np.random.RandomState(seed)
    K = 200
    boxes = _boxes(rng, K)
    scores = np.round(rng.uniform(size=K), 2).astype(np.float32)
    idxs = rng.randint(0, 5, K).astype(np.int32)
    valid = rng.uniform(size=K) > 0.2
    boxes[~valid] *= 50  # padding must not inflate the group offsets
    ref = np.asarray(jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.5, valid=jnp.asarray(valid)))
    out = n(batched_nms_padded(t(boxes), t(scores), t(idxs), 0.5, valid=t(valid)))
    np.testing.assert_array_equal(out, ref)


def test_top_k_breaks_ties_like_lax_top_k():
    rng = np.random.RandomState(5)
    x = np.round(rng.uniform(size=(4, 500)), 1).astype(np.float32)
    x[0, :10] = -np.inf
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 123)
    v, i = top_k(t(x), 123)
    np.testing.assert_array_equal(n(i), np.asarray(ref_i))
    np.testing.assert_array_equal(n(v), np.asarray(ref_v))


def _plain_pairwise_iou(a, b):
    """The formula without in-place steps."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(inter > 0, iou, torch.zeros_like(iou))


@pytest.mark.parametrize("shapes", [((7, 4), (9, 4)), ((3, 7, 4), (1, 50, 4)), ((2, 5, 4), (2, 6, 4))])
def test_pairwise_iou_in_place_has_the_plain_formulas_bits(shapes):
    """Broadcast leading dims (the RPN's gt x anchors), zero-area, inverted
    and NaN boxes: the same bits as the plain formula, and 0 where the
    intersection is empty."""
    from detectron2_tpu_torch.ops.nms import pairwise_iou

    rng = np.random.RandomState(len(shapes[1]) + shapes[1][-2])

    def boxes(shape):
        xy = rng.uniform(0, 50, shape[:-1] + (2,))
        return torch.from_numpy(np.concatenate([xy, xy + rng.uniform(-3, 27, shape[:-1] + (2,))], -1).astype(np.float32))

    a, b = boxes(shapes[0]), boxes(shapes[1])
    a[..., 0, 2:] = a[..., 0, :2]  # zero area
    b[..., 1, :] = float("nan")
    out, ref = pairwise_iou(a, b), _plain_pairwise_iou(a, b)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, ref)
    assert (out[..., 0, :] == 0).all() and (out[..., :, 1] == 0).all()
