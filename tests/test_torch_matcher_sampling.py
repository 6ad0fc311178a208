"""The port's Matcher and padded subsampler against the JAX package's, and
the Matcher against the reference golden. Exact: both compare and rank the
same float32 numbers.

The JAX sampler draws with ``jax.random.uniform``; the test replaces the
``jax`` its module sees with a shim that hands out the same numpy draws the
port's ``sampling.uniform_draws`` returns, so both run their own code on
identical draws.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import load_golden, n, t

import detectron2_tpu.modeling.sampling as jax_sampling
from detectron2_tpu.modeling.matcher import Matcher as JaxMatcher
from detectron2_tpu_torch.modeling import sampling
from detectron2_tpu_torch.modeling.matcher import Matcher

torch.set_num_threads(1)


def _iou(rng, B, M, N):
    iou = rng.rand(B, M, N).astype(np.float32)
    iou[iou < 0.4] = 0
    iou[:, 0, :3] = iou[:, 0, 3:6]  # exact ties for the low-quality rule
    return iou


@pytest.mark.parametrize(
    "thresholds,labels,low_quality",
    [([0.3, 0.7], [0, -1, 1], True), ([0.5], [0, 1], False), ([0.4, 0.5], [0, -1, 1], False)],
)
def test_matcher_matches_jax_on_padded_gt(thresholds, labels, low_quality):
    rng = np.random.RandomState(len(thresholds) + low_quality)
    B, M, N = 3, 6, 50
    iou = _iou(rng, B, M, N)
    gt_valid = np.ones((B, M), bool)
    gt_valid[1, 4:] = False
    gt_valid[2] = False  # no valid gt: everything background
    matches, match_labels = Matcher(thresholds, labels, low_quality)(t(iou), t(gt_valid))
    ref = JaxMatcher(thresholds, labels, low_quality)
    for b in range(B):
        rm, rl = ref(jnp.asarray(iou[b]), gt_valid=jnp.asarray(gt_valid[b]))
        np.testing.assert_array_equal(n(matches[b]), np.asarray(rm))
        np.testing.assert_array_equal(n(match_labels[b]), np.asarray(rl))
    assert match_labels.dtype == torch.int8
    assert (n(match_labels[2]) == labels[0]).all()


def test_matcher_matches_reference_golden():
    g = load_golden("matcher")
    matches, labels = Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)(t(g["iou"]))
    np.testing.assert_array_equal(n(matches), g["matches_lq"])
    np.testing.assert_array_equal(n(labels), g["labels_lq"])
    matches, labels = Matcher([0.5], [0, 1])(t(g["iou"]))
    np.testing.assert_array_equal(n(matches), g["matches_plain"])
    np.testing.assert_array_equal(n(labels), g["labels_plain"])


def _jax_shim(r1, r2):
    """A stand-in for the ``jax`` module of ``detectron2_tpu/modeling/sampling.py``
    whose two uniform draws are r1 and r2."""
    draws = {0: r1, 1: r2}
    random = types.SimpleNamespace(split=lambda key: (0, 1), uniform=lambda k, shape: jnp.asarray(draws[k]))
    return types.SimpleNamespace(random=random, lax=jax.lax)


@pytest.mark.parametrize("N,num_samples,fraction", [(300, 64, 0.25), (40, 64, 0.5), (200, 16, 0.5)])
def test_subsample_labels_padded_matches_jax_on_the_same_draws(N, num_samples, fraction, monkeypatch):
    rng = np.random.RandomState(N)
    B = 3
    labels = rng.choice([-1, 0, 1, 3], size=(B, N), p=[0.2, 0.6, 0.15, 0.05]).astype(np.int64)
    labels[2, :] = np.where(labels[2] > 0, 0, labels[2])  # no positives
    r1 = rng.rand(B, N).astype(np.float32)
    r2 = rng.rand(B, N).astype(np.float32)
    monkeypatch.setattr(sampling, "uniform_draws", lambda shape, generator, device: (t(r1), t(r2)))
    idx, valid, is_pos = sampling.subsample_labels_padded(t(labels), num_samples, fraction, bg_label=0)
    assert idx.shape == valid.shape == is_pos.shape == (B, num_samples)
    for b in range(B):
        monkeypatch.setattr(jax_sampling, "jax", _jax_shim(r1[b], r2[b]))
        ridx, rvalid, rpos = jax_sampling.subsample_labels_padded(
            None, jnp.asarray(labels[b]), num_samples, fraction, bg_label=0
        )
        np.testing.assert_array_equal(n(valid[b]), np.asarray(rvalid))
        np.testing.assert_array_equal(n(is_pos[b]), np.asarray(rpos))
        v = n(valid[b])
        np.testing.assert_array_equal(n(idx[b])[v], np.asarray(ridx)[v])
        # the reference's counts
        n_pos = min(int((labels[b] > 0).sum()), int(num_samples * fraction))
        n_neg = min(int((labels[b] == 0).sum()), num_samples - n_pos)
        assert int(n(is_pos[b]).sum()) == n_pos and int(v.sum()) == n_pos + n_neg


def test_subsample_draws_come_from_the_given_generator():
    labels = torch.from_numpy(np.random.RandomState(0).choice([-1, 0, 1], size=(2, 500)))
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(123)
        outs.append(sampling.subsample_labels_padded(labels, 64, 0.25, generator=gen))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
