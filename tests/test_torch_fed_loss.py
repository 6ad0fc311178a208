"""The port's sigmoid cross entropy and federated loss against the JAX
package's, on the CPU in float32.

Both packages get the same Gumbel draws: the port's through
``fast_rcnn.gumbel_draws``, the JAX package's through a ``jax`` in its
``modeling/roi_heads/fast_rcnn.py`` whose ``random.gumbel`` returns them
(as ``_torch_port.SameDraws`` does for the proposal sampler).

- ``fed_loss_class_mask`` is ``==`` the JAX one under the same draws: with
  padding, a zero weight, more appeared classes than the quota, the
  background present or not, and drawn cases at 1203 classes; the kept
  count is the appeared foreground classes plus ``max(F - n_appeared, 0)``
  draws (the background counted in ``n_appeared``), capped by the classes
  of nonzero weight.
- ``FastRCNNOutputLayers.losses`` with sigmoid CE, with and without the
  federated loss, equals JAX's in value and gradient (``jax.grad``) to 2e-5;
  the sigmoid ``predict_probs`` and ``inference`` to 2e-5.
- A tiny R18-FPN Mask R-CNN at 1203 classes with ``USE_SIGMOID_CE`` and
  ``USE_FED_LOSS`` (weights from the builtin ``lvis_v1_train``), on the same
  weights, batch and draws: the training losses at rtol 2e-5 (and every
  gradient as ``test_torch_train_step.py`` holds them) and, at weights of
  scale 0.05 whose sigmoids do not saturate, the detections at 2e-5.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import detectron2_tpu.modeling.roi_heads.fast_rcnn as jax_fast_rcnn
from detectron2_tpu.data.detection_utils import get_fed_loss_cls_weights as jax_fed_weights
from detectron2_tpu_torch.data.detection_utils import get_fed_loss_cls_weights
from detectron2_tpu_torch.modeling.roi_heads import fast_rcnn
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers, fed_loss_class_mask

from _torch_port import SameDraws, assert_train_step_matches, jax_inference, jax_model, jax_random_variables, n, port_model, t
from test_torch_train_step import make_batch, tiny_cfg

torch.set_num_threads(1)
C_LVIS = 1203


class JaxWithGumbel:
    """``jax`` for the JAX ``fast_rcnn`` module, with ``random.gumbel``
    returning fixed draws (``draws[0]`` for any key)."""

    def __init__(self, draws: np.ndarray):
        self.random = types.SimpleNamespace(gumbel=lambda key, shape, dtype=jnp.float32: jnp.asarray(draws[: shape[0]], dtype))

    def __getattr__(self, name):
        return getattr(jax, name)


def same_gumbel(monkeypatch, draws: np.ndarray) -> None:
    monkeypatch.setattr(jax_fast_rcnn, "jax", JaxWithGumbel(draws))
    monkeypatch.setattr(fast_rcnn, "gumbel_draws", lambda c, generator, device: torch.from_numpy(draws[:c]).to(device))


def gumbel(seed: int, c: int) -> np.ndarray:
    return np.random.RandomState(seed).gumbel(size=c).astype(np.float32)


MASK_CASES = {
    # gt classes (C = background, -1 padding), C, F, zero-weight classes
    "padding": ([2, -1, -1, -1], 16, 6, ()),
    "zero_weight": ([1, 30, 30], 30, 12, (5, 20)),
    "over_quota": ([0, 1, 2, 3, 4, 5, 20], 20, 4, ()),
    "background_counts": ([0, 3, 3, 7, 40, 40, -1, -1], 40, 10, ()),
    "few_nonzero": ([0, 9], 9, 8, (1, 2, 3, 4, 5, 6)),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
@pytest.mark.parametrize("seed", range(3))
def test_fed_loss_class_mask_equals_jax_under_the_same_draws(case, seed):
    gt, C, F, zero = MASK_CASES[case]
    rng = np.random.RandomState(seed)
    w = rng.rand(C).astype(np.float32) + 0.1
    w[list(zero)] = 0.0
    g = gumbel(seed, C)
    gt = np.asarray(gt, np.int32)
    valid = gt >= 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fast_rcnn, "jax", JaxWithGumbel(g))
        ref = np.asarray(jax_fast_rcnn.fed_loss_class_mask(
            jax.random.PRNGKey(0), jnp.asarray(gt), jnp.asarray(valid), C, F, jnp.asarray(w)))
    ours = n(fed_loss_class_mask(t(g), t(gt), t(valid), C, F, t(w)))
    np.testing.assert_array_equal(ours, ref)
    appeared_fg = {int(c) for c in gt[valid] if c < C}
    n_appeared = len({int(c) for c in gt[valid]})
    drawable = int(((w > 0) & ~np.isin(np.arange(C), list(appeared_fg))).sum())
    assert ours.sum() == len(appeared_fg) + min(max(F - n_appeared, 0), drawable)
    assert ours[list(appeared_fg)].all() and not ours[[z for z in zero if z not in appeared_fg]].any()


@pytest.mark.parametrize("seed", range(4))
def test_fed_loss_class_mask_at_lvis_width_equals_jax(seed):
    """1203 classes, the LVIS weights at power 0.5, 512 sampled slots."""
    rng = np.random.RandomState(seed)
    w = get_fed_loss_cls_weights("lvis_v1_train", 0.5)
    np.testing.assert_array_equal(w, jax_fed_weights("lvis_v1_train", 0.5))
    gt = np.where(rng.rand(512) < 0.25, rng.randint(0, 40 * (seed + 1), 512), C_LVIS).astype(np.int32)
    gt[rng.rand(512) < 0.1] = -1
    g = gumbel(10 + seed, C_LVIS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fast_rcnn, "jax", JaxWithGumbel(g))
        ref = np.asarray(jax_fast_rcnn.fed_loss_class_mask(
            jax.random.PRNGKey(0), jnp.asarray(gt), jnp.asarray(gt >= 0), C_LVIS, 50, jnp.asarray(w)))
    ours = n(fed_loss_class_mask(t(g), t(gt), t(gt >= 0), C_LVIS, 50, t(w)))
    np.testing.assert_array_equal(ours, ref)
    n_fg = len({int(c) for c in gt[gt >= 0] if c < C_LVIS})
    assert ours.sum() == n_fg + max(50 - (n_fg + 1), 0)


def test_gumbel_draws_are_standard_gumbel():
    """The port's own draws: mean ~ Euler's gamma, variance ~ pi^2 / 6, one
    generator's draws reproducible."""
    gen = torch.Generator().manual_seed(0)
    g = fast_rcnn.gumbel_draws(200000, gen, "cpu")
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - np.pi**2 / 6) < 0.03
    a = fast_rcnn.gumbel_draws(7, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a, fast_rcnn.gumbel_draws(7, torch.Generator().manual_seed(3), "cpu"))


def _predictions(seed, R=48, C=30, agnostic=False):
    rng = np.random.RandomState(seed)
    scores = (rng.standard_normal((R, C + 1)) * 2).astype(np.float32)
    deltas = (rng.standard_normal((R, 4 if agnostic else 4 * C)) * 0.3).astype(np.float32)
    xy = rng.uniform(0, 200, (R, 2))
    proposals = np.concatenate([xy, xy + rng.uniform(8, 100, (R, 2))], 1).astype(np.float32)
    gt_boxes = (proposals + rng.uniform(-6, 6, (R, 4))).astype(np.float32)
    gt_classes = np.where(rng.rand(R) < 0.3, rng.randint(0, C, R), C).astype(np.int32)
    gt_classes[rng.rand(R) < 0.15] = -1
    return scores, deltas, proposals, gt_boxes, gt_classes


@pytest.mark.parametrize("fed", [False, True], ids=["sigmoid_ce", "fed_loss"])
@pytest.mark.parametrize("seed", range(2))
def test_sigmoid_ce_losses_and_gradients_match_jax(fed, seed):
    C, F = 30, 12
    scores, deltas, proposals, gt_boxes, gt_classes = _predictions(seed, C=C)
    weights = tuple(float(x) for x in np.random.RandomState(seed).rand(C) + 0.05) if fed else None
    opts = dict(use_sigmoid_ce=True, use_fed_loss=fed, fed_loss_num_classes=F, fed_loss_cls_weights=weights)
    g = gumbel(seed, C)
    jm = jax_fast_rcnn.FastRCNNOutputLayers(num_classes=C, **opts)

    def jax_loss(s, d):
        losses = jm.apply({}, (s, d), jnp.asarray(proposals), jnp.asarray(gt_boxes), jnp.asarray(gt_classes),
                          method=jax_fast_rcnn.FastRCNNOutputLayers.losses, rngs={"sampling": jax.random.PRNGKey(0)})
        return losses["loss_cls"] + losses["loss_box_reg"], losses

    with pytest.MonkeyPatch.context() as mp:
        same_gumbel(mp, g)
        (_, ref), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(scores), jnp.asarray(deltas))
        layer = FastRCNNOutputLayers(16, C, **opts)
        s, d = t(scores).requires_grad_(True), t(deltas).requires_grad_(True)
        ours = layer.losses((s, d), t(proposals), t(gt_boxes), t(gt_classes))
    for k in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(ours[k].item(), float(ref[k]), rtol=2e-5, err_msg=k)
    (ours["loss_cls"] + ours["loss_box_reg"]).backward()
    for grad, ref_grad in zip((s.grad, d.grad), ref_grads):
        np.testing.assert_allclose(n(grad), np.asarray(ref_grad), rtol=0, atol=2e-5 * np.abs(ref_grad).max())
    # the federated mask drops classes: the loss is at most the unmasked one
    if fed:
        layer_all = FastRCNNOutputLayers(16, C, use_sigmoid_ce=True)
        full = layer_all.losses((t(scores), t(deltas)), t(proposals), t(gt_boxes), t(gt_classes))["loss_cls"]
        assert 0 < ours["loss_cls"].item() < full.item()


def test_sigmoid_predict_probs_and_inference_match_jax():
    C = 30
    scores, deltas, proposals, _, _ = _predictions(5, R=2 * 24, C=C)
    jm = jax_fast_rcnn.FastRCNNOutputLayers(num_classes=C, use_sigmoid_ce=True, test_score_thresh=0.3, test_topk_per_image=20)
    layer = FastRCNNOutputLayers(16, C, use_sigmoid_ce=True, test_score_thresh=0.3, test_topk_per_image=20)
    preds = (jnp.asarray(scores), jnp.asarray(deltas))
    ref_probs = jm.apply({}, preds, method=jax_fast_rcnn.FastRCNNOutputLayers.predict_probs)
    probs = layer.predict_probs((t(scores), t(deltas)))
    np.testing.assert_allclose(n(probs), np.asarray(ref_probs), rtol=2e-5, atol=1e-7)
    assert not np.allclose(n(probs).sum(1), 1.0)  # sigmoids, not a softmax
    props = proposals.reshape(2, 24, 4)
    valid = np.ones((2, 24), bool)
    valid[1, 20:] = False
    sizes = np.array([[240, 300], [200, 260]], np.int32)
    ref = jm.apply({}, preds, jnp.asarray(props), jnp.asarray(valid), jnp.asarray(sizes),
                   method=jax_fast_rcnn.FastRCNNOutputLayers.inference)
    out = layer.inference((t(scores), t(deltas)), t(props), t(valid), t(sizes))
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), np.asarray(ref["scores"]), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(n(out["pred_boxes"]), np.asarray(ref["pred_boxes"]), rtol=2e-5, atol=1e-4)
    assert n(out["valid"]).sum() > 10


def lvis_tiny_cfg():
    """``test_torch_train_step.py``'s tiny R18-FPN at LVIS's 1203 classes,
    sigmoid CE with the federated loss (weights of the builtin
    ``lvis_v1_train``), 60 detections an image."""
    cfg = tiny_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = C_LVIS
    cfg.MODEL.ROI_BOX_HEAD.USE_SIGMOID_CE = True
    cfg.MODEL.ROI_BOX_HEAD.USE_FED_LOSS = True
    cfg.DATASETS.TRAIN = ("lvis_v1_train",)
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.3
    cfg.TEST.DETECTIONS_PER_IMAGE = 60
    return cfg


@pytest.fixture(scope="module")
def lvis_run():
    """Same sampler draws and Gumbel draws in both packages; the JAX side's
    losses, gradients and detections at seeded weights."""
    g = gumbel(21, C_LVIS)
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        same_gumbel(mp, g)
        cfg = lvis_tiny_cfg()
        jm = jax_model(cfg)
        variables = jax_random_variables(jm, seed=5, scale=0.1)
        batch = {k: jnp.asarray(v) for k, v in make_batch().items()}

        def loss_fn(params):
            losses = jm.apply(params, batch, train=True, rngs={"sampling": jax.random.PRNGKey(0)})
            return sum(jax.tree_util.tree_leaves(losses)), losses

        from detectron2_tpu_torch.checkpoint import convert_jax_params

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
        # at scale 0.1 the sigmoids saturate to 1.0 and the boxes' exp(dw)
        # amplifies float32 noise; the detections are held at scale 0.05
        det_variables = jax_random_variables(jm, seed=5, scale=0.05)
        dets = jax_inference(jm, det_variables, {k: batch[k] for k in ("image", "image_sizes")})
        yield {
            "cfg": cfg, "variables": variables, "losses": {k: float(v) for k, v in losses.items()},
            "grads": convert_jax_params(jax.tree_util.tree_map(np.asarray, grads)), "dets": dets,
            "det_variables": det_variables,
        }


def test_tiny_lvis_model_losses_match_jax(lvis_run):
    model = port_model(lvis_run["cfg"], lvis_run["variables"])
    predictor = model.roi_heads.box_predictor
    assert predictor.use_sigmoid_ce and predictor.use_fed_loss and predictor.fed_loss_num_classes == 50
    np.testing.assert_array_equal(predictor.fed_loss_weights.numpy(), get_fed_loss_cls_weights("lvis_v1_train", 0.5))
    assert "roi_heads.box_predictor.fed_loss_weights" not in model.state_dict()
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        same_gumbel(mp, gumbel(21, C_LVIS))
        losses = assert_train_step_matches(model, make_batch(), lvis_run["losses"], lvis_run["grads"], loss_rtol=2e-5)
    assert all(np.isfinite(v) for v in losses.values())


def test_tiny_lvis_model_detections_match_jax(lvis_run):
    model = port_model(lvis_run["cfg"], lvis_run["det_variables"])
    batch = make_batch()
    with torch.no_grad():
        out = model({k: batch[k] for k in ("image", "image_sizes")})
    ref = lvis_run["dets"]
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    assert n(out["valid"]).sum() > 20
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=2e-5, atol=2e-5 * np.abs(ref["pred_boxes"]).max())
    assert 0.5 < ref["scores"][ref["valid"]].min() and ref["scores"].max() < 0.99  # not saturated
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=2e-5)
