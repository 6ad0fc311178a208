"""The port's Cascade R-CNN heads against the JAX package's: each stage's
predictions, the refined and clipped boxes between stages and the averaged
class probabilities on the same pooled features and weights, the tiny
cascade R18-FPN on carried weights, and the reference golden
``tests/goldens/e2e_cascadercnn_r18.npz`` from its d2 .pkl at
``tests/parity/test_e2e_cascade_golden.py:60-91``'s protocol.

Tolerances: stage outputs and boxes 1e-4 relative to their largest value
(matmul sum order); probabilities 1e-6; the model: indices and classes
equal, scores 1e-5, boxes 1e-3.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_inference, jax_model, jax_variables_from_d2, load_golden, n, port_model, t

from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.roi_heads import CascadeROIHeads
from detectron2_tpu_torch.testing import golden_cascade_config, golden_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_cascadercnn_r18")


def _batch(golden):
    return {"image": golden["image"][None].astype(np.float32), "image_sizes": np.array([[320, 320]], np.int32)}


@pytest.fixture(scope="module")
def jax_run(golden):
    cfg = golden_cascade_config()
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    return cfg, jm, variables, jax_inference(jm, variables, _batch(golden))


def test_stages_refinement_and_averaged_probabilities_match_jax(jax_run):
    cfg, jm, variables, _ = jax_run
    rng = np.random.RandomState(0)
    feats = [rng.standard_normal((2, 80 // s, 80 // s, 64)).astype(np.float32) for s in (1, 2, 4, 8)]
    xy = rng.uniform(-20, 300, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 250, (12, 2))], 1).astype(np.float32)
    bidx = np.repeat(np.arange(2, dtype=np.int32), 6)
    sizes = np.array([[320, 320]] * 6 + [[200, 256]] * 6, np.int32)

    def jax_fn(mod, fs, b, i, hw):
        rh, out = mod.roi_heads, []
        for k in range(3):
            if k > 0:
                b = rh._refine_boxes(k - 1, preds, b, hw)
            preds = rh._run_stage(fs, b, i, k, train=False)
            out.append((b, preds[0], preds[1], rh.box_predictor[k].predict_probs(preds)))
        return out

    ref = jm.apply(variables, [jnp.asarray(f) for f in feats], jnp.asarray(boxes), jnp.asarray(bidx), jnp.asarray(sizes), method=jax_fn)
    heads = port_model(cfg, variables).roi_heads
    assert isinstance(heads, CascadeROIHeads) and heads.num_cascade_stages == 3
    b, i, hw, probs = t(boxes), t(bidx), t(sizes), []
    with torch.no_grad():
        for k in range(3):
            if k > 0:
                b = heads._refine_boxes(k - 1, preds, b, hw)
            preds = heads.box_predictor[k](heads.box_head[k](heads.box_pooler([t(f) for f in feats], b, i), False))
            assert preds[1].shape == (12, 4)  # class-agnostic
            probs.append(heads.box_predictor[k].predict_probs(preds))
            for o, r in zip((b, preds[0], preds[1]), ref[k][:3]):
                np.testing.assert_allclose(n(o), np.asarray(r), rtol=0, atol=1e-4 * np.abs(np.asarray(r)).max())
            np.testing.assert_allclose(n(probs[-1]), np.asarray(ref[k][3]), rtol=0, atol=1e-6)
    assert (n(b)[:, 0::2] <= 320).all() and (n(b)[6:, 1::2] <= 200).all() and (n(b) >= 0).all()
    np.testing.assert_allclose(n(sum(probs) / 3), sum(np.asarray(r[3]) for r in ref) / 3, rtol=0, atol=1e-6)
    # each stage decodes with its own weights
    assert [p.box2box_transform.weights for p in heads.box_predictor] == [
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0)]


def test_tiny_cascade_matches_jax_model(golden, jax_run):
    cfg, _, variables, ref = jax_run
    out = port_model(cfg, variables)(_batch(golden))
    assert set(out) == set(ref)
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)


def test_port_reproduces_cascade_golden_from_d2_pkl(golden, tmp_path):
    path = tmp_path / "synthetic_cascade.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_cascade_config(), device="cpu")
    n_w = len(golden["weight_names"])
    assert load_d2_checkpoint(model, str(path)) == f"Loaded {n_w}/{n_w} tensors from the checkpoint."
    out = model(_batch(golden))
    valid = n(out["valid"][0])
    scores, boxes, classes = n(out["scores"][0])[valid], n(out["pred_boxes"][0])[valid], n(out["pred_classes"][0])[valid]
    assert abs(len(scores) - len(golden["out_scores"])) <= 1
    taken = np.zeros(len(scores), bool)
    unmatched = []
    for rs, rc, rbx in zip(golden["out_scores"], golden["out_classes"], golden["out_boxes"]):
        cand = np.where(
            (classes == rc) & ~taken & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4)
            & (np.abs(boxes - rbx).max(axis=1) < 0.05)
        )[0]
        if len(cand) == 0:
            unmatched.append((rs, rc, rbx))
            continue
        taken[cand[0]] = True
    extras = scores[~taken]
    hard = [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]
    assert not hard, hard
    assert taken.sum() >= 0.8 * len(golden["out_scores"]), taken.sum()


def test_cascade_refuses_training():
    """The heads no longer refuse training (``test_torch_cascade_train.py``
    holds it to the JAX package): one IoU per stage from the config, and
    class-agnostic stage predictors."""
    cfg = golden_cascade_config()
    heads = build_model(cfg, device="cpu").roi_heads
    assert heads.cascade_ious == tuple(cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS) == (0.5, 0.6, 0.7)
    assert all(p.bbox_pred.out_features == 4 for p in heads.box_predictor)
