"""The port's test-time augmentation against the JAX package's:
``DatasetMapperTTA``'s copies, the model's ``given_boxes`` route
(``forward_with_given_boxes``), ``GeneralizedRCNNWithTTA`` on the R18-FPN
fixture with carried weights, and the reference golden
``tests/goldens/e2e_tta_r18.npz`` (shortest edge 256 and 320, each flipped)
from its d2 .pkl at ``tests/parity/test_e2e_tta_golden.py:89,113-115``'s
bounds.

The port pastes the averaged masks on the device in float32, the JAX
package on the host with float64 box edges (ROADMAP C "Known
differences"): the pasted masks may differ on the 0.5 contour, bounded here
at 1e-4 of the pixels; boxes 1e-3, scores 1e-5, classes equal.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import jax_cfg_from_port, jax_model, jax_variables_from_d2, load_golden, n, port_model

from detectron2_tpu.modeling.test_time_augmentation import DatasetMapperTTA as JaxMapperTTA
from detectron2_tpu.modeling.test_time_augmentation import GeneralizedRCNNWithTTA as JaxTTA
from detectron2_tpu_torch.engine import DefaultPredictor
from detectron2_tpu_torch.modeling.test_time_augmentation import DatasetMapperTTA, GeneralizedRCNNWithTTA
from detectron2_tpu_torch.testing import golden_state_dict, golden_tta_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_tta_r18")


@pytest.fixture(scope="module")
def models(golden):
    cfg = golden_tta_config()
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    return cfg, jm, variables, port_model(cfg, variables)


def _input(golden):
    return {"image": golden["image"], "height": 320, "width": 320}


@pytest.mark.parametrize("shape", [(320, 320), (200, 300)])
def test_mapper_copies_equal_the_jax_mapper(golden, shape):
    """Every copy's image ``==`` the JAX one, and its transforms map boxes
    alike; (200, 300) is an image already resized from 320x320."""
    cfg = golden_tta_config()
    img = golden["image"][: shape[0], : shape[1]]
    d = {"image": img, "height": 320, "width": 320}
    ours = DatasetMapperTTA.from_config(cfg)(dict(d))
    ref = JaxMapperTTA.from_config(jax_cfg_from_port(cfg))(dict(d))
    assert len(ours) == len(ref) == 4
    box = np.array([[10.5, 20.25, 200.0, 300.0]])
    for a, b in zip(ours, ref):
        assert np.asarray(a["image"]).shape == b["image"].shape and (np.asarray(a["image"]) == b["image"]).all()
        np.testing.assert_allclose(a["transforms"].apply_box(box), b["transforms"].apply_box(box), rtol=1e-12)
        np.testing.assert_allclose(a["transforms"].inverse().apply_box(box), b["transforms"].inverse().apply_box(box), rtol=1e-12)


def test_forward_with_given_boxes_matches_jax(golden, models):
    cfg, jm, variables, model = models
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 250, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 70, (2, 6, 2))], -1).astype(np.float32)
    batch = {
        "image": np.stack([golden["image"], golden["image"][::-1]]).astype(np.float32),
        "image_sizes": np.array([[320, 320], [320, 320]], np.int32),
        "given_boxes": boxes,
        "given_classes": rng.randint(0, 7, (2, 6)).astype(np.int32),
        "given_valid": np.ones((2, 6), bool),
    }
    ref = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    out = model(batch)
    assert set(out) == set(ref) == {"pred_boxes", "pred_classes", "scores", "valid", "pred_masks"}
    assert out["pred_masks"].shape == (2, 6, 28, 28)
    np.testing.assert_allclose(n(out["pred_masks"]), np.asarray(ref["pred_masks"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n(out["scores"]), np.asarray(ref["scores"]))


def test_tta_matches_the_jax_package(golden, models):
    cfg, jm, variables, model = models
    ref = JaxTTA(jax_cfg_from_port(cfg), jm, variables)([_input(golden)])[0]["instances"]
    out = GeneralizedRCNNWithTTA(cfg, model)([_input(golden)])[0]["instances"]
    assert len(out) == len(ref) == 50 and out.image_size == (320, 320)
    np.testing.assert_array_equal(n(out.pred_classes), np.asarray(ref.pred_classes))
    np.testing.assert_allclose(n(out.scores), np.asarray(ref.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(out.pred_boxes.tensor), np.asarray(ref.pred_boxes.tensor), rtol=0, atol=1e-3)
    ours, theirs = n(out.pred_masks.tensor), np.asarray(ref.pred_masks.tensor)
    assert ours.shape == theirs.shape == (50, 320, 320)
    assert (ours != theirs).mean() <= 1e-4


def test_port_reproduces_tta_golden_from_d2_pkl(golden, tmp_path):
    path = tmp_path / "synthetic_tta.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    cfg = golden_tta_config()
    cfg.MODEL.WEIGHTS = str(path)
    predictor = DefaultPredictor(cfg, device="cpu")
    n_w = len(golden["weight_names"])
    assert predictor.load_report == f"Loaded {n_w}/{n_w} tensors from the checkpoint."
    out = GeneralizedRCNNWithTTA(cfg, predictor.model)([_input(golden)])[0]["instances"]
    boxes, scores, classes = n(out.pred_boxes.tensor), n(out.scores), n(out.pred_classes)
    taken = np.zeros(len(scores), bool)
    unmatched = []
    for rs, rc, rbx in zip(golden["out_scores"], golden["out_classes"], golden["out_boxes"]):
        cand = np.where(
            (classes == rc) & ~taken & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4)
            & (np.abs(boxes - rbx).max(axis=1) < 0.1)
        )[0]
        if len(cand) == 0:
            unmatched.append((float(rs), int(rc), rbx))
            continue
        taken[cand[0]] = True
    extras = scores[~taken]
    hard = [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]
    assert not hard, hard[:5]
    assert taken.sum() >= 0.9 * len(golden["out_scores"]), taken.sum()
    ref_order = np.argsort(-golden["out_scores"], kind="stable")[:10]
    masks = n(out.pred_masks.tensor)
    matched = 0
    for rank, ri in enumerate(ref_order):
        rs, rc, rbx = golden["out_scores"][ri], golden["out_classes"][ri], golden["out_boxes"][ri]
        cand = np.where(
            (classes == rc) & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4) & (np.abs(boxes - rbx).max(axis=1) < 0.1)
        )[0]
        if len(cand) == 0:
            continue
        ref_mask, ours = golden["out_masks10"][rank].astype(bool), masks[cand[0]]
        union = (ref_mask | ours).sum()
        if union:
            assert (ref_mask & ours).sum() / union > 0.85, rank
        matched += 1
    assert matched >= 7, matched


def test_single_scale_tta_equals_the_predictor(golden, models):
    """One size, no flip: the merge keeps the model's own detections and
    the mask re-run reproduces them, so TTA equals DefaultPredictor."""
    cfg, _, _, model = models
    cfg = cfg.clone()
    cfg.TEST.AUG.MIN_SIZES = (320,)
    cfg.TEST.AUG.MAX_SIZE = 512
    cfg.TEST.AUG.FLIP = False
    img = golden["image"][:240]
    out = GeneralizedRCNNWithTTA(cfg, model)([{"image": img, "height": 240, "width": 320}])[0]["instances"]
    ref = DefaultPredictor(model=model, min_size_test=320, max_size_test=512)(np.ascontiguousarray(img))["instances"]
    assert len(out) == len(ref) > 0
    np.testing.assert_array_equal(n(out.pred_classes), n(ref.pred_classes))
    np.testing.assert_allclose(n(out.scores), n(ref.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(out.pred_boxes.tensor), n(ref.pred_boxes.tensor), rtol=0, atol=1e-4)
    assert (n(out.pred_masks.tensor) == n(ref.pred_masks.tensor)).mean() >= 0.999
