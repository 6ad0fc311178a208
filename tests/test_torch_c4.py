"""The port's Mask R-CNN C4 (Res5ROIHeads) against the JAX package's: the
heads alone on the same pooled features and weights, the tiny R18-C4 model
on carried weights, and the reference golden
``tests/goldens/e2e_maskrcnn_c4_r18.npz`` from its d2 .pkl at
``tests/parity/test_e2e_c4_golden.py:90-116``'s protocol (set matching with
the near-tie exemption, >= 80% of the reference detections matched, mask
probabilities within 3e-4).

Tolerances: the heads' outputs 1e-4 relative to their largest value (conv
sum order); the model: indices and classes equal, scores 1e-5, boxes 1e-3,
masks 1e-4. The model runs on seeded random weights: the golden's scores
tie to 1e-7 (every detection ~0.2008), so which of them survive NMS is
float32 noise, which is why the parity protocol exempts near ties.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_model, jax_random_variables, jax_variables_from_d2, load_golden, n, port_model, t

from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.roi_heads import Res5ROIHeads
from detectron2_tpu_torch.testing import golden_c4_config, golden_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_maskrcnn_c4_r18")


def _batch(golden):
    return {"image": golden["image"][None].astype(np.float32), "image_sizes": np.array([[320, 320]], np.int32)}


@pytest.fixture(scope="module")
def jax_run(golden):
    cfg = golden_c4_config()
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    out = jm.apply(variables, {k: jnp.asarray(v) for k, v in _batch(golden).items()}, train=False)
    return cfg, jm, variables, jax.tree_util.tree_map(np.asarray, out)


def test_res5_roi_heads_match_jax(jax_run):
    """Pool on res4, the res5 stage built in the heads (3 bottleneck blocks
    of 512 outputs for R18), the mean, the predictor and the mask head."""
    cfg, jm, variables, _ = jax_run
    rng = np.random.RandomState(0)
    feat = rng.standard_normal((2, 20, 20, 256)).astype(np.float32)
    xy = rng.uniform(-10, 300, (9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 200, (9, 2))], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 9).astype(np.int32)

    def jax_fn(mod, f, b, i):
        x = mod.roi_heads._shared_roi_transform([f], b, i, train=False)
        scores, deltas = mod.roi_heads.box_predictor(x.mean(axis=(1, 2)), train=False)
        return x, scores, deltas, mod.roi_heads.mask_head(x, train=False)

    ref = jm.apply(variables, jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bidx), method=jax_fn)
    heads = port_model(cfg, variables).roi_heads
    assert isinstance(heads, Res5ROIHeads) and len(heads.res5) == 3
    with torch.no_grad():
        x = heads._shared_roi_transform([t(feat)], t(boxes), t(bidx))
        scores, deltas = heads.box_predictor(x.mean(dim=(2, 3)))
        masks = heads.mask_head(x.permute(0, 2, 3, 1))
    out = (x.permute(0, 2, 3, 1), scores, deltas, masks)
    assert out[0].shape == (9, 7, 7, 512) and masks.shape == (9, 14, 14, 7)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(n(o), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_tiny_c4_model_matches_jax_model(golden, jax_run):
    cfg, jm, _, _ = jax_run
    variables = jax_random_variables(jm, seed=0, scale=0.1)
    ref = jax.tree_util.tree_map(np.asarray, jm.apply(variables, {k: jnp.asarray(v) for k, v in _batch(golden).items()}, train=False))
    out = port_model(cfg, variables)(_batch(golden))
    assert set(out) == set(ref)
    assert out["pred_masks"].shape == ref["pred_masks"].shape == (1, 30, 14, 14) and ref["valid"].sum() == 30
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)


def test_port_reproduces_c4_golden_from_d2_pkl(golden, tmp_path):
    path = tmp_path / "synthetic_c4.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_c4_config(), device="cpu")
    n_w = len(golden["weight_names"])
    assert load_d2_checkpoint(model, str(path)) == f"Loaded {n_w}/{n_w} tensors from the checkpoint."
    # one RPN level of 15 anchors per cell (5 sizes x 3 ratios)
    assert model.proposal_generator.anchor_generator.num_anchors == [15]
    out = model(_batch(golden))
    valid = n(out["valid"][0])
    scores, boxes = n(out["scores"][0])[valid], n(out["pred_boxes"][0])[valid]
    classes, masks = n(out["pred_classes"][0])[valid], n(out["pred_masks"][0])[valid]
    assert abs(len(scores) - len(golden["out_scores"])) <= 1
    taken = np.zeros(len(scores), bool)
    unmatched = []
    for ri in np.argsort(-golden["out_scores"], kind="stable"):
        rs, rc, rbx = golden["out_scores"][ri], golden["out_classes"][ri], golden["out_boxes"][ri]
        cand = np.where(
            (classes == rc) & ~taken & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4)
            & (np.abs(boxes - rbx).max(axis=1) < 0.05)
        )[0]
        if len(cand) == 0:
            unmatched.append((rs, rc, rbx))
            continue
        taken[cand[0]] = True
        if ri < golden["mask_probs10"].shape[0]:
            np.testing.assert_allclose(masks[cand[0]], golden["mask_probs10"][ri], atol=3e-4)
    extras = scores[~taken]
    hard = [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]
    assert not hard, hard
    assert taken.sum() >= 0.8 * len(golden["out_scores"]), taken.sum()


def test_c4_backbone_stops_at_res4_and_heads_refuse_training():
    """The heads no longer refuse training (``test_torch_c4_train.py`` holds
    it to the JAX package): they carry the config's sampler settings."""
    cfg = golden_c4_config()
    model = build_model(cfg, device="cpu")
    assert model.backbone.stage_names == ["res2", "res3", "res4"]
    assert [n for n, _ in model.roi_heads.named_children()] == ["res5", "box_predictor", "mask_head"]
    heads, rh = model.roi_heads, cfg.MODEL.ROI_HEADS
    assert (heads.batch_size_per_image, heads.positive_fraction, heads.fg_budget) == (512, 0.25, 128)
    assert (heads.proposal_matcher.thresholds[1:-1], heads.proposal_append_gt) == (list(rh.IOU_THRESHOLDS), True)


@pytest.mark.parametrize("name,heads", [
    ("COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml", "StandardROIHeads"),
    ("COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml", "Res5ROIHeads"),
    ("Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml", "CascadeROIHeads"),
])
def test_zoo_configs_build_on_the_card_by_default_and_on_the_cpu_when_asked(name, heads):
    from detectron2_tpu_torch import model_zoo

    cfg = model_zoo.get_config(name)
    assert cfg.MODEL.DEVICE == "cuda"
    model = build_model(cfg, device="cpu")
    assert type(model.roi_heads).__name__ == heads and model.device.type == "cpu"
    if cfg.MODEL.KEYPOINT_ON:
        assert len(model.roi_heads.keypoint_head.conv_dims) == 8
    if not torch.cuda.is_available():  # no hidden fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(cfg)
