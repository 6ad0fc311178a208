"""The port's Keypoint R-CNN against the JAX package's: the heatmap decode
and its upsamples, the score_lowres deconv (4x4, stride 2), the keypoint head
and the keypoint rescale of ``detector_postprocess`` on the same inputs and
weights, the tiny Keypoint R-CNN R18-FPN on carried weights, and the
reference golden ``tests/goldens/e2e_keypointrcnn_r18.npz`` from its d2 .pkl.

Tolerances: the decode on identical maps: x, y 1e-4, prob 1e-6, logit 1e-6
plus 2 float32 ulps (the upsample's rounding);
head outputs 1e-4 relative to their largest value (conv sum order); the
golden at ``tests/parity/test_e2e_keypoint_golden.py``'s bounds (scores rtol
1e-3 / atol 1e-4, classes equal, boxes 0.05, the raw heatmap logits 5e-3).
On the end-to-end model the decoded x, y may move by one bin of the 4x
upsampled map where two bins tie to the float32 ulp (a bilinear 4x upsample
samples each source pixel at +-1/8 of a pixel, so the two nearest samples of
a peak differ only by its neighbours): held to one bin, and to 1e-3 on at
least 97% of the keypoints.
"""

import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_port import jax_inference, jax_model, jax_variables_from_d2, load_golden, n, port_model, t

from detectron2_tpu.layers.wrappers import ConvTranspose2d as JaxConvTranspose2d
from detectron2_tpu.modeling.postprocessing import detector_postprocess as jax_postprocess
from detectron2_tpu.modeling.roi_heads.keypoint_head import KRCNNConvDeconvUpsampleHead as JaxHead
from detectron2_tpu.modeling.roi_heads.keypoint_head import keypoint_rcnn_inference as jax_kpt_inference
from detectron2_tpu.structures.keypoints import heatmaps_to_keypoints as jax_decode
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.layers import ConvTranspose2d
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.modeling.roi_heads import KRCNNConvDeconvUpsampleHead, keypoint_rcnn_inference
from detectron2_tpu_torch.structures import Keypoints
from detectron2_tpu_torch.structures.keypoints import _bilinear_upsample, heatmaps_to_keypoints
from detectron2_tpu_torch.testing import golden_keypoint_config, golden_state_dict

torch.set_num_threads(1)


def _maps_and_rois(seed, N=7, K=5, S=12):
    rng = np.random.RandomState(seed)
    maps = rng.standard_normal((N, K, S, S)).astype(np.float32) * 3
    xy = rng.uniform(-20, 300, (N, 2))
    wh = rng.uniform(0.2, 150, (N, 2))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rois[0, 2] = rois[0, 0]  # zero width: clamped to 1
    return maps, rois


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heatmaps_to_keypoints_matches_jax(seed):
    maps, rois = _maps_and_rois(seed)
    ref = np.asarray(jax_decode(jnp.asarray(maps), jnp.asarray(rois)))
    out = n(heatmaps_to_keypoints(t(maps), t(rois), chunk=3))
    assert out.shape == ref.shape == (7, 5, 4)
    np.testing.assert_allclose(out[..., :2], ref[..., :2], rtol=0, atol=1e-4)
    # the upsampled logits agree to 2 float32 ulps (interpolation rounding)
    np.testing.assert_allclose(out[..., 2], ref[..., 2], rtol=2.4e-7, atol=1e-6)
    np.testing.assert_allclose(out[..., 3], ref[..., 3], rtol=0, atol=1e-6)


def test_heatmaps_to_keypoints_ties_take_the_first_index():
    """Flat maps and maps with two equal peaks: the first flat index wins,
    as jnp.argmax's; the probability of a flat map is 1 / U^2."""
    maps = np.zeros((3, 2, 8, 8), np.float32)
    maps[1, 0, 2, 5] = maps[1, 0, 6, 1] = 4.0  # two equal peaks
    maps[2, 1, :, :] = -3.0
    rois = np.array([[0, 0, 32, 32], [10, 20, 74, 52], [5, 5, 6, 9]], np.float32)
    ref = np.asarray(jax_decode(jnp.asarray(maps), jnp.asarray(rois)))
    out = n(heatmaps_to_keypoints(t(maps), t(rois)))
    np.testing.assert_allclose(out[..., :2], ref[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[..., 2:], ref[..., 2:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0, :, 3], 1.0 / 32**2, rtol=1e-5)
    assert heatmaps_to_keypoints(torch.zeros(0, 17, 8, 8), torch.zeros(0, 4)).shape == (0, 17, 4)


@pytest.mark.parametrize("factor,shape", [(2, (3, 28, 28, 5)), (4, (2, 5, 14, 14)), (2, (1, 1, 1, 3)), (4, (1, 2, 1, 1))])
def test_bilinear_upsample_matches_jax_image_resize(factor, shape):
    """The head's 2x, ``F.interpolate(align_corners=False)`` on NHWC, and
    the decode's 4x on NCHW vs ``jax.image.resize(..., "bilinear")``, edges
    included (jax.image.resize antialiases only when shrinking). The 4x
    decode equals it bit for bit past the outer pixel centres, where its
    samples tie."""
    x = np.random.RandomState(factor).standard_normal(shape).astype(np.float32)
    if factor == 2:  # NHWC, as the head holds it
        N, H, W, C = shape
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (N, H * 2, W * 2, C), method="bilinear"))
        out = n(F.interpolate(t(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=False).permute(0, 2, 3, 1))
    else:
        N, K, S, _ = shape
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (N, K, S * 4, S * 4), method="bilinear"))
        out = n(_bilinear_upsample(t(x), S * 4))
        # the two samples past each outer pixel centre tie exactly, in both
        for a in (out, ref):
            for i, j in ((0, 1), (-1, -2)):
                np.testing.assert_array_equal(a[..., i, :], a[..., j, :])
                np.testing.assert_array_equal(a[..., :, i], a[..., :, j])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_score_lowres_deconv_matches_flax():
    """The 4x4 stride-2 deconv (torch padding 1, flax "SAME"): 14 -> 28,
    the kernel carried across by ``convert_jax_params`` (flip + IOHW)."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 14, 14, 6)).astype(np.float32)
    mod = JaxConvTranspose2d(features=5, kernel_size=4, strides=2)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    state = convert_jax_params({"score_lowres": {"ConvTranspose_0": jax.tree_util.tree_map(np.asarray, variables["params"]["ConvTranspose_0"])}})
    deconv = ConvTranspose2d(6, 5, kernel_size=4, stride=2, padding=1)
    deconv.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        out = deconv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 28, 28, 5)
    np.testing.assert_allclose(n(out), ref, rtol=0, atol=1e-5)


def test_keypoint_head_and_inference_match_jax():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((5, 14, 14, 16)).astype(np.float32)
    jhead = JaxHead(num_keypoints=17, conv_dims=(24, 24, 24))
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jhead.apply(variables, jnp.asarray(x)))
    head = KRCNNConvDeconvUpsampleHead(16, 17, (24, 24, 24))
    head.load_state_dict(convert_jax_params(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        out = head(t(x), False)
    assert out.shape == ref.shape == (5, 56, 56, 17) and out.dtype == torch.float32
    np.testing.assert_allclose(n(out), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    boxes = np.array([[0, 0, 50, 80], [10, 10, 12, 13], [5, 7, 300, 200], [1, 1, 1, 1], [40, 2, 90, 60]], np.float32)
    ref_k = np.asarray(jax_kpt_inference(jnp.asarray(ref), jnp.asarray(boxes)))
    out_k = n(keypoint_rcnn_inference(t(ref), t(boxes)))
    np.testing.assert_allclose(out_k[..., :2], ref_k[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out_k[..., 2], ref_k[..., 2], rtol=2.4e-7, atol=1e-6)
    np.testing.assert_allclose(out_k[..., 3], ref_k[..., 3], rtol=0, atol=1e-6)


def test_postprocess_rescales_keypoints_as_jax():
    rng = np.random.RandomState(5)
    D, K = 9, 17
    boxes = rng.uniform(0, 200, (D, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(0, 60, (D, 2))], 1).astype(np.float32)
    boxes[3, 2] = boxes[3, 0]  # empty: dropped
    results = {
        "pred_boxes": boxes,
        "scores": rng.uniform(0, 1, D).astype(np.float32),
        "pred_classes": rng.randint(0, 3, D).astype(np.int32),
        "valid": np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool),
        "pred_keypoints": rng.uniform(0, 260, (D, K, 4)).astype(np.float32),
    }
    ref = jax_postprocess(results, 480, 640, 256, 320)
    out = detector_postprocess({k: t(v) for k, v in results.items()}, 480, 640, 256, 320)
    assert out.pred_keypoints.shape == (len(ref), K, 3) == (6, K, 3)
    np.testing.assert_allclose(n(out.pred_keypoints), np.asarray(ref.pred_keypoints), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(n(out.pred_classes), np.asarray(ref.pred_classes))


def test_keypoints_structure():
    kp = Keypoints(np.arange(2 * 17 * 3, dtype=np.float32).reshape(2, 17, 3))
    assert len(kp) == 2 and kp.tensor.dtype == torch.float32 and kp.device.type == "cpu"
    assert kp[1].tensor.shape == (1, 17, 3) and len(kp[torch.tensor([True, False])]) == 1
    assert Keypoints.cat([kp, kp[0]]).tensor.shape == (3, 17, 3)
    with pytest.raises(AssertionError):
        Keypoints(np.zeros((2, 17, 2)))


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_keypointrcnn_r18")


def _batch(golden):
    return {"image": golden["image"][None].astype(np.float32), "image_sizes": np.array([[320, 320]], np.int32)}


@pytest.fixture(scope="module")
def jax_run(golden):
    cfg = golden_keypoint_config()
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    return cfg, variables, jax_inference(jm, variables, _batch(golden))


def test_tiny_keypoint_rcnn_matches_jax_model(golden, jax_run):
    cfg, variables, ref = jax_run
    out = port_model(cfg, variables)(_batch(golden))
    assert set(out) == set(ref)
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    kp, rk = n(out["pred_keypoints"]), ref["pred_keypoints"]
    assert kp.shape == rk.shape == (1, 20, 17, 4)
    boxes = ref["pred_boxes"][0]
    bin_w = np.maximum(boxes[:, 2] - boxes[:, 0], 1) / 56  # one bin of the 4x upsampled 56x56 map
    bin_h = np.maximum(boxes[:, 3] - boxes[:, 1], 1) / 56
    dx, dy = np.abs(kp[0, ..., 0] - rk[0, ..., 0]), np.abs(kp[0, ..., 1] - rk[0, ..., 1])
    assert (dx <= bin_w[:, None] / 4 + 1e-3).all() and (dy <= bin_h[:, None] / 4 + 1e-3).all()
    assert ((dx <= 1e-3) & (dy <= 1e-3)).mean() >= 0.97, ((dx <= 1e-3) & (dy <= 1e-3)).mean()
    np.testing.assert_allclose(kp[..., 2], rk[..., 2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp[..., 3], rk[..., 3], rtol=0, atol=1e-5)


def test_port_reproduces_keypoint_golden_from_d2_pkl(golden, tmp_path):
    path = tmp_path / "synthetic_kpt.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_keypoint_config(), device="cpu")
    n_w = len(golden["weight_names"])
    assert load_d2_checkpoint(model, str(path)) == f"Loaded {n_w}/{n_w} tensors from the checkpoint."
    out = model(_batch(golden))
    valid = n(out["valid"][0])
    scores, boxes = n(out["scores"][0])[valid], n(out["pred_boxes"][0])[valid]
    classes, kpts = n(out["pred_classes"][0])[valid], n(out["pred_keypoints"][0])[valid]
    o = np.argsort(-scores, kind="stable")
    r = np.argsort(-golden["out_scores"], kind="stable")
    assert len(o) == len(r)
    np.testing.assert_allclose(scores[o], golden["out_scores"][r], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(classes[o], golden["out_classes"][r])
    np.testing.assert_allclose(boxes[o], golden["out_boxes"][r], rtol=1e-3, atol=0.05)
    # the deterministic pin: raw heatmap logits on the reference's top-10 boxes
    ref_boxes10 = torch.from_numpy(golden["out_boxes"][r[:10]].astype(np.float32))
    with torch.inference_mode():
        feats = model.backbone(model.preprocess_image(torch.from_numpy(_batch(golden)["image"])))
        logits = model.roi_heads.keypoint_logits(feats, ref_boxes10, torch.zeros(10, dtype=torch.int32))
    ref_logits = golden["kpt_logits10"][r[:10]]
    assert logits.permute(0, 3, 1, 2).shape == ref_logits.shape == (10, 17, 56, 56)
    assert np.abs(n(logits.permute(0, 3, 1, 2)) - ref_logits).max() < 5e-3
    # the decode's frame: every keypoint inside its box, probabilities in (0, 1]
    kp, bx = kpts[o], boxes[o]
    assert np.all(kp[..., 0] >= bx[:, None, 0] - 1e-3) and np.all(kp[..., 0] <= bx[:, None, 2] + 1e-3)
    assert np.all(kp[..., 1] >= bx[:, None, 1] - 1e-3) and np.all(kp[..., 1] <= bx[:, None, 3] + 1e-3)
    assert np.all(kp[..., 3] > 0) and np.all(kp[..., 3] <= 1)


def test_convert_jax_params_carries_the_keypoint_head(golden, jax_run):
    _, variables, _ = jax_run
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    sd = golden_state_dict(golden)
    assert sorted(state) == sorted(sd)
    for k in ("roi_heads.keypoint_head.score_lowres.weight", "roi_heads.keypoint_head.conv_fcn2.weight"):
        np.testing.assert_array_equal(n(state[k]), sd[k], err_msg=k)
