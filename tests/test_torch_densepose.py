"""DensePose (the chart family) in the port against the JAX package, float32:
the V1ConvX and DeepLab heads, the FPN decoder, the chart predictor with
the WC1 / WC2 / WC1M / WC2M confidence channels, the confidence losses,
``point_sample`` and the point annotations, ``roi_align_separable_chan``
(aligned and v1 grids; and against ``roi_align_multilevel_plain`` on the
one level), and the two goldens through the port's d2 ``.pkl`` loader
(``tests/test_torch_densepose_rcnn.py`` holds the tiny models).

Tolerances: modules and the pool 1e-5 absolute + 1e-5 relative; the
goldens at the bounds of ``tests/parity/test_e2e_densepose_golden.py``.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    jax_module_random_variables,
    load_golden,
    n,
    t,
)

from detectron2_tpu.ops.roi_align import roi_align_separable_chan as jax_separable_chan
from detectron2_tpu.projects.densepose import confidences as jax_conf
from detectron2_tpu.projects.densepose import densepose_head as jax_heads
from detectron2_tpu.projects.point_rend.point_features import point_sample as jax_point_sample
from detectron2_tpu.projects.point_sup.point_utils import (
    get_point_coords_from_point_annotation as jax_point_coords,
)
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint, load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_plain, roi_align_separable_chan
from detectron2_tpu_torch.projects.densepose import (
    DensePoseChartPredictor,
    DensePoseDecoder,
    DensePoseDeepLabHead,
    DensePoseV1ConvXHead,
    iid_isotropic_gaussian_uv_loss,
    indep_anisotropic_gaussian_uv_loss,
)
from detectron2_tpu_torch.projects.point_rend import point_sample
from detectron2_tpu_torch.projects.point_sup import get_point_coords_from_point_annotation
from detectron2_tpu_torch.testing import golden_densepose_config, golden_state_dict

torch.set_num_threads(1)


def close(ours, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=rtol, atol=atol)


def load_module(module, variables, scope):
    """A JAX module's variables into the port's module, through
    ``convert_jax_params`` under the ROI heads' attribute ``scope``: every
    tensor loaded, none left over."""
    state = convert_jax_params({k: {scope: v} for k, v in variables.items()})
    state = {k[len(scope) + 1 :]: v for k, v in state.items()}
    report = load_state_dict_report(module, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(module.state_dict())} tensors from the checkpoint."], report
    return module


def _features(seed=0, R=3, hw=7, C=32):
    return np.random.RandomState(seed).standard_normal((R, hw, hw, C)).astype(np.float32)


@pytest.mark.parametrize("kind", ["v1convx", "deeplab"])
def test_heads_match_jax(kind):
    x = _features()
    if kind == "v1convx":
        jm, port = jax_heads.DensePoseV1ConvXHead(conv_dims=48, num_convs=3), DensePoseV1ConvXHead(32, 48, 3)
    else:
        jm, port = jax_heads.DensePoseDeepLabHead(conv_dims=64, num_convs=2), DensePoseDeepLabHead(32, 64, 2)
    variables = jax_module_random_variables(jm, x, seed=1)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    load_module(port, variables, "densepose_head")
    with torch.no_grad():
        close(port(t(x), False), ref)


@pytest.mark.parametrize(
    "uv_confidence, segm_confidence",
    [("none", False), ("iid_iso", False), ("indep_aniso", False), ("iid_iso", True), ("indep_aniso", True)],
    ids=["plain", "WC1", "WC2", "WC1M", "WC2M"],
)
def test_chart_predictor_matches_jax(uv_confidence, segm_confidence):
    x = _features(seed=2, C=16)
    kw = dict(num_patches=24, num_coarse_segm_channels=15, uv_confidence=uv_confidence, segm_confidence=segm_confidence)
    jm = jax_heads.DensePoseChartPredictor(**kw)
    variables = jax_module_random_variables(jm, x, seed=3)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    port = load_module(DensePoseChartPredictor(16, **kw), variables, "densepose_predictor")
    with torch.no_grad():
        out = port(t(x))
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].dtype == torch.float32 and tuple(out[k].shape) == ref[k].shape == (3, 28, 28, ref[k].shape[-1])
        close(out[k], ref[k])


def test_decoder_matches_jax():
    rng = np.random.RandomState(4)
    feats = [rng.standard_normal((2, 32 // s, 48 // s, 16)).astype(np.float32) for s in (1, 2, 4, 8)]
    jm = jax_heads.DensePoseDecoder(conv_dims=24, num_classes=20)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))
    vr = np.random.RandomState(5)
    variables = jax.tree_util.tree_map(lambda s: jnp.asarray(vr.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    ref = jm.apply(variables, [jnp.asarray(f) for f in feats])
    port = load_module(DensePoseDecoder(("p2", "p3", "p4", "p5"), (4, 8, 16, 32), (16,) * 4, 24, 20), variables, "decoder")
    assert [len(getattr(port, f)) for f in port.in_features] == [1, 2, 4, 6]  # conv k at index 2k
    with torch.no_grad():
        out = port([t(f) for f in feats], False)
    assert tuple(out.shape) == ref.shape == (2, 32, 48, 20)
    close(out, ref)


def test_confidence_losses_match_jax():
    rng = np.random.RandomState(6)
    a = {k: rng.standard_normal((4, 9)).astype(np.float32) for k in ("u", "v", "s", "ku", "kv")}
    tu, tv = rng.rand(4, 9).astype(np.float32), rng.rand(4, 9).astype(np.float32)
    w = (rng.rand(4, 9) > 0.3).astype(np.float32)
    ref = jax_conf.iid_isotropic_gaussian_uv_loss(a["u"], a["v"], a["s"], tu, tv, w)
    close(iid_isotropic_gaussian_uv_loss(t(a["u"]), t(a["v"]), t(a["s"]), t(tu), t(tv), t(w)), ref)
    ref = jax_conf.indep_anisotropic_gaussian_uv_loss(a["u"], a["v"], a["s"], a["ku"], a["kv"], tu, tv, w)
    out = indep_anisotropic_gaussian_uv_loss(t(a["u"]), t(a["v"]), t(a["s"]), t(a["ku"]), t(a["kv"]), t(tu), t(tv), t(w))
    close(out, ref)
    # no valid point: the weighted mean is 0, as in JAX
    assert iid_isotropic_gaussian_uv_loss(t(a["u"]), t(a["v"]), t(a["s"]), t(tu), t(tv), torch.zeros(4, 9)).item() == 0.0


def test_point_sample_and_point_coords_match_jax():
    rng = np.random.RandomState(7)
    x = rng.standard_normal((3, 11, 13, 5)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (3, 20, 2)).astype(np.float32)  # some points off the map
    for mode in ("bilinear", "nearest"):
        close(point_sample(t(x), t(coords), mode=mode), jax_point_sample(jnp.asarray(x), jnp.asarray(coords), mode=mode))
    boxes = np.array([[2, 3, 20, 30], [0, 0, 5, 5], [10, 10, 10, 40]], np.float32)  # the last one zero-width
    pts = rng.uniform(-5, 45, (3, 20, 2)).astype(np.float32)
    labels = rng.randint(-1, 2, (3, 20)).astype(np.int64)
    ours = get_point_coords_from_point_annotation(t(boxes), t(pts), t(labels))
    ref = jax_point_coords(jnp.asarray(boxes), jnp.asarray(pts), jnp.asarray(labels))
    for o, r in zip(ours, ref):
        close(o, r)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "v1"])
@pytest.mark.parametrize("sampling_ratio", [0, 2, 3])
def test_roi_align_separable_chan_matches_jax_and_the_plain_roi_align(aligned, sampling_ratio):
    rng = np.random.RandomState(8)
    feats = rng.standard_normal((2, 20, 24, 6)).astype(np.float32)
    xy = rng.uniform(-20, 90, (2, 4, 2))
    wh = rng.uniform(0.5, 60, (2, 4, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[1, 0] = [40.0, 40.0, 40.0, 40.0]  # zero area
    args = dict(output_size=(7, 5), spatial_scale=0.25, sampling_ratio=sampling_ratio, aligned=aligned)
    ref = jax_separable_chan(jnp.asarray(feats), jnp.asarray(boxes), **args)
    out = roi_align_separable_chan(t(feats), t(boxes), **args)
    assert tuple(out.shape) == ref.shape == (2, 4, 7, 5, 6)
    close(out, ref)
    bidx = torch.arange(2, dtype=torch.int32).repeat_interleave(4)
    plain = roi_align_multilevel_plain(
        [t(feats)], t(boxes).reshape(-1, 4), bidx, torch.zeros(8, dtype=torch.int32), (0.25,), (7, 5),
        sampling_ratio, aligned,
    )
    close(out.reshape(8, 7, 5, 6), plain)


@pytest.mark.parametrize("deeplab", [False, True], ids=["e2e_densepose_r18", "e2e_densepose_dl_r18"])
def test_golden_through_the_d2_loader(deeplab, tmp_path):
    g = load_golden("e2e_densepose_dl_r18" if deeplab else "e2e_densepose_r18")
    pkl = tmp_path / "densepose.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    cfg = golden_densepose_config(deeplab)
    model = build_model(cfg, device="cpu")
    report = load_d2_checkpoint(model, str(pkl))
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."]
    batch = {"image": g["image"][None].astype(np.float32), "image_sizes": np.array([[320, 320]], np.int32)}
    with torch.no_grad():
        if not deeplab:  # the decoder's stride-4 map
            feats = model.backbone(model.preprocess_image(t(batch["image"])))
            dec = n(model.roi_heads.decoder([feats[f] for f in model.roi_heads.in_features], False))
            assert np.abs(dec - g["decoder_map"].transpose(0, 2, 3, 1)).max() < 2e-3
        out = model(batch)
    valid = n(out["valid"][0])
    scores, boxes, classes = n(out["scores"][0])[valid], n(out["pred_boxes"][0])[valid], n(out["pred_classes"][0])[valid]
    o_order, r_order = np.argsort(-scores, kind="stable"), np.argsort(-g["out_scores"], kind="stable")
    assert len(o_order) == len(r_order)
    np.testing.assert_allclose(scores[o_order], g["out_scores"][r_order], rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(classes[o_order], g["out_classes"][r_order])
    np.testing.assert_allclose(boxes[o_order], g["out_boxes"][r_order], rtol=1e-3, atol=0.05)
    keys = [("coarse_segm", "dp_coarse_segm"), ("fine_segm", "dp_fine_segm"), ("u", "dp_u"), ("v", "dp_v")]
    if deeplab:
        keys.append(("sigma_2", "dp_sigma2"))
    for ours, ref in keys:
        o = n(out["pred_densepose_raw"][ours][0])[valid][o_order[:8]]
        r = g[ref][r_order[:8]].transpose(0, 2, 3, 1)
        assert o.shape == r.shape and np.abs(o - r).max() < 5e-3, ours
    dp = n(out["pred_densepose"][0])[valid][o_order[:8]]
    ref_part = g["dp_fine_segm"][r_order[:8]].transpose(0, 2, 3, 1).argmax(-1)
    assert ((dp[..., 0] == ref_part) | (dp[..., 0] == 0)).mean() > 0.99
