"""The port's PointRend against the JAX package's, in float32 on the CPU.

- The point functions on seeded inputs, 1e-6: ``point_sample`` (bilinear
  and nearest), the regular grid, the image frame, the fine-grained gather
  over ``[B, H, W, C]`` levels, the uncertain draws (the same draws on both
  sides) and the grid top-k, whose indices are ``==`` also where a 2x
  upsample leaves ties (``lax.top_k`` takes the lower index);
  the semantic top-2 margin.
- ``StandardPointHead``, ``ImplicitPointHead``, ``CoarseMaskHead`` and
  ``ImplicitParameterHead`` on converted weights, 1e-5.
- Tiny R18-FPN ``PointRendROIHeads`` and ``ImplicitPointRendROIHeads``
  models (64x64 images; the implicit one at FPN width 256, the channel
  count the JAX implicit head takes): the 28x28 masks of the subdivision
  loop on given boxes, 1e-5 (the golden below holds the detections); the
  training losses (rtol 1e-4) and every
  gradient (``assert_train_step_matches``), both samplers and every point
  draw the same numbers (``SameDraws``, ``PointDraws``).
- A tiny ``PointRendSemSegHead`` SemanticSegmentor: the refined logits
  (2e-5 of max|x|), the losses and every gradient.
- ``tests/goldens/e2e_pointrend_r18.npz`` through the d2 loader, at its
  parity test's bounds.
- The 8 PointRend yamls merge after ``add_pointrend_config`` and build (on
  the meta device), naming only registered datasets.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    PointDraws,
    SameDraws,
    assert_train_step_matches,
    jax_inference,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)
from test_torch_train_step import make_batch, tiny_cfg

import detectron2_tpu.projects.point_rend as jpr
from detectron2_tpu.projects.point_rend import point_features as jpf
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import upsample_bilinear
from detectron2_tpu_torch.projects import point_rend as pr
from detectron2_tpu_torch.projects.point_rend import point_features as pf
from detectron2_tpu_torch.testing import compare_with_pointrend_golden, golden_pointrend_config, golden_state_dict

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(ours, ref, tol):
    ours, ref = n(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= tol, (err, tol)


# ------------------------------------------------------------- point functions
def test_point_sample_bilinear_and_nearest():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((3, 7, 9, 4)).astype(np.float32)
    coords = (rng.rand(3, 50, 2) * 1.2 - 0.1).astype(np.float32)  # some outside the map
    for mode in ("bilinear", "nearest"):
        close(pf.point_sample(t(x), t(coords), mode), jpf.point_sample(jnp.asarray(x), jnp.asarray(coords), mode), 1e-6)


def test_grid_and_image_frame():
    close(pf.generate_regular_grid_point_coords(3, 5), jpf.generate_regular_grid_point_coords(3, 5), 1e-6)
    rng = np.random.RandomState(1)
    boxes = np.sort(rng.rand(4, 2, 2) * 60, axis=1).transpose(0, 2, 1).reshape(4, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    coords = rng.rand(4, 11, 2).astype(np.float32)
    close(pf.get_point_coords_wrt_image(t(boxes), t(coords)), jpf.get_point_coords_wrt_image(boxes, coords), 1e-6)


def test_fine_grained_features_over_levels():
    rng = np.random.RandomState(2)
    feats = [rng.standard_normal((2, 16, 20, 3)).astype(np.float32), rng.standard_normal((2, 8, 10, 5)).astype(np.float32)]
    boxes = np.array([[2, 3, 40, 50], [-5, 0, 30, 20], [10, 10, 90, 70]], np.float32)
    bidx = np.array([1, 0, 1], np.int32)
    coords = rng.rand(3, 13, 2).astype(np.float32)
    ours, ours_abs = pf.point_sample_fine_grained_features([t(f) for f in feats], (0.25, 0.125), t(boxes), t(bidx), t(coords))
    ref, ref_abs = jpf.point_sample_fine_grained_features([jnp.asarray(f) for f in feats], (0.25, 0.125), boxes, bidx, coords)
    close(ours, ref, 1e-6)
    close(ours_abs, ref_abs, 1e-5)


def test_uncertain_points_with_randomness_on_the_same_draws(monkeypatch):
    PointDraws(seed=3).patch(monkeypatch)
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((4, 7, 7, 5)).astype(np.float32)
    classes = np.array([0, 4, 2, 9], np.int32)  # 9 clamps to the last class
    ours = pf.get_uncertain_point_coords_with_randomness(t(logits), t(classes), 20, 3, 0.75)
    ref = jpf.get_uncertain_point_coords_with_randomness(jax.random.PRNGKey(0), jnp.asarray(logits), classes, 20, 3, 0.75)
    close(ours, ref, 1e-6)
    close(pf._uncertainty(t(logits[:, 0]), t(classes)), jpf._uncertainty(logits[:, 0], classes), 1e-6)


def test_uncertain_points_on_grid_take_ties_as_lax_top_k():
    """A 2x upsample of a 7x7 map: every value repeats, and a quantised
    map ties across cells; the chosen indices are ``==``."""
    rng = np.random.RandomState(4)
    coarse = np.round(rng.standard_normal((3, 7, 7, 1)) * 4) / 4
    up = upsample_bilinear(t(coarse.astype(np.float32)), 2)[..., 0]
    ref_up = jax.image.resize(jnp.asarray(coarse, jnp.float32), (3, 14, 14, 1), "bilinear")[..., 0]
    close(up, ref_up, 1e-6)
    unc = -np.abs(np.asarray(ref_up))
    assert len(np.unique(unc)) < unc.size // 4  # many ties
    idx, coords = pf.get_uncertain_point_coords_on_grid(t(unc), 60)
    ref_idx, ref_coords = jpf.get_uncertain_point_coords_on_grid(jnp.asarray(unc), 60)
    np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
    close(coords, ref_coords, 1e-6)


def test_sem_seg_uncertainty_is_the_top2_margin():
    logits = np.random.RandomState(5).standard_normal((2, 6, 6, 5)).astype(np.float32)
    close(pr.calculate_uncertainty_sem_seg(t(logits)), jpr.calculate_uncertainty_sem_seg(jnp.asarray(logits)), 1e-6)


# ----------------------------------------------------------------------- heads
def _module_vars(module, args, seed):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, train=False))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)


def _as_port(variables, scope, prefix):
    """A head's JAX variables under ``scope`` (``roi_heads/<scope>``) ->
    the port head's state dict (d2's names with ``prefix`` dropped)."""
    tree = {col: {"roi_heads": {scope: v}} for col, v in variables.items()}
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    assert all(k.startswith(prefix) for k in state), sorted(state)
    return {k[len(prefix):]: v for k, v in state.items()}


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module


def test_standard_point_head_matches_jax():
    rng = np.random.RandomState(6)
    fine, coarse = rng.standard_normal((5, 17, 24)).astype(np.float32), rng.standard_normal((5, 17, 8)).astype(np.float32)
    for each_layer in (True, False):
        jm = jpr.StandardPointHead(num_classes=8, fc_dims=(32, 32, 32), coarse_pred_each_layer=each_layer)
        v = _module_vars(jm, (jnp.asarray(fine), jnp.asarray(coarse)), seed=7)
        head = _load(pr.StandardPointHead(24, 8, 32, 3, each_layer), _as_port(v, "point_head", "roi_heads.mask_head.point_head."))
        assert head.fc1.weight.shape == (32, 32, 1)  # d2's Conv1d layout
        close(head(t(fine), t(coarse)), jm.apply(v, fine, coarse), 1e-5)


def test_implicit_point_head_matches_jax():
    from detectron2_tpu.projects.point_rend.point_head import ImplicitPointHead as JaxImplicitPointHead

    jm = JaxImplicitPointHead(num_classes=8, num_fc=2, channels=16, image_feature_channels=24)
    rng = np.random.RandomState(8)
    R, P = 4, 19
    fine, coords = rng.standard_normal((R, P, 24)).astype(np.float32), rng.rand(R, P, 2).astype(np.float32)
    params = (rng.standard_normal((R, jm.num_params)) * 0.2).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, fine, coords, params))
    v = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)), shapes)
    head = pr.ImplicitPointHead(8, 2, 16, 24)
    assert head.num_params == jm.num_params
    _load(head, _as_port(v, "point_head", "roi_heads.mask_head.point_head."))
    close(head(t(fine), t(coords), t(params)), jm.apply(v, fine, coords, params), 1e-5)


def test_coarse_mask_head_and_parameter_head_match_jax():
    from detectron2_tpu.projects.point_rend.coarse_mask_head import ImplicitParameterHead as JaxParameterHead

    x = np.random.RandomState(9).standard_normal((6, 14, 14, 32)).astype(np.float32)
    for conv_dim in (16, 32):  # with and without the channel-reducing 1x1 conv
        jm = jpr.CoarseMaskHead(num_classes=8, conv_dim=conv_dim, fc_dims=(64, 64), output_side_resolution=7)
        v = _module_vars(jm, (jnp.asarray(x),), seed=10)
        head = _load(pr.CoarseMaskHead(32, 14, 8, conv_dim, (64, 64), 7), _as_port(v, "mask_head", "roi_heads.mask_head.coarse_head."))
        assert (head.reduce_channel_dim_conv is None) == (conv_dim == 32)
        close(head(t(x), False), jm.apply(v, x), 1e-5)
    jm = JaxParameterHead(num_params=300, conv_dim=16, fc_dims=(64,))
    v = _module_vars(jm, (jnp.asarray(x),), seed=11)
    head = _load(pr.ImplicitParameterHead(32, 14, 16, (64,), 300), _as_port(v, "parameter_head", "roi_heads.mask_head.parameter_head."))
    close(head(t(x), False), jm.apply(v, x), 1e-5)


# ------------------------------------------------------------------ the models
def rcnn_cfg(implicit: bool):
    cfg = tiny_cfg()
    pr.add_pointrend_config(cfg)
    m = cfg.MODEL
    m.ROI_HEADS.NAME = "ImplicitPointRendROIHeads" if implicit else "PointRendROIHeads"
    m.ROI_MASK_HEAD.NAME = "ImplicitPointRendMaskHead" if implicit else "CoarseMaskHead"
    m.ROI_MASK_HEAD.CONV_DIM = 16  # under the FPN width: the 1x1 channel reduction runs
    m.ROI_MASK_HEAD.FC_DIM = 64
    m.POINT_HEAD.NUM_CLASSES = 8
    m.POINT_HEAD.FC_DIM = 16 if implicit else 32
    m.POINT_HEAD.NUM_FC = 2 if implicit else 3
    m.POINT_HEAD.TRAIN_NUM_POINTS = 48
    # 7x7 and 2 steps of 196 points: the shortcut starts at 14x14 -> 28x28
    m.POINT_HEAD.SUBDIVISION_STEPS = 1 if implicit else 2
    m.POINT_HEAD.SUBDIVISION_NUM_POINTS = 196
    if implicit:
        m.FPN.OUT_CHANNELS = 256  # the JAX implicit point head takes 256 channels
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


@pytest.fixture(scope="module")
def draws():
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        PointDraws(seed=10).patch(mp)
        yield


def given_boxes_batch():
    """``make_batch``'s images with 7 given boxes an image (some past the
    border) and their classes: the mask branch alone on the same boxes in
    both packages."""
    rng = np.random.RandomState(13)
    xy = rng.uniform(-4, 50, (2, 7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(3, 40, (2, 7, 2))], -1).astype(np.float32)
    batch = make_batch()
    return {"image": batch["image"], "image_sizes": batch["image_sizes"], "given_boxes": boxes,
            "given_classes": rng.randint(0, 8, (2, 7)).astype(np.int32), "given_valid": np.ones((2, 7), bool)}


@pytest.fixture(scope="module", params=[False, True], ids=["standard", "implicit"])
def rcnn(request, draws):
    cfg = rcnn_cfg(request.param)
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=3, scale=0.1)
    return {
        "cfg": cfg,
        "variables": variables,
        "eval": jax_inference(jm, variables, given_boxes_batch()),
        "train": jax_losses_and_grads(cfg, variables, make_batch()),
    }


def test_rcnn_inference_through_the_subdivision_loop_matches_jax(rcnn):
    model = port_model(rcnn["cfg"], rcnn["variables"])
    heads = model.roi_heads
    assert (heads.subdivision_init_resolution, heads.subdivision_steps) == (14, 1)
    out, ref = model(given_boxes_batch()), rcnn["eval"]
    assert out["pred_masks"].shape == (2, 7, 28, 28)
    close(out["pred_masks"], ref["pred_masks"], 1e-5)


def test_rcnn_losses_and_gradients_match_jax(rcnn):
    model = port_model(rcnn["cfg"], rcnn["variables"])
    losses = assert_train_step_matches(model, make_batch(), *rcnn["train"])
    implicit = isinstance(model.roi_heads, pr.ImplicitPointRendROIHeads)
    assert {"loss_mask_point", "loss_l2" if implicit else "loss_mask"} <= set(losses)
    assert all(np.isfinite(v) and v > 0 for v in losses.values())
    for name, p in model.named_parameters():
        if name.startswith("roi_heads.mask_head."):
            assert p.grad is not None and p.grad.abs().sum() > 0, name


def sem_cfg():
    cfg = get_cfg()
    pr.add_pointrend_config(cfg)
    m = cfg.MODEL
    m.META_ARCHITECTURE = "SemanticSegmentor"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.SEM_SEG_HEAD.NAME = "PointRendSemSegHead"
    m.SEM_SEG_HEAD.NUM_CLASSES = m.POINT_HEAD.NUM_CLASSES = 5
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    m.POINT_HEAD.FC_DIM = 32
    m.POINT_HEAD.TRAIN_NUM_POINTS = 64
    m.POINT_HEAD.SUBDIVISION_NUM_POINTS = 256
    m.POINT_HEAD.COARSE_PRED_EACH_LAYER = False  # the semantic yamls'
    m.DEVICE = "cpu"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def sem_batch():
    rng = np.random.RandomState(12)
    sem = rng.randint(0, 5, (2, 64, 64)).astype(np.int32)
    sem[:, :6] = 255
    return {"image": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8), "image_sizes": np.array([[64, 64]] * 2, np.int32),
            "gt_sem_seg": sem}


def test_semantic_head_inference_and_training_match_jax(draws):
    cfg = sem_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=4, scale=0.1)
    model = port_model(cfg, variables)
    assert isinstance(model.sem_seg_head, pr.PointRendSemSegHead)
    batch = sem_batch()
    images = {k: batch[k] for k in ("image", "image_sizes")}
    ref = jax_inference(jm, variables, images)["sem_seg"]
    out = model(images)["sem_seg"]
    assert out.shape == (2, 64, 64, 5)
    close(out, ref, 2e-5 * np.abs(ref).max())
    ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert set(losses) == {"loss_sem_seg", "loss_sem_seg_point"}


def test_golden_through_the_d2_loader(tmp_path):
    g = load_golden("e2e_pointrend_r18")
    pkl = tmp_path / "pointrend.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    model = build_model(golden_pointrend_config(), device="cpu")
    assert (model.roi_heads.subdivision_init_resolution, model.roi_heads.subdivision_steps) == (14, 2)
    report = load_d2_checkpoint(model, str(pkl))
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."]
    assert any(k.startswith("roi_heads.mask_head.point_head.") for k in model.state_dict())
    errs = compare_with_pointrend_golden(model({"image": g["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}), g)
    assert errs["mask_probs10"] < 5e-4


POINT_REND_YAMLS = {
    "PointRend/implicit_pointrend_R_50_FPN_1x_coco.yaml": "ImplicitPointRendROIHeads",
    "PointRend/implicit_pointrend_R_50_FPN_3x_coco.yaml": "ImplicitPointRendROIHeads",
    "PointRend/pointrend_rcnn_R_101_FPN_3x_coco.yaml": "PointRendROIHeads",
    "PointRend/pointrend_rcnn_R_50_FPN_1x_cityscapes.yaml": "PointRendROIHeads",
    "PointRend/pointrend_rcnn_R_50_FPN_1x_coco.yaml": "PointRendROIHeads",
    "PointRend/pointrend_rcnn_R_50_FPN_3x_coco.yaml": "PointRendROIHeads",
    "PointRend/pointrend_rcnn_X_101_32x8d_FPN_3x_coco.yaml": "PointRendROIHeads",
    "PointRend/SemanticSegmentation/pointrend_semantic_R_101_FPN_1x_cityscapes.yaml": "PointRendSemSegHead",
}


def test_the_pointrend_yaml_set():
    found = sorted(os.path.relpath(os.path.join(d, f), os.path.join(ROOT, "configs"))
                   for d, _, fs in os.walk(os.path.join(ROOT, "configs", "PointRend")) for f in fs
                   if f.endswith(".yaml") and not f.startswith("Base"))
    assert found == sorted(POINT_REND_YAMLS)


@pytest.mark.parametrize("yaml", sorted(POINT_REND_YAMLS))
def test_pointrend_yamls_build(yaml):
    cfg = get_cfg()
    pr.add_pointrend_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    if "Semantic" in yaml:
        head = model.sem_seg_head
        assert type(head).__name__ == POINT_REND_YAMLS[yaml] and type(head.coarse_sem_seg_head).__name__ == "SemSegFPNHead"
        assert head.point_head.predictor.out_channels == 19 and not head.point_head.coarse_pred_each_layer
    else:
        heads = model.roi_heads
        assert type(heads).__name__ == POINT_REND_YAMLS[yaml]
        implicit = "implicit" in yaml
        assert (heads.subdivision_init_resolution, heads.subdivision_steps) == ((28, 3) if implicit else (14, 1))
        assert type(heads.mask_head.point_head).__name__ == ("ImplicitPointHead" if implicit else "StandardPointHead")
    for name in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST:
        assert name in DatasetCatalog.list(), name
