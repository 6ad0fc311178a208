"""The port's Mask R-CNN end to end on the CPU: the synthetic R18-FPN fixture
must reproduce the reference detections of tests/goldens/e2e_maskrcnn_r18.npz
at the tolerances of tests/parity/test_e2e_maskrcnn_golden.py:141-178, and
the same model with its weights carried across from the JAX package must
match the JAX model's output dict (float32)."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_model, jax_variables_from_d2, load_golden, n, port_model

from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.testing import compare_with_golden, golden_r18_config, golden_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_maskrcnn_r18")


@pytest.fixture(scope="module")
def d2_pkl(golden, tmp_path_factory):
    path = tmp_path_factory.mktemp("d2") / "synthetic_ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    return str(path)


def _batch(golden):
    return {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}


def test_port_reproduces_reference_golden_from_d2_pkl(golden, d2_pkl):
    model = build_model(golden_r18_config(), device="cpu")
    report = load_d2_checkpoint(model, d2_pkl)
    # every checkpoint tensor consumed, every model tensor loaded
    assert report == f"Loaded {len(golden['weight_names'])}/{len(golden['weight_names'])} tensors from the checkpoint."
    errs = compare_with_golden(model(_batch(golden)), golden)
    assert errs["min_mask_iou10"] > 0.9


def test_d2_loader_reports_unused_keys_both_ways(golden):
    sd = golden_state_dict(golden)
    sd.pop("roi_heads.box_predictor.cls_score.bias")
    sd["roi_heads.extra_head.weight"] = np.zeros(3, np.float32)
    sd["pixel_mean"] = np.zeros(3, np.float32)
    from detectron2_tpu_torch.checkpoint import load_state_dict_report

    report = load_state_dict_report(build_model(golden_r18_config(), device="cpu"), sd)
    assert "Not found in the checkpoint: ['roi_heads.box_predictor.cls_score.bias']" in report
    assert "Unused checkpoint keys: ['roi_heads.extra_head.weight']" in report
    sd["roi_heads.box_predictor.cls_score.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_state_dict_report(build_model(golden_r18_config(), device="cpu"), sd)


@pytest.fixture(scope="module")
def jax_run(golden):
    """The JAX model on the golden weights, run once per module (the slow part)."""
    cfg = golden_r18_config()
    cfg.TPU.PASTE_MASKS_IN_GRAPH = True
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    out = jm.apply(variables, {k: jnp.asarray(v) for k, v in _batch(golden).items()}, train=False)
    return cfg, variables, jax.tree_util.tree_map(np.asarray, out)


def test_convert_jax_params_inverts_the_jax_converter(golden, jax_run):
    _, variables, _ = jax_run
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    sd = golden_state_dict(golden)
    assert sorted(state) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(n(state[k]), v, err_msg=k)


def test_port_matches_jax_model_output(golden, jax_run):
    cfg, variables, ref = jax_run
    out = port_model(cfg, variables)(_batch(golden))
    assert set(out) == set(ref)
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)
    full = n(out["pred_masks_full"])
    assert full.shape == ref["pred_masks_full"].shape == (1, 50, 320, 320)
    # bf16-operand paste on both sides: pixels may flip only at the contour
    assert (full != ref["pred_masks_full"]).mean() < 1e-4


def test_predictor_returns_instances_in_the_original_frame(d2_pkl):
    from detectron2_tpu_torch.engine import DefaultPredictor

    cfg = golden_r18_config()
    cfg.MODEL.WEIGHTS = d2_pkl
    cfg.INPUT.MIN_SIZE_TEST = 160
    cfg.INPUT.MAX_SIZE_TEST = 250
    predictor = DefaultPredictor(cfg, device="cpu")
    img = np.random.RandomState(0).randint(0, 256, (120, 180, 3)).astype(np.uint8)
    inst = predictor(img)["instances"]
    assert inst.image_size == (120, 180) and len(inst) > 0
    boxes = n(inst.pred_boxes.tensor)
    assert len(inst.pred_boxes) == len(inst.pred_masks) == len(inst)
    assert (boxes >= 0).all() and (boxes[:, 0::2] <= 180).all() and (boxes[:, 1::2] <= 120).all()
    masks = inst.pred_masks.tensor
    assert masks.shape == (len(inst), 120, 180) and masks.dtype == torch.bool


def test_resize_follows_the_jax_package_pil_resize():
    """Bit-exact with PIL's BILINEAR: upscale, downscale, odd sizes, one axis
    only, and 1-pixel edges."""
    from detectron2_tpu.data.transforms.transform import ResizeTransform
    from detectron2_tpu_torch.data import ResizeShortestEdge
    from detectron2_tpu_torch.data.transforms import pil_bilinear_resize

    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (90, 140, 3)).astype(np.uint8)
    for short, max_size in ((60, 1000), (160, 200)):  # down- and upscaling
        aug = ResizeShortestEdge(short, max_size)
        h, w = aug.get_output_shape(90, 140, short, max_size)
        ref = ResizeTransform(90, 140, h, w).apply_image(img)
        out = n(aug.get_transform(img).apply_image(torch.from_numpy(img)))
        assert out.shape == ref.shape
        assert (out == ref).all()
    pairs = [
        ((480, 640), (800, 1067)), ((600, 800), (799, 1066)), ((800, 1333), (427, 711)),
        ((31, 47), (30, 46)), ((13, 17), (13, 40)), ((13, 17), (29, 17)), ((100, 100), (7, 9)),
        ((1, 1), (5, 7)), ((7, 5), (1, 1)), ((3, 200), (1, 40)), ((200, 3), (41, 2)), ((2, 2), (3, 3)),
    ]
    pairs += [(tuple(rng.randint(1, 120, 2)), tuple(rng.randint(1, 160, 2))) for _ in range(12)]
    for (h, w), (nh, nw) in pairs:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref = ResizeTransform(h, w, nh, nw).apply_image(img)
        out = n(pil_bilinear_resize(torch.from_numpy(img), nh, nw))
        assert out.shape == ref.shape, ((h, w), (nh, nw))
        assert (out == ref).all(), ((h, w), (nh, nw))


def test_entry_points_default_to_the_card():
    cfg = golden_r18_config()
    assert cfg.MODEL.DEVICE == "cuda"
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:  # no hidden fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(cfg)
