"""The port's ROI heads against the JAX package's: Fast R-CNN padded
inference (vs the reference golden and the JAX function), the box head and
predictor, and the mask head (weights carried across, float32).

Tolerances: the golden's own (scores 1e-5, boxes 1e-3); head outputs 1e-4
relative to their largest value (matmul/conv sum order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import jax_model, jax_random_variables, load_golden, n, port_model, t

from detectron2_tpu.modeling.roi_heads.fast_rcnn import fast_rcnn_inference_padded as jax_inference
from detectron2_tpu.modeling.roi_heads.mask_head import mask_rcnn_inference as jax_mask_inference
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.modeling.roi_heads import fast_rcnn_inference_padded, mask_rcnn_inference

torch.set_num_threads(1)


def test_fast_rcnn_inference_matches_reference_golden():
    g = load_golden("fast_rcnn_inference")
    R, C = g["scores"].shape[0], g["scores"].shape[1] - 1
    out = fast_rcnn_inference_padded(
        t(g["boxes"].reshape(1, R, C, 4)),
        t(g["scores"][None]),
        torch.ones((1, R), dtype=torch.bool),
        t(g["image_shape"][None]),
        score_thresh=0.05,
        nms_thresh=0.5,
        topk_per_image=100,
    )
    assert out["pred_boxes"].shape == (1, 100, 4)
    v = n(out["valid"][0])
    ours = sorted(
        zip(n(out["scores"][0])[v].tolist(), n(out["pred_classes"][0])[v].tolist(), n(out["pred_boxes"][0])[v].round(3).tolist()),
        reverse=True,
    )
    ref = sorted(zip(g["out_scores"].tolist(), g["out_classes"].tolist(), g["out_boxes"].round(3).tolist()), reverse=True)
    assert len(ours) == len(ref)
    for (s1, c1, b1), (s2, c2, b2) in zip(ours, ref):
        assert abs(s1 - s2) < 1e-5 and c1 == c2
        np.testing.assert_allclose(b1, b2, atol=1e-3)


@pytest.mark.parametrize("K,topk,candidates", [(6, 40, 2048), (1, 30, 64), (6, 500, 2048)])
def test_fast_rcnn_inference_matches_jax(K, topk, candidates):
    """Per-class and class-agnostic boxes, a candidate cap below the
    qualifying count, and fewer survivors than output slots (padding)."""
    rng = np.random.RandomState(K + topk)
    B, P, C = 2, 60, 6
    xy = rng.uniform(-10, 90, (B, P, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 40, (B, P, K, 2))], -1).astype(np.float32)
    logits = rng.standard_normal((B, P, C + 1)) * 2
    scores = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    scores[0, :5, :C] = 0.3  # exact ties across proposals and classes
    valid = rng.uniform(size=(B, P)) > 0.1
    sizes = np.array([[80, 100], [64, 64]], np.int32)
    args = (boxes, scores, valid, sizes)
    ref = jax_inference(*(jnp.asarray(a) for a in args), 0.05, 0.5, topk, candidates)
    out = fast_rcnn_inference_padded(*(t(a) for a in args), 0.05, 0.5, topk, candidates)
    assert set(out) == set(ref)
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), np.asarray(ref["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(out["pred_boxes"]), np.asarray(ref["pred_boxes"]), rtol=0, atol=1e-4)


def _cfg():
    cfg = get_cfg()
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 5
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 2
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.MASK_ON = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=11, scale=0.1)
    return jm, variables, port_model(cfg, variables)


def _close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(n(out), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_box_head_and_predictor_match_jax(models):
    jm, variables, model = models
    pooled = np.random.RandomState(0).standard_normal((9, 7, 7, 32)).astype(np.float32)

    def jax_fn(mod, x):
        feat = mod.roi_heads.box_head(x, train=False)
        return (feat,) + tuple(mod.roi_heads.box_predictor(feat, train=False))

    ref = jm.apply(variables, jnp.asarray(pooled), method=jax_fn)
    with torch.no_grad():
        feat = model.roi_heads.box_head(t(pooled), False)
        out = (feat,) + tuple(model.roi_heads.box_predictor(feat))
    for o, r in zip(out, ref):
        _close(o, r)


def test_mask_head_matches_jax(models):
    jm, variables, model = models
    rng = np.random.RandomState(1)
    pooled = rng.standard_normal((6, 14, 14, 32)).astype(np.float32)
    classes = rng.randint(0, 5, 6).astype(np.int32)
    ref = jm.apply(variables, jnp.asarray(pooled), method=lambda mod, x: mod.roi_heads.mask_head(x, train=False))
    with torch.no_grad():
        out = model.roi_heads.mask_head(t(pooled), False)
    assert out.shape == (6, 28, 28, 5)
    _close(out, ref)
    np.testing.assert_allclose(
        n(mask_rcnn_inference(out, t(classes))),
        np.asarray(jax_mask_inference(ref, jnp.asarray(classes))),
        rtol=0, atol=1e-5,
    )
