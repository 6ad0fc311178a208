"""The port's training losses and targets against the JAX package's on the
same inputs (float32): the loss functions, ``Box2BoxTransform.get_deltas``,
the RPN losses, ``FastRCNNOutputLayers.losses``, ``mask_rcnn_loss``,
``label_and_sample_proposals_padded``, ``select_foreground_slots`` and
``crop_gt_masks_to_proposals``.

The samplers get the same draws (``_torch_port.SameDraws``).
Tolerances: losses rtol 1e-5 (float32 sums in another order); targets,
labels and indices exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import SameDraws, jax_cfg_from_port, load_golden, n, t

import detectron2_tpu.layers.losses as jax_losses
import detectron2_tpu.modeling.roi_heads.roi_heads as jax_roi_heads
from detectron2_tpu.layers.shape_spec import ShapeSpec as JaxShapeSpec
from detectron2_tpu.modeling.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from detectron2_tpu.modeling.matcher import Matcher as JaxMatcher
from detectron2_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from detectron2_tpu.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers as JaxFastRCNNOutputLayers
from detectron2_tpu.modeling.roi_heads.mask_head import mask_rcnn_loss as jax_mask_rcnn_loss
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.layers import ShapeSpec, losses
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.proposal_generator import build_rpn
from detectron2_tpu_torch.modeling.roi_heads import roi_heads
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers
from detectron2_tpu_torch.modeling.roi_heads.mask_head import mask_rcnn_loss

torch.set_num_threads(1)


def _close(out, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture
def same_draws(monkeypatch):
    SameDraws(seed=17).patch(monkeypatch)


def test_loss_functions_match_jax():
    rng = np.random.RandomState(0)
    x, y = rng.standard_normal((2, 50, 4)).astype(np.float32) * 3
    for beta in (0.0, 0.5):
        _close(losses.smooth_l1_loss(t(x), t(y), beta), jax_losses.smooth_l1_loss(x, y, beta))
    logits = rng.standard_normal((40, 6)).astype(np.float32) * 5
    targets = (rng.rand(40, 6) > 0.5).astype(np.float32)
    _close(losses.binary_cross_entropy_with_logits(t(logits), t(targets)),
           jax_losses.binary_cross_entropy_with_logits(logits, targets))
    labels = rng.randint(0, 6, 40)
    labels[:3] = -100
    labels[3:5] = -1
    for reduction in ("mean", "sum", "none"):
        for ignore in (-100, -1):
            ok = (labels >= 0) | (labels == ignore)
            _close(losses.cross_entropy(t(logits[ok]), t(labels[ok]), reduction, ignore_index=ignore),
                   jax_losses.cross_entropy(logits[ok], labels[ok], reduction, ignore_index=ignore))
    all_ignored = np.full(5, -100)
    assert float(losses.cross_entropy(t(logits[:5]), t(all_ignored))) == 0.0


def test_get_deltas_matches_reference_golden_and_jax():
    g = load_golden("box2box")
    b2b = Box2BoxTransform((10.0, 10.0, 5.0, 5.0))
    _close(b2b.get_deltas(t(g["src"]), t(g["tgt"])), g["deltas"], rtol=1e-5, atol=1e-5)
    src = g["src"].copy()
    src[:4] = 0  # padded rows
    ref = JaxBox2BoxTransform((10.0, 10.0, 5.0, 5.0)).get_deltas(jnp.asarray(src), jnp.asarray(g["tgt"]))
    _close(b2b.get_deltas(t(src), t(g["tgt"])), ref, rtol=1e-6, atol=1e-4)


def _rpn_cfg(boundary_thresh):
    cfg = get_cfg()
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[16], [32], [64]]
    cfg.MODEL.RPN.IN_FEATURES = ["p2", "p3", "p4"]
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.BOUNDARY_THRESH = boundary_thresh
    cfg.MODEL.RPN.SMOOTH_L1_BETA = 0.1
    cfg.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 2.0
    return cfg


@pytest.mark.parametrize("boundary_thresh", [-1, 0])
def test_rpn_losses_match_jax(boundary_thresh, same_draws):
    cfg = _rpn_cfg(boundary_thresh)
    strides = {"p2": 4, "p3": 8, "p4": 16}
    rpn = build_rpn(cfg, {k: ShapeSpec(channels=8, stride=s) for k, s in strides.items()})
    jrpn = JaxRPN.from_config(jax_cfg_from_port(cfg), {k: JaxShapeSpec(channels=8, stride=s) for k, s in strides.items()})
    grids = [(16, 16), (8, 8), (4, 4)]
    anchors = rpn.anchor_generator(grids, "cpu")
    rng = np.random.RandomState(boundary_thresh + 2)
    B, G = 2, 4
    logits = [rng.standard_normal((B, a.shape[0])).astype(np.float32) for a in anchors]
    deltas = [rng.standard_normal((B, a.shape[0], 4)).astype(np.float32) * 0.3 for a in anchors]
    xy = rng.uniform(-5, 40, (B, G, 2))
    gt = np.concatenate([xy, xy + rng.uniform(4, 40, (B, G, 2))], -1).astype(np.float32)
    gt_valid = np.array([[True, True, True, False], [True, False, False, False]])
    sizes = np.array([[64, 64], [50, 60]], np.int32)
    out = rpn.losses(anchors, [t(x) for x in logits], [t(x) for x in deltas], t(gt), t(gt_valid), t(sizes))
    ref = jrpn.losses(
        [jnp.asarray(n(a)) for a in anchors], [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas],
        jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(sizes), jax.random.PRNGKey(0),
    )
    assert set(out) == set(ref) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in out:
        _close(out[k], ref[k])
    assert float(out["loss_rpn_loc"]) > 0


@pytest.mark.parametrize("agnostic,beta", [(False, 0.0), (True, 0.0), (False, 0.5)])
def test_fast_rcnn_losses_match_jax(agnostic, beta):
    C, R = 5, 60
    rng = np.random.RandomState(int(agnostic) + 3)
    scores = rng.standard_normal((R, C + 1)).astype(np.float32) * 2
    deltas = rng.standard_normal((R, 4 * (1 if agnostic else C))).astype(np.float32)
    xy = rng.uniform(0, 50, (R, 2))
    props = np.concatenate([xy, xy + rng.uniform(1, 30, (R, 2))], -1).astype(np.float32)
    gts = (props + rng.uniform(-3, 3, (R, 4))).astype(np.float32)
    classes = rng.randint(-1, C + 1, R)
    port = FastRCNNOutputLayers(8, C, cls_agnostic_bbox_reg=agnostic, smooth_l1_beta=beta, loss_weight_box=1.5)
    ref = JaxFastRCNNOutputLayers(
        num_classes=C, cls_agnostic_bbox_reg=agnostic, smooth_l1_beta=beta, loss_weight_box=1.5
    ).losses((jnp.asarray(scores), jnp.asarray(deltas)), jnp.asarray(props), jnp.asarray(gts), jnp.asarray(classes))
    out = port.losses((t(scores), t(deltas)), t(props), t(gts), t(classes))
    assert set(out) == set(ref)
    for k in out:
        _close(out[k], ref[k])


@pytest.mark.parametrize("C", [1, 4])
def test_mask_rcnn_loss_matches_jax(C):
    rng = np.random.RandomState(C)
    R, M = 12, 28
    logits = rng.standard_normal((R, M, M, C)).astype(np.float32) * 3
    classes = rng.randint(0, 4, R)
    targets = (rng.rand(R, M, M) > 0.5).astype(np.float32)
    valid = rng.rand(R) > 0.3
    _close(mask_rcnn_loss(t(logits), t(classes), t(targets), t(valid)),
           jax_mask_rcnn_loss(jnp.asarray(logits), jnp.asarray(classes), jnp.asarray(targets), jnp.asarray(valid)))
    assert float(mask_rcnn_loss(t(logits), t(classes), t(targets), t(np.zeros(R, bool)))) == 0.0


def _proposals_and_targets(rng, B=2, P=40, G=5, num_classes=6):
    xy = rng.uniform(0, 60, (B, P, 2))
    props = np.concatenate([xy, xy + rng.uniform(2, 40, (B, P, 2))], -1).astype(np.float32)
    valid = rng.rand(B, P) > 0.1
    gxy = rng.uniform(0, 60, (B, G, 2))
    gt_boxes = np.concatenate([gxy, gxy + rng.uniform(8, 40, (B, G, 2))], -1).astype(np.float32)
    props[:, :G] = gt_boxes + rng.uniform(-2, 2, (B, G, 4)).astype(np.float32)  # some positives
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, 3:] = False
    return props, valid, {
        "gt_boxes": gt_boxes,
        "gt_classes": rng.randint(0, num_classes, (B, G)).astype(np.int32),
        "gt_valid": gt_valid,
        "gt_masks": (rng.rand(B, G, 28, 28) > 0.5).astype(np.float32),
    }


def test_label_and_sample_and_foreground_slots_match_jax(same_draws):
    rng = np.random.RandomState(21)
    props, valid, targets = _proposals_and_targets(rng)
    S, frac, C = 32, 0.25, 6
    out = roi_heads.label_and_sample_proposals_padded(
        t(props), t(valid), {k: t(v) for k, v in targets.items()}, Matcher([0.5], [0, 1]), S, frac, C
    )
    ref = jax_roi_heads.label_and_sample_proposals_padded(
        jax.random.PRNGKey(0), jnp.asarray(props), jnp.asarray(valid), {k: jnp.asarray(v) for k, v in targets.items()},
        JaxMatcher([0.5], [0, 1]), S, frac, C,
    )
    for k in ("valid", "is_fg", "gt_classes"):
        np.testing.assert_array_equal(n(out[k]), np.asarray(ref[k]), err_msg=k)
    v = n(out["valid"])
    np.testing.assert_array_equal(n(out["gt_idx"])[v], np.asarray(ref["gt_idx"])[v])
    np.testing.assert_array_equal(n(out["boxes"])[v], np.asarray(ref["boxes"])[v])
    assert n(out["is_fg"]).sum() > 0

    idx, fg_valid = roi_heads.select_foreground_slots(out["is_fg"], 8)
    for b in range(2):
        ridx, rvalid = jax_roi_heads.select_foreground_slots(jnp.asarray(n(out["is_fg"][b])), 8)
        np.testing.assert_array_equal(n(idx[b]), np.asarray(ridx))
        np.testing.assert_array_equal(n(fg_valid[b]), np.asarray(rvalid))


def test_crop_gt_masks_to_proposals_matches_jax():
    rng = np.random.RandomState(22)
    props, _, targets = _proposals_and_targets(rng)
    R = 16
    gt_idx = rng.randint(0, 5, (2, R))
    boxes = props[:, :R]
    out = roi_heads.crop_gt_masks_to_proposals(t(targets["gt_masks"]), t(targets["gt_boxes"]), t(gt_idx), t(boxes), 28)
    assert out.shape == (2, R, 28, 28)
    for b in range(2):
        ref = jax_roi_heads.crop_gt_masks_to_proposals(
            jnp.asarray(targets["gt_masks"][b]), jnp.asarray(targets["gt_boxes"][b]), jnp.asarray(gt_idx[b]),
            jnp.asarray(boxes[b]), 28,
        )
        np.testing.assert_array_equal(n(out[b]), np.asarray(ref))
