"""The port's GIoU, DIoU and CIoU box losses against the JAX package's, on
the CPU in float32.

- ``giou_loss``, ``diou_loss`` and ``ciou_loss`` on seeded XYXY pairs with
  zero-area, disjoint, identical, nested, touching and zero-height boxes,
  in every reduction, and their gradients against ``jax.grad`` (CIoU's
  ``alpha`` carries none, as in JAX);
- the dense loss's ``"giou"``, ``"diou"`` and ``"ciou"`` branches
  (``_dense_box_regression_loss``, which RetinaNet and the RPN read);
- the RPN's losses with each type and ``BBOX_REG_LOSS_WEIGHT`` 2 on the same
  anchors, logits, deltas and gt, with the same sampler draws;
- the box head's losses (``FastRCNNOutputLayers.losses``) with each type,
  ``loss_weight_box`` 10 and ``loss_weight_cls`` 0.5, the deltas of the gt
  class decoded against the proposals, on padded, background and
  foreground slots, class-specific and class-agnostic;
- a tiny R18-FPN Mask R-CNN with ``mask_rcnn_R_50_FPN_1x_giou.yaml``'s box
  options (the RPN's GIoU at weight 2, the box head's at 10) and
  ``TRAIN_ON_PRED_BOXES``: one training step's losses and every gradient
  against the JAX ``value_and_grad`` (computed once for the two model
  tests); without the flag the port's losses are the same exactly
  (ROADMAP C: the JAX package reads it nowhere, d2 trains the mask head on
  the predicted boxes; a difference that stays).

Tolerances: the losses rtol 1e-5, atol 1e-6 (float32, the same formula in
the same order); their gradients rtol 1e-5, atol 1e-6; the model step as
the R-CNN train-step tests, losses rtol 1e-4 and each gradient within 1e-3
of max|g| + 1e-6 (sums over every proposal in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    n,
    port_model,
    t,
)
from test_torch_fcos import boxes_pair

from detectron2_tpu.layers import losses as jax_losses
from detectron2_tpu.modeling.box_regression import Box2BoxTransform as JaxTransform
from detectron2_tpu.modeling.box_regression import _dense_box_regression_loss as jax_dense_loss
from detectron2_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from detectron2_tpu.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers as JaxOutputLayers
from detectron2_tpu_torch.layers import losses
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransform, _dense_box_regression_loss
from detectron2_tpu_torch.modeling.matcher import Matcher
from detectron2_tpu_torch.modeling.proposal_generator import RPN
from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers
from detectron2_tpu_torch.testing import synthetic_train_batch

torch.set_num_threads(1)
TYPES = ("giou", "diou", "ciou")
TOL = dict(rtol=1e-5, atol=1e-6)


def pairs():
    a, b = boxes_pair(seed=7)
    a[7], b[7] = [0, 4, 9, 4], [1, 2, 8, 12]  # zero height: CIoU's clamp
    a[8], b[8] = [40, 40, 60, 50], [0, 0, 5, 5]  # far apart
    return a, b


@pytest.mark.parametrize("kind", TYPES)
def test_iou_losses_and_gradients_match_jax(kind):
    a, b = pairs()
    ours, ref = getattr(losses, f"{kind}_loss"), getattr(jax_losses, f"{kind}_loss")
    for reduction in ("none", "sum", "mean"):
        np.testing.assert_allclose(n(ours(t(a), t(b), reduction)), np.asarray(ref(a, b, reduction)), **TOL)
    assert np.isfinite(n(ours(t(a), t(b)))).all()
    at = t(a).requires_grad_()
    ours(at, t(b), "sum").backward()
    ref_grad = jax.grad(lambda x: ref(x, jnp.asarray(b), "sum"))(jnp.asarray(a))
    np.testing.assert_allclose(n(at.grad), np.asarray(ref_grad), **TOL)
    assert losses.IOU_LOSSES[kind] is ours


def _anchors_and_deltas(seed, N=64):
    rng = np.random.RandomState(seed)
    anchors, gt = boxes_pair(seed=seed, N=N)
    anchors[:7] += [0, 0, 1, 1]  # positive sizes: the decode divides by them
    deltas = (rng.standard_normal((N, 4)) * 0.5).astype(np.float32)
    fg = rng.rand(N) > 0.4
    return anchors, deltas, gt, fg


@pytest.mark.parametrize("kind", TYPES + ("smooth_l1",))
def test_dense_box_regression_loss_matches_jax(kind):
    anchors, deltas, gt, fg = _anchors_and_deltas(seed=3)
    weights = (1.0, 1.0, 1.0, 1.0)
    ours = _dense_box_regression_loss(t(anchors), Box2BoxTransform(weights), t(deltas), t(gt), t(fg), kind, 0.1)
    ref = jax_dense_loss(anchors, JaxTransform(weights), deltas, gt, fg, kind, 0.1)
    np.testing.assert_allclose(n(ours), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="Invalid"):
        _dense_box_regression_loss(t(anchors), Box2BoxTransform(weights), t(deltas), t(gt), t(fg), "l2")


def _rpn_inputs(seed=0, B=2, G=4):
    rng = np.random.RandomState(seed)
    anchors, logits, deltas = [], [], []
    for A in (120, 40):
        xy = rng.rand(A, 2) * 56
        anchors.append(np.concatenate([xy, xy + rng.rand(A, 2) * 24 + 2], 1).astype(np.float32))
        logits.append(rng.standard_normal((B, A)).astype(np.float32))
        deltas.append((rng.standard_normal((B, A, 4)) * 0.3).astype(np.float32))
    xy = rng.rand(B, G, 2) * 48
    gt = np.concatenate([xy, xy + rng.rand(B, G, 2) * 20 + 4], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return anchors, logits, deltas, gt, valid, np.full((B, 2), 64, np.int32)


@pytest.mark.parametrize("kind", TYPES)
def test_rpn_losses_match_jax(kind, monkeypatch):
    SameDraws(seed=5).patch(monkeypatch)
    anchors, logits, deltas, gt, valid, sizes = _rpn_inputs()
    fields = dict(batch_size_per_image=32, positive_fraction=0.5, loss_weight_cls=1.0, loss_weight_loc=2.0)
    ours = RPN(
        in_features=("p2", "p3"), head=None, anchor_generator=None,
        anchor_matcher=Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True),
        box_reg_loss_type=kind, **fields,
    ).losses([t(a) for a in anchors], [t(x) for x in logits], [t(x) for x in deltas], t(gt), t(valid), t(sizes))
    ref = JaxRPN(in_features=("p2", "p3"), head=None, anchor_generator=None, box_reg_loss_type=kind, **fields).losses(
        [jnp.asarray(a) for a in anchors], [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas],
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(sizes), jax.random.PRNGKey(0),
    )
    assert set(ours) == set(ref) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in ours:
        np.testing.assert_allclose(n(ours[k]), np.asarray(ref[k]), err_msg=k, **TOL)
    assert n(ours["loss_rpn_loc"]) > 0


def _head_inputs(seed, C, agnostic, R=48):
    rng = np.random.RandomState(seed)
    xy = rng.rand(R, 2) * 60
    proposals = np.concatenate([xy, xy + rng.rand(R, 2) * 30 + 1], 1).astype(np.float32)
    gt = (proposals + rng.standard_normal((R, 4)) * 3).astype(np.float32)
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 0.5)
    classes = rng.randint(0, C + 1, R).astype(np.int32)  # C is the background
    classes[-5:] = -1  # padding
    scores = rng.standard_normal((R, C + 1)).astype(np.float32)
    deltas = (rng.standard_normal((R, (1 if agnostic else C) * 4)) * 0.4).astype(np.float32)
    return scores, deltas, proposals, gt, classes


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("kind", TYPES + ("smooth_l1",))
def test_box_head_losses_match_jax(kind, agnostic):
    C = 5
    scores, deltas, proposals, gt, classes = _head_inputs(seed=11, C=C, agnostic=agnostic)
    fields = dict(box2box_weights=(10.0, 10.0, 5.0, 5.0), cls_agnostic_bbox_reg=agnostic, smooth_l1_beta=0.0,
                  box_reg_loss_type=kind, loss_weight_cls=0.5, loss_weight_box=10.0)
    ours = FastRCNNOutputLayers(8, C, **fields).losses((t(scores), t(deltas)), t(proposals), t(gt), t(classes))
    ref = JaxOutputLayers(num_classes=C, **fields).losses((scores, deltas), proposals, gt, classes)
    assert set(ours) == set(ref) == {"loss_cls", "loss_box_reg"}
    for k in ours:
        np.testing.assert_allclose(n(ours[k]), np.asarray(ref[k]), err_msg=k, **TOL)
    with pytest.raises(ValueError, match="Invalid bbox reg loss type"):
        FastRCNNOutputLayers(8, C, box_reg_loss_type="l2")


def tiny_giou_cfg():
    from test_torch_panoptic import tiny_cfg

    cfg = tiny_cfg()
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    cfg.MODEL.RPN.BBOX_REG_LOSS_TYPE = "giou"
    cfg.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 2.0
    cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "giou"
    cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 10.0
    return cfg


@pytest.fixture(scope="module")
def giou_step():
    """The tiny GIoU model with ``TRAIN_ON_PRED_BOXES``: its config, JAX
    variables, batch, sampler draws and the JAX step's losses and
    gradients."""
    draws = SameDraws(seed=9)
    cfg = tiny_giou_cfg()
    cfg.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = True
    jm = jax_model(cfg)
    assert jm.roi_heads.train_on_pred_boxes
    variables = jax_random_variables(jm, seed=0, scale=0.1)
    batch = synthetic_train_batch(num_classes=8)
    with pytest.MonkeyPatch.context() as mp:
        draws.patch(mp)
        ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    return draws, cfg, variables, batch, ref_losses, ref_grads


def test_giou_model_train_step_matches_jax(giou_step, monkeypatch):
    draws, cfg, variables, batch, ref_losses, ref_grads = giou_step
    draws.patch(monkeypatch)
    model = port_model(cfg, variables)
    assert model.proposal_generator.box_reg_loss_type == model.roi_heads.box_predictor.box_reg_loss_type == "giou"
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert all(np.isfinite(v) for v in losses.values()) and losses["loss_box_reg"] > 0


def test_train_on_pred_boxes_follows_jax(giou_step, monkeypatch):
    """The flag is read nowhere in the JAX package: the mask head trains on
    the sampled proposals with it or without it."""
    draws, cfg, variables, batch, ref_losses, ref_grads = giou_step
    draws.patch(monkeypatch)
    model = port_model(cfg, variables)
    assert model.roi_heads.train_on_pred_boxes
    with_flag = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    cfg = cfg.clone()
    cfg.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False
    plain = port_model(cfg, variables)
    assert not plain.roi_heads.train_on_pred_boxes
    assert {k: v.item() for k, v in plain(batch, train=True).items()} == with_flag
