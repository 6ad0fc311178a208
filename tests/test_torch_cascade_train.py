"""Cascade Mask R-CNN training (``CascadeROIHeads.forward_train``) in the
port against the JAX package, on the CPU: the tiny cascade R18-FPN
(``testing.golden_cascade_config``, with the mask head on, and with the
keypoint head) on seeded weights carried across by ``convert_jax_params``,
both packages' samplers on the same draws (``_torch_port.SameDraws``);
``_ScaleGradient`` against the JAX ``_scale_gradient``; the refined boxes
carry no gradient.

Tolerances, as ``test_torch_train_step.py``: every loss rtol 1e-4 (the
stage losses ``{loss_cls, loss_box_reg}_stage{k}`` separately); every
parameter's gradient within 1e-3 * max|g_ref| + 1e-6. ``_ScaleGradient``:
bitwise equal to the JAX vjp in float32. The weights are drawn at scale
0.05: at 0.1 stage 0's random deltas move every box off its gt, and stages
1-2 and the mask loss have no foreground to check.
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

from detectron2_tpu.modeling.roi_heads.cascade_rcnn import _scale_gradient as jax_scale_gradient
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.roi_heads.cascade_rcnn import CascadeROIHeads, _ScaleGradient
from detectron2_tpu_torch.testing import golden_cascade_config, synthetic_train_batch

torch.set_num_threads(1)
STAGE_LOSSES = tuple(f"{k}_stage{s}" for s in range(3) for k in ("loss_cls", "loss_box_reg"))


def tiny_cascade_cfg(head):
    cfg = golden_cascade_config()
    cfg.MODEL.MASK_ON = head == "mask"
    cfg.MODEL.KEYPOINT_ON = head == "keypoint"
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (32, 32)
    cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 5
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    return cfg


@pytest.mark.parametrize("head", ["mask", "keypoint"])
def test_cascade_losses_and_gradients_match_jax(head):
    cfg = tiny_cascade_cfg(head)
    batch = synthetic_train_batch(num_classes=7, num_keypoints=5 if head == "keypoint" else 0, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=11).patch(mp)
        variables = jax_random_variables(jax_model(cfg), seed=7, scale=0.05)
        ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
        losses = assert_train_step_matches(port_model(cfg, variables), batch, ref_losses, ref_grads)
    extra = {"mask": "loss_mask", "keypoint": "loss_keypoint"}[head]
    assert set(losses) == set(STAGE_LOSSES) | {extra, "loss_rpn_cls", "loss_rpn_loc"}
    assert losses[extra] > 0 and all(losses[f"loss_box_reg_stage{s}"] > 0 for s in range(3))


def test_scale_gradient_backward_is_g_over_three():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((6, 7, 7, 4)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32) * 1e3
    xt = t(x).requires_grad_(True)
    y = _ScaleGradient.apply(xt, 1.0 / 3)
    assert torch.equal(y, xt)
    y.backward(t(g))
    _, vjp = jax.vjp(lambda a: jax_scale_gradient(a, 1.0 / 3), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(n(xt.grad), ref)
    np.testing.assert_allclose(n(xt.grad), g / 3, rtol=2**-23, atol=0)


def test_refined_boxes_carry_no_gradient():
    """Every stage pools boxes that carry no gradient (a gradient that
    reached the boxes of stage k + 1 would flow into stage k's predictor
    through ``_refine_boxes``), and each stage's pooled features get the
    gradient of its box head's input times 1/3, exactly."""
    cfg = tiny_cascade_cfg("mask")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    heads = model.roi_heads
    assert isinstance(heads, CascadeROIHeads) and heads.cascade_ious == (0.5, 0.6, 0.7)
    boxes, pooled, head_in = [], [], []
    pooler = heads.box_pooler

    def recording(feats, b, batch_idx):
        boxes.append(b)
        out = pooler(feats, b, batch_idx)
        out.retain_grad()
        pooled.append(out)
        return out

    heads.box_pooler = recording
    for head in heads.box_head:
        head.register_forward_pre_hook(lambda m, args: (args[0].retain_grad(), head_in.append(args[0]))[0])
    losses = model(synthetic_train_batch(num_classes=7, seed=4), train=True)
    sum(v for k, v in losses.items() if "_stage" in k).backward()
    assert len(boxes) == len(pooled) == len(head_in) == 3
    assert all(not b.requires_grad for b in boxes)
    for p, h in zip(pooled, head_in):
        assert h.grad.abs().max() > 0
        assert torch.equal(p.grad, h.grad * (1.0 / 3))
