"""Mask R-CNN C4 training (``Res5ROIHeads.forward_train``) in the port
against the JAX package, on the CPU: the tiny R18-C4 model
(``testing.golden_c4_config``: a bare R18 to res4, one RPN level, the res5
stage in the heads, a mask head without convs) on seeded weights carried
across by ``convert_jax_params``, with both packages' samplers on the same
draws (``_torch_port.SameDraws``).

Tolerances, as ``test_torch_train_step.py``: the five losses rtol 1e-4;
every parameter's gradient within 1e-3 * max|g_ref| + 1e-6.
"""

import pytest
import torch

from _torch_port import SameDraws, assert_train_step_matches, jax_losses_and_grads, jax_model, jax_random_variables, port_model

import detectron2_tpu_torch.modeling.poolers as poolers
from detectron2_tpu_torch.testing import golden_c4_config, synthetic_train_batch

torch.set_num_threads(1)
LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")


def tiny_c4_cfg(mask_on=True):
    cfg = golden_c4_config()
    cfg.MODEL.MASK_ON = mask_on
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    return cfg


@pytest.mark.parametrize("mask_on", [True, False])
def test_c4_losses_and_gradients_match_jax(mask_on):
    cfg = tiny_c4_cfg(mask_on)
    batch = synthetic_train_batch(num_classes=7, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=4).patch(mp)
        variables = jax_random_variables(jax_model(cfg), seed=6, scale=0.1)
        ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
        model = port_model(cfg, variables)
        calls = []
        entry = poolers.roi_align_multilevel
        mp.setattr(poolers, "roi_align_multilevel", lambda *a, **k: calls.append(a[1].shape[0]) or entry(*a, **k))
        losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert set(losses) == set(LOSSES if mask_on else LOSSES[:2] + LOSSES[3:])
    # one pool of the sampled slots on res4; the mask loss reads res5's rows
    assert calls == [2 * cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE]
    if mask_on:
        assert losses["loss_mask"] > 0
