"""DensePoseROIHeads on a tiny DensePose R-CNN R18-FPN against the JAX
package, float32, in four forms: the decoder with the V1ConvX head, the
``_legacy`` FPN pool (no decoder, 15 coarse channels), the DeepLab head
with the iid UV confidence (DL_WC1) and the anisotropic one with the
segmentation confidence (WC2M). Inference (detections, the raw maps and
``pred_densepose`` with ``MAX_INFERENCE_INSTANCES`` below the detections),
and the train losses and every gradient with both samplers on the same
draws.

Tolerances: the detections as ``tests/test_torch_vitdet_e2e.py``, the
DensePose maps 1e-4 of their largest value, the train step as
``_torch_port.assert_train_step_matches``.

The JAX loss takes ``gt_dp_part + 1`` as the fine-segmentation class where
the port takes ``gt_dp_part`` (d2's ``dp_I``, ROADMAP C): the JAX side of
the train test is given ``gt_dp_part - 1``.
"""

import numpy as np
import pytest
import torch

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_inference,
    jax_model,
    jax_random_variables,
    jax_train_step,
    n,
    port_model,
)

from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.projects.densepose import DensePoseROIHeads, add_densepose_config
from detectron2_tpu_torch.testing import synthetic_train_batch

torch.set_num_threads(1)


def tiny_cfg(variant: str):
    """A tiny DensePose R-CNN R18-FPN (the JAX test's ``_cfg``, FPN width 32)."""
    cfg = get_cfg()
    add_densepose_config(cfg)
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TRAIN = m.RPN.PRE_NMS_TOPK_TEST = 64
    m.RPN.POST_NMS_TOPK_TRAIN = m.RPN.POST_NMS_TOPK_TEST = 32
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 1
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 32
    m.MASK_ON = False
    h = m.ROI_DENSEPOSE_HEAD
    h.NUM_STACKED_CONVS = 2
    h.CONV_HEAD_DIM = 32
    h.POOLER_RESOLUTION = 14
    h.DECODER_CONV_DIMS = 32
    h.DECODER_NUM_CLASSES = 32
    h.MAX_INFERENCE_INSTANCES = 5
    h.RAW_OUTPUTS = True
    cfg.TEST.DETECTIONS_PER_IMAGE = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    if variant == "legacy":  # the _legacy configs: no decoder, the FPN pool (B1/B2 on the card), 15 coarse channels
        h.DECODER_ON = False
        h.NUM_COARSE_SEGM_CHANNELS = 15
        h.INDEX_WEIGHTS, h.PART_WEIGHTS, h.POINT_REGRESSION_WEIGHTS = 2.0, 0.3, 0.1
        m.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlign"
    elif variant == "dl_wc1":
        h.NAME = "DensePoseDeepLabHead"
        h.UV_CONFIDENCE.ENABLED = True
        h.UV_CONFIDENCE.TYPE = "iid_iso"
    elif variant == "wc2m":
        h.UV_CONFIDENCE.ENABLED = True
        h.UV_CONFIDENCE.TYPE = "indep_aniso"
        h.SEGM_CONFIDENCE.ENABLED = True
    return cfg


VARIANTS = ["decoder", "legacy", "dl_wc1", "wc2m"]


@pytest.fixture(scope="module", params=VARIANTS)
def tiny(request):
    cfg = tiny_cfg(request.param)
    jm = jax_model(cfg)
    # at scale 0.1 p2 reaches ~80 and float32 rounding moves the one-class
    # scores by ~5e-4 (the backbones agree to 7e-7 of their largest value)
    variables = jax_random_variables(jm, seed=0, scale=0.05)
    return request.param, cfg, jm, variables


def eval_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8),
        "image_sizes": np.array([[64, 96], [56, 80]], np.int32),
    }


def test_densepose_rcnn_inference_matches_jax(tiny):
    variant, cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    assert isinstance(model.roi_heads, DensePoseROIHeads) and (model.roi_heads.decoder is None) == (variant == "legacy")
    batch = eval_batch()
    ref = jax_inference(jm, variables, batch)
    out = model(batch)
    assert set(out) == set(ref)
    assert ref["valid"].sum() >= 10
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    for k, r in ref["pred_densepose_raw"].items():
        o = n(out["pred_densepose_raw"][k])
        assert o.shape == r.shape and not r[:, 5:].any() and not o[:, 5:].any(), k  # the slots past the cap
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)
    dp, rdp = n(out["pred_densepose"]), ref["pred_densepose"]
    assert dp.shape == rdp.shape == (2, 8, 56, 56, 3) and not dp[:, 5:].any()
    same = dp[..., 0] == rdp[..., 0]
    assert same.mean() > 0.999, same.mean()  # parts: argmaxes, equal but at float32 near-ties
    np.testing.assert_allclose(dp[..., 1:][same], rdp[..., 1:][same], rtol=0, atol=1e-4)
    assert set(np.unique(dp[..., 0])) <= set(range(25)) and dp[..., 1:].min() >= 0 and dp[..., 1:].max() <= 1


def dp_train_batch(seed=0, P=12):
    """``synthetic_train_batch`` with one class and DensePose points inside
    each gt box: parts dp_I in 1..24, the last two slots padding, and one gt
    of image 0 without points."""
    batch = synthetic_train_batch(B=2, H=64, W=96, G=5, num_classes=1, seed=seed)
    del batch["gt_masks"]
    rng = np.random.RandomState(seed + 1)
    boxes = batch["gt_boxes"]
    frac = rng.rand(2, 5, P, 2).astype(np.float32)
    batch["gt_dp_points"] = (boxes[..., None, :2] + frac * (boxes[..., None, 2:] - boxes[..., None, :2])).astype(np.float32)
    part = rng.randint(1, 25, (2, 5, P)).astype(np.int64)
    part[..., -2:] = -1
    part[0, 1] = -1
    batch["gt_dp_part"] = part
    batch["gt_dp_u"] = rng.rand(2, 5, P).astype(np.float32)
    batch["gt_dp_v"] = rng.rand(2, 5, P).astype(np.float32)
    return batch


def test_densepose_rcnn_train_step_matches_jax(tiny, monkeypatch):
    variant, cfg, jm, variables = tiny
    SameDraws(0).patch(monkeypatch)
    model = port_model(cfg, variables)
    batch = dp_train_batch()
    jbatch = dict(batch, gt_dp_part=np.where(batch["gt_dp_part"] >= 0, batch["gt_dp_part"] - 1, -1))
    ref_losses, ref_grads = jax_train_step(jm, variables, jbatch)
    dp_losses = {"loss_densepose_I", "loss_densepose_S"} | (
        {"loss_densepose_U", "loss_densepose_V"} if variant in ("decoder", "legacy") else {"loss_densepose_UV"}
    )
    assert dp_losses <= set(ref_losses) and all(ref_losses[k] > 0 for k in dp_losses)
    assert_train_step_matches(model, batch, ref_losses, ref_grads)
    heads = [k for k, p in model.named_parameters() if k.startswith(("roi_heads.densepose", "roi_heads.decoder"))]
    unmoved = {k for k in heads if model.get_parameter(k).grad.abs().sum() == 0}
    # the ASPP's pooling branch is 1x1 and its GN has one channel a group
    # here (32 channels): the GN output is its bias, nothing reaches the conv
    # or the GN's scale (in both packages)
    aspp_pool = {"roi_heads.densepose_head.ASPP.convs.4.1.weight", "roi_heads.densepose_head.ASPP.convs.4.2.weight"}
    assert len(heads) > 10 and unmoved == (aspp_pool if variant == "dl_wc1" else set()), unmoved
