"""The port's PanopticFPN against the JAX package's, on the CPU in float32.

- The PanopticFPN R18-FPN of ``tests/goldens/e2e_panoptic_r18.npz`` with the
  JAX model's variables (the golden's weights through the JAX converter)
  carried across by ``convert_jax_params``: the output dict, ``sem_seg``
  within 2e-5 of max|x|, the detections as ``tests/test_torch_e2e.py``
  holds them; and the golden itself through the port's d2 ``.pkl`` loader,
  at the JAX golden test's bounds (logits 2e-3, the set matching of the
  detections, the fused partition's categories on more than 99% of the
  pixels, the same numbers of thing and stuff segments).
- A tiny PanopticFPN (FPN width 32): one training step's losses (rtol 1e-4:
  ``loss_sem_seg``, the ROI heads' times ``INSTANCE_LOSS_WEIGHT``, the
  RPN's) and every gradient (1e-3 of max|g| + 1e-6) against the JAX
  ``value_and_grad``, with the same sampler draws.
- ``combine_semantic_and_instance_outputs`` ``==`` the JAX function on the
  same inputs (tied scores, overlaps, empty masks, small stuff regions).
- ``add_panoptic_outputs`` (ROADMAP C, correction (c)): the JAX
  ``COCOPanopticEvaluator.process`` raises ``KeyError: 'panoptic_seg'`` on
  the JAX model's outputs, which carry none; the port's step adds it, equal
  to the JAX fusion of the JAX package's own postprocessing of the same
  outputs on all but the paste's contour pixels (under 1e-3).
- The box head without fc (``get_cfg()``'s ``NUM_FC`` 0, the lazy
  PanopticFPN's) and its predictor against the JAX pair: HWC flattening.
- The PanopticFPN yamls build, and ``panoptic_fpn_R_50_1x.py``
  instantiates, with the JAX model's parameter names and sizes; the lazy
  model keeps ``get_cfg()``'s 14x14 box pool, ``NUM_FC`` 0 and RPN test
  top-k 6000.
"""

import os
import pickle

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
    jax_variables_from_d2,
    load_golden,
    n,
    port_model,
    t,
)

from detectron2_tpu.config import LazyConfig as JaxLazyConfig
from detectron2_tpu.config import instantiate as jax_instantiate
from detectron2_tpu.modeling.meta_arch.panoptic_fpn import (
    combine_semantic_and_instance_outputs as jax_combine,
)
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.config import LazyConfig, get_cfg, instantiate
from detectron2_tpu_torch.modeling import PanopticFPN, build_model
from detectron2_tpu_torch.modeling.meta_arch.panoptic_fpn import (
    add_panoptic_outputs,
    combine_semantic_and_instance_outputs,
)
from detectron2_tpu_torch.structures import BitMasks, Instances
from detectron2_tpu_torch.testing import golden_panoptic_config, golden_state_dict, synthetic_train_batch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_panoptic_r18")


def _batch(golden):
    return {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}


@pytest.fixture(scope="module")
def jax_run(golden):
    cfg = golden_panoptic_config()
    cfg.MODEL.DEVICE = "cpu"
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    out = jm.apply(variables, {k: jnp.asarray(v) for k, v in _batch(golden).items()}, train=False)
    return cfg, variables, jax.tree_util.tree_map(np.asarray, out)


def test_port_matches_the_jax_output_dict(golden, jax_run):
    cfg, variables, ref = jax_run
    model = port_model(cfg, variables)
    assert isinstance(model, PanopticFPN)
    out = model(_batch(golden))
    assert set(out) == set(ref)
    sem, ref_sem = n(out["sem_seg"]), ref["sem_seg"]
    assert sem.shape == ref_sem.shape == (1, 320, 320, 9)
    assert np.abs(sem - ref_sem).max() <= 2e-5 * np.abs(ref_sem).max()
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)


def _jax_host_panoptic(out, hw, thresholds):
    """The JAX package's own host steps on one image's outputs: its
    ``detector_postprocess`` (host paste), its ``sem_seg_postprocess``
    (cv2), argmax, its fusion."""
    from detectron2_tpu.modeling.postprocessing import detector_postprocess as jax_postprocess
    from detectron2_tpu.modeling.postprocessing import sem_seg_postprocess as jax_sem_seg_postprocess

    one = {k: np.asarray(v)[0] for k, v in out.items() if k != "sem_seg"}
    inst = jax_postprocess(one, *hw, *hw)
    labels = jax_sem_seg_postprocess(np.asarray(out["sem_seg"])[0], hw, *hw).argmax(-1)
    return jax_combine(inst, labels, *thresholds)


def test_panoptic_outputs_added_by_the_port_and_missing_in_jax(golden, jax_run):
    """Correction (c): the JAX evaluator cannot run after a PanopticFPN
    forward; the port's step fuses as the JAX functions do."""
    from detectron2_tpu.evaluation.panoptic_evaluation import COCOPanopticEvaluator as JaxPanopticEvaluator

    cfg, variables, ref = jax_run
    meta = [{"image_id": 1, "height": 320, "width": 320}]
    jax_eval = JaxPanopticEvaluator.__new__(JaxPanopticEvaluator)
    jax_eval.reset()
    with pytest.raises(KeyError, match="panoptic_seg"):
        jax_eval.process({"metadata": meta}, ref)

    model = port_model(cfg, variables)
    batch = {**_batch(golden), "metadata": meta}
    out = add_panoptic_outputs(model, batch, model(batch))
    (pan, info), = out["panoptic_seg"]
    thresholds = (model.combine_overlap_thresh, model.combine_stuff_area_thresh, model.combine_instances_score_thresh)
    assert thresholds == (0.5, 4096, 0.5)
    ref_pan, ref_info = _jax_host_panoptic(ref, (320, 320), thresholds)
    assert pan.dtype == np.int32 and pan.shape == (320, 320)
    assert (pan != ref_pan).mean() < 1e-3
    assert [(s["id"], s["isthing"], s["category_id"]) for s in info] == [
        (s["id"], s["isthing"], s["category_id"]) for s in ref_info
    ]
    assert any(s["isthing"] for s in info) and any(not s["isthing"] for s in info)
    # other models' outputs pass through unchanged
    assert add_panoptic_outputs(torch.nn.Identity(), batch, {"x": 1}) == {"x": 1}
    model.combine_enabled = False
    assert "panoptic_seg" not in add_panoptic_outputs(model, batch, {"sem_seg": out["sem_seg"]})


def test_golden_through_the_d2_loader(golden, tmp_path):
    pkl = tmp_path / "panoptic.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_panoptic_config(), device="cpu")
    report = load_d2_checkpoint(model, str(pkl))
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."]
    out = model(_batch(golden))
    sem = n(out["sem_seg"][0])
    assert np.abs(sem - golden["sem_seg"].transpose(1, 2, 0)).max() < 2e-3

    valid = n(out["valid"][0])
    scores, boxes, classes = (n(out[k][0])[valid] for k in ("scores", "pred_boxes", "pred_classes"))
    taken = np.zeros(len(scores), bool)
    unmatched = []
    for rs, rc, rbx in zip(golden["out_scores"], golden["out_classes"], golden["out_boxes"]):
        cand = (classes == rc) & ~taken & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4) & (np.abs(boxes - rbx).max(axis=1) < 0.05)
        idx = np.where(cand)[0]
        if len(idx) == 0:
            unmatched.append((rs, rc, rbx))
            continue
        taken[idx[0]] = True
    extras = scores[~taken]
    assert not [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]

    batch = {**_batch(golden), "metadata": [{"height": 320, "width": 320}]}
    (pan, info), = add_panoptic_outputs(model, batch, out)["panoptic_seg"]

    def cat_map(pan, rows):
        m = np.zeros_like(pan, dtype=np.int64) - 1
        for r in rows:
            m[pan == r[0]] = r[2] + (1000 if r[1] else 0)
        return m

    rows = np.array([[s["id"], int(s["isthing"]), s["category_id"], 0] for s in info], np.int64).reshape(-1, 4)
    ref_rows = golden["seg_rows"]
    assert (cat_map(pan, rows) == cat_map(golden["pan_seg"], ref_rows)).mean() > 0.99
    assert (rows[:, 1] == 1).sum() == (ref_rows[:, 1] == 1).sum()
    assert (rows[:, 1] == 0).sum() == (ref_rows[:, 1] == 0).sum()


def _fusion_inputs(seed):
    rng = np.random.RandomState(seed)
    N, H, W = 12, 40, 56
    scores = rng.choice(np.array([0.9, 0.8, 0.8, 0.7, 0.6, 0.55, 0.5, 0.4], np.float32), N)
    masks = np.zeros((N, H, W), bool)
    for i in range(N):
        y, x = rng.randint(0, H - 5), rng.randint(0, W - 5)
        masks[i, y : y + rng.randint(3, 25), x : x + rng.randint(3, 30)] = True
    masks[3] = False  # empty
    masks[4] = masks[0]  # a full overlap
    semantic = rng.randint(0, 4, (H // 8, W // 8)).repeat(8, 0).repeat(8, 1)
    semantic[:2, :3] = 5  # a stuff region below the area threshold
    classes = rng.randint(0, 7, N)
    return scores, masks, classes, semantic


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_equals_jax(seed):
    from detectron2_tpu.structures import BitMasks as JaxBitMasks
    from detectron2_tpu.structures import Instances as JaxInstances

    scores, masks, classes, semantic = _fusion_inputs(seed)
    jinst = JaxInstances(semantic.shape)
    jinst.pred_masks, jinst.scores, jinst.pred_classes = JaxBitMasks(masks), scores, classes
    inst = Instances(semantic.shape)
    inst.pred_masks, inst.scores, inst.pred_classes = BitMasks(t(masks)), t(scores), t(classes)
    for thresholds in ((0.5, 20, 0.5), (0.2, 0, 0.45)):
        ref_pan, ref_info = jax_combine(jinst, semantic, *thresholds)
        pan, info = combine_semantic_and_instance_outputs(inst, semantic, *thresholds)
        np.testing.assert_array_equal(pan, ref_pan)
        assert pan.dtype == ref_pan.dtype and info == ref_info


def tiny_cfg():
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "PanopticFPN"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TRAIN = 200
    m.RPN.POST_NMS_TOPK_TRAIN = 100
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 8
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 2
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.MASK_ON = True
    m.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.SEM_SEG_HEAD.NUM_CLASSES = 9
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    m.SEM_SEG_HEAD.LOSS_WEIGHT = 0.5
    m.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 0.7
    m.DEVICE = "cpu"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_train_step_matches_jax(monkeypatch):
    SameDraws(seed=9).patch(monkeypatch)
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.1)
    batch = synthetic_train_batch(num_classes=8)
    sem = np.random.RandomState(3).randint(0, 9, (2, 64, 64)).astype(np.int32)
    sem[:, :6] = 255
    batch["gt_sem_seg"] = sem
    ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    assert set(ref_losses) == {"loss_sem_seg", "loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"}
    model = port_model(cfg, variables)
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert all(np.isfinite(v) for v in losses.values())
    assert model.train_target_sizes() == {"mask_size": 28, "num_keypoints": 0, "with_sem_seg": True, "sem_seg_ignore_value": 255}


def test_box_head_without_fc_flattens_as_the_jax_predictor():
    from detectron2_tpu.modeling.roi_heads.box_head import FastRCNNConvFCHead as JaxHead
    from detectron2_tpu.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers as JaxPredictor
    from detectron2_tpu_torch.modeling.roi_heads.box_head import FastRCNNConvFCHead
    from detectron2_tpu_torch.modeling.roi_heads.fast_rcnn import FastRCNNOutputLayers

    rng = np.random.RandomState(0)
    x = rng.standard_normal((5, 3, 3, 4)).astype(np.float32)
    jhead, jpred = JaxHead(conv_dims=(), fc_dims=()), JaxPredictor(num_classes=3)
    feats = jhead.apply({}, jnp.asarray(x))
    assert feats.shape == (5, 3, 3, 4)
    pv = jpred.init(jax.random.PRNGKey(0), feats)
    ref_scores, ref_deltas = jpred.apply(pv, feats)
    head = FastRCNNConvFCHead(4, 3, fc_dims=())
    assert head.output_dim == 36
    pred = FastRCNNOutputLayers(36, 3)
    pred.load_state_dict(convert_jax_params(jax.tree_util.tree_map(np.asarray, pv)))
    with torch.no_grad():
        scores, deltas = pred(head(t(x), False))
    np.testing.assert_allclose(n(scores), np.asarray(ref_scores), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(deltas), np.asarray(ref_deltas), rtol=1e-5, atol=1e-6)


def _jax_names(jm, batch):
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return {k: v.numel() for k, v in convert_jax_params(zeros).items()}


_DUMMY = {"image": jnp.zeros((1, 64, 64, 3)), "image_sizes": jnp.asarray([[64, 64]], jnp.int32)}


@pytest.mark.parametrize(
    "config",
    [
        "COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml",
        "COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml",
        "COCO-PanopticSegmentation/panoptic_fpn_R_101_3x.yaml",
        "quick_schedules/panoptic_fpn_R_50_inference_acc_test.yaml",
        "quick_schedules/panoptic_fpn_R_50_instant_test.yaml",
        "quick_schedules/panoptic_fpn_R_50_training_acc_test.yaml",
    ],
)
def test_panoptic_yamls_build_with_the_jax_names(config):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    assert type(model).__name__ == "PanopticFPN" and model.sem_seg_head.loss_weight == 0.5
    assert model.combine_enabled and model.roi_heads.mask_head is not None
    assert _jax_names(jax_model(cfg), _DUMMY) == {k: v.numel() for k, v in model.state_dict().items()}


def test_the_lazy_panoptic_fpn_instantiates_with_the_jax_names():
    path = os.path.join(ROOT, "configs", "COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.py")
    model = instantiate(LazyConfig.load(path).model)
    assert type(model).__name__ == "PanopticFPN" and str(model.device) == "cpu" and model.compute_dtype == torch.bfloat16
    assert model.roi_heads.box_pooler.output_size == (14, 14) and model.roi_heads.box_head.fc_dims == ()
    assert model.roi_heads.box_predictor.cls_score.in_features == 256 * 14 * 14
    assert model.proposal_generator.pre_nms_topk[False] == 6000
    assert model.sem_seg_head.loss_weight == 0.5
    assert _jax_names(jax_instantiate(JaxLazyConfig.load(path).model), _DUMMY) == {
        k: v.numel() for k, v in model.state_dict().items()
    }
