"""The port's FCOS against the JAX package's, on the CPU in float32.

- ``giou_loss``, ``Box2BoxTransformLinear`` and the dense box loss's
  ``"giou"`` branch (and its ``"diou"`` and ``"ciou"`` ones) against the JAX functions on seeded boxes, including
  zero-area, disjoint, identical and nested ones and zero-size source boxes;
- the tiny R18-FPN FCOS of the golden (FPN width 64, two GN tower convs,
  7 classes) with the JAX model's variables carried across by
  ``convert_jax_params``: the raw per-level outputs, the padded decode (at
  threshold 0, so that random weights give detections), the point matching,
  the losses and every gradient, and two SGD steps of ``SimpleTrainer``
  against two of the JAX ``make_train_step``, with ``loss_normalizer``;
- ``tests/goldens/e2e_fcos_r18.npz`` through the port's d2 loader (the
  ``(conv, GN, ReLU)`` towers at d2's Sequential indices), at the JAX golden
  test's tolerances;
- ``FCOS.clone`` (the lazy config's ``base.clone(backbone=...)``).

Tolerances: float32 outputs within 2e-5 of max|x| of the JAX ones; the
losses rtol 1e-4 and each gradient within 1e-3 of max|g| + 1e-6, as the
R-CNN train-step tests (sums over every location in another order);
parameters after two steps within 1e-3 of how far they moved;
``loss_normalizer`` rtol 1e-6.
"""

import math
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    assert_dense_golden_detections,
    assert_train_step_matches,
    jax_model,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)
from test_torch_retinanet import close, eval_batch, jax_train, make_batch

from detectron2_tpu.layers.losses import giou_loss as jax_giou
from detectron2_tpu.modeling.box_regression import Box2BoxTransformLinear as JaxLinear
from detectron2_tpu.modeling.box_regression import _dense_box_regression_loss as jax_dense_loss
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.engine import SimpleTrainer, hooks
from detectron2_tpu_torch.layers import GroupNorm
from detectron2_tpu_torch.layers.losses import giou_loss
from detectron2_tpu_torch.modeling import FCOS, build_model
from detectron2_tpu_torch.modeling.box_regression import Box2BoxTransformLinear, _dense_box_regression_loss
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer
from detectron2_tpu_torch.testing import golden_dense_config, golden_state_dict

torch.set_num_threads(1)


def boxes_pair(seed=0, N=64):
    """Random XYXY pairs, then edge cases: zero-area on either side,
    disjoint, identical, nested, touching."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(N, 2).astype(np.float32) * 50
    a = np.concatenate([xy, xy + rng.rand(N, 2).astype(np.float32) * 30], 1)
    xy = rng.rand(N, 2).astype(np.float32) * 50
    b = np.concatenate([xy, xy + rng.rand(N, 2).astype(np.float32) * 30], 1)
    a[0, 2:] = a[0, :2]  # zero area
    b[1, 2:] = b[1, :2]
    a[2], b[2] = [0, 0, 1, 1], [5, 5, 6, 9]  # disjoint
    a[3] = b[3]  # identical
    a[4], b[4] = [0, 0, 10, 10], [2, 2, 3, 3]  # nested
    a[5], b[5] = [0, 0, 10, 10], [10, 0, 20, 10]  # touching
    a[6], b[6] = [3, 3, 3, 3], [3, 3, 3, 3]  # both empty, same point
    return a.astype(np.float32), b.astype(np.float32)


def test_giou_loss_matches_jax():
    a, b = boxes_pair()
    close(giou_loss(t(a), t(b)), jax_giou(a, b), name="giou")
    for red in ("sum", "mean"):
        close(giou_loss(t(a), t(b), red), jax_giou(a, b, red), name=red)
    out = n(giou_loss(t(a), t(b)))
    assert np.isfinite(out).all() and out[3] == 0.0 and out[2] > 1.0
    at = t(a).requires_grad_()
    giou_loss(at, t(b), "sum").backward()
    close(at.grad, jax.grad(lambda v: jax_giou(v, b, "sum"))(jnp.asarray(a)), name="grad")


@pytest.mark.parametrize("normalize", [True, False])
def test_box2box_transform_linear_matches_jax(normalize):
    src, tgt = boxes_pair(seed=1)
    src[7] = [4, 4, 4, 4]  # a zero-size source: the stride is clamped to 1e-6
    port, ref = Box2BoxTransformLinear(normalize), JaxLinear(normalize)
    deltas = port.get_deltas(t(src), t(tgt))
    close(deltas, ref.get_deltas(src, tgt), name="get_deltas")
    d = np.random.RandomState(2).standard_normal((64, 8)).astype(np.float32) * 3  # k = 2 boxes a row, negatives relu'd
    close(port.apply_deltas(t(d), t(src)), ref.apply_deltas(d, src), name="apply_deltas")
    roundtrip = port.apply_deltas(deltas, t(src))
    ok = (n(deltas) >= 0).all(1) & ((src[:, 2:] - src[:, :2]) > 0).all(1)
    np.testing.assert_allclose(n(roundtrip)[ok], tgt[ok], atol=1e-4)


def test_dense_box_regression_loss_giou_branch_matches_jax():
    anchors, gt = boxes_pair(seed=3)
    d = np.random.RandomState(4).standard_normal((64, 4)).astype(np.float32)
    fg = np.random.RandomState(5).rand(64) > 0.4
    port = _dense_box_regression_loss(t(anchors), Box2BoxTransformLinear(), t(d), t(gt), t(fg), "giou")
    close(port, jax_dense_loss(anchors, JaxLinear(), d, gt, fg, "giou"), name="giou loss")
    # DIoU and CIoU, ported since, through the same linear decode
    for kind in ("diou", "ciou"):
        port = _dense_box_regression_loss(t(anchors), Box2BoxTransformLinear(), t(d), t(gt), t(fg), kind)
        close(port, jax_dense_loss(anchors, JaxLinear(), d, gt, fg, kind), name=f"{kind} loss")


def tiny_cfg():
    from test_torch_retinanet import tiny_cfg as retina_cfg

    cfg = retina_cfg()
    cfg.MODEL.META_ARCHITECTURE = "FCOS"
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 100
    return cfg


@pytest.fixture(scope="module")
def jax_run():
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.1, train_batch=make_batch())
    eb = {k: jnp.asarray(v) for k, v in eval_batch().items()}
    raw = jax.tree_util.tree_map(np.asarray, jm.apply(variables, eb, train=False, raw=True))
    det = jax.tree_util.tree_map(np.asarray, jm.clone(test_score_thresh=0.0).apply(variables, eb, train=False))
    det_default = jax.tree_util.tree_map(np.asarray, jm.apply(variables, eb, train=False))
    b = make_batch()
    anchors = [np.asarray(a) for a in jm.apply(variables, eb, method=lambda m, _: m._point_anchors([(12, 12), (6, 6), (3, 3), (2, 2), (1, 1)]))]
    level = np.concatenate([np.full(len(a), i, np.int32) for i, a in enumerate(anchors)])
    match = jax.vmap(lambda g, v: jm._match_points_to_gt(jnp.concatenate(anchors), jnp.asarray(level), g, v))(
        jnp.asarray(b["gt_boxes"]), jnp.asarray(b["gt_valid"])
    )
    losses, grads, states = jax_train(cfg, jm, variables, b, 2)
    return {
        "cfg": cfg, "variables": variables, "raw": raw, "det": det, "det_default": det_default,
        "anchors": anchors, "match": [np.asarray(x) for x in match],
        "losses": losses, "grads": grads, "states": states,
    }


def test_every_jax_leaf_lands_on_the_gn_towers(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    assert isinstance(model.head.cls_subnet[1], GroupNorm) and isinstance(model.head.bbox_subnet[4], GroupNorm)
    assert model.test_score_thresh == 0.2 and model.test_nms_thresh == 0.6
    assert model.head.cls_score.out_channels == 7 and model.head.ctrness.out_channels == 1


def test_raw_outputs_and_point_anchors_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    raw = model(eval_batch(), raw=True)
    for key in ("logits", "deltas", "ctrness"):
        for i, (out, ref) in enumerate(zip(raw[key], jax_run["raw"][key])):
            close(out, ref, name=f"{key} level {i}")
    anchors = model.point_anchors([(12, 12), (6, 6), (3, 3), (2, 2), (1, 1)], "cpu")
    for out, ref in zip(anchors, jax_run["anchors"]):
        np.testing.assert_array_equal(n(out), ref)


def test_point_matching_matches_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    b = make_batch()
    anchors = model.point_anchors([(12, 12), (6, 6), (3, 3), (2, 2), (1, 1)], "cpu")
    matched, is_fg = model.match_points_to_gt(anchors, t(b["gt_boxes"]), t(b["gt_valid"]))
    ref_matched, ref_fg = jax_run["match"]
    np.testing.assert_array_equal(n(is_fg), ref_fg)
    assert 0 < ref_fg.sum() < ref_fg.size
    np.testing.assert_array_equal(n(matched), ref_matched)  # background rows take gt 0 on both sides


def test_decoded_detections_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    out = model(eval_batch())
    np.testing.assert_array_equal(n(out["valid"]), jax_run["det_default"]["valid"])
    model.test_score_thresh = 0.0
    out, ref = model(eval_batch()), jax_run["det"]
    np.testing.assert_array_equal(n(out["valid"]), ref["valid"])
    assert n(out["valid"]).sum() > 20
    np.testing.assert_array_equal(n(out["pred_classes"]), ref["pred_classes"])
    close(out["scores"], ref["scores"], name="scores")
    close(out["pred_boxes"], ref["pred_boxes"], name="boxes")


def test_losses_and_gradients_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    losses = assert_train_step_matches(model, make_batch(), jax_run["losses"], jax_run["grads"])
    assert set(losses) == {"loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr"} and all(v > 0 for v in losses.values())


def test_two_sgd_steps_and_loss_normalizer_match_make_train_step(jax_run):
    cfg = jax_run["cfg"]
    model = port_model(cfg, jax_run["variables"])
    optimizer = build_optimizer(cfg, model)
    normalizers = []

    class Record(hooks.HookBase):
        def after_step(self):
            normalizers.append(model.loss_normalizer.item())

    trainer = SimpleTrainer(model, [make_batch()] * 2, optimizer)
    trainer.register_hooks([hooks.LRScheduler(optimizer, build_lr_scheduler(cfg, optimizer)), Record()])
    trainer.train(0, 2)
    p0 = convert_jax_params(jax.tree_util.tree_map(np.asarray, jax_run["variables"]))
    p2 = jax_run["states"][-1]
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, p0[name]), name
            continue
        moved = (p2[name] - p0[name]).abs().max().item()
        assert moved > 0, name
        assert (p.detach() - p2[name]).abs().max().item() <= 1e-3 * moved + 1e-6, name
    ref = [s["loss_normalizer"].item() for s in jax_run["states"]]
    for got, want in zip(normalizers, ref):
        assert math.isclose(got, want, rel_tol=1e-6), (got, want)


def test_clone_replaces_the_backbone_and_copies_the_rest(jax_run):
    from detectron2_tpu_torch.modeling.backbone import FPN, LastLevelP6P7, build_resnet_backbone

    cfg = jax_run["cfg"]
    base = port_model(cfg, jax_run["variables"])
    base.loss_normalizer.fill_(42.0)
    backbone = FPN(
        bottom_up=build_resnet_backbone(cfg),
        in_features=("res3", "res4", "res5"),
        out_channels=64,
        top_block=LastLevelP6P7(64, 64, in_feature="p5"),
    )
    clone = base.clone(backbone=backbone)
    assert clone.backbone is backbone and clone.head is not base.head
    assert clone.backbone.top_block.p6.in_channels == 64 and clone.strides == base.strides
    assert clone.loss_normalizer.item() == 42.0
    for (k, v), (k2, v2) in zip(base.head.state_dict().items(), clone.head.state_dict().items()):
        assert k == k2 and torch.equal(v, v2) and v.data_ptr() != v2.data_ptr()
    with pytest.raises(TypeError, match="backbone and head"):
        base.clone(num_classes=3)
    assert set(clone(eval_batch())) == {"pred_boxes", "scores", "pred_classes", "valid"}


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_fcos_r18")


def test_golden_through_the_d2_loader(golden, tmp_path):
    path = tmp_path / "synthetic_fcos.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_dense_config("FCOS"), device="cpu")
    report = load_d2_checkpoint(model, str(path))
    n_names = len(golden["weight_names"])
    assert report.splitlines() == [
        f"Loaded {n_names}/{n_names + 1} tensors from the checkpoint.",
        "Not found in the checkpoint: ['loss_normalizer']",
    ]
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    raw = model(batch, raw=True)
    for i, f in enumerate(["p3", "p4", "p5", "p6", "p7"]):
        for key, k, post in (("logits", 7, None), ("deltas", 4, np.maximum), ("ctrness", 1, None)):
            ref = golden[f"{key}_{f}"]
            if post is not None:  # the reference's relu is inside apply_deltas, the JAX head's in the head
                ref = post(ref, 0.0)
            ref = ref.transpose(0, 2, 3, 1).reshape(1, -1, k)
            assert np.abs(n(raw[key][i]) - ref).max() < 2e-3, (f, key)
    out = model(batch)
    inst = detector_postprocess({k: v[0] for k, v in out.items()}, 320, 320, 320, 320)
    assert_dense_golden_detections(inst, golden, max_count_diff=3, min_taken=int(0.8 * len(golden["out_scores"])))
