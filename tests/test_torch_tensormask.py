"""The port's TensorMask against the JAX package's, in float32 on the CPU,
weights carried across by ``convert_jax_params`` (``mask_subnet{i}`` and
``mask_fuse`` map to d2's ``mask_subnet.{2i}`` and ``mask_fuse.0``).

- ``swap_align2nat`` at λ 1, 2 and 4 on maps whose sizes λ does not divide
  (taps outside the tensor take ``pad_val``): the output, and the input
  gradient against ``jax.vjp``.
- ``tensormask_assignment`` on padded gt with duplicated boxes (the
  uniqueness rule) against the JAX rule: the labels and the matches
  exactly; ``sigmoid_focal_loss_star`` and its gradient.
- A tiny TensorMask R18-FPN (p3 and p4, two anchor sizes, aligned and
  bipyramid masks, GN): the head's outputs of every level; the three losses and
  every gradient; the inference outputs, ``mask_boxes`` included.
- Correction 22 both ways: ``detector_postprocess`` pastes each mask in its
  anchor box (``mask_boxes``, scaled, not clipped; d2's frame), where the
  JAX one pastes it in the detection's box.
- ``tests/goldens/e2e_tensormask_r18.npz`` through the d2 loader at its
  parity test's bounds; the two TensorMask yamls on the meta device.

Tolerances: activations within 1e-5 * max|ref| + 1e-6 (the model's mask
maps 1e-5 * max|ref| + 1e-5: they pass the towers, the bipyramid's resize
and fuse, and the two-pass resample); losses rtol 1e-4; gradients within 1e-4 *
max|g_ref| + 1e-6 for the op and 1e-3 * max|g_ref| + 1e-6 for the model
(``_torch_port.assert_train_step_matches``; a parameter the losses do not
reach has no gradient on the port and a zero one in JAX); scores rtol 1e-4
atol 1e-5, boxes 1e-3 px, the 28x28 mask probabilities 1e-5, classes,
validity and ``mask_boxes`` equal.
"""

import math
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_model, jax_random_variables, jax_train_step, load_golden, n, port_model, t
from detectron2_tpu.modeling.postprocessing import detector_postprocess as jax_detector_postprocess
from detectron2_tpu.projects import tensormask as jtm
from detectron2_tpu_torch.checkpoint import load_d2_checkpoint
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image
from detectron2_tpu_torch.projects import tensormask as tm
from detectron2_tpu_torch.testing import compare_with_tensormask_golden, golden_state_dict, golden_tensormask_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("TensorMask/tensormask_R_50_FPN_1x.yaml", "TensorMask/tensormask_R_50_FPN_6x.yaml")


def close(ours, ref, rtol=1e-5, atol=1e-6):
    """Within ``rtol * max|ref| + atol``."""
    ours, ref = n(ours).astype(np.float64), np.asarray(ref).astype(np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, (err, np.abs(ref).max())


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("lam, shape", [(1, (2, 5, 7, 9)), (2, (2, 9, 7, 16)), (4, (1, 13, 10, 25))],
                         ids=["lambda1", "lambda2", "lambda4"])
def test_swap_align2nat_and_its_gradient(lam, shape):
    rng = np.random.RandomState(lam)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((shape[0], -(-shape[1] // lam), -(-shape[2] // lam), shape[3] * lam * lam)).astype(np.float32)
    ref, ref_grad = jax.jit(lambda a, c: (lambda o, f: (o, f(c)[0]))(*jax.vjp(lambda b: jtm.swap_align2nat(b, lam), a)))(
        jnp.asarray(x), jnp.asarray(cot))
    N, H, W, C = shape
    V = int(round(C**0.5))
    assert ref.shape == (N, -(-H // lam), -(-W // lam), (V * lam) ** 2)
    assert float(jnp.min(ref)) < -3.0  # taps outside the tensor were taken (pad_val -6)
    xt = t(x).requires_grad_()
    out = tm.swap_align2nat(xt, lam)
    close(out, ref)
    (out * t(cot)).sum().backward()
    close(xt.grad, ref_grad)
    close(tm.SwapAlign2Nat(lam)(t(x)), ref)


def test_tensormask_assignment_exactly():
    rng = np.random.RandomState(3)
    B, G, R = 2, 6, 300
    gt = rng.rand(B, G, 4).astype(np.float32) * 60
    gt[..., 2:] = gt[..., :2] + rng.rand(B, G, 2) * 50 + 4
    gt[:, 1] = gt[:, 0]  # two gt claim the same anchors: the uniqueness rule
    valid = np.ones((B, G), bool)
    valid[1, 4:] = False  # padding
    anchors = rng.rand(R, 4).astype(np.float32) * 50
    anchors[:, 2:] = anchors[:, :2] + rng.rand(R, 2) * 80 + 8
    units = (rng.randint(0, 3, R) * 8 + 8).astype(np.float32)
    ref_matches, ref_labels = jax.jit(jax.vmap(lambda g, v: jtm.tensormask_assignment(
        g, v, jnp.asarray(anchors), jnp.asarray(units), 12.0)))(jnp.asarray(gt), jnp.asarray(valid))  # as the model runs it
    matches, labels = tm.tensormask_assignment(t(gt), t(valid), t(anchors), t(units), 12.0)
    np.testing.assert_array_equal(n(labels), np.asarray(ref_labels).astype(bool))
    np.testing.assert_array_equal(n(matches), np.asarray(ref_matches))
    assert 10 < n(labels).sum() and (n(labels) == 0).sum() > 10


def test_sigmoid_focal_loss_star_and_its_gradient():
    rng = np.random.RandomState(4)
    x = (rng.standard_normal((5, 7)) * 3).astype(np.float32)
    y = (rng.rand(5, 7) > 0.7).astype(np.float32)
    ref, grad = jax.value_and_grad(lambda a: jtm.arch.sigmoid_focal_loss_star(a, jnp.asarray(y), 0.3, 3.0).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    loss = tm.sigmoid_focal_loss_star(xt, t(y), 0.3, 3.0).sum()
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()
    close(xt.grad, grad)


# -------------------------------------------------------------- the model
def tiny_cfg():
    cfg = get_cfg()
    tm.add_tensormask_config(cfg)
    m = cfg.MODEL
    m.META_ARCHITECTURE = "TensorMask"
    m.MASK_ON = True
    m.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    m.RESNETS.NORM = "GN"
    m.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[24, 32], [48, 64]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[1.0]]
    m.ANCHOR_GENERATOR.OFFSET = 0.0
    tmc = m.TENSOR_MASK
    tmc.IN_FEATURES = ["p3", "p4"]
    tmc.NUM_CLASSES = 9
    tmc.NUM_CONVS = 2
    tmc.CLS_CHANNELS = tmc.BBOX_CHANNELS = tmc.MASK_CHANNELS = 32
    tmc.ALIGNED_ON = tmc.BIPYRAMID_ON = True
    tmc.MASK_GT_BUDGETS = (8, 4)
    tmc.TOPK_CANDIDATES_TEST = 200
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.DEVICE = "cpu"
    return cfg


# ------------------------------------------------------ golden, yamls
def test_tensormask_golden_through_the_d2_loader(tmp_path):
    """d2's names load as they are: ``head.mask_subnet.{2i}``,
    ``head.mask_pred_{m:02d}``, ``head.mask_fuse.0``."""
    g = load_golden("e2e_tensormask_r18")
    path = tmp_path / "tensormask.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    cfg = golden_tensormask_config()
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    report = load_d2_checkpoint(model, str(path))
    assert report.splitlines() == ["Loaded 142/142 tensors from the checkpoint."], report
    batch = {"image": t(g["image"][None].astype(np.float32)), "image_sizes": torch.tensor([[320, 320]])}
    errs = compare_with_tensormask_golden(model(batch, raw=True), model(batch), g)
    assert errs["matched"] >= 20


@pytest.mark.parametrize("yaml", YAMLS, ids=[os.path.basename(y) for y in YAMLS])
def test_tensormask_yamls_build(yaml):
    cfg = get_cfg()
    tm.add_tensormask_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    model = build_model(cfg, device="meta")
    assert type(model) is tm.TensorMask and model.mask_sizes == (11, 15)
    assert model.head.aligned_on and model.head.bipyramid_on and model.min_anchor_size == 40
    assert model.head.mask_pred_15.weight.shape == (225, 128, 1, 1) and model.head.cls_score.weight.shape == (160, 256, 3, 3)
    assert model.mask_gt_budgets == (64, 32, 16, 8, 4, 4) and model.backbone.fuse_type == "avg"
    for name in tuple(cfg.DATASETS.TRAIN) + tuple(cfg.DATASETS.TEST):
        assert name in DatasetCatalog.list(), name
    if "6x" in yaml:
        assert cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING == "range" and tuple(cfg.INPUT.MIN_SIZE_TRAIN) == (640, 800)


# --------------------------------------------------- the model's outputs
def tiny_batches():
    """One batch of two 128x128 images, and the same with four gt each."""
    rng = np.random.RandomState(0)
    B, H, W, G = 2, 128, 128, 4
    batch = {"image": (rng.rand(B, H, W, 3) * 255).astype(np.float32), "image_sizes": np.asarray([[H, W]] * B, np.int32)}
    xy, wh = rng.rand(B, G, 2) * 60, rng.rand(B, G, 2) * 40 + 12
    train_batch = dict(batch, gt_boxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
                       gt_classes=rng.randint(0, 9, (B, G)).astype(np.int32), gt_valid=np.ones((B, G), bool),
                       gt_masks=(rng.rand(B, G, 28, 28) > 0.5).astype(np.float32))
    return batch, train_batch


def _jax_reference():
    """The tiny model's JAX side, run once, jitted: its seeded variables,
    the detections of one batch with the head's outputs captured on the
    way, and the losses and gradients of a training batch with gt masks;
    as numpy."""
    jm = jax_model(tiny_cfg())
    v = jax_random_variables(jm, seed=0, scale=0.1)
    batch, train_batch = tiny_batches()
    head = lambda module, method: isinstance(module, jtm.TensorMaskHead) and method == "__call__"  # noqa: E731
    with ThreadPoolExecutor(2) as pool:  # the two compile side by side
        forward = pool.submit(jax.jit(lambda v, b: jm.apply(v, b, train=False, capture_intermediates=head)),
                              v, {k: jnp.asarray(x) for k, x in batch.items()})
        losses, grads = jax_train_step(jm, v, train_batch)
        ref, state = forward.result()
    return {"variables": jax.tree_util.tree_map(np.asarray, v),
            "raw": jax.tree_util.tree_map(np.asarray, state["intermediates"]["head"]["__call__"][0]),
            "ref": jax.tree_util.tree_map(np.asarray, ref), "losses": losses, "grads": {k: n(g) for k, g in grads.items()}}


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """``_jax_reference`` in a process of its own, started with the module:
    the tests before the model's run beside it."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool.submit(_jax_reference)


@pytest.fixture(scope="module")
def tiny(jax_reference):
    """The tiny model on the JAX side's variables, its batches, and the JAX
    side's results."""
    cfg = tiny_cfg()
    batch, train_batch = tiny_batches()
    ref = jax_reference.result()
    return {"cfg": cfg, "batch": batch, "train_batch": train_batch, **ref, "model": port_model(cfg, ref["variables"])}


def test_head_outputs_with_the_bipyramid(tiny):
    model = tiny["model"]
    assert model.mask_sizes == (3, 4) and model.head.bipyramid_on and model.head.aligned_on
    assert [k for k, _ in model.head.named_children()] == [
        "cls_subnet", "cls_score", "bbox_subnet", "bbox_pred", "mask_subnet", "mask_pred_03", "mask_pred_04", "mask_fuse"]
    out = model({k: t(x) for k, x in tiny["batch"].items()}, raw=True)
    logits, deltas, masks = tiny["raw"]
    for lvl in range(2):
        close(out["logits"][lvl], logits[lvl])
        close(out["deltas"][lvl], deltas[lvl])
        for anc, side in enumerate((3, 4)):
            ref = masks[lvl][anc]
            assert ref.shape[-1] == (side * 2**lvl) ** 2
            close(out["masks"][lvl][anc], ref, 1e-5, 1e-5)


def test_losses_and_gradients_match_jax(tiny):
    """The three losses and every gradient; the convs the heads do not
    reach (FPN's p5-p7: the heads read p3 and p4) and the frozen stem and
    res2 get none on either side."""
    model = port_model(tiny["cfg"], tiny["variables"]).train()
    losses = model(tiny["train_batch"], train=True)
    assert set(losses) == set(tiny["losses"]) == {"loss_cls", "loss_box_reg", "loss_mask"}
    for k, v in tiny["losses"].items():
        assert math.isclose(losses[k].item(), v, rel_tol=1e-4), (k, losses[k].item(), v)
    assert losses["loss_mask"].item() > 0 and losses["loss_box_reg"].item() > 0
    sum(losses.values()).backward()
    unreached = []
    for name, p in model.named_parameters():
        ref = n(tiny["grads"][name])
        if p.grad is None:
            assert not ref.any(), name
            unreached.append(name)
            continue
        err = np.abs(n(p.grad) - ref).max()
        assert err <= 1e-3 * np.abs(ref).max() + 1e-6, (name, err, np.abs(ref).max())
    assert unreached and all(k.startswith(("backbone.top_block.", "backbone.fpn_output5.", "backbone.bottom_up.stem.",
                                           "backbone.bottom_up.res2.")) for k in unreached), unreached


def test_inference_outputs_match_jax(tiny):
    out = tiny["model"]({k: t(x) for k, x in tiny["batch"].items()})
    ref = tiny["ref"]
    assert set(out) == set(ref) == {"pred_boxes", "scores", "pred_classes", "valid", "pred_masks", "mask_boxes"}
    assert ref["valid"].sum() >= 10 and tuple(out["pred_masks"].shape) == (2, 20, 28, 28)
    for k in ("valid", "pred_classes", "mask_boxes"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-5)


def test_correction22_pastes_in_the_anchor_boxes(tiny):
    """The port pastes each 28x28 mask in its anchor box, scaled to the
    output size and not clipped; the JAX package pastes the same mask in the
    detection's box. Shown on the tiny model's detections of image 0,
    postprocessed to 1.5x the input size."""
    ref = {k: v[0] for k, v in tiny["ref"].items()}
    ours = detector_postprocess({k: t(v) for k, v in ref.items()}, 192, 192, 128, 128)
    theirs = jax_detector_postprocess(ref, 192, 192, 128, 128)
    valid = ref["valid"]
    boxes = np.clip(ref["pred_boxes"][valid] * 1.5, 0, 192)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    masks = t(ref["pred_masks"][valid][keep])
    in_anchors = paste_masks_in_image(masks, t(ref["mask_boxes"][valid][keep] * 1.5), (192, 192))
    in_boxes = paste_masks_in_image(masks, t(boxes[keep]), (192, 192))
    assert torch.equal(ours.pred_masks.tensor, in_anchors)
    assert np.array_equal(np.asarray(theirs.pred_masks.tensor), n(in_boxes))
    np.testing.assert_allclose(n(ours.pred_boxes.tensor), np.asarray(theirs.pred_boxes.tensor), rtol=0, atol=1e-4)
    differ = [(a != b).any().item() for a, b in zip(in_anchors, in_boxes)]
    assert sum(differ) >= len(differ) // 2, differ
    # a mask of all ones covers its anchor box (to a pixel at the edges),
    # clipped to the image, and nothing outside it
    full = detector_postprocess({**{k: t(v) for k, v in ref.items()}, "pred_masks": torch.ones(ref["pred_masks"].shape)},
                                192, 192, 128, 128).pred_masks.tensor
    for m, box in zip(full, ref["mask_boxes"][valid][keep] * 1.5):
        x0, y0, x1, y1 = np.clip(box, 0, 192)
        assert m[int(np.ceil(y0)) + 1:int(y1) - 1, int(np.ceil(x0)) + 1:int(x1) - 1].all()
        ys, xs = np.nonzero(n(m))
        assert ys.min() >= y0 - 1 and ys.max() <= y1 and xs.min() >= x0 - 1 and xs.max() <= x1
