"""The port's RetinaNet against the JAX package's, on the CPU in float32.

- ``sigmoid_focal_loss`` against the JAX function on seeded inputs (hard and
  soft targets, with and without alpha, gamma 0, 1.5 and 2), values and
  gradients;
- the tiny R18-FPN RetinaNet of the golden (FPN width 64, two tower convs,
  7 classes, two anchor sizes a level) with the JAX model's variables
  carried across by ``convert_jax_params``: the raw per-level outputs, the
  padded decode, the losses and every gradient, and two SGD steps of the
  port's ``SimpleTrainer`` against two of the JAX ``make_train_step``, with
  ``loss_normalizer`` after each step;
- the SyncBN head (``MODEL.RETINANET.NORM = "SyncBN"``): each norm is one
  module applied to p3..p7 in turn, so one training step folds five
  batches' statistics into its running ones, in level order, as flax's
  mutable ``batch_stats`` does;
- ``tests/goldens/e2e_retinanet_r18.npz`` through the port's d2 loader, at
  the JAX golden test's tolerances (raw maps 2e-3, detections set-matched
  with its near-tie exemption);
- ``DefaultTrainer`` on a tiny RetinaNet yaml-style config: training,
  a bitwise resume of ``loss_normalizer``, ``DefaultTrainer.test`` and
  ``DefaultPredictor``.

Tolerances: float32 outputs (raw maps, decoded scores and boxes, focal
loss values) within 2e-5 of max|x| of the JAX ones; the losses rtol 1e-4 and
each gradient within 1e-3 of max|g| + 1e-6, as the R-CNN train-step tests
(sums over every anchor in another order); parameters after two steps within
1e-3 of how far they moved; ``loss_normalizer`` rtol 1e-6 (a few float32
operations on integer counts); the SyncBN head's running statistics within
1e-4 of max|x| + 1e-6, as ``test_torch_bn_train.py``.
"""

import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    assert_dense_golden_detections,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_model,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)

from detectron2_tpu.layers.losses import sigmoid_focal_loss as jax_focal
from detectron2_tpu.parallel import TrainState, make_train_step
from detectron2_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultPredictor, DefaultTrainer, SimpleTrainer, hooks
from detectron2_tpu_torch.engine.hooks import update_bn_stats
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.layers import SyncBatchNorm
from detectron2_tpu_torch.layers.losses import sigmoid_focal_loss
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer
from detectron2_tpu_torch.testing import (
    golden_dense_config,
    golden_state_dict,
    synthetic_train_batch,
    write_synthetic_overfit_coco,
)
from detectron2_tpu_torch.utils import events

torch.set_num_threads(1)


def close(out, ref, rtol=2e-5, name=""):
    out, ref = n(out).astype(np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (name, out.shape, ref.shape)
    if ref.size:
        err = np.abs(out - ref).max()
        assert err <= rtol * max(np.abs(ref).max(), 1e-30), (name, err, np.abs(ref).max())


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (-1.0, 2.0), (0.25, 0.0), (0.5, 1.5)])
def test_sigmoid_focal_loss_matches_jax(alpha, gamma):
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((6, 50, 7)) * 4).astype(np.float32)
    hard = (rng.rand(6, 50, 7) > 0.8).astype(np.float32)
    soft = rng.rand(6, 50, 7).astype(np.float32)
    for targets in (hard, soft):
        close(sigmoid_focal_loss(t(x), t(targets), alpha, gamma), jax_focal(x, targets, alpha, gamma), name="loss")
        for red in ("sum", "mean"):
            close(sigmoid_focal_loss(t(x), t(targets), alpha, gamma, red), jax_focal(x, targets, alpha, gamma, red), name=red)
        xt = t(x).requires_grad_()
        sigmoid_focal_loss(xt, t(targets), alpha, gamma, "sum").backward()
        ref = jax.grad(lambda v: jax_focal(v, targets, alpha, gamma, "sum"))(jnp.asarray(x))
        close(xt.grad, ref, name="grad")


def tiny_cfg(norm=""):
    cfg = golden_dense_config("RetinaNet")
    cfg.MODEL.RETINANET.NORM = norm
    s = cfg.SOLVER
    s.BASE_LR = 0.01
    s.MAX_ITER = 10
    s.STEPS = (1,)
    s.WARMUP_ITERS = 4
    s.WARMUP_FACTOR = 0.5
    s.BIAS_LR_FACTOR = 2.0
    s.WEIGHT_DECAY_BIAS = 0.0
    return cfg


def make_batch():
    """Two 96x96 images, 5 gt slots each (one padded), 7 classes."""
    return synthetic_train_batch(H=96, W=96, num_classes=7, seed=3)


def eval_batch():
    b = make_batch()
    return {"image": b["image"], "image_sizes": b["image_sizes"]}


def jax_train(cfg, jm, variables, batch, steps):
    """Losses and gradients at ``variables`` (meters mutable, as the train
    step has them), then the variables after each of ``steps`` steps of
    ``make_train_step``."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    mutable = [c for c in variables if c != "params"]

    def loss_fn(params):
        losses, _ = jm.apply(params, jbatch, train=True, rngs={"sampling": key}, mutable=mutable)
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    state = TrainState.create(variables, jax_build_optimizer(jax_cfg_from_port(cfg), variables))
    step = make_train_step(jm, donate=False)
    states = []
    for i in range(steps):
        state, _ = step(state, jbatch, jax.random.fold_in(key, i))
        states.append(convert_jax_params(jax.tree_util.tree_map(np.asarray, state.params)))
    return {k: float(v) for k, v in losses.items()}, convert_jax_params(jax.tree_util.tree_map(np.asarray, {"params": grads["params"]})), states


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side once per module. Seed 0's weights leave every ReLU input
    at least 2.5e-6 from zero (in float64); at seed 3 one res5 input is
    2.5e-8, inside float32 rounding, and XLA's compiled step and the
    op-by-op evaluation (JAX's and the port's alike) take opposite sides of
    that kink: 1% apart in that conv's gradient."""
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.1, train_batch=make_batch())
    eb = {k: jnp.asarray(v) for k, v in eval_batch().items()}
    raw = jax.tree_util.tree_map(np.asarray, jm.apply(variables, eb, train=False, raw=True))
    det = jax.tree_util.tree_map(np.asarray, jm.apply(variables, eb, train=False))
    losses, grads, states = jax_train(cfg, jm, variables, make_batch(), 2)
    return {"cfg": cfg, "variables": variables, "raw": raw, "det": det, "losses": losses, "grads": grads, "states": states}


def test_every_jax_leaf_lands_on_the_port_model(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    assert model.loss_normalizer.item() == 100.0
    assert "head.cls_subnet.2.weight" in model.state_dict() and "backbone.top_block.p7.bias" in model.state_dict()


def test_raw_outputs_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    raw = model(eval_batch(), raw=True)
    assert set(raw) == {"logits", "deltas"} and len(raw["logits"]) == 5
    for key in ("logits", "deltas"):
        for i, (out, ref) in enumerate(zip(raw[key], jax_run["raw"][key])):
            close(out, ref, name=f"{key} level {i}")


def test_decoded_detections_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    out, ref = model(eval_batch()), jax_run["det"]
    assert set(out) == set(ref)
    np.testing.assert_array_equal(n(out["valid"]), ref["valid"])
    assert n(out["valid"]).sum() > 20
    np.testing.assert_array_equal(n(out["pred_classes"]), ref["pred_classes"])
    close(out["scores"], ref["scores"], name="scores")
    close(out["pred_boxes"], ref["pred_boxes"], name="boxes")


def test_losses_and_gradients_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    model.train()
    losses = assert_train_step_matches(model, make_batch(), jax_run["losses"], jax_run["grads"])
    assert set(losses) == {"loss_cls", "loss_box_reg"} and all(v > 0 for v in losses.values())


def test_two_sgd_steps_and_loss_normalizer_match_make_train_step(jax_run):
    cfg = jax_run["cfg"]
    model = port_model(cfg, jax_run["variables"])
    optimizer = build_optimizer(cfg, model)
    normalizers = []

    class Record(hooks.HookBase):
        def after_step(self):
            normalizers.append(model.loss_normalizer.clone())

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
    assert ref[0] != 100.0 and ref[1] != ref[0]
    for got, want in zip(normalizers, ref):
        assert math.isclose(got.item(), want, rel_tol=1e-6), (got.item(), want)


def test_eval_forward_leaves_the_normalizer_alone(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    model(eval_batch())
    model(eval_batch(), raw=True)
    assert model.loss_normalizer.item() == 100.0


def test_syncbn_head_running_statistics_after_one_step_match_jax():
    """Trap of the shared head: one BN per tower conv, called on p3..p7 in
    turn, so its running statistics take five momentum updates a step."""
    cfg = tiny_cfg(norm="SyncBN")
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=4, scale=0.1, train_batch=make_batch())
    _, _, states = jax_train(cfg, jm, variables, make_batch(), 1)
    model = port_model(cfg, variables)
    norms = [m for name, m in model.named_modules() if name.startswith("head.") and isinstance(m, SyncBatchNorm)]
    assert len(norms) == 4
    optimizer = build_optimizer(cfg, model)
    SimpleTrainer(model, [make_batch()], optimizer).train(0, 1)
    p0 = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    state = model.state_dict()
    head_stats = [k for k in state if k.startswith("head.") and k.endswith(("running_mean", "running_var"))]
    assert len(head_stats) == 8
    for k in head_stats:
        ref = states[0][k]
        assert not torch.equal(ref, p0[k]), k
        err = (state[k] - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item() + 1e-6, (k, err)
    assert math.isclose(state["loss_normalizer"].item(), states[0]["loss_normalizer"].item(), rel_tol=1e-6)


@pytest.fixture(scope="module")
def golden():
    return load_golden("e2e_retinanet_r18")


@pytest.fixture(scope="module")
def golden_model(golden, tmp_path_factory):
    path = tmp_path_factory.mktemp("d2") / "synthetic_retinanet.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden), "__author__": "reference-oracle"}, f)
    model = build_model(golden_dense_config("RetinaNet"), device="cpu")
    report = load_d2_checkpoint(model, str(path))
    return model, report


def test_golden_loads_every_d2_tensor(golden, golden_model):
    _, report = golden_model
    n_names = len(golden["weight_names"])
    # loss_normalizer is the port's buffer; d2 keeps it as a Python float
    assert report.splitlines() == [
        f"Loaded {n_names}/{n_names + 1} tensors from the checkpoint.",
        "Not found in the checkpoint: ['loss_normalizer']",
    ]


def test_golden_raw_maps_and_detections(golden, golden_model):
    model, _ = golden_model
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    raw = model(batch, raw=True)
    for i, f in enumerate(["p3", "p4", "p5", "p6", "p7"]):
        for key, k in (("logits", 7), ("deltas", 4)):
            ref = golden[f"{key}_{f}"]  # [1, A*K, H, W]
            ref = ref.transpose(0, 2, 3, 1).reshape(1, -1, k)
            assert np.abs(n(raw[key][i]) - ref).max() < 2e-3, (f, key)
    out = model(batch)
    inst = detector_postprocess({k: v[0] for k, v in out.items()}, 320, 320, 320, 320)
    assert_dense_golden_detections(inst, golden, max_count_diff=1, min_taken=40)


TRAIN_NAME = "dense_overfit"


class Trainer(DefaultTrainer):
    """tools/train_net.py's Trainer with the printer and metrics.json as its
    writers (the tensorboard writer imports TensorFlow here)."""

    def build_writers(self):
        os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
        return [events.CommonMetricPrinter(self.max_iter), events.JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json"))]

    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        return COCOEvaluator(dataset_name, distributed=False)


def trainer_cfg(out_dir, norm=""):
    """The golden's tiny RetinaNet on the train->AP gate's 64x64 images:
    3 classes, 4 images a step, 4 steps, a checkpoint every 2."""
    cfg = golden_dense_config("RetinaNet")
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.RETINANET.NUM_CLASSES = 3
    cfg.MODEL.RETINANET.NORM = norm
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0
    cfg.SEED = 0
    cfg.DATASETS.TRAIN = cfg.DATASETS.TEST = (TRAIN_NAME,)
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.INPUT.MIN_SIZE_TRAIN = (64,)
    cfg.INPUT.MAX_SIZE_TRAIN = cfg.INPUT.MIN_SIZE_TEST = cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.TPU.MAX_GT_INSTANCES = 8
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EVAL_PERIOD = 0
    cfg.OUTPUT_DIR = out_dir
    return cfg


@pytest.fixture(scope="module")
def overfit_data(tmp_path_factory):
    json_file, image_dir = write_synthetic_overfit_coco(str(tmp_path_factory.mktemp("dense_overfit")))
    if TRAIN_NAME not in DatasetCatalog:
        register_coco_instances(TRAIN_NAME, {}, json_file, image_dir)
    return json_file, image_dir


def test_default_trainer_trains_resumes_and_evaluates(overfit_data, tmp_path):
    """Four steps through the yaml path's trainer, then a resume from the
    checkpoint after step 2 restores ``loss_normalizer`` bitwise with the
    parameters and the momentum, and the evaluation has the bbox AP keys."""
    cfg = trainer_cfg(str(tmp_path))
    trainer = Trainer(cfg)
    assert type(trainer.model).__name__ == "RetinaNet"
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    assert set(results) == {"bbox"} and np.isfinite(results["bbox"]["AP50"])
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        first = json.loads(f.readline())
    assert {"loss_cls", "loss_box_reg"} <= set(first) and np.isfinite(first["total_loss"])
    final_normalizer = trainer.model.loss_normalizer.clone()
    assert final_normalizer.item() != 100.0
    saved = torch.load(os.path.join(cfg.OUTPUT_DIR, "model_0000001.pth"), weights_only=True)
    assert saved["model"]["loss_normalizer"].item() not in (100.0, final_normalizer.item())

    with open(os.path.join(cfg.OUTPUT_DIR, "last_checkpoint"), "w") as f:
        f.write("model_0000001.pth")
    resumed = Trainer(cfg)
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == 2
    assert torch.equal(resumed.model.loss_normalizer, saved["model"]["loss_normalizer"])
    for k, v in saved["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    state = resumed.optimizer.state_dict()["state"]
    ref = saved["trainer"]["_trainer"]["optimizer"]["state"]
    assert state.keys() == ref.keys() and all(torch.equal(state[i]["momentum_buffer"], ref[i]["momentum_buffer"]) for i in ref)
    resumed.train()  # steps 2 and 3 (the loader starts its stream anew, as d2's does)
    assert resumed.model.loss_normalizer.item() != saved["model"]["loss_normalizer"].item()

    predictor = DefaultPredictor(model=trainer.model, min_size_test=64, max_size_test=64)
    img = np.random.RandomState(0).randint(0, 256, (48, 80, 3)).astype(np.uint8)
    inst = predictor(img)["instances"]
    assert inst.image_size == (48, 80) and 0 < len(inst) <= 50 and not inst.has("pred_masks")
    boxes = n(inst.pred_boxes.tensor)
    assert np.isfinite(boxes).all() and (boxes[:, 0::2] <= 80).all() and (boxes[:, 1::2] <= 48).all()


def test_precise_bn_leaves_the_loss_normalizer_alone():
    """``update_bn_stats`` recomputes the SyncBN head's statistics and
    restores every other buffer, as the JAX ``PreciseBN`` makes only
    ``batch_stats`` mutable."""
    cfg = tiny_cfg(norm="SyncBN")
    model = build_model(cfg, device="cpu")
    bn = model.head.cls_subnet[1]
    before_stats = bn.running_mean.clone()
    update_bn_stats(model, iter([make_batch()] * 2), 2)
    assert model.loss_normalizer.item() == 100.0
    assert not torch.equal(bn.running_mean, before_stats)
    model(make_batch(), train=True)
    assert model.loss_normalizer.item() != 100.0
