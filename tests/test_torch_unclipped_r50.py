"""Why ``chip_smoke.py`` phase 11 clips its gradients: the zoo's R50-FPN
(``mask_rcnn_R_50_FPN_3x.yaml``, float32) with seeded weights, its FrozenBN
statistics calibrated on 4 train images as phase 11 does, trained without
clipping under phase 11's schedule (``MAX_ITER`` 20 with ``WARMUP_ITERS``
100, so the warmup ramps over all 20 steps), diverges in the JAX package
as it does in the port.

The port's ``DefaultTrainer`` takes its steps from the registered train
loader (2 images of 96x128 a step); the JAX package's ``make_train_step``
(the step of its ``DefaultTrainer``) takes the same batches from the same
weights, carried across by the JAX package's own d2 name mapping, with the
yaml's optimizer, and both samplers get the same draws
(``_torch_port.SameDraws``).

- The first step's five losses agree (rtol 2e-3: the losses are summed over
  a seeded R50 in another order, and ``loss_cls`` starts near 15).
- Both packages' total loss leaves 100x its first value, or stops being
  finite, at the same step, inside phase 11's 20 steps.

Each run stops once that step is decided: the port's after the step whose
loss left 100x (or a non-finite loss), the JAX package's after the same
step or its own divergence. The JAX steps run in a thread beside the
port's, each on the batch the port's step took, started once that step is
done.

Phase 11 itself shows that with the clip (global norm 1) the losses stay
finite over its 20 steps on the card.
"""

import math
import queue
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import SameDraws, jax_cfg_from_port, jax_model, jax_variables_from_d2

from detectron2_tpu.parallel import TrainState, make_train_step
from detectron2_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.data import DatasetCatalog, build_detection_test_loader
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer, hooks
from detectron2_tpu_torch.modeling import calibrate_frozen_bn
from detectron2_tpu_torch.testing import write_synthetic_coco

torch.set_num_threads(2)
NAME = "unclipped_r50_train"
LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")
MAX_ITER = 20  # phase 11's
BATCH_KEYS = ("image", "image_sizes", "gt_boxes", "gt_classes", "gt_valid", "gt_masks")


class _Trainer(DefaultTrainer):
    def build_writers(self):
        return []


def _cfg(out_dir):
    cfg = model_zoo.get_config("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml")
    cfg.MODEL.DEVICE = "cpu"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.DATASETS.TRAIN = (NAME,)
    cfg.DATASETS.TEST = ()
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.INPUT.MIN_SIZE_TRAIN = (96,)
    cfg.INPUT.MAX_SIZE_TRAIN = 160
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 160
    cfg.SOLVER.MAX_ITER = MAX_ITER
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * MAX_ITER
    assert not cfg.SOLVER.CLIP_GRADIENTS.ENABLED  # the yaml's
    cfg.SEED = 0
    cfg.OUTPUT_DIR = str(out_dir)
    return cfg


class _Diverged(Exception):
    pass


def _diverged_at(totals, first):
    return next((i for i, v in enumerate(totals) if not math.isfinite(v) or v > 100 * first), None)


def _jax_run(cfg, state, batches: queue.Queue, out: dict) -> None:
    """The JAX package's steps from the port's calibrated ``state`` on the
    batches the port's steps put on ``batches`` (None ends them), until its
    total loss diverges; its per-step losses go to ``out["losses"]`` (an
    exception to ``out["error"]``)."""
    try:
        jm = jax_model(cfg)
        variables = jax_variables_from_d2(jm, state)
        jax_state = TrainState.create(variables, jax_build_optimizer(jax_cfg_from_port(cfg), variables))
        step = make_train_step(jm, donate=False)
        totals = []
        for i, batch in enumerate(iter(batches.get, None)):
            jax_state, loss = step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
            out["losses"].append({k: float(v) for k, v in loss.items()})
            totals.append(out["losses"][-1]["total_loss"])
            if _diverged_at(totals, totals[0]) is not None:
                break
    except Exception as e:  # re-raised by the fixture
        out["error"] = e


def _runs(cfg):
    """The port's steps until its total loss leaves 100x the first or a
    loss stops being finite (the seeded trainer, FrozenBN calibrated on 4
    train images), and the JAX package's on the same batches in a thread:
    the port's per-step losses and the step that raised (or None), the JAX
    package's per-step losses."""
    trainer = _Trainer(cfg)
    calib = next(iter(build_detection_test_loader(cfg, NAME, batch_size=4)))
    calibrate_frozen_bn(trainer.model, {k: v for k, v in calib.items() if k != "metadata"})
    state = {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}
    batches, losses, jax_out = queue.Queue(), [], {"losses": []}
    jax_thread = threading.Thread(target=_jax_run, args=(cfg, state, batches, jax_out))
    jax_thread.start()
    loader, taken = trainer._trainer.data_loader, []

    def recording():
        for batch in loader:
            taken.append({k: np.asarray(batch[k]) for k in BATCH_KEYS})
            yield batch

    def after_step(t):
        # the JAX step starts once the port's is done: the draws of both
        # packages' samplers are made in the order of a run one after the other
        batches.put(taken[-1])
        losses.append({k: t.storage.history(k).latest() for k in LOSSES})
        totals = [sum(x.values()) for x in losses]
        if _diverged_at(totals, totals[0]) is not None:
            raise _Diverged()

    trainer._trainer.data_loader = recording()
    trainer.register_hooks([hooks.CallbackHook(after_step=after_step)])
    raised = None
    try:
        trainer.train()
    except FloatingPointError:
        raised = len(losses)
        batches.put(taken[-1])  # the JAX package's step on the batch the port's raised on
    except _Diverged:
        pass
    finally:
        batches.put(None)
        jax_thread.join(timeout=1200)
    assert not jax_thread.is_alive(), "the JAX package's steps did not end"
    if "error" in jax_out:
        raise jax_out["error"]
    return losses, raised, jax_out["losses"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("unclipped")
    json_file, image_root = write_synthetic_coco(str(root / "coco"), 8, sizes=((120, 160),))
    if NAME not in DatasetCatalog:
        register_coco_instances(NAME, {}, json_file, image_root)
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=3).patch(mp)
        losses, raised, jax_losses = _runs(_cfg(root / "port"))
    port = [sum(x.values()) for x in losses] + ([math.nan] if raised is not None else [])
    jax_totals = [x["total_loss"] for x in jax_losses]
    print("port, unclipped:", port)
    print("JAX package, unclipped:", jax_totals)
    return {"port": losses, "port_totals": port, "jax": jax_losses, "jax_totals": jax_totals}


def test_first_step_losses_match_the_jax_package(runs):
    for k in LOSSES:
        assert math.isclose(runs["port"][0][k], runs["jax"][0][k], rel_tol=2e-3), k


def test_both_packages_diverge_at_the_same_step_without_clipping(runs):
    port, ref = runs["port_totals"], runs["jax_totals"]
    at = _diverged_at(port, port[0])
    assert at is not None and at < MAX_ITER, port
    assert _diverged_at(ref, ref[0]) == at, (port, ref)

