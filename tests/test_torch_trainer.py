"""DefaultTrainer of the port on the CPU: four steps of the train->AP gate's
config (``testing.overfit_config``, R18-FPN with GroupNorm on 64x64
synthetic rectangles) through the registered dataset, the train loader, the
hooks, the checkpointer and the EvalHook; then resume, the writers and the
command line.

- ``metrics.json`` holds the step's losses, ``lr``, ``data_time`` and
  ``time`` and, after training, the evaluation's flattened AP; the
  periodic and final checkpoints exist and the ``last_checkpoint`` tag
  names the final one.
- ``resume_or_load(resume=True)`` starts after the saved iteration, and the
  model, optimizer, scheduler and sampling-generator state equal the saved
  ones (``torch.equal``).
- The EvalHook's AP dicts have the JAX package's keys, and equal the JAX
  ``COCOEvaluator``'s on the same predictions.
- A d2 ``.pkl`` that matches no tensor of the model raises.
- ``EventStorage`` and ``JSONWriter`` write what the JAX package's write on
  the same scalars.
- A dropped trainer frees its model by reference counting (``gc``
  disabled), after one step, with PreciseBN, or never trained.
"""

import copy
import gc
import json
import os
import pickle
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

import detectron2_tpu.data as jax_data
import detectron2_tpu.utils.events as jax_events
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_tpu_torch.checkpoint import Checkpointer, PeriodicCheckpointer
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer, hooks
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.testing import overfit_config, write_synthetic_overfit_coco
from detectron2_tpu_torch.utils import events

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "trainer_overfit"
LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")


@pytest.fixture(scope="module")
def overfit(tmp_path_factory):
    """The gate's 16 images, registered in both packages."""
    json_file, image_dir = write_synthetic_overfit_coco(str(tmp_path_factory.mktemp("overfit")))
    if NAME not in DatasetCatalog:
        register_coco_instances(NAME, {}, json_file, image_dir)
    if NAME not in jax_data.DatasetCatalog:
        jax_coco.register_coco_instances(NAME, {}, json_file, image_dir)
        jax_data.DatasetCatalog.get(NAME)
    return json_file, image_dir


class Trainer(DefaultTrainer):
    """tools/train_net.py's Trainer, keeping its evaluators; its writers are
    the printer and metrics.json (the command-line test covers
    ``default_writers``, whose tensorboard writer imports TensorFlow here)."""

    evaluators = []

    def build_writers(self):
        os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
        return [events.CommonMetricPrinter(self.max_iter), events.JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json"))]

    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        ev = COCOEvaluator(dataset_name, output_dir=os.path.join(cfg.OUTPUT_DIR, "eval"), distributed=False)
        cls.evaluators.append(ev)
        return ev


def _cfg(out_dir, iters=4):
    cfg = overfit_config(out_dir, NAME)
    cfg.MODEL.DEVICE = "cpu"
    cfg.SEED = 0
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EXPECTED_RESULTS = []
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # detections after 4 steps
    return cfg


@pytest.fixture(scope="module")
def trained(overfit, tmp_path_factory):
    cfg = _cfg(str(tmp_path_factory.mktemp("run")))
    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    return cfg, trainer, results


def test_four_steps_write_metrics_and_checkpoints(trained):
    cfg, trainer, results = trained
    out = cfg.OUTPUT_DIR
    with open(os.path.join(out, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    # the writer's period (20) ends at the last step; the evaluation after training
    assert [x["iteration"] for x in lines] == [3, 4]
    assert set(LOSSES) | {"total_loss", "lr", "data_time", "time"} <= set(lines[0])
    assert all(np.isfinite(lines[0][k]) for k in LOSSES)
    assert lines[1]["bbox/AP"] == results["bbox"]["AP"] and lines[1]["segm/AP"] == results["segm"]["AP"]
    files = sorted(f for f in os.listdir(out) if f.endswith(".pth"))
    assert files == ["model_0000001.pth", "model_0000003.pth", "model_final.pth"]
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read() == "model_final.pth"
    saved = torch.load(os.path.join(out, "model_final.pth"), weights_only=True)
    assert set(saved) == {"model", "trainer", "iteration"} and saved["iteration"] == 3
    assert set(saved["trainer"]) == {"iteration", "hooks", "_trainer"}
    assert set(saved["trainer"]["_trainer"]) == {"iteration", "optimizer", "generator"}
    assert saved["trainer"]["hooks"]["LRScheduler"]["last_epoch"] == 4
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    assert trainer.model.device.type == "cpu" and trainer.iter == 4


def _assert_state_equal(trainer, saved):
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    opt, ref = trainer.optimizer.state_dict(), saved["trainer"]["_trainer"]["optimizer"]
    assert opt["param_groups"] == ref["param_groups"]
    assert opt["state"].keys() == ref["state"].keys() and len(opt["state"]) > 30
    for i in ref["state"]:
        assert torch.equal(opt["state"][i]["momentum_buffer"], ref["state"][i]["momentum_buffer"]), i
    assert torch.equal(trainer._trainer.generator.get_state(), saved["trainer"]["_trainer"]["generator"])
    assert trainer.scheduler.last_epoch == saved["trainer"]["hooks"]["LRScheduler"]["last_epoch"]


def test_resume_starts_after_the_saved_iteration_with_equal_state(trained):
    cfg = trained[0]
    out = cfg.OUTPUT_DIR
    second = Trainer(cfg)
    second.resume_or_load(resume=True)
    assert second.start_iter == 4
    _assert_state_equal(second, torch.load(os.path.join(out, "model_final.pth"), weights_only=True))
    # from the first periodic checkpoint, then the two steps after it
    cfg2 = cfg.clone()
    cfg2.OUTPUT_DIR = os.path.join(out, "resumed")
    os.makedirs(cfg2.OUTPUT_DIR)
    with open(os.path.join(cfg2.OUTPUT_DIR, "last_checkpoint"), "w") as f:
        f.write("../model_0000001.pth")
    third = Trainer(cfg2)
    third.resume_or_load(resume=True)
    assert third.start_iter == 2
    _assert_state_equal(third, torch.load(os.path.join(out, "model_0000001.pth"), weights_only=True))
    third.train()
    assert [i for _, i in third.storage.history("total_loss").values()] == [2, 3]
    # without resume: MODEL.WEIGHTS, a port checkpoint, as weights only
    cfg3 = cfg.clone()
    cfg3.MODEL.WEIGHTS = os.path.join(out, "model_0000003.pth")
    fourth = Trainer(cfg3)
    fourth.resume_or_load(resume=False)
    assert fourth.start_iter == 0 and fourth.scheduler.last_epoch == 0
    saved = torch.load(cfg3.MODEL.WEIGHTS, weights_only=True)
    assert all(torch.equal(saved["model"][k], v) for k, v in fourth.model.state_dict().items())


def test_eval_hook_results_have_the_jax_keys(trained, overfit):
    cfg, trainer, results = trained
    ev = Trainer.evaluators[0]
    # evaluate() mapped the predictions' classes to the dataset's ids in place
    contiguous = MetadataCatalog.get(NAME).thing_dataset_id_to_contiguous_id
    predictions = copy.deepcopy(ev._predictions)
    for p in predictions:
        for inst in p["instances"]:
            inst["category_id"] = contiguous[inst["category_id"]]
    ref_ev = JaxCOCOEvaluator(NAME, distributed=False)
    ref_ev._predictions = predictions
    ref = ref_ev.evaluate()
    assert set(results) == set(ref) == {"bbox", "segm"}
    for task in ref:
        assert list(results[task]) == list(ref[task])
        np.testing.assert_equal(results[task], ref[task])
        assert trainer.storage.latest()[f"{task}/AP"] == (results[task]["AP"], 4)
    assert sum(len(p["instances"]) for p in ev._predictions) > 0


def test_a_pkl_that_matches_nothing_raises(overfit, tmp_path):
    weights = tmp_path / "other.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": {"not.a.tensor.of.the.model": np.zeros(3, np.float32)}}, f)
    cfg = _cfg(str(tmp_path / "out"))
    cfg.MODEL.WEIGHTS = str(weights)
    trainer = Trainer(cfg)
    with pytest.raises(RuntimeError, match="matched 0 tensors"):
        trainer.resume_or_load(resume=False)
    cfg.MODEL.WEIGHTS = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError):
        Trainer(cfg).resume_or_load(resume=False)


def test_entry_points_default_to_the_card():
    assert get_cfg().MODEL.DEVICE == "cuda" and overfit_config("", "x").MODEL.DEVICE == "cuda"


def test_periodic_checkpointer_keeps_the_newest(tmp_path):
    model = torch.nn.Linear(2, 2)
    pc = PeriodicCheckpointer(Checkpointer(model, str(tmp_path)), 2, max_iter=9, max_to_keep=2)
    for it in range(9):
        pc.step(it)
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_0000005.pth", "model_0000007.pth", "model_final.pth"]
    assert Checkpointer(model, str(tmp_path)).get_checkpoint_file().endswith("model_final.pth")


def test_best_checkpointer_saves_on_improvement(tmp_path):
    model = torch.nn.Linear(2, 2)
    saved = []
    ckpt = Checkpointer(model, str(tmp_path))
    ckpt.save = lambda name, **kw: saved.append(name)

    class Fake:
        iter, max_iter = 0, 10
        storage = events.EventStorage()

    hook = hooks.BestCheckpointer(2, ckpt, "bbox/AP")
    hook.trainer = Fake()
    for it, ap in enumerate([0, 5.0, 0, 4.0, 0, 7.0]):
        Fake.iter = it
        if it % 2 == 1:
            Fake.storage.put_scalar("bbox/AP", ap, smoothing_hint=False, cur_iter=it)
        hook.after_step()
    assert saved == ["model_best", "model_best"] and hook.best_metric == 7.0 and hook.best_iter == 5


def test_profiler_and_memory_hooks_on_the_cpu(tmp_path):
    """TorchProfiler traces the iterations its predicate selects and writes
    one chrome trace when they end; MemoryStats records nothing without the
    card."""
    model = torch.nn.Linear(4, 1)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = model

        def forward(self, batch, train=False, generator=None):
            return {"loss_mse": self.lin(batch["x"]).pow(2).mean()}

    from detectron2_tpu_torch.engine import SimpleTrainer

    trainer = SimpleTrainer(Toy(), [{"x": torch.ones(2, 4)}] * 4, torch.optim.SGD(model.parameters(), lr=0.1))
    trainer.register_hooks([hooks.TorchProfiler(lambda t: t.iter in (1, 2), str(tmp_path)), hooks.MemoryStats(period=1)])
    trainer.train(0, 4)
    traces = sorted(os.listdir(tmp_path))
    assert traces == ["profiler-trace-iter3.json"]
    with open(tmp_path / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert "device_peak_bytes" not in trainer.storage.histories()


def _write_scalars(mod, path):
    with mod.EventStorage(0) as storage:
        writer = mod.JSONWriter(str(path), window_size=3)
        for it in range(7):
            storage.iter = it
            storage.put_scalars(total_loss=10.0 / (it + 1), data_time=0.01 * it)
            storage.put_scalar("lr", 0.1 * it, smoothing_hint=False)
            if it % 3 == 2:
                with storage.name_scope("val"):
                    storage.put_scalar("AP", float(it), smoothing_hint=False)
                writer.write()
        writer.write()
        writer.close()
        return storage.latest_with_smoothing_hint(3), storage.count_samples("total_loss", 3)


def test_event_storage_and_json_writer_equal_the_jax_package(tmp_path):
    ours = _write_scalars(events, tmp_path / "ours.json")
    ref = _write_scalars(jax_events, tmp_path / "ref.json")
    assert ours == ref
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    with pytest.raises(AssertionError, match="inside a 'with EventStorage"):
        events.get_event_storage()


_DROP_IN_A_FRESH_PROCESS = r"""
import gc, sys, weakref
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer

class Trainer(DefaultTrainer):
    def build_writers(self):
        return []

name, json_file, image_dir, config = sys.argv[1:]
register_coco_instances(name, {}, json_file, image_dir)
cfg = get_cfg()
cfg.merge_from_file(config)
gc.disable()
trainer = Trainer(cfg)
trainer.train()
refs = [weakref.ref(trainer.model), weakref.ref(next(trainer.model.parameters())), weakref.ref(trainer.optimizer)]
del trainer
print("model alive after del:", any(r() is not None for r in refs))
"""


@pytest.mark.parametrize("case", ["one_step_in_a_fresh_process", "one_step_with_precise_bn", "never_trained"])
def test_a_dropped_trainer_frees_its_model_by_reference_counting(case, overfit, tmp_path):
    """ROADMAP C: with ``gc.disable()`` a dropped ``DefaultTrainer``'s
    model, its parameters and its optimizer are freed at ``del``. Four
    cycles held them until a collection: the LR scheduler's function (a
    bound method of the scheduler, which holds the optimizer and so every
    parameter and its state); the first optimizer's import of
    ``torch._dynamo`` (a ``torch.fx.wrap`` frame holds itself and so the
    whole stack that built the trainer; it shows in a process's first
    trainer); the EvalHook's function (until the end of training) and
    PreciseBN's batches, which held the trainer."""
    cfg = _cfg(str(tmp_path / "out"), iters=1)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.TEST.EVAL_PERIOD = 0
    cfg.DATASETS.TEST = ()
    if case == "one_step_in_a_fresh_process":
        config = tmp_path / "one_step.yaml"
        config.write_text(cfg.dump())
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        proc = subprocess.run([sys.executable, "-c", _DROP_IN_A_FRESH_PROCESS, NAME, *overfit, str(config)],
                              cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
        assert "model alive after del: False" in proc.stdout, proc.stdout[-2000:]
        return
    if case == "one_step_with_precise_bn":
        cfg.MODEL.RESNETS.NORM = cfg.MODEL.FPN.NORM = "BN"
        cfg.TEST.PRECISE_BN.ENABLED = True
        cfg.TEST.PRECISE_BN.NUM_ITER = 1
    gc.disable()
    try:
        trainer = Trainer(cfg)
        if case == "one_step_with_precise_bn":
            assert any(type(h).__name__ == "PreciseBN" for h in trainer._hooks)
            trainer.train()
        refs = {"model": weakref.ref(trainer.model), "a parameter": weakref.ref(next(trainer.model.parameters())),
                "the optimizer": weakref.ref(trainer.optimizer)}
        del trainer
        assert all(r() is None for r in refs.values()), [k for k, r in refs.items() if r() is not None]
    finally:
        gc.enable()


def test_train_command_line_resumes(overfit, tmp_path):
    """``python -m detectron2_tpu_torch.tools.train_net --resume`` with
    ``--dataset`` and ``MODEL.DEVICE cpu`` on the gate's config, after two
    steps of the same config in this process: it trains the third."""
    out = tmp_path / "out"
    cfg = overfit_config(str(out), NAME)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.DATASETS.TEST = ()
    cfg.TEST.EXPECTED_RESULTS = []
    config = tmp_path / "overfit.yaml"
    config.write_text(cfg.dump())
    cfg.MODEL.DEVICE = "cpu"
    cfg.SOLVER.MAX_ITER = 2
    Trainer(cfg).train()
    cmd = [sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config),
           "--dataset", NAME, *overfit, "--resume", "MODEL.DEVICE", "cpu", "SOLVER.MAX_ITER", "3"]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert "Starting training from iteration 2" in log and (out / "config.yaml").exists()
    with open(out / "metrics.json") as f:
        assert [json.loads(x)["iteration"] for x in f] == [1, 2]
    assert torch.load(out / "model_final.pth", weights_only=True)["iteration"] == 2
