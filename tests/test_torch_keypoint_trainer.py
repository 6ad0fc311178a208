"""The keypoint train->AP gate's config through the port's DefaultTrainer
on the CPU, four steps, against the JAX package.

``testing.overfit_keypoint_config`` (the JAX gate's keypoint config,
``tests/test_train_to_ap.py:170-226``) on ``write_synthetic_overfit_coco(
keypoints=True)``, registered in both packages with the corner keypoint
names and an empty flip map:

- the dataset's bytes equal the JAX test's fixture where both write the
  same json fields (the JAX writer needs PIL, so the json is compared);
- four ``DefaultTrainer`` steps: ``metrics.json`` holds the five losses,
  ``loss_keypoint`` among them; at every step the JAX model, on the weights
  the port's step started from (carried across by the JAX package's own d2
  name mapping), the same batch and the same sampler draws
  (``_torch_port.SameDraws``), gives the same loss keys, the same losses
  (rtol 1e-4) and the same gradient of every parameter (1e-3 * max|g_ref|
  + 1e-6). Each step starts from the port's weights: run free, the two
  packages' weights part by float32 rounding that this random GroupNorm
  model amplifies (0.4% in ``loss_cls`` at step 3), while the optimizer
  itself is held to ``make_train_step`` in ``test_torch_train_step.py``;
- the EvalHook's result dict has the JAX evaluator's tasks and keys and
  equals the JAX ``COCOEvaluator``'s on the same predictions with the
  config's OKS sigmas.

The 500-step gate itself runs on the card (``chip_smoke.py`` phase 22).
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import detectron2_tpu.data as jax_data
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_tpu_torch.checkpoint import convert_jax_params
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_PERSON_KEYPOINT_FLIP_MAP
from detectron2_tpu_torch.engine import DefaultTrainer, hooks
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.testing import OVERFIT_KEYPOINT_NAMES, overfit_keypoint_config, write_synthetic_overfit_coco
from detectron2_tpu_torch.utils import events

from _torch_port import SameDraws, jax_model, jax_variables_from_d2

torch.set_num_threads(2)
NAME = "trainer_overfit_keypoints"
LOSSES = ("loss_cls", "loss_box_reg", "loss_keypoint", "loss_rpn_cls", "loss_rpn_loc")
BATCH_KEYS = ("image", "image_sizes", "gt_boxes", "gt_classes", "gt_valid", "gt_keypoints")
ITERS = 4


@pytest.fixture(scope="module")
def overfit_kpt(tmp_path_factory):
    """The keypoint gate's 16 images, registered in both packages with the
    metadata the JAX test sets."""
    json_file, image_dir = write_synthetic_overfit_coco(str(tmp_path_factory.mktemp("overfit_kpt")), keypoints=True)
    meta = dict(keypoint_names=OVERFIT_KEYPOINT_NAMES, keypoint_flip_map=())
    if NAME not in DatasetCatalog:
        register_coco_instances(NAME, {}, json_file, image_dir)
        MetadataCatalog.get(NAME).set(**meta)
    if NAME not in jax_data.DatasetCatalog:
        jax_coco.register_coco_instances(NAME, {}, json_file, image_dir)
        jax_data.MetadataCatalog.get(NAME).set(**meta)
        jax_data.DatasetCatalog.get(NAME)
    return json_file, image_dir


class Trainer(DefaultTrainer):
    """tools/train_net.py's Trainer with the JAX gate's evaluator (OKS
    sigmas from the config), keeping its evaluators; writers: the printer
    and metrics.json."""

    evaluators = []

    def build_writers(self):
        os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
        return [events.CommonMetricPrinter(self.max_iter), events.JSONWriter(os.path.join(self.cfg.OUTPUT_DIR, "metrics.json"))]

    @classmethod
    def build_evaluator(cls, cfg, dataset_name):
        ev = COCOEvaluator(dataset_name, output_dir=os.path.join(cfg.OUTPUT_DIR, "eval"), distributed=False,
                           kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS)
        cls.evaluators.append(ev)
        return ev


@pytest.fixture(scope="module")
def trained(overfit_kpt, tmp_path_factory):
    cfg = overfit_keypoint_config(str(tmp_path_factory.mktemp("kpt_run")), NAME)
    cfg.MODEL.DEVICE = "cpu"
    cfg.SEED = 0
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.TEST.EXPECTED_RESULTS = []  # four steps do not reach the gate's bands
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # detections after 4 steps
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=21).patch(mp)
        trainer = Trainer(cfg)
        trainer.resume_or_load(resume=False)
        batches, states, steps = [], [], []
        loader = trainer._trainer.data_loader

        def recording():
            for batch in loader:
                batches.append({k: np.asarray(batch[k]) for k in BATCH_KEYS})
                yield batch

        def after_step(t):
            losses = {k: t.storage.history(k).latest() for k in LOSSES}
            steps.append((losses, {k: p.grad.detach().numpy().copy() for k, p in t.model.named_parameters()}))

        trainer._trainer.data_loader = recording()
        trainer.register_hooks([
            hooks.CallbackHook(
                before_step=lambda t: states.append({k: v.detach().numpy().copy() for k, v in t.model.state_dict().items()}),
                after_step=after_step,
            )
        ])
        results = trainer.train()

        jm = jax_model(cfg)

        @jax.jit
        def losses_and_grads(params, batch):
            def loss_fn(p):
                losses = jm.apply(p, batch, train=True, rngs={"sampling": jax.random.PRNGKey(0)})
                return sum(jax.tree_util.tree_leaves(losses)), losses

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        ref = []
        for state, batch in zip(states, batches):
            (_, losses), grads = losses_and_grads(jax_variables_from_d2(jm, state), {k: jnp.asarray(v) for k, v in batch.items()})
            ref.append(({k: float(v) for k, v in losses.items()}, convert_jax_params(jax.tree_util.tree_map(np.asarray, grads))))
    return cfg, trainer, results, steps, ref


def test_dataset_json_equals_the_jax_fixture(overfit_kpt):
    """The JAX test's ``_make_synthetic_coco(keypoints=True)`` json, rebuilt
    from its draws: 4 corner keypoints inset 2 px, every category naming
    them."""
    with open(overfit_kpt[0]) as f:
        coco = json.load(f)
    rng = np.random.RandomState(0)
    anns = iter(coco["annotations"])
    for img_id in range(1, 17):
        rng.rand(64, 64, 3)
        for j in range(1 + img_id % 2):
            w, h = int(rng.randint(18, 28)), int(rng.randint(18, 28))
            x0 = int(rng.randint(1, 32 - w - 1)) + 32 * j if img_id % 2 else int(rng.randint(1, 64 - w - 1))
            y0 = int(rng.randint(1, 64 - h - 1))
            cat = int(rng.randint(0, 3))
            a = next(anns)
            assert a["bbox"] == [x0, y0, w, h] and a["category_id"] == cat + 1, a
            x1, y1 = x0 + w, y0 + h
            assert a["keypoints"] == [x0 + 2, y0 + 2, 2, x1 - 2, y0 + 2, 2, x1 - 2, y1 - 2, 2, x0 + 2, y1 - 2, 2]
            assert a["num_keypoints"] == 4
    assert next(anns, None) is None
    assert all(c["keypoints"] == list(OVERFIT_KEYPOINT_NAMES) for c in coco["categories"])


def test_every_step_matches_the_jax_package_on_the_same_weights(trained):
    cfg, trainer, results, steps, ref = trained
    assert len(steps) == len(ref) == ITERS
    for i, ((losses, grads), (ref_losses, ref_grads)) in enumerate(zip(steps, ref)):
        assert set(ref_losses) == set(LOSSES), sorted(ref_losses)
        for k in LOSSES:
            assert math.isfinite(losses[k]) and math.isclose(losses[k], ref_losses[k], rel_tol=1e-4), (i, k, losses[k], ref_losses[k])
        assert set(grads) == set(ref_grads)
        for name, g in grads.items():
            r = ref_grads[name].numpy()
            assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max() + 1e-6, (i, name)
    assert steps[0][0]["loss_keypoint"] > 0
    with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["iteration"] for x in lines] == [ITERS - 1, ITERS]
    assert set(LOSSES) | {"total_loss", "lr", "data_time", "time"} <= set(lines[0])
    assert lines[1]["keypoints/AP"] == results["keypoints"]["AP"]


def test_eval_hook_results_equal_the_jax_evaluator(trained, overfit_kpt):
    cfg, trainer, results, _, _ = trained
    ev = Trainer.evaluators[-1]
    contiguous = MetadataCatalog.get(NAME).thing_dataset_id_to_contiguous_id
    predictions = copy.deepcopy(ev._predictions)
    for p in predictions:
        for inst in p["instances"]:
            inst["category_id"] = contiguous[inst["category_id"]]
    assert all("keypoints" in inst for p in predictions for inst in p["instances"])
    ref_ev = JaxCOCOEvaluator(NAME, distributed=False, kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS)
    ref_ev._predictions = predictions
    ref = ref_ev.evaluate()
    assert set(results) == set(ref) == {"bbox", "keypoints"}
    for task in ref:
        assert list(results[task]) == list(ref[task])
        np.testing.assert_equal(results[task], ref[task])
        assert trainer.storage.latest()[f"{task}/AP"] == (results[task]["AP"], ITERS)
    assert sum(len(p["instances"]) for p in ev._predictions) > 0
    # what the gate holds after 500 steps (chip_smoke.py phase 22); the
    # four-step run here clears EXPECTED_RESULTS
    gate = overfit_keypoint_config("", NAME)
    assert gate.TEST.KEYPOINT_OKS_SIGMAS == cfg.TEST.KEYPOINT_OKS_SIGMAS == [0.1] * 4
    assert gate.TEST.EXPECTED_RESULTS == [["bbox", "AP", 75.0, 25.0], ["keypoints", "AP", 60.0, 40.0]]


def test_train_net_trains_a_keypoint_model(tmp_path):
    """``train_net`` with ``--dataset`` on a 17-keypoint config: the dataset
    gets COCO's person keypoint names and flip map, two steps with flips
    write ``loss_keypoint`` and the checkpoint, and the evaluation after
    training runs (two steps from seeded weights detect nothing above score
    0, so its AP dict has bbox only)."""
    from detectron2_tpu_torch.testing import golden_keypoint_config, write_synthetic_coco
    from detectron2_tpu_torch.tools import train_net

    json_file, image_root = write_synthetic_coco(str(tmp_path / "coco"), 4, seed=3, sizes=((72, 96), (96, 72)), keypoints=True)
    cfg = golden_keypoint_config()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 1
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.MAX_ITER, cfg.SOLVER.BASE_LR = 2, 2, 0.001
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (64, 72), 128
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 128
    config = tmp_path / "kpt.yaml"
    config.write_text(cfg.dump())
    out = tmp_path / "out"
    args = train_net.argument_parser().parse_args([
        "--config-file", str(config), "--dataset", "cli_kpt", json_file, image_root, "MODEL.DEVICE", "cpu",
        "DATASETS.TRAIN", '("cli_kpt",)', "DATASETS.TEST", '("cli_kpt",)', "OUTPUT_DIR", str(out),
    ])
    results = train_net.main(args)
    meta = MetadataCatalog.get("cli_kpt")
    assert meta.keypoint_flip_map == COCO_PERSON_KEYPOINT_FLIP_MAP and len(meta.keypoint_names) == 17
    assert "bbox" in results
    with open(out / "metrics.json") as f:
        lines = [json.loads(x) for x in f]
    assert all(math.isfinite(x["loss_keypoint"]) for x in lines if "loss_keypoint" in x)
    assert sum("loss_keypoint" in x for x in lines) >= 1 and (out / "model_final.pth").exists()
