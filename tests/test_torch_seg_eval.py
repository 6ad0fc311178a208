"""The port's semantic and panoptic data and evaluation against the JAX
package's, on the CPU, on a synthetic COCO panoptic tree
(``testing.write_synthetic_coco_panoptic``: PNG images under COCO's names,
the instances and panoptic jsons, RGB-id PNGs and "L" stuff labels).

- The builtin registrations: COCO panoptic (standard and separated) and
  ADE20K have the JAX package's names, metadata and paths; the port has
  ``coco_2017_*_panoptic_stuffonly`` besides (correction (a): the JAX
  ``register_coco_panoptic_separated`` never registers it, yet the JAX
  package's semantic yamls name it).
- ``load_sem_seg``, ``load_coco_panoptic_json`` and the separated merge
  ``==`` the JAX loaders, the ``val2017_100`` intersection included.
- The mapper's ``sem_seg`` (read as "L", resized nearest, flipped, int64)
  and the collator's ``gt_sem_seg`` ``[B, H, W]`` int32 padded with 255
  ``==`` the JAX ones.
- ``SemSegEvaluator`` and ``COCOPanopticEvaluator``: the same predictions
  give the JAX evaluators' result dicts to 1e-12 (the logits through
  ``sem_seg_postprocess`` from a resized, padded frame); the ground truth
  fed back gives mIoU, pACC and PQ 100. Correction (d): on metadata without
  height and width the JAX ``SemSegEvaluator.process`` raises ``KeyError``
  and the port's takes the image's size in the batch.
- The panoptic PNGs read by ``data/png.py`` ``==`` ``cv2.imread(...)[:, :,
  ::-1]``.
- Correction (b): ``build_evaluator`` gives a ``coco_panoptic_seg``
  dataset SemSegEvaluator, COCOEvaluator and COCOPanopticEvaluator, a
  ``sem_seg`` one SemSegEvaluator; the JAX ``tools/train_net.py`` gives
  COCOEvaluator alone and raises on ``sem_seg``.
- In subprocesses with ``DETECTRON2_DATASETS`` set to the tree (the builtin
  names exist at import): the builtin panoptic, stuff-only and ADE20K sets
  load; the panoptic and semantic yamls' test sets get their evaluators;
  ``tools/train_net.py --eval-only`` of a tiny PanopticFPN on
  ``coco_2017_val_100_panoptic_separated`` prints bbox, segm, sem_seg and
  panoptic_seg results; ``lazyconfig_train_net --eval-only`` of
  ``panoptic_fpn_R_50_1x.py`` (seeded weights) runs its three evaluators.
"""

import copy
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import detectron2_tpu.data.datasets  # noqa: F401  (the JAX builtin names)
from detectron2_tpu import data as jax_data
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.build import PaddedBatchCollator as JaxCollator
from detectron2_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.data.datasets import coco_panoptic as jax_pan
from detectron2_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_builtin_meta
from detectron2_tpu.evaluation.panoptic_evaluation import COCOPanopticEvaluator as JaxPanopticEvaluator
from detectron2_tpu.evaluation.sem_seg_evaluation import SemSegEvaluator as JaxSemSegEvaluator
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog, PaddedBatchCollator
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.dataset_mapper import DatasetMapper
from detectron2_tpu_torch.data.datasets import (
    load_coco_panoptic_json,
    load_sem_seg,
    register_coco_panoptic,
    register_coco_panoptic_separated,
)
from detectron2_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from detectron2_tpu_torch.data.png import read_png, write_png
from detectron2_tpu_torch.evaluation import COCOPanopticEvaluator, DatasetEvaluators, SemSegEvaluator
from detectron2_tpu_torch.evaluation.panoptic_evaluation import rgb2id
from detectron2_tpu_torch.testing import golden_panoptic_config, write_synthetic_coco_panoptic

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = ((96, 128), (120, 100), (80, 120))
NAME = "synth_pan_val"  # registered as NAME (standard), NAME_separated, NAME_stuffonly


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    out = write_synthetic_coco_panoptic(root, 6, seed=0, sizes=SIZES, val_100=4)
    val = out["val"]
    for separated, standard, meta in (
        (register_coco_panoptic_separated, register_coco_panoptic, _get_builtin_metadata),
        (jax_pan.register_coco_panoptic_separated, jax_pan.register_coco_panoptic, jax_builtin_meta),
    ):
        separated(NAME, meta("coco_panoptic_separated"), val["images"], val["panoptic_root"], val["panoptic_json"],
                  val["stuff_root"], val["instances_json"])
        standard(NAME, meta("coco_panoptic_standard"), val["images"], val["panoptic_root"], val["panoptic_json"],
                 val["instances_json"])
    return out


def _plain(x):
    """Dataset dicts with enums as ints, for comparison across packages."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return int(x.value) if hasattr(x, "value") and not isinstance(x, (int, float, str)) else x


def test_builtin_registrations_equal_jax():
    ours = {x for x in DatasetCatalog.list() if "panoptic" in x or "ade20k" in x}
    ref = {x for x in jax_data.DatasetCatalog.list() if "panoptic" in x or "ade20k" in x}
    stuffonly = {f"coco_2017_{s}_panoptic_stuffonly" for s in ("train", "val", "val_100")}
    # and d2's Cityscapes panoptic splits (ROADMAP C, correction 20)
    cityscapes = {f"cityscapes_fine_panoptic_{s}" for s in ("train", "val")}
    assert ours - ref == stuffonly | cityscapes and ref <= ours and len(ref) == 3 * 2 + 2
    for name in sorted(ref):
        assert MetadataCatalog.get(name).as_dict() == jax_data.MetadataCatalog.get(name).as_dict(), name
    for name in stuffonly:
        meta = MetadataCatalog.get(name)
        assert meta.evaluator_type == "sem_seg" and meta.ignore_label == 255 and len(meta.stuff_classes) == 54
    assert MetadataCatalog.get("coco_2017_val_100_panoptic_stuffonly").sem_seg_root.endswith("coco/panoptic_stuff_val2017_100")
    assert len(MetadataCatalog.get("ade20k_sem_seg_val").stuff_classes) == 150


def test_stuffonly_is_registered_beside_the_separated_set(tree):
    """Correction (a): d2 registers ``{name}_stuffonly``; the JAX function
    registers only ``{name}_separated``, so the JAX package's semantic yamls
    name a dataset it lacks."""
    from detectron2_tpu.config import get_cfg as jax_get_cfg

    jax_cfg = jax_get_cfg()
    jax_cfg.merge_from_file(os.path.join(REPO, "configs", "Misc/semantic_R_50_FPN_1x.yaml"))
    assert jax_cfg.DATASETS.TRAIN == ("coco_2017_train_panoptic_stuffonly",)
    for name in (jax_cfg.DATASETS.TRAIN[0], NAME + "_stuffonly"):
        assert name not in jax_data.DatasetCatalog.list()
        with pytest.raises(KeyError):
            jax_data.DatasetCatalog.get(name)
    assert NAME + "_separated" in jax_data.DatasetCatalog.list()
    dicts = DatasetCatalog.get(NAME + "_stuffonly")
    val = tree["val"]
    assert dicts == jax_coco.load_sem_seg(val["stuff_root"], val["images"]) and len(dicts) == 6
    assert MetadataCatalog.get(NAME + "_stuffonly").evaluator_type == "sem_seg"


def test_loaders_equal_jax(tree):
    val, val_100 = tree["val"], tree["val_100"]
    assert load_sem_seg(val["stuff_root"], val["images"]) == jax_coco.load_sem_seg(val["stuff_root"], val["images"])
    small = load_sem_seg(val_100["stuff_root"], val_100["images"])
    assert small == jax_coco.load_sem_seg(val_100["stuff_root"], val_100["images"]) and len(small) == 4
    meta = _get_builtin_metadata("coco_panoptic_standard")
    std = load_coco_panoptic_json(val["panoptic_json"], val["images"], val["panoptic_root"], meta)
    assert std == jax_pan.load_coco_panoptic_json(val["panoptic_json"], val["images"], val["panoptic_root"], jax_builtin_meta("coco_panoptic_standard"))
    assert any(s["isthing"] for d in std for s in d["segments_info"]) and any(not s["isthing"] for d in std for s in d["segments_info"])
    sep = DatasetCatalog.get(NAME + "_separated")
    ref = jax_data.DatasetCatalog.get(NAME + "_separated")
    assert _plain(sep) == _plain(ref) and all("sem_seg_file_name" in d and d["annotations"] for d in sep)
    assert DatasetCatalog.get(NAME) == jax_data.DatasetCatalog.get(NAME)


def test_panoptic_png_reads_as_cv2(tree):
    cv2 = pytest.importorskip("cv2")
    root = tree["val"]["panoptic_root"]
    for f in sorted(os.listdir(root)):
        ours = read_png(os.path.join(root, f))
        np.testing.assert_array_equal(ours, cv2.imread(os.path.join(root, f), cv2.IMREAD_COLOR)[:, :, ::-1])
        assert rgb2id(ours).max() > 1


def _mappers(is_train):
    aug = [T.ResizeShortestEdge((64, 64), 100)] + ([T.RandomFlip(prob=1.0)] if is_train else [])
    jaug = [JT.ResizeShortestEdge((64, 64), 100)] + ([JT.RandomFlip(prob=1.0)] if is_train else [])
    kw = {"image_format": "BGR", "use_instance_mask": True}
    return DatasetMapper(is_train, augmentations=aug, **kw), JaxMapper(is_train, augmentations=jaug, **kw)


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_and_collator_sem_seg_equal_jax(tree, is_train):
    ours_mapper, jax_mapper = _mappers(is_train)
    dicts = DatasetCatalog.get(NAME + "_separated")[:3]
    ours = [ours_mapper(d) for d in dicts]
    ref = [jax_mapper(copy.deepcopy(d)) for d in jax_data.DatasetCatalog.get(NAME + "_separated")[:3]]
    for o, r in zip(ours, ref):
        assert o["sem_seg"].dtype == r["sem_seg"].dtype == np.int64
        np.testing.assert_array_equal(o["sem_seg"], r["sem_seg"])
        np.testing.assert_array_equal(o["image"], r["image"])
        assert o["sem_seg"].shape == o["image"].shape[:2] and set(np.unique(o["sem_seg"])) <= set(range(54)) | {255}
    batch = PaddedBatchCollator(with_sem_seg=True, mask_size=28 if is_train else 0)(ours)
    jbatch = JaxCollator(with_sem_seg=True, mask_size=28 if is_train else 0)([{**r, "image": r["image"].astype(np.float32)} for r in ref])
    assert batch["gt_sem_seg"].dtype == torch.int32 and batch["gt_sem_seg"].shape == batch["image"].shape[:3]
    np.testing.assert_array_equal(batch["gt_sem_seg"].numpy(), jbatch["gt_sem_seg"])
    assert (batch["gt_sem_seg"][1, ours[1]["sem_seg"].shape[0]:] == 255).all()
    assert "gt_sem_seg" not in PaddedBatchCollator()(ours)


def _eval_inputs(tree, seed, identity=False):
    """Per image: the batch dict the evaluators take and ``[1, H, W, 54]``
    logits, random (``identity``: at the original size, else at a resized
    frame padded to a multiple of 32)."""
    rng = np.random.RandomState(seed)
    out = []
    for d in DatasetCatalog.get(NAME + "_stuffonly"):
        h, w = read_png(d["sem_seg_file_name"]).shape
        ih, iw = (h, w) if identity else (int(h * 0.6), int(w * 0.6))
        H, W = (ih, iw) if identity else (-(-ih // 32) * 32, -(-iw // 32) * 32)
        low = rng.standard_normal((1, -(-ih // 8), -(-iw // 8), 54)).astype(np.float32)
        logits = np.zeros((1, H, W, 54), np.float32)
        logits[:, :ih, :iw] = low.repeat(8, 1).repeat(8, 2)[:, :ih, :iw] + 0.3 * rng.standard_normal((1, ih, iw, 54))
        meta = [{"file_name": d["file_name"], "height": h, "width": w, "image_id": 0}]
        out.append(({"image_sizes": np.array([[ih, iw]], np.int32), "metadata": meta}, logits))
    return out


def _same_results(ours, ref):
    assert list(ours) == list(ref)
    for task in ref:
        assert list(ours[task]) == list(ref[task]), task
        for k, v in ref[task].items():
            assert (np.isnan(v) and np.isnan(ours[task][k])) or abs(ours[task][k] - v) <= 1e-12, (task, k, ours[task][k], v)


@pytest.mark.parametrize("identity", [True, False])
def test_sem_seg_evaluator_equals_jax(tree, identity):
    ours, ref = SemSegEvaluator(NAME + "_stuffonly"), JaxSemSegEvaluator.__new__(JaxSemSegEvaluator)
    ref.__init__(NAME + "_separated", distributed=False)  # the JAX package has no _stuffonly: same records and classes
    ref.input_file_to_gt_file = dict(ours.input_file_to_gt_file)
    ours.reset(), ref.reset()
    for inputs, logits in _eval_inputs(tree, seed=1, identity=identity):
        ours.process(inputs, {"sem_seg": torch.from_numpy(logits)})
        ref.process(inputs, {"sem_seg": logits})
    res = ours.evaluate()
    _same_results(res, ref.evaluate())
    assert 0 < res["sem_seg"]["mIoU"] < 100 and len(res["sem_seg"]) == 4 + 2 * 54


def test_sem_seg_ground_truth_gives_miou_100_and_height_falls_back(tree):
    """The labels as one-hot logits: mIoU, fwIoU, mACC, pACC 100. Without
    height and width in the metadata (``load_sem_seg``'s records have none)
    the JAX ``process`` raises and the port's takes the batch's size
    (correction (d))."""
    ours = SemSegEvaluator(NAME + "_stuffonly")
    ref = JaxSemSegEvaluator(NAME + "_separated", distributed=False)
    ours.reset(), ref.reset()
    for d in DatasetCatalog.get(NAME + "_stuffonly"):
        gt = read_png(d["sem_seg_file_name"]).astype(np.int64)
        h, w = gt.shape
        logits = np.zeros((1, h, w, 54), np.float32)
        np.put_along_axis(logits[0], np.where(gt == 255, 0, gt)[..., None], 1.0, axis=-1)
        inputs = {"image_sizes": np.array([[h, w]], np.int32), "metadata": [{"file_name": d["file_name"]}]}
        with pytest.raises(KeyError, match="height"):
            ref.process(inputs, {"sem_seg": logits})
        ours.process(inputs, {"sem_seg": torch.from_numpy(logits)})
    res = ours.evaluate()["sem_seg"]
    assert (res["mIoU"], res["fwIoU"], res["mACC"], res["pACC"]) == (100.0, 100.0, 100.0, 100.0)


def _panoptic_predictions(tree, perturb_seed=None):
    """The ground truth as the model's fused outputs (contiguous ids with
    ``isthing``), optionally perturbed: a segment dropped to void, a
    category changed, one segment grown into another."""
    meta = _get_builtin_metadata("coco_panoptic_separated")
    thing_map, stuff_map = meta["thing_dataset_id_to_contiguous_id"], meta["stuff_dataset_id_to_contiguous_id"]
    rng = None if perturb_seed is None else np.random.RandomState(perturb_seed)
    with open(tree["val"]["panoptic_json"]) as f:
        anns = json.load(f)["annotations"]
    batches = []
    for ann in anns:
        pan = rgb2id(read_png(os.path.join(tree["val"]["panoptic_root"], ann["file_name"])))
        info = []
        for s in ann["segments_info"]:
            isthing = s["category_id"] in thing_map
            info.append({"id": s["id"], "isthing": isthing,
                         "category_id": (thing_map if isthing else stuff_map)[s["category_id"]]})
        if rng is not None and len(info) > 2:
            drop, change, grow = rng.choice(len(info), 3, replace=False)
            pan = np.where(pan == info[drop]["id"], 0, pan)
            info[change]["category_id"] = (info[change]["category_id"] + 1) % (80 if info[change]["isthing"] else 54)
            if not info[change]["isthing"]:
                info[change]["category_id"] = max(info[change]["category_id"], 1)
            ys, xs = np.nonzero(pan == info[grow]["id"])
            if len(ys):
                pan[max(ys.min() - 3, 0) : ys.max() + 4, max(xs.min() - 3, 0) : xs.max() + 4] = info[grow]["id"]
            info = [s for i, s in enumerate(info) if i != drop]
        batches.append(({"metadata": [{"image_id": ann["image_id"]}]}, {"panoptic_seg": [(pan.astype(np.int32), info)]}))
    return batches


@pytest.mark.parametrize("perturb", [None, 3, 4])
def test_panoptic_evaluator_equals_jax(tree, perturb):
    ours, ref = COCOPanopticEvaluator(NAME + "_separated"), JaxPanopticEvaluator(NAME + "_separated")
    ours.reset(), ref.reset()
    for inputs, outputs in _panoptic_predictions(tree, perturb):
        ours.process(inputs, outputs)
        ref.process(inputs, copy.deepcopy(outputs))
    res = ours.evaluate()
    _same_results(res, ref.evaluate())
    if perturb is None:
        assert all(res["panoptic_seg"][k] == 100.0 for k in ("PQ", "SQ", "RQ", "PQ_th", "PQ_st"))
    else:
        assert 0 < res["panoptic_seg"]["PQ"] < 100


def _jax_train_net():
    spec = importlib.util.spec_from_file_location("jax_tools_train_net", os.path.join(REPO, "tools", "train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_build_evaluator_gives_panoptic_and_semantic_sets_their_evaluators(tree, tmp_path):
    """Correction (b), both behaviours."""
    from detectron2_tpu.config import get_cfg as jax_get_cfg
    from detectron2_tpu_torch.tools.train_net import build_evaluator

    cfg = golden_panoptic_config()
    ev = build_evaluator(cfg, NAME + "_separated", output_folder=str(tmp_path))
    assert isinstance(ev, DatasetEvaluators)
    assert [type(e).__name__ for e in ev._evaluators] == ["SemSegEvaluator", "COCOEvaluator", "COCOPanopticEvaluator"]
    assert type(build_evaluator(cfg, NAME + "_stuffonly", output_folder=str(tmp_path))).__name__ == "SemSegEvaluator"

    jax_train_net = _jax_train_net()
    jax_ev = jax_train_net.build_evaluator(jax_get_cfg(), NAME + "_separated", output_folder=str(tmp_path))
    assert type(jax_ev).__name__ == "COCOEvaluator"
    jax_data.MetadataCatalog.get("synth_jax_sem_seg").set(evaluator_type="sem_seg")
    with pytest.raises(NotImplementedError, match="sem_seg"):
        jax_train_net.build_evaluator(jax_get_cfg(), "synth_jax_sem_seg", output_folder=str(tmp_path))


def _write_ade20k(root, n=3):
    rng = np.random.RandomState(5)
    for split in ("training", "validation"):
        img_dir = os.path.join(root, "ADEChallengeData2016", "images", split)
        gt_dir = os.path.join(root, "ADEChallengeData2016", "annotations_detectron2", split)
        os.makedirs(img_dir), os.makedirs(gt_dir)
        for i in range(n):
            write_png(os.path.join(img_dir, f"ADE_{split}_{i:08d}.jpg"), rng.randint(0, 256, (64, 80, 3)).astype(np.uint8))
            write_png(os.path.join(gt_dir, f"ADE_{split}_{i:08d}.png"), rng.randint(0, 150, (64, 80)).astype(np.uint8))


def _env(root):
    return {**os.environ, "DETECTRON2_DATASETS": root, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


_BUILTIN_AND_EVALUATORS = r"""
import json, sys
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.config import LazyConfig, instantiate
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.tools.train_net import build_evaluator

out = {"sizes": {n: len(DatasetCatalog.get(n)) for n in (
    "coco_2017_val_100_panoptic_separated", "coco_2017_val_panoptic_stuffonly", "coco_2017_val_100_panoptic_stuffonly",
    "coco_2017_train_panoptic_separated", "coco_2017_val_panoptic", "ade20k_sem_seg_val")}}
for config in json.loads(sys.argv[1]):
    cfg = model_zoo.get_config(config)
    name = cfg.DATASETS.TEST[0]
    ev = build_evaluator(cfg, name, output_folder="")
    out[config] = [name] + [type(e).__name__ for e in getattr(ev, "_evaluators", [ev])]
lazy = LazyConfig.load("configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.py")
out["lazy"] = [type(e).__name__ for e in instantiate(lazy.dataloader.evaluator)]
print(json.dumps(out))
"""

PANOPTIC_YAMLS = ["COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml", "quick_schedules/panoptic_fpn_R_50_instant_test.yaml"]
SEMANTIC_YAMLS = ["Misc/semantic_R_50_FPN_1x.yaml", "quick_schedules/semantic_R_50_FPN_instant_test.yaml"]


@pytest.fixture(scope="module")
def datasets_root(tree):
    _write_ade20k(tree["root"])
    return tree["root"]


def test_builtin_sets_load_and_the_yamls_get_their_evaluators(datasets_root):
    proc = subprocess.run(
        [sys.executable, "-c", _BUILTIN_AND_EVALUATORS, json.dumps(PANOPTIC_YAMLS + SEMANTIC_YAMLS)],
        env=_env(datasets_root), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["sizes"] == {
        "coco_2017_val_100_panoptic_separated": 4, "coco_2017_val_panoptic_stuffonly": 6,
        "coco_2017_val_100_panoptic_stuffonly": 4, "coco_2017_train_panoptic_separated": 6,
        "coco_2017_val_panoptic": 6, "ade20k_sem_seg_val": 3,
    }
    three = ["SemSegEvaluator", "COCOEvaluator", "COCOPanopticEvaluator"]
    assert out[PANOPTIC_YAMLS[0]] == ["coco_2017_val_panoptic_separated"] + three
    assert out[PANOPTIC_YAMLS[1]] == ["coco_2017_val_100_panoptic_separated"] + three
    assert out[SEMANTIC_YAMLS[0]] == ["coco_2017_val_panoptic_stuffonly", "SemSegEvaluator"]
    assert out[SEMANTIC_YAMLS[1]] == ["coco_2017_val_100_panoptic_stuffonly", "SemSegEvaluator"]
    assert out["lazy"] == ["COCOEvaluator", "SemSegEvaluator", "COCOPanopticEvaluator"]


def test_eval_only_command_lines_on_the_builtin_panoptic_val(datasets_root, tmp_path):
    """``tools/train_net.py --eval-only`` of a tiny PanopticFPN on the
    builtin val_100 set, and ``lazyconfig_train_net --eval-only`` of
    ``panoptic_fpn_R_50_1x.py`` on the builtin val set: seeded weights, every
    evaluator's table."""
    cfg = golden_panoptic_config()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.0
    cfg.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 64
    cfg.DATASETS.TEST = ("coco_2017_val_100_panoptic_separated",)
    config = tmp_path / "panoptic_r18.yaml"
    config.write_text(cfg.dump())
    cmd = [
        sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config), "--eval-only",
        "MODEL.DEVICE", "cpu", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128", "OUTPUT_DIR", str(tmp_path / "out"),
    ]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=_env(datasets_root), capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    for task in ("bbox", "segm", "sem_seg", "panoptic_seg"):
        assert f"copypaste: Task: {task}" in log, task
    assert "copypaste: mIoU,fwIoU,mACC,pACC" in log and "copypaste: PQ,SQ,RQ,PQ_th,SQ_th,RQ_th,PQ_st,SQ_st,RQ_st" in log
    assert os.path.exists(tmp_path / "out" / "inference" / "sem_seg_evaluation.json")

    aug = "dataloader.test.mapper.augmentations.0"
    cmd = [
        sys.executable, "-m", "detectron2_tpu_torch.tools.lazyconfig_train_net", "--config-file",
        os.path.join(REPO, "configs", "COCO-PanopticSegmentation", "panoptic_fpn_R_50_1x.py"), "--eval-only",
        "train.device=cpu", "train.init_checkpoint=", f"train.output_dir={tmp_path / 'lazy'}",
        f"{aug}.short_edge_length=64", f"{aug}.max_size=96",
    ]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=_env(datasets_root), capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    for task in ("bbox", "segm", "sem_seg", "panoptic_seg"):
        assert f"copypaste: Task: {task}" in log, task
