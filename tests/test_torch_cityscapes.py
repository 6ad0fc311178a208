"""The port's Cityscapes data and evaluation against the JAX package's, on
the CPU, on a synthetic Cityscapes tree (``testing.
write_synthetic_cityscapes`` at 96 x 192: PNG images, polygon jsons,
``labelIds`` and ``labelTrainIds`` PNGs).

- ``load_cityscapes_instances`` and ``load_cityscapes_semantic`` ``==`` the
  JAX loaders (crowds written ``cargroup`` kept as crowds, ``"car group"``,
  deleted objects, stuff and two-point polygons skipped, as there; the
  ``labelIds`` fallback where a ``labelTrainIds`` file is missing); the
  nine builtin ``cityscapes_fine_{instance_seg,sem_seg}_{train,val,test}``
  names have the JAX package's metadata and paths.
- ``CityscapesInstanceEvaluator`` and ``CityscapesSemSegEvaluator``: the
  same padded outputs give the JAX evaluators' results to 1e-9, the JAX
  ones given ``annotations`` and ``sem_seg_file_name`` in the metadata, the
  port's reading the dataset's records and the image's
  ``*_gtFine_labelIds.png``; without those keys (what the loaders give) the
  JAX evaluators raise or score no ground truth; the labels fed back give
  IoU 100.
- The eleventh correction of the reference (ROADMAP C): ``build_evaluator``
  gives ``cityscapes_instance`` sets CityscapesInstanceEvaluator and
  ``cityscapes_sem_seg`` sets CityscapesSemSegEvaluator, as d2's
  ``train_net``; the JAX ``tools/train_net.py`` raises ``NotImplementedError``.
- ``Cityscapes/mask_rcnn_R_50_FPN.yaml`` builds and names registered sets;
  the train loader's batches of a Cityscapes set train a tiny Mask R-CNN;
  and, with ``DETECTRON2_DATASETS`` set to the tree in a subprocess,
  ``train_net --eval-only`` of a tiny model on
  ``cityscapes_fine_instance_seg_val`` prints the segm AP and AP50.
"""

import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import detectron2_tpu.data.datasets  # noqa: F401  (the JAX builtin names)
from detectron2_tpu import data as jax_data
from detectron2_tpu.data.datasets import cityscapes as jax_cityscapes
from detectron2_tpu.evaluation import cityscapes_evaluation as jax_eval
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader
from detectron2_tpu_torch.data.datasets import load_cityscapes_instances, load_cityscapes_semantic, register_cityscapes
from detectron2_tpu_torch.data.detection_utils import read_image
from detectron2_tpu_torch.evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from detectron2_tpu_torch.evaluation.cityscapes_evaluation import CITYSCAPES_ID_TO_TRAINID
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.structures import BoxMode
from detectron2_tpu_torch.testing import golden_r18_config, write_synthetic_cityscapes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (96, 192)
INST, SEM = "synth_cityscapes_val_inst", "synth_cityscapes_val_sem"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    out = write_synthetic_cityscapes(root, 4, seed=0, n_val=3, size=SIZE, max_objects=6)
    val = out["val"]
    for register in (register_cityscapes, jax_cityscapes.register_cityscapes):
        register(INST, val["image_dir"], val["gt_dir"], instances=True)
        register(SEM, val["image_dir"], val["gt_dir"], instances=False)
    register_cityscapes("synth_cityscapes_train_inst", out["train"]["image_dir"], out["train"]["gt_dir"])
    return out


def _plain(x):
    """Records with enums as ints and numpy scalars as floats."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, BoxMode) or type(x).__name__ == "BoxMode":
        return int(x.value)
    return float(x) if isinstance(x, np.floating) else x


@pytest.mark.parametrize("split", ["train", "val"])
def test_loaders_equal_jax(tree, split):
    d = tree[split]
    ours = load_cityscapes_instances(d["image_dir"], d["gt_dir"])
    ref = jax_cityscapes.load_cityscapes_instances(d["image_dir"], d["gt_dir"])
    assert _plain(ours) == _plain(ref)
    assert load_cityscapes_semantic(d["image_dir"], d["gt_dir"]) == jax_cityscapes.load_cityscapes_semantic(
        d["image_dir"], d["gt_dir"]
    )
    # what the loader keeps of the polygons written
    for rec in ours:
        city = os.path.basename(os.path.dirname(rec["file_name"]))
        stem = os.path.basename(rec["file_name"])[: -len("leftImg8bit.png")]
        with open(os.path.join(d["gt_dir"], city, stem + "gtFine_polygons.json")) as f:
            objects = json.load(f)["objects"]
        kept = [
            o for o in objects
            if not o.get("deleted") and len(o["polygon"]) >= 3
            and (o["label"][:-5] if o["label"].endswith("group") else o["label"]) in jax_cityscapes.CITYSCAPES_THING_CLASSES
        ]
        assert len(rec["annotations"]) == len(kept) and (rec["height"], rec["width"]) == SIZE
        assert [a["iscrowd"] for a in rec["annotations"]] == [int(o["label"].endswith("group")) for o in kept]
        assert rec["image_id"] == os.path.basename(rec["file_name"])
    labels = []
    for rec in ours:
        with open(_polygons(d, rec)) as f:
            labels += [o["label"] for o in json.load(f)["objects"]]
    assert {"car group", "sky"} <= set(labels) and any(lab.endswith("group") and " " not in lab for lab in labels)
    assert any(a["iscrowd"] for rec in ours for a in rec["annotations"]) or split == "val"


def _polygons(d, rec):
    city = os.path.basename(os.path.dirname(rec["file_name"]))
    return os.path.join(d["gt_dir"], city, os.path.basename(rec["file_name"]).replace("leftImg8bit.png", "gtFine_polygons.json"))


def test_semantic_falls_back_to_label_ids(tree, tmp_path):
    d = tree["val"]
    image_dir, gt_dir = str(tmp_path / "img"), str(tmp_path / "gt")
    shutil.copytree(d["image_dir"], image_dir)
    shutil.copytree(d["gt_dir"], gt_dir)
    first = load_cityscapes_semantic(image_dir, gt_dir)[0]["sem_seg_file_name"]
    os.remove(first)
    ours = load_cityscapes_semantic(image_dir, gt_dir)
    assert ours == jax_cityscapes.load_cityscapes_semantic(image_dir, gt_dir)
    assert ours[0]["sem_seg_file_name"].endswith("_gtFine_labelIds.png")
    assert ours[1]["sem_seg_file_name"].endswith("_gtFine_labelTrainIds.png")


def test_builtin_registrations_equal_jax():
    names = {f"cityscapes_fine_{task}_{split}" for task in ("instance_seg", "sem_seg") for split in ("train", "val", "test")}
    # the port also registers d2's panoptic splits (ROADMAP C, correction 20)
    panoptic = {f"cityscapes_fine_panoptic_{split}" for split in ("train", "val")}
    assert {x for x in DatasetCatalog.list() if x.startswith("cityscapes")} == names | panoptic
    assert {x for x in jax_data.DatasetCatalog.list() if x.startswith("cityscapes")} == names
    for name in sorted(names):
        assert MetadataCatalog.get(name).as_dict() == jax_data.MetadataCatalog.get(name).as_dict(), name
    meta = MetadataCatalog.get("cityscapes_fine_instance_seg_val")
    assert meta.evaluator_type == "cityscapes_instance" and len(meta.thing_classes) == 8
    assert meta.gt_dir.endswith("cityscapes/gtFine/val/")
    assert MetadataCatalog.get("cityscapes_fine_sem_seg_train").evaluator_type == "cityscapes_sem_seg"


def _instance_outputs(records, seed, D=12, M=28):
    """Padded detections over the gt boxes (integer corners, shifted, some
    classes changed) with box-shaped masks, one slot left invalid; the
    network frame at the original size."""
    rng = np.random.RandomState(seed)
    B = len(records)
    out = {
        "pred_boxes": np.zeros((B, D, 4), np.float32),
        "scores": rng.rand(B, D).astype(np.float32),
        "pred_classes": rng.randint(0, 8, (B, D)).astype(np.int64),
        "valid": np.zeros((B, D), bool),
        "pred_masks": np.ones((B, D, M, M), np.float32),
    }
    for i, rec in enumerate(records):
        annos = rec["annotations"][:D - 1]
        for k, a in enumerate(annos):
            box = np.round(np.asarray(a["bbox"], np.float64)) + rng.randint(-2, 3, 4)
            out["pred_boxes"][i, k] = np.clip(box, 0, [SIZE[1], SIZE[0]] * 2)
            if rng.rand() < 0.7:
                out["pred_classes"][i, k] = a["category_id"]
            out["valid"][i, k] = True
        out["pred_masks"][i, :, M // 2 :, : M // 3] = 0.0
    return out


def _inputs(records, metadata_keys):
    return {
        "image_sizes": np.tile(np.asarray([SIZE], np.int32), (len(records), 1)),
        "metadata": [{k: r[k] for k in metadata_keys if k in r} for r in records],
    }


def _run(evaluator, inputs, outputs, torch_outputs):
    evaluator.reset()
    evaluator.process(inputs, {k: torch.from_numpy(v) for k, v in outputs.items()} if torch_outputs else outputs)
    return evaluator.evaluate()


def _close(ours, ref):
    assert ours.keys() == ref.keys()
    for task in ref:
        assert ours[task].keys() == ref[task].keys()
        for k, v in ref[task].items():
            assert abs(ours[task][k] - v) <= 1e-9, (task, k, ours[task][k], v)


@pytest.mark.parametrize("seed", [0, 1])
def test_instance_evaluator_equals_jax(tree, seed):
    records = DatasetCatalog.get(INST)
    outputs = _instance_outputs(records, seed)
    full = _inputs(records, ("image_id", "file_name", "height", "width", "annotations"))
    ref = _run(jax_eval.CityscapesInstanceEvaluator(INST), copy.deepcopy(full), outputs, False)
    ours = _run(CityscapesInstanceEvaluator(INST), copy.deepcopy(full), outputs, True)
    _close(ours, ref)
    assert 0 < ref["segm"]["AP"] < 100 and 0 < ref["segm"]["AP50"] <= 100
    # what the loader gives: no annotations in the metadata
    loop = _inputs(records, ("image_id", "file_name", "height", "width"))
    _close(_run(CityscapesInstanceEvaluator(INST), loop, outputs, True), ref)
    jax_loop = _run(jax_eval.CityscapesInstanceEvaluator(INST), copy.deepcopy(loop), outputs, False)
    assert jax_loop["segm"]["AP"] < 0  # the JAX evaluator scores no ground truth (COCOeval's -1)


def _sem_seg_outputs(records, seed, fed_back):
    """``[B, H, W, 19]`` logits in a padded frame 8 pixels larger; with
    ``fed_back`` one-hot of each image's train ids."""
    rng = np.random.RandomState(seed)
    h, w = SIZE
    logits = rng.standard_normal((len(records), h + 8, w + 8, 19)).astype(np.float32)
    if fed_back:
        for i, rec in enumerate(records):
            gt = _label_ids(rec["file_name"])
            train = np.full(gt.shape, -1)
            for lid, tid in CITYSCAPES_ID_TO_TRAINID.items():
                train[gt == lid] = tid
            logits[i, :h, :w] = np.where(train[..., None] == np.arange(19), 10.0, 0.0)
    return {"sem_seg": logits}


def _label_ids(file_name):
    city = os.path.basename(os.path.dirname(file_name))
    gt_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(file_name)))), "gtFine", "val")
    name = os.path.basename(file_name).replace("leftImg8bit.png", "gtFine_labelIds.png")
    return read_image(os.path.join(gt_dir, city, name), "L")[..., 0]


@pytest.mark.parametrize("fed_back", [False, True])
def test_sem_seg_evaluator_equals_jax(tree, fed_back):
    records = DatasetCatalog.get(SEM)
    outputs = _sem_seg_outputs(records, seed=3, fed_back=fed_back)
    # the JAX evaluator reads the file and the size from the metadata
    full = _inputs(records, ("file_name",))
    for meta, rec in zip(full["metadata"], records):
        meta.update(height=SIZE[0], width=SIZE[1], sem_seg_file_name=rec["sem_seg_file_name"].replace("labelTrainIds", "labelIds"))
    ref = _run(jax_eval.CityscapesSemSegEvaluator(SEM), copy.deepcopy(full), outputs, False)
    _close(_run(CityscapesSemSegEvaluator(SEM), full, outputs, True), ref)
    # what the loader gives: the port finds the labelIds file and the size
    loop = _inputs(records, ("file_name",))
    _close(_run(CityscapesSemSegEvaluator(SEM), loop, outputs, True), ref)
    with pytest.raises(KeyError):
        _run(jax_eval.CityscapesSemSegEvaluator(SEM), copy.deepcopy(loop), outputs, False)
    if fed_back:
        assert ref["sem_seg"]["IoU"] == 100.0
    else:
        assert 0 < ref["sem_seg"]["IoU"] < 20


def _jax_train_net():
    spec = importlib.util.spec_from_file_location("jax_tools_train_net", os.path.join(REPO, "tools", "train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize(
    "name, evaluator",
    [("cityscapes_fine_instance_seg_val", "CityscapesInstanceEvaluator"),
     ("cityscapes_fine_sem_seg_val", "CityscapesSemSegEvaluator")],
)
def test_build_evaluator_gives_cityscapes_sets_their_evaluator(name, evaluator, tmp_path):
    """The eleventh correction, both behaviours."""
    from detectron2_tpu.config import get_cfg as jax_get_cfg
    from detectron2_tpu_torch.tools.train_net import build_evaluator

    assert type(build_evaluator(get_cfg(), name, output_folder=str(tmp_path))).__name__ == evaluator
    with pytest.raises(NotImplementedError, match=MetadataCatalog.get(name).evaluator_type):
        _jax_train_net().build_evaluator(jax_get_cfg(), name, output_folder=str(tmp_path))


def test_yaml_builds_and_names_registered_sets():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "Cityscapes", "mask_rcnn_R_50_FPN.yaml"))
    assert cfg.DATASETS.TRAIN == ("cityscapes_fine_instance_seg_train",)
    assert set(cfg.DATASETS.TRAIN + cfg.DATASETS.TEST) <= set(DatasetCatalog.list())
    model = build_model(cfg, device="cpu")
    assert model.roi_heads.box_predictor.num_classes == 8 and model.roi_heads.mask_head is not None


def tiny_cityscapes_cfg():
    cfg = golden_r18_config()
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 200, 100
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST, cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 200, 50
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (64, 80), 160
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 128
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


def test_train_loader_batches_train_a_tiny_model(tree):
    cfg = tiny_cityscapes_cfg()
    cfg.DATASETS.TRAIN = ("synth_cityscapes_train_inst",)
    batch = next(iter(build_detection_train_loader(cfg)))
    assert batch["gt_masks"].shape[:2] == batch["gt_valid"].shape and batch["gt_valid"].any()
    assert int(batch["gt_classes"][batch["gt_valid"]].max()) < 8
    model = build_model(cfg, device="cpu")
    losses = model({k: v for k, v in batch.items() if k != "metadata"}, train=True)
    assert set(losses) >= {"loss_mask", "loss_box_reg"} and all(torch.isfinite(v) for v in losses.values())


def test_eval_only_on_the_builtin_val(tree, tmp_path):
    """``tools/train_net.py --eval-only`` of a tiny Mask R-CNN (seeded
    weights) on ``cityscapes_fine_instance_seg_val`` under the tree."""
    cfg = tiny_cityscapes_cfg()
    cfg.DATASETS.TEST = ("cityscapes_fine_instance_seg_val",)
    config = tmp_path / "cityscapes_r18.yaml"
    config.write_text(cfg.dump())
    env = {**os.environ, "DETECTRON2_DATASETS": tree["root"], "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config), "--eval-only",
           "OUTPUT_DIR", str(tmp_path / "out")]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert "copypaste: Task: segm" in log and "copypaste: AP,AP50" in log
    line = log[log.index("copypaste: AP,AP50") :].splitlines()[1]
    ap, ap50 = (float(x) for x in line.split("copypaste: ")[1].split(","))
    assert np.isfinite(ap) and 0 <= ap <= ap50 <= 100
