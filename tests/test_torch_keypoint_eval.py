"""Keypoint evaluation end to end on the CPU: the synthetic person-keypoint
COCO of ``testing.write_synthetic_coco(keypoints=True)`` (17 keypoints per
person, visibility 0/1/2, the names in the json's category), AP 100 for the
ground truth fed back (bbox and keypoints), a tiny one-class Keypoint R-CNN
R18-FPN with the same weights in both packages (the keypoint golden's,
cut to one class) through the JAX
``DefaultTrainer.test`` (with ``tools/train_net.py``'s evaluator) and the
port's, and ``--eval-only`` in a subprocess.

Tolerances: classes equal, scores rtol 1e-4 / atol 1e-5, boxes 1e-3 px;
keypoint x, y within one bin of the 4x-upsampled heatmap (the decode's
argmax may tie to the float32 ulp, ``tests/test_torch_keypoint.py``) and
within 1e-3 px on at least 97% of them, scores (the keypoint probability)
1e-5; the AP dicts within 0.5 AP (a moved keypoint moves OKS).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import detectron2_tpu.data as jax_data
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
from detectron2_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_PERSON_KEYPOINT_FLIP_MAP, COCO_PERSON_KEYPOINT_NAMES
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.testing import golden_keypoint_config, golden_state_dict, ground_truth_detections, write_synthetic_coco

from _torch_port import jax_cfg_from_port, jax_model, jax_variables_from_d2, load_golden, port_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96


def _register(name, json_file, image_root):
    """In both packages, with the flip map the JAX mapper reads for
    keypoint models (d2's builtin COCO keypoint metadata)."""
    meta = {"keypoint_flip_map": COCO_PERSON_KEYPOINT_FLIP_MAP}
    if name not in DatasetCatalog:
        register_coco_instances(name, meta, json_file, image_root)
        DatasetCatalog.get(name)
    if name not in jax_data.DatasetCatalog:
        jax_coco.register_coco_instances(name, meta, json_file, image_root)
        jax_data.DatasetCatalog.get(name)


@pytest.fixture(scope="module")
def kpt_coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("kpt_coco")
    json_file, image_root = write_synthetic_coco(str(root), 6, seed=7, sizes=((SIZE, SIZE),), max_objects=4, keypoints=True)
    _register("kpt_synth", json_file, image_root)
    return json_file, image_root


def test_synthetic_keypoint_coco(kpt_coco):
    json_file, _ = kpt_coco
    with open(json_file) as f:
        coco = json.load(f)
    assert coco["categories"] == [{"id": 1, "name": "person", "keypoints": list(COCO_PERSON_KEYPOINT_NAMES), "skeleton": []}]
    assert MetadataCatalog.get("kpt_synth").keypoint_names == COCO_PERSON_KEYPOINT_NAMES
    seen = set()
    for ann in coco["annotations"]:
        assert ann["category_id"] == 1
        if ann["iscrowd"]:
            continue
        k = np.asarray(ann["keypoints"]).reshape(17, 3)
        seen |= set(k[:, 2].astype(int).tolist())
        assert ann["num_keypoints"] == (k[:, 2] > 0).sum() >= 1
        x0, y0, w, h = ann["bbox"]
        lab = k[:, 2] > 0
        assert (k[lab, 0] >= np.floor(x0)).all() and (k[lab, 0] <= x0 + w).all()
        assert (k[lab, 1] >= np.floor(y0)).all() and (k[lab, 1] <= y0 + h).all()
        assert (k[~lab, :2] == 0).all()
    assert seen == {0, 1, 2}


def test_ground_truth_keypoints_give_ap_100(kpt_coco):
    json_file, _ = kpt_coco
    dets = ground_truth_detections(json_file)
    assert all(len(d["keypoints"]) == 51 for d in dets)
    contiguous = MetadataCatalog.get("kpt_synth").thing_dataset_id_to_contiguous_id
    by_image = {}
    for d in dets:
        d["category_id"] = contiguous[d["category_id"]]
        by_image.setdefault(d["image_id"], []).append(d)
    for cls in (COCOEvaluator, JaxCOCOEvaluator):
        ev = cls("kpt_synth", distributed=False)
        ev.reset()
        ev._predictions = [{"image_id": k, "instances": v} for k, v in json.loads(json.dumps(by_image)).items()]
        for p in ev._predictions:
            p["image_id"] = int(p["image_id"])
        res = ev.evaluate()
        assert res["bbox"]["AP"] == 100.0 and res["keypoints"]["AP"] == 100.0, (cls, res)


def _kpt_cfg():
    cfg = golden_keypoint_config()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 1
    cfg.MODEL.DEVICE = "cpu"
    cfg.DATASETS.TEST = ("kpt_synth",)
    cfg.DATASETS.TRAIN = ("kpt_synth",)  # the JAX mapper's keypoint flip map comes from it
    cfg.INPUT.MIN_SIZE_TEST = SIZE
    cfg.INPUT.MAX_SIZE_TEST = SIZE
    cfg.OUTPUT_DIR = ""
    return cfg


def _one_class_weights():
    """The keypoint golden's weights with the predictor cut to its first
    class and the background: a one-class (person) Keypoint R-CNN."""
    sd = golden_state_dict(load_golden("e2e_keypointrcnn_r18"))
    for k in ("weight", "bias"):
        cls = sd[f"roi_heads.box_predictor.cls_score.{k}"]
        sd[f"roi_heads.box_predictor.cls_score.{k}"] = cls[[0, -1]]
        sd[f"roi_heads.box_predictor.bbox_pred.{k}"] = sd[f"roi_heads.box_predictor.bbox_pred.{k}"][:4]
    return sd


def _jax_train_net():
    spec = importlib.util.spec_from_file_location("jax_train_net", os.path.join(REPO, "tools", "train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_keypoint_default_trainer_test_matches_the_jax_package(kpt_coco):
    cfg = _kpt_cfg()
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, _one_class_weights())
    jax_cfg = jax_cfg_from_port(cfg)
    ref_ev = _jax_train_net().build_evaluator(jax_cfg, "kpt_synth", output_folder="")
    ref = JaxDefaultTrainer.test(jax_cfg, jm, evaluators=[ref_ev], params=variables)
    ev = COCOEvaluator("kpt_synth", distributed=False)
    ours = DefaultTrainer.test(cfg, port_model(cfg, variables), evaluators=[ev])
    n_det = n_kpt = n_exact = 0
    for a, b in zip(ev._predictions, ref_ev._predictions):
        assert a["image_id"] == b["image_id"]
        assert [x["category_id"] for x in a["instances"]] == [y["category_id"] for y in b["instances"]]
        if not a["instances"]:
            continue
        n_det += len(a["instances"])
        np.testing.assert_allclose([x["score"] for x in a["instances"]], [y["score"] for y in b["instances"]],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose([x["bbox"] for x in a["instances"]], [y["bbox"] for y in b["instances"]],
                                   rtol=0, atol=1e-3)
        for x, y in zip(a["instances"], b["instances"]):
            kx, ky = np.asarray(x["keypoints"]).reshape(17, 3), np.asarray(y["keypoints"]).reshape(17, 3)
            bin_px = max(y["bbox"][2], y["bbox"][3], 1.0) / 56 + 1e-3
            d = np.abs(kx[:, :2] - ky[:, :2]).max(axis=1)
            assert (d <= bin_px).all(), (d.max(), bin_px)
            n_kpt, n_exact = n_kpt + 17, n_exact + int((d <= 1e-3).sum())
            np.testing.assert_allclose(kx[:, 2], ky[:, 2], rtol=0, atol=1e-5)
    assert n_det > 6 and n_exact >= 0.97 * n_kpt, (n_det, n_exact, n_kpt)
    assert set(ours) == set(ref) == {"bbox", "keypoints"}
    for task in ours:
        assert list(ours[task]) == list(ref[task])
        for key in ref[task]:
            assert ours[task][key] == pytest.approx(ref[task][key], abs=0.5, nan_ok=True), (task, key)


def test_keypoint_eval_only_command_line_on_the_cpu(kpt_coco, tmp_path):
    """``train_net --eval-only`` with the keypoint config and no weights
    (seeded init, FrozenBN calibrated): prints bbox and keypoints AP."""
    config = tmp_path / "kpt.yaml"
    config.write_text(_kpt_cfg().dump())
    cmd = [
        sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config),
        "--dataset", "cli_kpt_synth", *kpt_coco, "--eval-only", "DATASETS.TEST", '("cli_kpt_synth",)',
        "OUTPUT_DIR", str(tmp_path / "out"),
    ]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    for task in ("bbox", "keypoints"):
        assert f"copypaste: Task: {task}" in log
    assert "copypaste: AP,AP50,AP75,APm,APl" in log
