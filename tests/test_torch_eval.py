"""The port's evaluation path against the JAX package's on the CPU:
COCOEvaluator's AP dicts on the same predictions (equal, NaN for NaN: both
run the same numpy), ``process`` on the same padded outputs, box proposals,
AP 100 for the ground truth fed back as detections, and the slice end to
end: a tiny R18-FPN Mask R-CNN with the same weights in both packages over
an 8-image synthetic COCO of 64x64 images, the JAX ``DefaultTrainer.test``
(with ``tools/train_net.py``'s evaluator) against the port's.

Tolerances of the end-to-end run are those of ``tests/test_torch_e2e.py``
(float32 on both sides): classes equal, scores rtol 1e-4 / atol 1e-5, boxes
atol 1e-3 px, and under 1e-4 of the mask pixels differing (the JAX package
pastes on the host in float64, the port on the device in float32); the AP
dicts within 0.01 AP. ``process`` on the same padded outputs gives equal
boxes, scores and classes, hence an equal bbox AP dict; segm within 0.01 AP.
The command-line entry point runs once, in a subprocess.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import detectron2_tpu.data as jax_data
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
from detectron2_tpu.evaluation import rle as jax_rle
from detectron2_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxCOCOEvaluator
from detectron2_tpu_torch.data import DatasetCatalog, DatasetMapper, MetadataCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator, instances_to_coco_json
from detectron2_tpu_torch.evaluation.coco_evaluation import _instances_to_host
from detectron2_tpu_torch.evaluation.rle import mask_to_rle, rle_to_mask
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.structures import BitMasks, Boxes, Instances
from detectron2_tpu_torch.testing import (
    golden_r18_config,
    golden_state_dict,
    ground_truth_detections,
    write_synthetic_coco,
)

from _torch_port import jax_cfg_from_port, jax_model, jax_variables_from_d2, load_golden, port_model

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


def _register(name, json_file, image_root):
    """Register in both packages and load once, which sets the category id
    maps the evaluators read (the test loader does that in a run)."""
    if name not in DatasetCatalog:
        register_coco_instances(name, {}, json_file, image_root)
        DatasetCatalog.get(name)
    if name not in jax_data.DatasetCatalog:
        jax_coco.register_coco_instances(name, {}, json_file, image_root)
        jax_data.DatasetCatalog.get(name)


@pytest.fixture(scope="module")
def coco_small(tmp_path_factory):
    """24 images at the four COCO sizes, registered in both packages."""
    root = tmp_path_factory.mktemp("coco_small")
    json_file, image_root = write_synthetic_coco(str(root), 24, seed=5)
    _register("eval_synth", json_file, image_root)
    return json_file, image_root


@pytest.fixture(scope="module")
def coco_tiny(tmp_path_factory):
    """8 images of 64x64 with up to 4 objects, registered in both packages."""
    root = tmp_path_factory.mktemp("coco_tiny")
    json_file, image_root = write_synthetic_coco(str(root), 8, seed=6, sizes=((SIZE, SIZE),), max_objects=4)
    _register("tiny_synth", json_file, image_root)
    return json_file, image_root


def _evaluate_both(name, predictions):
    results = []
    for cls in (COCOEvaluator, JaxCOCOEvaluator):
        ev = cls(name, distributed=False)
        ev.reset()
        ev._predictions = json.loads(json.dumps(predictions))
        results.append(ev.evaluate())
    return results


def _random_predictions(json_file, seed):
    """Jittered ground truth with some classes swapped, plus false
    positives; contiguous class ids, as the model gives them."""
    r = np.random.RandomState(seed)
    with open(json_file) as f:
        coco = json.load(f)
    contiguous = {c["id"]: i for i, c in enumerate(coco["categories"])}
    by_image = {im["id"]: [] for im in coco["images"]}
    for det in ground_truth_detections(json_file):
        x, y, w, h = det["bbox"]
        m = jax_rle.rle_to_mask(det["segmentation"])
        if r.rand() < 0.5:  # a mask one pixel off
            m = np.roll(m, 1, axis=int(r.randint(2)))
        rle = jax_rle.mask_to_rle(m)
        rle["counts"] = rle["counts"].decode("ascii")
        cat = contiguous[det["category_id"]] if r.rand() > 0.1 else int(r.randint(80))
        j = r.randn(4) * 2
        by_image[det["image_id"]].append({
            "image_id": det["image_id"], "category_id": cat, "score": float(r.rand()), "segmentation": rle,
            "bbox": [x + j[0], y + j[1], max(w + j[2], 1.0), max(h + j[3], 1.0)],
        })
    return [{"image_id": k, "instances": v} for k, v in by_image.items()]


def test_evaluator_gives_the_jax_ap_dicts_on_the_same_predictions(coco_small):
    ours, ref = _evaluate_both("eval_synth", _random_predictions(coco_small[0], 0))
    assert set(ours) == set(ref) == {"bbox", "segm"}
    for task in ours:
        assert list(ours[task]) == list(ref[task])
        np.testing.assert_equal(ours[task], ref[task])
    assert 0 < ours["bbox"]["AP"] < 100 and 0 < ours["segm"]["AP"] < 100


def test_ground_truth_as_detections_gives_ap_100(coco_small):
    json_file = coco_small[0]
    contiguous = MetadataCatalog.get("eval_synth").thing_dataset_id_to_contiguous_id
    by_image = {}
    for det in ground_truth_detections(json_file):
        det["category_id"] = contiguous[det["category_id"]]
        by_image.setdefault(det["image_id"], []).append(det)
    preds = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    ours, ref = _evaluate_both("eval_synth", preds)
    for task in ("bbox", "segm"):
        for key in ("AP", "AP50", "AP75", "APs", "APm", "APl"):
            assert ours[task][key] == ref[task][key] == 100.0, (task, key)


def _padded_outputs(seed, B=3, D=12, M=28, H=(480, 640, 427), W=(640, 480, 640)):
    """Padded detections of B images in a 1.5x network frame; some slots
    invalid, some boxes clipped to empty, masks of 28x28 probabilities."""
    r = np.random.RandomState(seed)
    image_sizes = np.array([[int(h * 1.5), int(w * 1.5)] for h, w in zip(H, W)], np.int32)
    xy = r.uniform(-20, 900, (B, D, 2))
    wh = r.uniform(2, 300, (B, D, 2))
    out = {
        "pred_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
        "scores": r.rand(B, D).astype(np.float32),
        "pred_classes": r.randint(0, 80, (B, D)).astype(np.int32),
        "valid": r.rand(B, D) > 0.2,
        "pred_masks": r.rand(B, D, M, M).astype(np.float32),
    }
    metadata = [{"image_id": i + 1, "height": h, "width": w} for i, (h, w) in enumerate(zip(H, W))]
    return {"image_sizes": image_sizes, "metadata": metadata}, out


def test_process_on_the_same_padded_outputs_matches_jax(coco_small):
    inputs, outputs = _padded_outputs(1)
    ev, ref_ev = COCOEvaluator("eval_synth", distributed=False), JaxCOCOEvaluator("eval_synth", distributed=False)
    ev.reset()
    ref_ev.reset()
    ev.process({**inputs, "image_sizes": torch.from_numpy(inputs["image_sizes"])},
               {k: torch.from_numpy(v) for k, v in outputs.items()})
    ref_ev.process(inputs, outputs)
    n_pixels = n_diff = 0
    for a, b in zip(ev._predictions, ref_ev._predictions):
        assert a["image_id"] == b["image_id"] and len(a["instances"]) == len(b["instances"]) > 0
        for x, y in zip(a["instances"], b["instances"]):
            assert (x["category_id"], x["bbox"], x["score"]) == (y["category_id"], y["bbox"], y["score"])
            mx, my = rle_to_mask(x["segmentation"]), jax_rle.rle_to_mask(y["segmentation"])
            n_pixels, n_diff = n_pixels + mx.size, n_diff + int((mx != my).sum())
    assert n_diff / n_pixels < 1e-4
    # one image's json alone, through the public function
    inst = detector_postprocess({k: torch.from_numpy(v[0]) for k, v in outputs.items()}, 480, 640, 720, 960)
    assert instances_to_coco_json(inst, 1) == ev._predictions[0]["instances"]
    ours, ref = ev.evaluate(), ref_ev.evaluate()
    np.testing.assert_equal(ours["bbox"], ref["bbox"])
    for key in ref["segm"]:
        assert ours["segm"][key] == pytest.approx(ref["segm"][key], abs=0.01, nan_ok=True), key


def test_device_rle_runs_equal_the_host_encoder():
    """``process`` finds each mask's column-major runs on the masks' device;
    the RLEs it makes equal ``mask_to_rle`` of both packages, mask by mask:
    empty and full masks, a first pixel set and not, one-pixel runs, and
    images of different sizes in one batch (one with no detections)."""
    r = np.random.RandomState(0)
    images = []
    for h, w, n in ((37, 53, 7), (64, 48, 5), (20, 30, 0)):
        masks = r.rand(n, h, w) < r.rand(n, 1, 1)  # densities from empty to full
        if n:
            masks[0] = False
            masks[1] = True
            masks[2] = r.rand(h, w) < 0.5  # many one-pixel runs
            masks[3, 0, 0], masks[4, 0, 0] = True, False
        inst = Instances(
            (h, w),
            pred_boxes=Boxes(torch.from_numpy(r.rand(n, 4).astype(np.float32))),
            scores=torch.from_numpy(r.rand(n).astype(np.float32)),
            pred_classes=torch.from_numpy(r.randint(0, 80, n)),
            pred_masks=BitMasks(torch.from_numpy(masks)),
        )
        images.append((inst, masks))
    hosts = _instances_to_host([inst for inst, _ in images])
    for host, (inst, masks) in zip(hosts, images):
        assert len(host["rles"]) == len(masks)
        for rle, m in zip(host["rles"], masks):
            ours, jax_ref = mask_to_rle(m), jax_rle.mask_to_rle(m)
            assert rle == {"size": ours["size"], "counts": ours["counts"].decode("utf-8")}
            assert rle == {"size": jax_ref["size"], "counts": jax_ref["counts"].decode("utf-8")}
            np.testing.assert_array_equal(rle_to_mask(rle), m)


def test_box_proposals_equal_the_jax_package(coco_small):
    r = np.random.RandomState(2)
    B, P = 3, 200
    xy = r.uniform(0, 900, (B, P, 2))
    outputs = {
        "proposal_boxes": np.concatenate([xy, xy + r.uniform(4, 400, (B, P, 2))], -1).astype(np.float32),
        "proposal_logits": r.randn(B, P).astype(np.float32),
        "valid": r.rand(B, P) > 0.1,
    }
    inputs, _ = _padded_outputs(0)
    results = []
    for cls, wrap in ((COCOEvaluator, torch.from_numpy), (JaxCOCOEvaluator, lambda a: a)):
        ev = cls("eval_synth", distributed=False)
        ev.reset()
        ev.process({**inputs, "image_sizes": wrap(inputs["image_sizes"])}, {k: wrap(v) for k, v in outputs.items()})
        results.append(ev.evaluate())
    assert set(results[0]) == {"box_proposals"} and results[0]["box_proposals"]["AR@1000"] > 0
    np.testing.assert_equal(results[0], results[1])


def _tiny_cfg(name):
    cfg = golden_r18_config()
    cfg.MODEL.DEVICE = "cpu"
    cfg.DATASETS.TEST = (name,)
    cfg.INPUT.MIN_SIZE_TEST = SIZE
    cfg.INPUT.MAX_SIZE_TEST = SIZE
    cfg.OUTPUT_DIR = ""
    return cfg


def _jax_train_net():
    spec = importlib.util.spec_from_file_location("jax_train_net", os.path.join(REPO, "tools", "train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_default_trainer_test_matches_the_jax_package(coco_tiny):
    """Golden R18-FPN weights (7 classes, mapped onto the first 7 COCO
    ids), the same in both packages."""
    golden = load_golden("e2e_maskrcnn_r18")
    cfg = _tiny_cfg("tiny_synth")
    jm = jax_model(cfg)
    variables = jax_variables_from_d2(jm, golden_state_dict(golden))
    jax_cfg = jax_cfg_from_port(cfg)
    ref_ev = _jax_train_net().build_evaluator(jax_cfg, "tiny_synth", output_folder="")
    ref = JaxDefaultTrainer.test(jax_cfg, jm, evaluators=[ref_ev], params=variables)

    ev = COCOEvaluator("tiny_synth", distributed=False)
    timing = {}
    ours = DefaultTrainer.test(cfg, port_model(cfg, variables), evaluators=[ev], timing=timing)
    assert timing["tiny_synth"]["batches"] == 8

    n_det = n_pixels = n_diff = 0
    for a, b in zip(ev._predictions, ref_ev._predictions):
        assert a["image_id"] == b["image_id"]
        assert [x["category_id"] for x in a["instances"]] == [y["category_id"] for y in b["instances"]]
        n_det += len(a["instances"])
        if not a["instances"]:
            continue
        np.testing.assert_allclose([x["score"] for x in a["instances"]], [y["score"] for y in b["instances"]],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose([x["bbox"] for x in a["instances"]], [y["bbox"] for y in b["instances"]],
                                   rtol=0, atol=1e-3)
        for x, y in zip(a["instances"], b["instances"]):
            mx, my = rle_to_mask(x["segmentation"]), jax_rle.rle_to_mask(y["segmentation"])
            n_pixels, n_diff = n_pixels + mx.size, n_diff + int((mx != my).sum())
    assert n_det > 8
    assert n_diff / n_pixels < 1e-4
    assert set(ours) == set(ref) == {"bbox", "segm"}
    for task in ours:
        assert list(ours[task]) == list(ref[task])
        for key in ref[task]:
            assert ours[task][key] == pytest.approx(ref[task][key], abs=0.01, nan_ok=True), (task, key)


def test_eval_only_command_line_on_the_cpu(coco_tiny, tmp_path):
    """``python -m detectron2_tpu_torch.tools.train_net --eval-only`` with
    ``MODEL.DEVICE cpu``, a d2 .pkl and a registered dataset prints the csv
    table and writes the predictions."""
    golden = load_golden("e2e_maskrcnn_r18")
    weights = tmp_path / "model.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": golden_state_dict(golden)}, f)
    config = tmp_path / "r18.yaml"
    config.write_text(golden_r18_config().dump())
    out_dir = tmp_path / "out"
    cmd = [
        sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config),
        "--dataset", "cli_synth", *coco_tiny, "--eval-only",
        "MODEL.WEIGHTS", str(weights), "MODEL.DEVICE", "cpu", "DATASETS.TEST", '("cli_synth",)',
        "INPUT.MIN_SIZE_TEST", str(SIZE), "INPUT.MAX_SIZE_TEST", str(SIZE), "OUTPUT_DIR", str(out_dir),
    ]
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    n = len(golden["weight_names"])
    assert f"Loaded {n}/{n} tensors from the checkpoint." in log
    for task in ("bbox", "segm"):
        assert f"copypaste: Task: {task}" in log
    assert "copypaste: AP,AP50,AP75,APs,APm,APl" in log
    assert (out_dir / "inference" / "instances_predictions.json").exists()
    assert (out_dir / "config.yaml").exists()


def test_eval_path_refuses_what_is_not_ported_or_not_asked(coco_tiny, tmp_path):
    cfg = _tiny_cfg("tiny_synth")
    # keypoint targets (keypoint training) wait for ROADMAP A7
    cfg.MODEL.KEYPOINT_ON = True
    with pytest.raises(NotImplementedError, match="A7"):
        DatasetMapper(cfg, True)
    from detectron2_tpu_torch.tools import train_net

    config = tmp_path / "r18.yaml"
    config.write_text(cfg.dump())
    args = train_net.argument_parser().parse_args(["--config-file", str(config), "DATASETS.TRAIN", '("tiny_synth",)'])
    with pytest.raises(NotImplementedError, match="A7"):
        train_net.main(args)
    # a CPU model while the config asks for the card: refused, not run
    cfg.MODEL.KEYPOINT_ON = False
    cfg.MODEL.DEVICE = "cuda"
    model = port_model(_tiny_cfg("tiny_synth"), jax_variables_from_d2(jax_model(cfg), golden_state_dict(load_golden("e2e_maskrcnn_r18"))))
    with pytest.raises(ValueError, match="MODEL.DEVICE"):
        DefaultTrainer.test(cfg, model, evaluators=[COCOEvaluator("tiny_synth", distributed=False)])
