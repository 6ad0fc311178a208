"""The port's Pascal VOC data and evaluation against the JAX package's, on
the CPU.

- ``load_voc_instances`` on a synthetic VOC 2007 / 2012 tree
  (``testing.write_synthetic_voc``: 1-based boxes, difficult objects) is
  ``==`` the JAX loader's for every split; difficult objects are dropped.
- ``voc_ap`` (the 11-point metric and the area under the envelope) and
  ``voc_eval`` on the same detection lines are ``==`` the JAX functions,
  difficult ground truth neither a hit nor a miss.
- ``PascalVOCDetectionEvaluator``: ``process`` on the same padded outputs
  gives the same detection lines, and ``evaluate`` the JAX results to
  1e-12, for 2007 (11-point) and 2012; the ground truth fed back through
  ``process`` gives AP, AP50 and AP75 100.
- The two VOC yamls build (20 classes; the C4 model's res4 pool at 1024
  channels) and the builtin ``voc_*`` names carry the evaluator's metadata.
"""

import os

import numpy as np
import pytest
import torch

import detectron2_tpu.data as jax_data
from detectron2_tpu.data.datasets import pascal_voc as jax_voc
from detectron2_tpu.evaluation import pascal_voc_evaluation as jax_eval
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets import pascal_voc
from detectron2_tpu_torch.evaluation import PascalVOCDetectionEvaluator, pascal_voc_evaluation
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.testing import write_synthetic_voc

torch.set_num_threads(1)
SPLITS = {"t_voc07_trainval": (2007, "trainval"), "t_voc07_test": (2007, "test"), "t_voc12_trainval": (2012, "trainval"),
          "t_voc12_val": (2012, "val")}


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = write_synthetic_voc(str(tmp_path_factory.mktemp("voc")), 10, seed=2)
    for name, (year, split) in SPLITS.items():
        dirname = os.path.join(root, f"VOC{year}")
        if name not in DatasetCatalog:
            pascal_voc.register_pascal_voc(name, dirname, split, year)
        if name not in jax_data.DatasetCatalog:
            jax_voc.register_pascal_voc(name, dirname, split, year)
    return root


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_load_voc_instances_equals_jax(voc_root, name):
    ours, ref = DatasetCatalog.get(name), jax_data.DatasetCatalog.get(name)
    assert ours == ref and len(ours) == (5 if name == "t_voc12_val" else 10)
    assert MetadataCatalog.get(name).as_dict() == jax_data.MetadataCatalog.get(name).as_dict()
    assert MetadataCatalog.get(name).evaluator_type == "pascal_voc"
    assert ours[0]["file_name"].endswith(".jpg") and all(a["bbox"][0] >= 0 for d in ours for a in d["annotations"])


def test_difficult_objects_are_skipped(voc_root):
    year, split = SPLITS["t_voc07_test"]
    d = os.path.join(voc_root, f"VOC{year}")
    n_objects = sum(len(pascal_voc_evaluation._parse_rec(os.path.join(d, "Annotations", f"{i}.xml")))
                    for i in open(os.path.join(d, "ImageSets", "Main", split + ".txt")).read().split())
    n_difficult = sum(o["difficult"] for i in open(os.path.join(d, "ImageSets", "Main", split + ".txt")).read().split()
                      for o in pascal_voc_evaluation._parse_rec(os.path.join(d, "Annotations", f"{i}.xml")))
    loaded = sum(len(r["annotations"]) for r in DatasetCatalog.get("t_voc07_test"))
    assert n_difficult > 0 and loaded == n_objects - n_difficult


@pytest.mark.parametrize("use_07", [True, False], ids=["11_point", "area"])
@pytest.mark.parametrize("seed", range(3))
def test_voc_ap_equals_jax(use_07, seed):
    r = np.random.RandomState(seed)
    rec = np.sort(r.rand(40))
    prec = r.rand(40)
    assert pascal_voc_evaluation.voc_ap(rec, prec, use_07) == jax_eval.voc_ap(rec, prec, use_07)
    assert pascal_voc_evaluation.voc_ap(np.zeros(0), np.zeros(0), use_07) == jax_eval.voc_ap(np.zeros(0), np.zeros(0), use_07)


def _detection_lines(root, year, split, seed):
    """Jittered ground truth (difficult objects too), some classes and
    images changed, random scores: VOC's "image_id score box" lines."""
    r = np.random.RandomState(seed)
    d = os.path.join(root, f"VOC{year}")
    ids = open(os.path.join(d, "ImageSets", "Main", split + ".txt")).read().split()
    lines = {}
    for i in ids:
        for o in pascal_voc_evaluation._parse_rec(os.path.join(d, "Annotations", f"{i}.xml")):
            box = np.asarray(o["bbox"], float) + r.randn(4) * 3
            name = o["name"] if r.rand() > 0.1 else pascal_voc.CLASS_NAMES[r.randint(20)]
            image = i if r.rand() > 0.05 else ids[r.randint(len(ids))]
            lines.setdefault(name, []).append(f"{image} {r.rand():.3f} {box[0]:.1f} {box[1]:.1f} {box[2]:.1f} {box[3]:.1f}")
    return d, lines


@pytest.mark.parametrize("use_07", [True, False], ids=["11_point", "area"])
def test_voc_eval_equals_jax(voc_root, use_07):
    d, lines = _detection_lines(voc_root, 2007, "test", 0)
    annopath = os.path.join(d, "Annotations", "{}.xml")
    imageset = os.path.join(d, "ImageSets", "Main", "test.txt")
    for cls in pascal_voc.CLASS_NAMES:
        for thresh in (0.5, 0.75):
            ours = pascal_voc_evaluation.voc_eval(lines.get(cls, [""]), annopath, imageset, cls, thresh, use_07)
            ref = jax_eval.voc_eval(lines.get(cls, [""]), annopath, imageset, cls, thresh, use_07)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)


def _padded_outputs(name, seed, D=40):
    """The split's images in a 1.25x network frame, padded detections: the
    ground truth jittered plus random boxes, some slots invalid."""
    r = np.random.RandomState(seed)
    dicts = DatasetCatalog.get(name)
    B = len(dicts)
    boxes = np.zeros((B, D, 4), np.float32)
    classes = r.randint(0, 20, (B, D)).astype(np.int32)
    for i, rec in enumerate(dicts):
        xy = r.uniform(0, 500, (D, 2))
        boxes[i] = np.concatenate([xy, xy + r.uniform(8, 300, (D, 2))], 1)
        for j, a in enumerate(rec["annotations"]):
            boxes[i, j] = np.asarray(a["bbox"]) + r.randn(4) * 2
            classes[i, j] = a["category_id"]
    sizes = np.array([[int(rec["height"] * 1.25), int(rec["width"] * 1.25)] for rec in dicts], np.int32)
    outputs = {"pred_boxes": boxes * 1.25, "scores": r.rand(B, D).astype(np.float32), "pred_classes": classes,
               "valid": r.rand(B, D) > 0.1}
    inputs = {"image_sizes": sizes,
              "metadata": [{"image_id": rec["image_id"], "height": rec["height"], "width": rec["width"]} for rec in dicts]}
    return inputs, outputs


@pytest.mark.parametrize("name", ["t_voc07_test", "t_voc12_trainval"])
def test_evaluator_equals_jax_on_the_same_padded_outputs(voc_root, name):
    inputs, outputs = _padded_outputs(name, 1)
    ev, ref_ev = PascalVOCDetectionEvaluator(name), jax_eval.PascalVOCDetectionEvaluator(name)
    ev.reset()
    ref_ev.reset()
    ev.process({**inputs, "image_sizes": torch.from_numpy(inputs["image_sizes"])}, {k: torch.from_numpy(v) for k, v in outputs.items()})
    ref_ev.process(inputs, outputs)
    assert dict(ev._predictions) == dict(ref_ev._predictions) and sum(map(len, ev._predictions.values())) > 300
    ours, ref = ev.evaluate(), ref_ev.evaluate()
    assert list(ours) == list(ref) == ["bbox"] and list(ours["bbox"]) == list(ref["bbox"]) == ["AP", "AP50", "AP75"]
    np.testing.assert_allclose([ours["bbox"][k] for k in ref["bbox"]], [ref["bbox"][k] for k in ref["bbox"]], rtol=1e-12)
    assert 0 < ours["bbox"]["AP"] < ours["bbox"]["AP50"] < 100


@pytest.mark.parametrize("name", ["t_voc07_test", "t_voc12_trainval"])
def test_ground_truth_through_process_gives_ap_100(voc_root, name):
    dicts = DatasetCatalog.get(name)
    D = max(len(rec["annotations"]) for rec in dicts) + 2
    ev = PascalVOCDetectionEvaluator(name)
    ev.reset()
    for rec in dicts:
        n = len(rec["annotations"])
        boxes = torch.zeros((1, D, 4))
        classes = torch.zeros((1, D), dtype=torch.int64)
        if n:
            boxes[0, :n] = torch.tensor([a["bbox"] for a in rec["annotations"]])
            classes[0, :n] = torch.tensor([a["category_id"] for a in rec["annotations"]])
        valid = torch.arange(D)[None] < n
        ev.process({"image_sizes": torch.tensor([[rec["height"], rec["width"]]]),
                    "metadata": [{"image_id": rec["image_id"], "height": rec["height"], "width": rec["width"]}]},
                   {"pred_boxes": boxes, "scores": torch.ones((1, D)), "pred_classes": classes, "valid": valid})
    res = ev.evaluate()["bbox"]
    assert len({a["category_id"] for rec in dicts for a in rec["annotations"]}) == 20  # a class without gt would score 0
    for key in ("AP", "AP50", "AP75"):  # means of 20 classes x 100, in float64
        assert res[key] == pytest.approx(100.0, abs=1e-9), (key, res[key])


@pytest.mark.parametrize("config", ["PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml", "PascalVOC-Detection/faster_rcnn_R_50_C4.yaml"])
def test_voc_yamls_build(config):
    cfg = model_zoo.get_config(config)
    assert cfg.DATASETS.TRAIN == ("voc_2007_trainval", "voc_2012_trainval") and cfg.DATASETS.TEST == ("voc_2007_test",)
    assert tuple(cfg.INPUT.MIN_SIZE_TRAIN) == tuple(range(480, 801, 32)) and not cfg.MODEL.MASK_ON
    model = build_model(cfg, device="cpu")
    assert model.roi_heads.box_predictor.cls_score.out_features == 21
    for name in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST:
        meta = MetadataCatalog.get(name)
        assert meta.evaluator_type == "pascal_voc" and len(meta.thing_classes) == 20
