"""The port's LVIS data and evaluation against the JAX package's, on the CPU.

- ``load_lvis_json`` on a synthetic LVIS v1 tree (``testing.
  write_synthetic_lvis``: 1203 categories, ``coco_url`` file names, a
  dropped 4-number polygon, not-exhaustive and negative ids) is ``==`` the
  JAX loader's, dicts and the metadata it sets; the builtin registrations
  (COCO, COCO person keypoints, COCO panoptic, LVIS, Pascal VOC) have the
  JAX package's names, metadata and paths under ``$DETECTRON2_DATASETS``
  (the port has d2's ``_panoptic_stuffonly`` names besides; Cityscapes is
  compared in ``tests/test_torch_cityscapes.py``); ``get_fed_loss_cls_weights`` at powers 0.5 and 1 and the repeat
  factors at LVIS's threshold 0.001 (some above 1: a category in one image
  of 1200) are ``==``.
- ``LVISEvaluator``: the same predictions give the JAX evaluator's results
  to 1e-12 (AP, APr/APc/APf), ``process`` on the same padded outputs the same
  json, and the ground truth fed back AP 100 in every band.
- The mask head's logits stay in the compute dtype: the class channel is
  taken before the float32 cast, with the same bits as casting every
  channel first.
- The six LVIS yamls build at 1203 classes; the six ViTDet LVIS ``.py``
  configs instantiate (a narrow ViT) with sigmoid CE and the federated
  loss in every box predictor, their weights the JAX config's.
- In a subprocess with ``DETECTRON2_DATASETS`` set to the synthetic tree:
  ``build_evaluator`` of each LVIS and VOC yaml's test set, and
  ``tools/train_net.py --eval-only`` of a tiny R18-FPN at 1203 classes on
  the builtin ``lvis_v1_val``.
"""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import detectron2_tpu.data as jax_data
from detectron2_tpu.config import LazyConfig as JaxLazyConfig
from detectron2_tpu.config import instantiate as jax_instantiate
from detectron2_tpu.data.datasets import lvis as jax_lvis
from detectron2_tpu.data.detection_utils import get_fed_loss_cls_weights as jax_fed_weights
from detectron2_tpu.data.samplers import RepeatFactorTrainingSampler as JaxRepeatFactorTrainingSampler
from detectron2_tpu.evaluation import rle as jax_rle
from detectron2_tpu.evaluation.lvis_evaluation import LVISEvaluator as JaxLVISEvaluator
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.config import LazyConfig, instantiate, lazy_targets
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets import lvis
from detectron2_tpu_torch.data.detection_utils import get_fed_loss_cls_weights
from detectron2_tpu_torch.data.samplers import RepeatFactorTrainingSampler
from detectron2_tpu_torch.evaluation import LVISEvaluator
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.roi_heads.mask_head import MaskRCNNConvUpsampleHead, mask_rcnn_inference, mask_rcnn_loss
from detectron2_tpu_torch.testing import golden_r18_config, ground_truth_detections, write_synthetic_lvis

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LVIS_YAMLS = [
    f"LVISv{v}-InstanceSegmentation/mask_rcnn_{m}_FPN_1x.yaml"
    for v in ("1", "0.5") for m in ("R_50", "R_101", "X_101_32x8d")
]
VOC_YAMLS = ["PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml", "PascalVOC-Detection/faster_rcnn_R_50_C4.yaml"]
VITDET_LVIS = [f"ViTDet/LVIS/{m}_vitdet_{s}_100ep.py" for m in ("mask_rcnn", "cascade_mask_rcnn") for s in "blh"]
NARROW_VIT = [
    "model.backbone.net.embed_dim=32",
    "model.backbone.net.depth=3",
    "model.backbone.net.num_heads=2",
    "model.backbone.net.window_block_indexes=(0,2)",
    "model.backbone.net.drop_path_rate=0.0",
]
TRAIN, VAL = "t_lvis_train", "t_lvis_val"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """12 train images listed 100 times (1200 train entries), 12 val
    images, registered in both packages with LVIS v1's static metadata."""
    out = write_synthetic_lvis(str(tmp_path_factory.mktemp("lvis")), 12, seed=3, train_repeat=100)
    for name, key in ((TRAIN, "train_json"), (VAL, "val_json")):
        if name not in DatasetCatalog:
            lvis.register_lvis_instances(name, lvis.get_lvis_instances_meta("lvis_v1_train"), out[key], out["image_root"])
        if name not in jax_data.DatasetCatalog:
            jax_lvis.register_lvis_instances(name, jax_lvis.get_lvis_instances_meta("lvis_v1_train"), out[key], out["image_root"])
    return out


def test_load_lvis_json_equals_jax(tree):
    for name, key in ((TRAIN, "train_json"), (VAL, "val_json")):
        ours, ref = DatasetCatalog.get(name), jax_data.DatasetCatalog.get(name)
        assert ours == ref and len(ours) == (1200 if name == TRAIN else 12)
        ours_meta = MetadataCatalog.get(name).as_dict()
        assert ours_meta == jax_data.MetadataCatalog.get(name).as_dict()
        assert len(ours_meta["thing_classes"]) == 1203 and ours_meta["evaluator_type"] == "lvis"
    train = DatasetCatalog.get(TRAIN)
    assert train[0]["file_name"] == os.path.join(tree["image_root"], "train2017", os.path.basename(train[0]["file_name"]))
    assert all(len(p) >= 6 and len(p) % 2 == 0 for d in train for a in d["annotations"] for p in a["segmentation"])
    with open(tree["train_json"]) as f:
        raw = json.load(f)
    assert any(len(p) == 4 for a in raw["annotations"] for p in a["segmentation"])  # dropped by the loader
    assert all("file_name" not in im for im in raw["images"])
    assert {a["category_id"] for d in train for a in d["annotations"]} <= set(range(1203))
    assert train[0]["neg_category_ids"] and train[0]["not_exhaustive_category_ids"]


# the JAX builtin family compared in tests/test_torch_cityscapes.py
_ELSEWHERE = ("cityscapes",)
# d2's names the JAX package lacks (ROADMAP C, correction (a))
_STUFFONLY = {f"coco_2017_{s}_panoptic_stuffonly" for s in ("train", "val", "val_100")}


def test_builtin_registrations_equal_jax():
    ours = set(DatasetCatalog.list())
    ref = {n for n in jax_data.DatasetCatalog.list() if not any(f in n for f in _ELSEWHERE)}
    builtin = {n for n in ours if n.startswith(("coco_", "keypoints_coco_", "lvis_", "voc_"))}
    assert builtin - _STUFFONLY == {n for n in ref if n.startswith(("coco_", "keypoints_coco_", "lvis_", "voc_"))}
    assert len(builtin) == 9 + 6 + 10 + 7 + 3 * 3
    for name in sorted(builtin - _STUFFONLY):
        assert MetadataCatalog.get(name).as_dict() == jax_data.MetadataCatalog.get(name).as_dict(), name
    assert MetadataCatalog.get("lvis_v1_val").evaluator_type == "lvis"
    assert MetadataCatalog.get("voc_2007_test").year == 2007
    assert len(MetadataCatalog.get("keypoints_coco_2017_train").keypoint_connection_rules) == 14


@pytest.mark.parametrize("power", [0.5, 1.0])
def test_fed_loss_weights_equal_jax(tree, power):
    for name in ("lvis_v1_train", TRAIN):
        ours = get_fed_loss_cls_weights(name, power)
        assert ours.dtype == np.float32 and ours.shape == (1203,)
        np.testing.assert_array_equal(ours, jax_fed_weights(name, power))
    np.testing.assert_array_equal(get_fed_loss_cls_weights([TRAIN, VAL], power), get_fed_loss_cls_weights(TRAIN, power))


@pytest.mark.parametrize("thresh", [0.001, 0.1])
def test_repeat_factors_equal_jax(tree, thresh):
    dicts = DatasetCatalog.get(TRAIN)
    ours = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(dicts, thresh)
    ref = JaxRepeatFactorTrainingSampler.repeat_factors_from_category_frequency(jax_data.DatasetCatalog.get(TRAIN), thresh)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    assert (np.asarray(ours) > 1).any() and (np.asarray(ours) == 1).any()


def _lvis_predictions(json_file, seed):
    """Jittered ground truth, some classes changed, random scores, some
    masks one pixel off: contiguous class ids, as the model gives them."""
    r = np.random.RandomState(seed)
    by_image = {}
    for det in ground_truth_detections(json_file):
        x, y, w, h = det["bbox"]
        m = jax_rle.rle_to_mask(det["segmentation"])
        if r.rand() < 0.5:
            m = np.roll(m, 1, axis=int(r.randint(2)))
        rle = jax_rle.mask_to_rle(m)
        rle["counts"] = rle["counts"].decode("ascii")
        cat = det["category_id"] - 1 if r.rand() > 0.15 else int(r.randint(1203))
        j = r.randn(4) * 2
        by_image.setdefault(det["image_id"], []).append({
            "image_id": det["image_id"], "category_id": cat, "score": float(r.rand()), "segmentation": rle,
            "bbox": [x + j[0], y + j[1], max(w + j[2], 1.0), max(h + j[3], 1.0)],
        })
    return [{"image_id": k, "instances": v} for k, v in by_image.items()]


def _evaluate_both(predictions, output_dir=None):
    results = []
    for cls in (LVISEvaluator, JaxLVISEvaluator):
        ev = cls(VAL, distributed=False, output_dir=output_dir)
        ev.reset()
        ev._predictions = copy.deepcopy(predictions)
        results.append(ev.evaluate())
    return results


def _assert_close_dicts(ours, ref):
    assert set(ours) == set(ref)
    for task in ref:
        assert list(ours[task]) == list(ref[task]), task
        np.testing.assert_allclose([ours[task][k] for k in ref[task]], [ref[task][k] for k in ref[task]], rtol=1e-12)


def test_lvis_evaluator_equals_jax_on_the_same_predictions(tree, tmp_path):
    ours, ref = _evaluate_both(_lvis_predictions(tree["val_json"], 0), str(tmp_path))
    _assert_close_dicts(ours, ref)
    for task in ("bbox", "segm"):
        assert {"APr", "APc", "APf"} <= set(ours[task]) and 0 < ours[task]["AP"] < 100
    with open(tmp_path / "lvis_instances_results.json") as f:
        assert min(r["category_id"] for r in json.load(f)) >= 1  # LVIS's 1-based ids


def test_ground_truth_as_detections_gives_ap_100_in_every_band(tree):
    by_image = {}
    for det in ground_truth_detections(tree["val_json"]):
        det["category_id"] -= 1
        by_image.setdefault(det["image_id"], []).append(det)
    ours, ref = _evaluate_both([{"image_id": k, "instances": v} for k, v in by_image.items()])
    _assert_close_dicts(ours, ref)
    for task in ("bbox", "segm"):
        for key in ("AP", "AP50", "AP75"):
            assert ours[task][key] == 100.0, (task, key, ours[task][key])
        for key in ("APr", "APc", "APf"):  # a mean of the bands' precisions, x 100 in float64
            assert ours[task][key] == pytest.approx(100.0, abs=1e-9), (task, key, ours[task][key])


def test_process_on_the_same_padded_outputs_matches_jax(tree):
    r = np.random.RandomState(4)
    with open(tree["val_json"]) as f:
        images = json.load(f)["images"][:3]
    B, D = len(images), 300
    image_sizes = np.array([[int(im["height"] * 1.5), int(im["width"] * 1.5)] for im in images], np.int32)
    xy = r.uniform(-20, 900, (B, D, 2))
    outputs = {
        "pred_boxes": np.concatenate([xy, xy + r.uniform(2, 300, (B, D, 2))], -1).astype(np.float32),
        "scores": r.rand(B, D).astype(np.float32),
        "pred_classes": r.randint(0, 1203, (B, D)).astype(np.int32),
        "valid": r.rand(B, D) > 0.1,
    }
    inputs = {"image_sizes": image_sizes,
              "metadata": [{"image_id": im["id"], "height": im["height"], "width": im["width"]} for im in images]}
    ev, ref_ev = LVISEvaluator(VAL, distributed=False), JaxLVISEvaluator(VAL, distributed=False)
    ev.reset()
    ref_ev.reset()
    ev.process({**inputs, "image_sizes": torch.from_numpy(image_sizes)}, {k: torch.from_numpy(v) for k, v in outputs.items()})
    ref_ev.process(inputs, outputs)
    assert ev._predictions == ref_ev._predictions
    assert sum(len(p["instances"]) for p in ev._predictions) > 600
    _assert_close_dicts(ev.evaluate(), ref_ev.evaluate())


def test_mask_logits_take_the_class_channel_before_the_float32_cast():
    """bf16 logits at 1203 classes: the gathered-then-cast channel has the
    bits of the cast-then-gathered one, in inference and in the loss."""
    gen = torch.Generator().manual_seed(0)
    head = MaskRCNNConvUpsampleHead(16, 1203, 16, 1)
    x = torch.randn((6, 7, 7, 16), generator=gen).to(torch.bfloat16)
    head = head.to(torch.bfloat16)
    logits = head(x, False)
    assert logits.dtype == torch.bfloat16 and logits.shape == (6, 14, 14, 1203)
    classes = torch.tensor([0, 1202, 5, 5, 700, 3])
    full = logits.float()
    ref_channel = torch.gather(full, 3, classes[:, None, None, None].expand(6, 14, 14, 1))[..., 0]
    assert torch.equal(mask_rcnn_inference(logits, classes), torch.sigmoid(ref_channel))
    targets = (torch.rand((6, 14, 14), generator=gen) > 0.5).float()
    fg = torch.tensor([True, True, False, True, True, True])
    assert torch.equal(mask_rcnn_loss(logits, classes, targets, fg), mask_rcnn_loss(full, classes, targets, fg))


@pytest.mark.parametrize("config", LVIS_YAMLS)
def test_lvis_yamls_build(config):
    cfg = model_zoo.get_config(config)
    assert cfg.MODEL.ROI_HEADS.NUM_CLASSES == (1203 if "v1" in config else 1230)
    assert cfg.TEST.DETECTIONS_PER_IMAGE == 300 and cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler"
    model = build_model(cfg, device="cpu")
    heads = model.roi_heads
    assert heads.box_predictor.cls_score.out_features == cfg.MODEL.ROI_HEADS.NUM_CLASSES + 1
    assert heads.mask_head.predictor.out_channels == cfg.MODEL.ROI_HEADS.NUM_CLASSES
    assert not heads.box_predictor.use_sigmoid_ce


@pytest.mark.parametrize("config", VITDET_LVIS)
def test_vitdet_lvis_configs_instantiate_with_the_federated_loss(config):
    cfg = LazyConfig.apply_overrides(LazyConfig.load(os.path.join(REPO, "configs", config)), NARROW_VIT)
    model = instantiate(cfg.model)
    predictors = model.roi_heads.box_predictor
    predictors = list(predictors) if isinstance(predictors, torch.nn.ModuleList) else [predictors]
    assert len(predictors) == (3 if "cascade" in config else 1)
    ref_model = jax_instantiate(JaxLazyConfig.apply_overrides(JaxLazyConfig.load(os.path.join(REPO, "configs", config)), NARROW_VIT).model)
    ref_predictors = ref_model.roi_heads.box_predictor
    ref_predictors = list(ref_predictors) if isinstance(ref_predictors, (list, tuple)) else [ref_predictors]
    weights = get_fed_loss_cls_weights("lvis_v1_train", 0.5)
    for p, ref in zip(predictors, ref_predictors):
        assert p.use_sigmoid_ce and p.use_fed_loss and p.num_classes == 1203 and p.fed_loss_num_classes == 50
        assert (p.test_score_thresh, p.test_topk_per_image) == (0.02, 300)
        np.testing.assert_array_equal(p.fed_loss_weights.numpy(), np.asarray(ref.fed_loss_cls_weights, np.float32))
        np.testing.assert_array_equal(p.fed_loss_weights.numpy(), weights)
    assert model.roi_heads.mask_head.predictor.out_channels == 1203
    assert lazy_targets.resolve(cfg.dataloader.evaluator._target_) is LVISEvaluator
    assert cfg.dataloader.evaluator.max_dets_per_image == 300


_BUILD_EVALUATORS = r"""
import json, sys
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.tools.train_net import build_evaluator
out = {}
for config in json.loads(sys.argv[1]):
    cfg = model_zoo.get_config(config)
    name = cfg.DATASETS.TEST[0]
    out[config] = [name, type(build_evaluator(cfg, name, output_folder="")).__name__]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def datasets_root(tree, tmp_path_factory):
    """A ``$DETECTRON2_DATASETS`` tree: the synthetic LVIS (its val json
    also as v0.5's) and a small synthetic VOC."""
    from detectron2_tpu_torch.testing import write_synthetic_voc

    root = tree["root"]
    shutil.copy(tree["val_json"], os.path.join(root, "lvis", "lvis_v0.5_val.json"))
    write_synthetic_voc(root, 4, seed=1)
    return root


def _env(root):
    return {**os.environ, "DETECTRON2_DATASETS": root, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def test_build_evaluator_picks_lvis_and_voc_for_the_zoo_yamls(datasets_root):
    proc = subprocess.run(
        [sys.executable, "-c", _BUILD_EVALUATORS, json.dumps(LVIS_YAMLS + VOC_YAMLS)],
        env=_env(datasets_root), cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for config in LVIS_YAMLS:
        assert out[config] == ["lvis_v1_val" if "v1" in config else "lvis_v0.5_val", "LVISEvaluator"]
    for config in VOC_YAMLS:
        assert out[config] == ["voc_2007_test", "PascalVOCDetectionEvaluator"]


def test_eval_only_command_line_on_the_builtin_lvis_val(datasets_root, tmp_path):
    """``tools/train_net.py --eval-only`` of a tiny R18-FPN at 1203 classes
    (sigmoid CE) on ``lvis_v1_val`` under ``$DETECTRON2_DATASETS``: seeded
    weights, the LVIS csv table and the results json."""
    cfg = golden_r18_config()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 1203
    cfg.MODEL.ROI_BOX_HEAD.USE_SIGMOID_CE = True
    cfg.DATASETS.TEST = ("lvis_v1_val",)
    cfg.TEST.DETECTIONS_PER_IMAGE = 30
    config = tmp_path / "r18_lvis.yaml"
    config.write_text(cfg.dump())
    out_dir = tmp_path / "out"
    cmd = [
        sys.executable, "-m", "detectron2_tpu_torch.tools.train_net", "--config-file", str(config), "--eval-only",
        "MODEL.DEVICE", "cpu", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128", "OUTPUT_DIR", str(out_dir),
    ]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=_env(datasets_root), capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    assert "No MODEL.WEIGHTS: seeded random weights" in log
    for task in ("bbox", "segm"):
        assert f"copypaste: Task: {task}" in log
    assert "copypaste: AP,AP50,AP75,APs,APm,APl,APr,APc,APf" in log
    with open(out_dir / "inference" / "lvis_instances_results.json") as f:
        results = json.load(f)
    assert len(results) == 12 * 30 and all(1 <= r["category_id"] <= 1203 for r in results)
