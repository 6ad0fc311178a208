"""DensePose's config, data and training entry point in the port against
the JAX package, on the CPU:

- ``add_densepose_config`` adds the JAX function's keys with its values,
  leaf by leaf (``BOOTSTRAP_MODEL.DEVICE`` is "cuda", the JAX one's "tpu"),
  and its ``new_allowed`` nodes take new keys on merge;
- the 29 chart DensePose yamls build after it (on the meta device), and
  the evolution and HRNet/HRFPN yamls (the CSE yamls:
  ``tests/test_torch_densepose_cse_data.py``);
- on a synthetic DensePose-COCO (``testing.write_synthetic_densepose_coco``)
  the json loads as the JAX loader loads it, and the mapper's and the
  collator's batches ``==`` the JAX ones, with and without a flip (the JAX
  collator's CSE keys are all padding on chart data);
- ``dp_masks`` decode (``DensePoseDataRelative.segm``) and the chart
  results' quantize / compress ``==`` the JAX structures';
- ``densepose_train_net`` in a subprocess with jax blocked: three steps of a
  tiny DensePose R-CNN on the builtin ``densepose_coco_2014_train`` under
  ``$DETECTRON2_DATASETS``, finite DensePose losses, its checkpoints; the
  bootstrap loader without ChimpnSee's videos and the DensePose evaluator
  without the SMPL files name the files they miss; a CSE model's warning
  says that neither package has a CSE DensePose evaluation.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import n

from detectron2_tpu.config import get_cfg as jax_get_cfg
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from detectron2_tpu.projects.densepose import add_densepose_config as jax_add_densepose_config
from detectron2_tpu.projects.densepose import structures as jax_structures
from detectron2_tpu.projects.densepose.dataset_mapper import DensePoseBatchCollator as JaxCollator
from detectron2_tpu.projects.densepose.dataset_mapper import DensePoseDatasetMapper as JaxMapper
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets.builtin import DENSEPOSE_ANN_KEYS
from detectron2_tpu_torch.data.datasets.coco import load_coco_json
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects.densepose import (
    DensePoseBatchCollator,
    DensePoseChartResult,
    DensePoseDataRelative,
    DensePoseDatasetMapper,
    DensePoseROIHeads,
    Trainer,
    add_densepose_config,
    compress_quantized_densepose_chart_result,
    decompress_compressed_densepose_chart_result,
    quantize_densepose_chart_result,
)
from detectron2_tpu_torch.testing import golden_densepose_config, write_synthetic_densepose_coco

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_CONFIGS = os.path.join(REPO, "configs", "DensePose")


def _yamls(sub=""):
    root = os.path.join(DP_CONFIGS, sub)
    return [os.path.join(sub, f) for f in sorted(os.listdir(root)) if f.endswith(".yaml") and not f.startswith("Base")]


_ALL = _yamls() + _yamls("quick_schedules") + _yamls("cse") + _yamls("evolution") + _yamls("quick_schedules/cse")
_OTHER = [y for y in _ALL if "HRNet" in y or "cse" in y or "evolution" in y]
CHART = [y for y in _ALL if y not in _OTHER]
CSE = [y for y in _OTHER if y.startswith(("cse", "quick_schedules/cse"))]


def _nodes(node, prefix=""):
    """Every leaf, and every empty node, of a config: dotted key -> value."""
    out = {}
    for k, v in node.items():
        if isinstance(v, dict) and v:
            out.update(_nodes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = dict(v) if isinstance(v, dict) else v
    return out


def test_add_densepose_config_matches_jax_leaf_by_leaf():
    ours, ref = get_cfg(), jax_get_cfg()
    before = (_nodes(ours), _nodes(ref))
    add_densepose_config(ours)
    jax_add_densepose_config(ref)
    added = [{k: v for k, v in _nodes(c).items() if k not in b or b[k] != v} for c, b in zip((ours, ref), before)]
    assert added[0].pop("BOOTSTRAP_MODEL.DEVICE") == "cuda" and added[1].pop("BOOTSTRAP_MODEL.DEVICE") == "tpu"
    assert added[0] == added[1] and len(added[0]) > 80
    for key in ("DATASETS.CATEGORY_MAPS", "DATASETS.WHITELISTED_CATEGORIES",
                "DATASETS.CLASS_TO_MESH_NAME_MAPPING", "MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS"):
        node = ours
        for k in key.split("."):
            node = node[k]
        assert node.is_new_allowed(), key
    ours.merge_from_other_cfg(type(ours)({"DATASETS": {"CATEGORY_MAPS": {"a": {"16": 1}}}}))
    assert ours.DATASETS.CATEGORY_MAPS.a == {"16": 1}
    with pytest.raises(KeyError, match="Non-existent config key"):
        ours.merge_from_other_cfg(type(ours)({"MODEL": {"NOT_A_KEY": 1}}))


def test_the_densepose_yaml_set():
    assert len(_ALL) == 52 and len(CHART) == 29


def _merged(yaml):
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(DP_CONFIGS, yaml))
    return cfg


@pytest.mark.parametrize("yaml", CHART)
def test_chart_yamls_build(yaml):
    cfg = _merged(yaml)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    heads, h = model.roi_heads, cfg.MODEL.ROI_DENSEPOSE_HEAD
    assert isinstance(heads, DensePoseROIHeads) and (heads.decoder is None) == (not h.DECODER_ON)
    assert type(heads.densepose_head).__name__ == h.NAME
    pred = heads.densepose_predictor
    assert hasattr(pred, "sigma_2_lowres") == h.UV_CONFIDENCE.ENABLED
    assert hasattr(pred, "kappa_u_lowres") == (h.UV_CONFIDENCE.ENABLED and h.UV_CONFIDENCE.TYPE == "indep_aniso")
    assert hasattr(pred, "fine_segm_confidence_lowres") == h.SEGM_CONFIDENCE.ENABLED
    assert pred.ann_index_lowres.out_channels == h.NUM_COARSE_SEGM_CHANNELS
    for name in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST:
        assert name in DatasetCatalog.list(), name


@pytest.mark.parametrize("yaml", [y for y in _OTHER if y not in CSE])
def test_cse_evolution_and_hrnet_yamls_refuse_naming_a10(yaml):
    """The evolution and HRNet/HRFPN yamls, which refused naming ROADMAP A10
    until HRFPN and the bootstrap were ported, build (on the meta device):
    HRFPN's five levels, the evolution config's bootstrap dataset."""
    cfg = _merged(yaml)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert isinstance(model.roi_heads, DensePoseROIHeads)
    if "HRNet" in yaml:
        assert type(model.backbone).__name__ == "HRFPN" and len(model.backbone.output_shape()) == 5
    else:
        assert [d["DATASET"] for d in cfg.BOOTSTRAP_DATASETS] == ["chimpnsee"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("densepose"))
    split = "densepose_coco_2014_train"
    json_file, image_root = write_synthetic_densepose_coco(
        root, 6, seed=0, sizes=((60, 90), (90, 64)), splits=(split,), max_persons=5
    )[split]
    return root, json_file, image_root


def test_synthetic_densepose_coco_loads_as_in_jax(synthetic):
    _, json_file, image_root = synthetic
    ours = load_coco_json(json_file, image_root, "synth_dp", extra_annotation_keys=DENSEPOSE_ANN_KEYS)
    ref = jax_load_coco_json(json_file, image_root, "synth_dp", extra_annotation_keys=DENSEPOSE_ANN_KEYS)
    assert ours == ref and len(ours) == 6
    persons = [a for d in ours for a in d["annotations"]]
    with_dp = [a for a in persons if "dp_I" in a]
    assert 0 < len(with_dp) < len(persons)
    for a in with_dp:
        assert 20 <= len(a["dp_x"]) == len(a["dp_U"]) <= 100 and len(a["dp_masks"]) == 14
        assert min(a["dp_I"]) >= 1 and max(a["dp_I"]) <= 24


def test_dp_masks_and_chart_results_equal_jax(synthetic):
    _, json_file, image_root = synthetic
    anns = [a for d in load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_ANN_KEYS)
            for a in d["annotations"] if "dp_I" in a]
    for a in anns[:4]:
        ours, ref = DensePoseDataRelative(copy.deepcopy(a)), jax_structures.DensePoseDataRelative(copy.deepcopy(a))
        assert ours.segm.shape == (256, 256) and ours.segm.max() > 0
        np.testing.assert_array_equal(ours.segm, ref.segm)
    rng = np.random.RandomState(0)
    labels, uv = rng.randint(0, 25, (9, 7)), rng.uniform(-0.1, 1.1, (2, 9, 7)).astype(np.float32)
    q = quantize_densepose_chart_result(DensePoseChartResult(labels=labels, uv=uv))
    jq = jax_structures.quantize_densepose_chart_result(jax_structures.DensePoseChartResult(labels=labels, uv=uv))
    np.testing.assert_array_equal(q.labels_uv_uint8, jq.labels_uv_uint8)
    c = compress_quantized_densepose_chart_result(q)
    assert c.labels_uv_str == jax_structures.compress_quantized_densepose_chart_result(jq).labels_uv_str
    np.testing.assert_array_equal(decompress_compressed_densepose_chart_result(c).labels_uv_uint8, q.labels_uv_uint8)


@pytest.mark.parametrize("flip", [0.0, 1.0], ids=["no_flip", "flip"])
def test_mapper_and_collator_equal_jax(synthetic, flip):
    _, json_file, image_root = synthetic
    dicts = load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_ANN_KEYS)
    ours = DensePoseDatasetMapper(
        True, augmentations=[T.ResizeShortestEdge((96,), 128, "choice"), T.RandomFlip(prob=flip)], image_format="BGR"
    )
    ref = JaxMapper(
        True, augmentations=[JT.ResizeShortestEdge((96,), 128, "choice"), JT.RandomFlip(prob=flip)], image_format="BGR"
    )
    batch = DensePoseBatchCollator(max_gt_instances=8)([ours(copy.deepcopy(d)) for d in dicts])
    jbatch = JaxCollator(max_gt_instances=8)([ref(copy.deepcopy(d)) for d in dicts])
    assert set(jbatch) - set(batch) == {"gt_dp_vertex", "gt_dp_mesh_id"}
    assert (np.asarray(jbatch["gt_dp_vertex"]) == -1).all() and (np.asarray(jbatch["gt_dp_mesh_id"]) == -1).all()
    for k, v in batch.items():
        if k != "metadata":
            np.testing.assert_array_equal(n(v), np.asarray(jbatch[k]), err_msg=k)
    part = n(batch["gt_dp_part"])
    assert batch["gt_dp_points"].shape == (6, 8, 196, 2) and ((part >= 1) & (part <= 24) | (part == -1)).all()
    assert (part >= 1).any(-1).sum() < n(batch["gt_valid"]).sum()  # a valid gt without points


def test_the_train_loader_collates_the_points_the_jax_one_drops(synthetic):
    """The port's Trainer gives its loader the DensePose collator; the JAX
    non-bootstrap Trainer's loader keeps the default collator, whose batch
    has no ``gt_dp_*`` (ROADMAP C), so its DensePose branch trains on no
    point."""
    from detectron2_tpu.data.build import _train_loader_from_config as jax_train_loader_from_config
    from detectron2_tpu_torch.data.build import _train_loader_from_config

    cfg = golden_densepose_config()
    cfg.DATASETS.TRAIN = ("densepose_coco_2014_train",)
    jcfg = jax_get_cfg()
    jax_add_densepose_config(jcfg)
    jcfg.DATASETS.TRAIN = cfg.DATASETS.TRAIN
    _, json_file, image_root = synthetic
    dicts = load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_ANN_KEYS)
    ours = _train_loader_from_config(cfg, dataset=dicts, mapper_class=DensePoseDatasetMapper,
                                     collator_class=DensePoseBatchCollator)
    assert type(ours["collator"]) is DensePoseBatchCollator and type(ours["mapper"]) is DensePoseDatasetMapper
    ref = jax_train_loader_from_config(jcfg, mapper=JaxMapper(jcfg, True), dataset=dicts)
    mapped = [ref["mapper"](copy.deepcopy(d)) for d in dicts[:2]]
    assert not any(k.startswith("gt_dp_") for k in ref["collator"](mapped))
    assert "gt_dp_points" in ours["collator"]([ours["mapper"](copy.deepcopy(d)) for d in dicts[:2]])


def test_bootstrap_loader_and_evaluator_refuse(tmp_path, monkeypatch):
    """The bootstrap loader is ported: with the ground truth present it is
    built up to ChimpnSee's video list, a download, which it names."""
    cfg = golden_densepose_config()
    cfg.MODEL.DEVICE = "cpu"
    json_file, image_root = write_synthetic_densepose_coco(
        str(tmp_path / "gt"), 2, seed=2, sizes=((60, 90),), splits=("densepose_coco_2014_train",)
    )["densepose_coco_2014_train"]
    if "refuse_gt" not in DatasetCatalog.list():
        DatasetCatalog.register("refuse_gt", lambda: load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_ANN_KEYS))
    cfg.DATASETS.TRAIN = ("refuse_gt",)
    cfg.BOOTSTRAP_DATASETS = [{"DATASET": "chimpnsee", "IMAGE_LOADER": {"TYPE": "video_keyframe", "SELECT": {
        "STRATEGY": "random_k", "NUM_IMAGES": 4}, "TRANSFORM": {"TYPE": "resize", "MIN_SIZE": 800, "MAX_SIZE": 1333}}}]
    with pytest.raises(FileNotFoundError, match=r"chimpnsee/cdna.eva.mpg.de/video_list.txt"):
        Trainer.build_train_loader(cfg)
    # the evaluator is ported: without the SMPL evaluation files it names them
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=r"SMPL_subdiv.mat, Pdist_matrix.pkl and SMPL_SUBDIV_TRANSFORM.mat"):
        Trainer.build_evaluator(cfg, "densepose_coco_2014_minival")


def test_cse_evaluation_warning_says_neither_package_has_one(caplog):
    """ROADMAP C: a CSE model gets COCOEvaluator alone; the warning
    says that neither package has a CSE DensePose evaluation (it once named
    a queue item that does not exist)."""
    import logging

    cfg = _merged(CSE[0])
    # the warning comes first; then COCOEvaluator reads the (absent) json
    with caplog.at_level(logging.WARNING), pytest.raises(FileNotFoundError, match=r"_cse\.json"):
        Trainer.build_evaluator(cfg, cfg.DATASETS.TEST[0])
    assert "neither this package nor the JAX package has a CSE DensePose evaluation" in caplog.text
    assert "ROADMAP A10" not in caplog.text


_RUN_TOOL = r"""
import runpy, sys
sys.modules["jax"] = None  # the tool imports nothing of jax
sys.modules["torch.utils.tensorboard"] = None  # (imports TensorFlow here)
sys.argv = ["densepose_train_net"] + sys.argv[1:]
runpy.run_module("detectron2_tpu_torch.tools.densepose_train_net", run_name="__main__")
"""


def test_densepose_train_net_trains_a_tiny_model(tmp_path):
    root = str(tmp_path / "datasets")
    write_synthetic_densepose_coco(root, 4, seed=1, sizes=((60, 90), (90, 64)), splits=("densepose_coco_2014_train",))
    cfg = golden_densepose_config()
    cfg.MODEL.RESNETS.NORM = "GN"
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 200, 50
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = ("densepose_coco_2014_train",), ()
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (64,), 96
    cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER, cfg.SOLVER.CHECKPOINT_PERIOD = 2, 0.01, 3, 2
    config = tmp_path / "densepose_r18.yaml"
    config.write_text(cfg.dump())
    out = tmp_path / "out"
    cmd = [sys.executable, "-c", _RUN_TOOL, "--config-file", str(config), "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(out)]
    env = {**os.environ, "DETECTRON2_DATASETS": root, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-3000:]
    with open(out / "metrics.json") as f:
        lines = [json.loads(x) for x in f]
    last = lines[-1]  # the writer runs every 20 steps and after the last
    assert last["iteration"] == 2
    for k in ("loss_densepose_I", "loss_densepose_S", "loss_densepose_U", "loss_densepose_V", "loss_cls"):
        assert np.isfinite(last[k]) and last[k] > 0, (k, last)
    assert (out / "model_final.pth").exists() and (out / "model_0000001.pth").exists()
