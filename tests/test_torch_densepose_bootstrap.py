"""DensePose bootstrap training in the port against the JAX package, on the
CPU: the host-side modules give ``==`` results for the same inputs and
seeds, and the bootstrap predictor's chart maps match.

- converters: chart results (with and without confidences), the coarse
  masks pasted into the image and the horizontal flip ``==`` the JAX ones;
- samplers: uniform and confidence-based points, the masks, the
  prediction -> ground-truth sampler and the score filter ``==``;
- ``InferenceBasedLoader`` over a stand-in predictor (chart maps drawn from
  each image's own seed), ``CombinedDataLoader``'s mix, ``ImageListDataset``
  with ``ImageResizeTransform`` (PNGs), ``VideoKeyframeDataset`` with an
  injected lister and reader, ``pseudo_to_train_sample`` and a collated
  batch of ``build_combined_train_loader`` ``==`` the JAX ones; without
  PyAV the video readers return nothing, with a warning;
- ``build_bootstrap_predictor`` of a tiny DensePose R-CNN (DL_WC1, the iid
  UV confidence) against the JAX one's detections and chart maps;
- the evolution yaml builds (on the meta device) and its loader schema
  merges; ROADMAP C's eighteenth correction both ways: the JAX catalog has
  no ``base_coco_2017_train``, the port's reads it with raw category ids.

The JAX converters resize with ``cv2.resize(..., INTER_LINEAR)``; OpenCV
built with IPP takes IPP's resize for one, three and four channels (its
weights differ by up to 2e-5 from OpenCV's own), so the JAX side runs with
``cv2.ipp.setUseIPP(False)``, the resize the port states.
"""

import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch

from _torch_port import jax_cfg_from_port, jax_model, jax_random_variables, n, port_model
from test_torch_densepose_rcnn import tiny_cfg

from detectron2_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from detectron2_tpu.projects.densepose import bootstrap as JB
from detectron2_tpu.projects.densepose import build as JBuild
from detectron2_tpu.projects.densepose import converters as JC
from detectron2_tpu.projects.densepose import structures as JS
from detectron2_tpu.projects.densepose import video as JV
from detectron2_tpu.projects.densepose.trainer import build_bootstrap_predictor as jax_build_bootstrap_predictor
from detectron2_tpu.structures import Boxes as JaxBoxes
from detectron2_tpu.structures import Instances as JaxInstances
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets.builtin import DENSEPOSE_ANN_KEYS
from detectron2_tpu_torch.data.datasets.coco import load_coco_json
from detectron2_tpu_torch.data.png import write_png
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects.densepose import add_densepose_config, get_bootstrap_dataset_config
from detectron2_tpu_torch.projects.densepose import bootstrap as B
from detectron2_tpu_torch.projects.densepose import build as PB
from detectron2_tpu_torch.projects.densepose import converters as C
from detectron2_tpu_torch.projects.densepose import structures as S
from detectron2_tpu_torch.projects.densepose import video as V
from detectron2_tpu_torch.projects.densepose.datasets import densepose_dataset_dicts, load_coco_json_raw_ids
from detectron2_tpu_torch.projects.densepose.trainer import SampleCountingLoader, build_bootstrap_predictor
from detectron2_tpu_torch.structures import Boxes, Instances
from detectron2_tpu_torch.testing import write_synthetic_coco, write_synthetic_densepose_coco
from detectron2_tpu_torch.utils.events import EventStorage

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def opencv_own_resize():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


def chart_maps(rng, S=28, conf=True):
    """One detection's predictor maps, ``[S, S, C]``."""
    maps = {"coarse_segm": rng.randn(S, S, 2), "fine_segm": rng.randn(S, S, 25), "u": rng.rand(S, S, 25),
            "v": rng.rand(S, S, 25)}
    if conf:
        maps.update(sigma_2=rng.rand(S, S, 1), fine_segm_confidence=rng.rand(S, S, 1))
    return {k: v.astype(np.float32) for k, v in maps.items()}


def assert_same(a, b, what=""):
    """Equal structures: arrays ``==`` (tensors as numpy), dicts and lists
    element by element, other values ``==``."""
    if isinstance(a, dict):
        assert set(a) == set(b), (what, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b), (what, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)) or isinstance(b, (np.ndarray, torch.Tensor)):
        x, y = n(a), n(b)
        assert x.shape == y.shape and np.array_equal(x, y), (what, x.shape, y.shape)
    else:
        assert a == b, (what, a, b)


# ------------------------------------------------------------------ converters


BOXES = np.array([[3.2, 5.7, 61.9, 90.1], [10.0, 0.0, 13.5, 40.0], [-4.0, 20.5, 30.0, 75.25]], np.float32)


@pytest.mark.parametrize("box", range(len(BOXES)))
def test_chart_results_equal_jax(box):
    maps = chart_maps(np.random.RandomState(box))
    ours = C.densepose_chart_predictor_output_to_result_with_confidences(maps, BOXES[box])
    ref = JC.densepose_chart_predictor_output_to_result_with_confidences(maps, BOXES[box])
    for k in ("labels", "uv", "sigma_1", "sigma_2", "kappa_u", "kappa_v", "fine_segm_confidence", "coarse_segm_confidence"):
        assert_same(getattr(ours, k), getattr(ref, k), k) if getattr(ref, k) is not None else None
    assert ours.sigma_1 is None and ours.sigma_2.shape == ours.labels.shape and ours.labels.max() > 0
    plain = C.ToChartResultConverter.convert(maps, Boxes(torch.from_numpy(BOXES[box : box + 1])))
    assert_same(plain.labels, JC.ToChartResultConverter.convert(maps, JaxBoxes(BOXES[box : box + 1])).labels)
    assert C.make_int_box([3.7, -1.2, 9.99, 4.0]) == JC.make_int_box([3.7, -1.2, 9.99, 4.0]) == (3, -1, 9, 4)


def test_coarse_masks_and_hflip_equal_jax():
    rng = np.random.RandomState(5)
    coarse = rng.randn(3, 28, 28, 2).astype(np.float32)
    ours = C.ToMaskConverter.convert(coarse, Boxes(torch.from_numpy(BOXES)), (80, 64))
    ref = JC.ToMaskConverter.convert(coarse, JaxBoxes(BOXES), (80, 64))
    assert_same(ours.tensor, ref.tensor) and ours.tensor.any()
    tables = {k: rng.rand(24, 256, 256).astype(np.float32) for k in ("U_transforms", "V_transforms")}
    for uv in (None, tables):
        maps = chart_maps(rng)
        maps["coarse_segm"] = rng.randn(28, 28, 15).astype(np.float32)  # the body-part layout is permuted too
        ours = C.densepose_chart_predictor_output_hflip(maps, S.DensePoseTransformData(uv))
        ref = JC.densepose_chart_predictor_output_hflip(maps, JS.DensePoseTransformData(uv))
        assert_same(ours, ref)


# ------------------------------------------------------------------- samplers


def instances_pair(seed, n_det=3, h=96, w=80, conf=True):
    """The same detections as a port and a JAX ``Instances``."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n_det, 2) * [w / 2, h / 2]
    boxes = np.concatenate([xy, xy + 8 + rng.rand(n_det, 2) * [w / 2, h / 2]], 1).astype(np.float32)
    scores = rng.rand(n_det).astype(np.float32)
    maps = [chart_maps(rng, conf=conf) for _ in range(n_det)]
    ours = Instances((h, w), pred_boxes=Boxes(torch.from_numpy(boxes)), scores=scores,
                     pred_classes=np.zeros(n_det, np.int64), pred_densepose=maps)
    ref = JaxInstances((h, w))
    ref.pred_boxes, ref.scores, ref.pred_classes, ref.pred_densepose = JaxBoxes(boxes), scores, np.zeros(n_det, np.int64), maps
    return ours, ref


def densepose_list_as_arrays(dp_list):
    return [{k: getattr(d, k) for k in ("x", "y", "u", "v", "i", "segm")} for d in dp_list.densepose_datas]


@pytest.mark.parametrize("kind", ["uniform", "sigma_2", "fine_segm_confidence"])
def test_point_samplers_equal_jax(kind):
    ours_inst, ref_inst = instances_pair(7)
    if kind == "uniform":
        ours, ref = B.DensePoseUniformSampler(8, seed=3), JB.DensePoseUniformSampler(8, seed=3)
    else:
        ours = B.DensePoseConfidenceBasedSampler(kind, 8, search_proportion=0.5, seed=3)
        ref = JB.DensePoseConfidenceBasedSampler(kind, 8, search_proportion=0.5, seed=3)
    for _ in range(2):  # the generators move on alike
        a, b = densepose_list_as_arrays(ours(ours_inst)), densepose_list_as_arrays(ref(ref_inst))
        assert_same(a, b)
    assert all(0 < len(d["i"]) <= 8 * 24 and d["i"].min() >= 1 and d["u"].max() <= 1 for d in a)
    assert_same(B.MaskFromDensePoseSampler()(ours_inst).tensor, JB.MaskFromDensePoseSampler()(ref_inst).tensor)
    assert B.FINE_TO_COARSE_SEGMENTATION == JB.FINE_TO_COARSE_SEGMENTATION


def test_prediction_to_ground_truth_and_the_score_filter_equal_jax():
    outs = []
    for pkg, (inst_idx, BB) in (("port", (0, B)), ("jax", (1, JB))):
        inst = instances_pair(11)[inst_idx]
        data = BB.ScoreBasedFilter(min_score=0.3)([{"instances": inst}])
        sampler = BB.PredictionToGroundTruthSampler("bs")
        sampler.register_sampler("pred_densepose", "gt_densepose", BB.DensePoseUniformSampler(8, seed=2))
        sampler.register_sampler("pred_densepose", "gt_masks", BB.MaskFromDensePoseSampler())
        out = sampler(data)[0]
        i = out["instances"]
        assert not i.has("scores") and not i.has("pred_boxes") and out["dataset"] == "bs"
        outs.append({"boxes": i.gt_boxes.tensor, "classes": i.gt_classes, "masks": i.gt_masks.tensor,
                     "dp": densepose_list_as_arrays(i.gt_densepose), "n": len(i)})
    assert_same(outs[0], outs[1])
    assert 0 < outs[0]["n"] < 3


# --------------------------------------------------------------------- loaders


def stand_in_predictor(pkg):
    """A predictor of each image's own seeded detections (its pixel sum)."""

    def predict(batch):
        out = []
        for d in batch:
            seed = int(np.asarray(d["image"], np.float64).sum()) % 1000
            h, w = d["image"].shape[:2]
            inst = instances_pair(seed, n_det=2, h=h, w=w, conf=False)[0 if pkg == "port" else 1]
            out.append({"instances": inst})
        return out

    return predict


def image_batches(n_batches=3):
    rng = np.random.RandomState(0)
    return [[{"images": rng.randint(0, 255, (2, 40, 48, 3)).astype(np.float32), "categories": ["chimp", "person"]}]
            for _ in range(n_batches)]


def loader_samples(pkg, BB):
    sampler = BB.PredictionToGroundTruthSampler("bs")
    sampler.register_sampler("pred_densepose", "gt_densepose", BB.DensePoseUniformSampler(4, seed=5))
    loader = BB.InferenceBasedLoader(
        stand_in_predictor(pkg), image_batches(), data_sampler=sampler, data_filter=BB.ScoreBasedFilter(0.2),
        batch_size=2, inference_batch_size=3, category_to_class_mapping={"chimp": 1}, seed=4,
    )
    return [
        [{"image": s["image"], "boxes": s["instances"].gt_boxes.tensor, "classes": s["instances"].dataset_classes,
          "dp": densepose_list_as_arrays(s["instances"].gt_densepose)} for s in batch]
        for batch in loader
    ]


def test_inference_based_loader_equals_jax():
    ours, ref = loader_samples("port", B), loader_samples("jax", JB)
    assert_same(ours, ref)
    assert len(ours) >= 2 and {int(c[0]) for b in ours for c in (s["classes"] for s in b)} == {0, 1}


def test_combined_loader_mix_equals_jax():
    def counting(tag):
        def gen():
            k = 0
            while True:
                yield [(tag, k), (tag, k + 1), (tag, k + 2)]
                k += 3
        return gen()

    ours = PB.CombinedDataLoader([counting("gt"), counting("bs")], 5, [1.0, 0.5], seed=9)
    ref = JBuild.CombinedDataLoader([counting("gt"), counting("bs")], 5, [1.0, 0.5], seed=9)
    a = [b for _, b in zip(range(30), ours)]
    assert a == [b for _, b in zip(range(30), ref)]
    flat = [x for b in a for x in b]
    assert len(set(flat)) == len(flat) == 150 and 30 < sum(t == "bs" for t, _ in flat) < 70


@pytest.fixture(scope="module")
def image_list(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_list")
    rng = np.random.RandomState(1)
    paths = []
    for i, (h, w) in enumerate(((60, 80), (90, 50))):
        paths.append(str(root / f"{i}.png"))
        write_png(paths[-1], rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "list.txt", "w") as f:
        f.write("0.png\n\n1.png\nmissing.png\n")
    return root, paths


def test_image_list_dataset_equals_jax(image_list, caplog):
    root, paths = image_list
    ours = PB.ImageListDataset(paths + [str(root / "missing.png")], "chimp", PB.ImageResizeTransform(96, 160))
    ref = JBuild.ImageListDataset(paths + [str(root / "missing.png")], "chimp", JBuild.ImageResizeTransform(96, 160))
    assert len(ours) == len(ref) == 3
    with caplog.at_level(logging.WARNING):
        for i in range(3):
            assert_same(ours[i], ref[i], str(i))
    assert ours[0]["images"].shape == (1, 96, 128, 3) and ours[2] == {"images": ours._EMPTY_IMAGE, "categories": []}
    assert "missing.png" in caplog.text


def test_video_keyframe_dataset_equals_jax(tmp_path, caplog):
    frames = np.random.RandomState(2).randint(0, 256, (5, 30, 40, 3)).astype(np.uint8)
    lister = lambda path: [] if "empty" in path else [0, 10, 20, 30, 40]  # noqa: E731
    reader = lambda path, kfs: frames[[k // 10 for k in kfs]]  # noqa: E731
    helper = tmp_path / "keyframes.csv"
    helper.write_text('video_id,keyframes\n1,"[10,30]"\n')
    videos = ["a.mp4", "b.mp4", "empty.mp4"]  # b's keyframes from the helper file
    kw = dict(keyframe_helper_fpath=str(helper), keyframe_lister=lister, keyframe_reader=reader)
    ours = V.VideoKeyframeDataset(videos, "chimp", V.FirstKFramesSelector(2), PB.ImageResizeTransform(48, 80), **kw)
    ref = JV.VideoKeyframeDataset(videos, "chimp", JV.FirstKFramesSelector(2), JBuild.ImageResizeTransform(48, 80), **kw)
    for i in range(3):
        assert_same(ours[i], ref[i], str(i))
    assert ours[0]["images"].shape == ours[1]["images"].shape == (2, 48, 64, 3) and ours[2]["categories"] == []
    list_file = tmp_path / "videos.txt"
    list_file.write_text("x.mp4\n/abs/y.mp4\n")
    assert V.video_list_from_file(str(list_file), "/base") == JV.video_list_from_file(str(list_file), "/base") == [
        "/base/x.mp4", "/abs/y.mp4"]
    # without PyAV: no keyframes and no frames, each with a warning
    with caplog.at_level(logging.WARNING):
        assert V.list_keyframes("v.mp4") == [] and V.read_keyframes("v.mp4", [0]) is None
    assert "PyAV" in caplog.text


def test_pseudo_to_train_sample_equals_jax():
    packed = []
    for inst_idx, BB, BBuild in ((0, B, PB), (1, JB, JBuild)):
        inst = instances_pair(13)[inst_idx]
        sampler = BB.PredictionToGroundTruthSampler("bs")
        sampler.register_sampler("pred_densepose", "gt_densepose", BB.DensePoseUniformSampler(8, seed=1))
        sample = sampler([{"instances": inst}])[0]
        sample["image"] = np.full((96, 80, 3), 7, np.float32)
        out = BBuild.pseudo_to_train_sample(sample, max_points=64)
        i = out["instances"]
        packed.append({k: i.get(k) if k != "gt_boxes" else i.gt_boxes.tensor for k in (
            "gt_boxes", "gt_classes", "gt_dp_points", "gt_dp_part", "gt_dp_u", "gt_dp_v")} | {"image": out["image"]})
    assert_same(packed[0], packed[1])
    assert (packed[0]["gt_dp_part"] > 0).sum() > 20


# ------------------------------------------- the combined loader and predictor


def _tiny_bootstrap_cfg(root, list_file):
    cfg = tiny_cfg("dl_wc1")
    cfg.MODEL.DEVICE = "cpu"
    cfg.SEED = 3
    cfg.DATASETS.TRAIN = ("bs_gt",)
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN, cfg.INPUT.RANDOM_FLIP = (64,), 96, "none"
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.TPU.MAX_GT_INSTANCES = 8
    cfg.BOOTSTRAP_DATASETS = [{
        "DATASET": "bs_list", "RATIO": 1.0,
        "IMAGE_LOADER": {"TYPE": "image_list", "TRANSFORM": {"TYPE": "resize", "MIN_SIZE": 64, "MAX_SIZE": 96},
                         "BATCH_SIZE": 2, "CATEGORY_TO_CLASS_MAPPING": {"chimp": 0}},
        "INFERENCE": {"INPUT_BATCH_SIZE": 2, "OUTPUT_BATCH_SIZE": 1},
        "DATA_SAMPLER": {"TYPE": "densepose_uniform", "COUNT_PER_CLASS": 4},
        "FILTER": {"TYPE": "detection_score", "MIN_VALUE": 0.0},
    }]
    return cfg


@pytest.fixture(scope="module")
def registered(tmp_path_factory, image_list):
    """One gt image (``bs_gt``, the DensePose COCO layout) and the image
    list ``bs_list`` registered in both packages' catalogs."""
    root = str(tmp_path_factory.mktemp("bootstrap"))
    json_file, image_root = write_synthetic_densepose_coco(
        root, 1, seed=3, sizes=((60, 80),), splits=("densepose_coco_2014_train",), max_persons=3
    )["densepose_coco_2014_train"]
    list_root, _ = image_list
    for cat, meta, load in ((DatasetCatalog, MetadataCatalog, load_coco_json),
                            (JaxDatasetCatalog, JaxMetadataCatalog, jax_load_coco_json)):
        if "bs_gt" not in cat.list():
            cat.register("bs_gt", lambda load=load: load(json_file, image_root, "bs_gt", extra_annotation_keys=DENSEPOSE_ANN_KEYS))
            cat.register("bs_list", lambda: [])
        dtype = PB.DatasetType.IMAGE_LIST if cat is DatasetCatalog else JBuild.DatasetType.IMAGE_LIST
        meta.get("bs_list").set(dataset_type=dtype, image_list_fpath=str(list_root / "list.txt"),
                                image_base_path=str(list_root), category="chimp")
    return root


def test_a_collated_combined_batch_equals_jax(registered):
    cfg = _tiny_bootstrap_cfg(registered, None)
    jcfg = jax_cfg_from_port(cfg)
    ours_loader = PB.build_combined_train_loader(cfg, stand_in_predictor("port"), seed=3, wrap=SampleCountingLoader)
    ref_loader = JBuild.build_combined_train_loader(jcfg, stand_in_predictor("jax"), seed=3)
    with EventStorage(0) as storage:
        ours = [next(ours_loader) for _ in range(2)]
    ref = [next(ref_loader) for _ in range(2)]
    for a, b in zip(ours, ref):
        a = {k: v for k, v in a.items() if k != "metadata"}
        extra = set(b) - set(a) - {"metadata"}
        assert extra <= {"gt_dp_vertex", "gt_dp_mesh_id"} and all((b[k] == -1).all() for k in extra), extra
        assert_same(a, {k: b[k] for k in a})
    counts = {k: [v for v, _ in h.values()] for k, h in storage.histories().items() if k.startswith("batch/")}
    assert set(counts) == {"batch/gt", "batch/bs_list"} and sum(counts["batch/bs_list"]) > 0, counts


def test_bootstrap_predictor_matches_jax():
    cfg = tiny_cfg("dl_wc1")
    cfg.MODEL.DEVICE = "cpu"
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.05)
    rng = np.random.RandomState(3)
    batch = [{"image": rng.randint(0, 256, (h, w, 3)).astype(np.float32), "category": "chimp"} for h, w in ((64, 96), (56, 80))]
    ours = build_bootstrap_predictor(cfg, model=port_model(cfg, variables))(batch)
    ref = jax_build_bootstrap_predictor(jax_cfg_from_port(cfg), model=jm, params=variables)(batch)
    for o, r in zip(ours, ref):
        o, r = o["instances"], r["instances"]
        assert len(o) == len(r) >= 5 and o.image_size == r.image_size
        np.testing.assert_allclose(n(o.pred_boxes.tensor), r.pred_boxes.tensor, rtol=0, atol=1e-3)
        np.testing.assert_allclose(o.scores, r.scores, rtol=1e-4, atol=1e-5)
        assert_same(o.pred_classes, r.pred_classes)
        for i, (dm, rm) in enumerate(zip(o.pred_densepose[:5], r.pred_densepose[:5])):
            assert set(dm) == set(rm) >= {"coarse_segm", "fine_segm", "u", "v", "sigma_2"}
            for k in rm:
                np.testing.assert_allclose(dm[k], rm[k], rtol=0, atol=1e-4 * np.abs(rm[k]).max(), err_msg=f"{i} {k}")


# ------------------------------------------------------------- configs, data


EVOLUTION = "evolution/densepose_R_50_FPN_DL_WC1M_3x_Atop10P_CA_B_uniform.yaml"


def test_evolution_yaml_builds_and_its_loader_schema_merges():
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, "configs", "DensePose", EVOLUTION))
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert model.roi_heads.uv_confidence == "iid_iso" and hasattr(model.roi_heads.densepose_predictor, "sigma_2_lowres")
    spec = get_bootstrap_dataset_config().clone()
    spec.merge_from_other_cfg(type(spec)(cfg.BOOTSTRAP_DATASETS[0]))
    assert (spec.DATASET, spec.IMAGE_LOADER.TYPE, spec.DATA_SAMPLER.TYPE, spec.FILTER.MIN_VALUE, spec.INFERENCE.OUTPUT_BATCH_SIZE) == (
        "chimpnsee", "video_keyframe", "densepose_uniform", 0.8, 1)
    meta = MetadataCatalog.get("chimpnsee")
    assert meta.dataset_type == PB.DatasetType.VIDEO_LIST and meta.category == "chimpanzee"
    assert isinstance(PB.build_data_sampler(cfg, spec.DATA_SAMPLER)._samplers[("pred_densepose", "gt_densepose")].func,
                      B.DensePoseUniformSampler)


def test_base_coco_2017_is_registered_in_the_port_only(tmp_path):
    """ROADMAP C, correction 18: the evolution base yaml trains on
    ``base_coco_2017_train``, which the JAX package registers nowhere; the
    port reads it with raw category ids, which the yaml's whitelist and map
    make class 0."""
    assert "base_coco_2017_train" not in JaxDatasetCatalog.list()
    for split in ("train", "val"):
        meta = MetadataCatalog.get(f"base_coco_2017_{split}")
        assert meta.json_file.endswith(f"coco/annotations/instances_{split}2017.json")
        assert meta.image_root.endswith(f"coco/{split}2017") and f"base_coco_2017_{split}" in DatasetCatalog.list()
    json_file, image_root = write_synthetic_coco(str(tmp_path), 8, seed=4, sizes=((40, 50),))
    with open(json_file) as f:
        raw = sorted(a["category_id"] for a in json.load(f)["annotations"])
    DatasetCatalog.register("bs_base_raw", lambda: load_coco_json_raw_ids(json_file, image_root, "bs_base_raw"))
    dicts = DatasetCatalog.get("bs_base_raw")
    assert sorted(a["category_id"] for d in dicts for a in d["annotations"]) == raw and max(raw) > 1
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, "configs", "DensePose", EVOLUTION))
    keep = [1] + list(range(16, 26))
    cfg.DATASETS.WHITELISTED_CATEGORIES["bs_base_raw"] = keep
    cfg.DATASETS.CATEGORY_MAPS["bs_base_raw"] = {str(i): 1 for i in range(16, 26)}
    merged = densepose_dataset_dicts(cfg, ["bs_base_raw"], filter_empty=False)
    kept = [a["category_id"] for d in merged for a in d["annotations"]]
    assert kept == [0] * sum(c in keep for c in raw) and len(kept) < len(raw)
