"""The DensePose evaluator of the port (``projects/densepose/{dp_coco_eval,
evaluation,tensor_storage,trainer}.py``):

- the protocol engine against every mode of
  ``tests/projects/data/densepose_eval_goldens.json`` (d2's evaluation file
  on the scenario of ``tests/projects/densepose_eval_synth.py``), atol 1e-9
  as the JAX oracle test holds it;
- ``DensePoseCOCOEvaluator`` against the JAX evaluator on the same ground
  truth and prediction dicts (quantized stacks and ``[M, M, 3]`` grids),
  with and without a spool;
- ``testing.write_synthetic_densepose_eval_data``'s SMPL files (the full
  ~1.5 GB condensed matrix) through both packages' ``load_smpl_mesh_tables``,
  against the tables written;
- the spool's round trip in both backends;
- correction 16 (ROADMAP C) both ways: a tiny R18 DensePose R-CNN through
  the JAX ``Trainer.test`` fails in its evaluator's ``process`` and the JAX
  trainer's evaluator scores nothing (``AP`` nan) given predictions it
  takes; through the port's ``Trainer.test`` it gives finite
  ``densepose_gps``, ``densepose_gpsm`` and ``densepose_segm``.
"""

import copy
import gc
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "projects"))

from densepose_eval_synth import make_cases, make_mesh_tables, rasterize_ignore_regions  # noqa: E402

from detectron2_tpu_torch.projects.densepose import dp_coco_eval  # noqa: E402
from detectron2_tpu_torch.projects.densepose.evaluation import (  # noqa: E402
    DensePoseCOCOEvaluator,
    load_smpl_mesh_tables,
)
from detectron2_tpu_torch.projects.densepose.tensor_storage import (  # noqa: E402
    BlobSpool,
    LazyBlob,
    build_densepose_evaluator_storage,
)
from detectron2_tpu_torch.testing import synthetic_pdist_values, write_synthetic_densepose_eval_data  # noqa: E402

torch.set_num_threads(1)
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "projects", "data", "densepose_eval_goldens.json")


@pytest.fixture(scope="module")
def scenario():
    return make_cases(), make_mesh_tables()


@pytest.mark.parametrize("mode", ["gps", "gpsm", "iou"])
def test_engine_matches_goldens(scenario, mode):
    with open(GOLDENS) as f:
        g = json.load(f)["modes"][mode]
    cases, table_kw = scenario
    dts = [dict({k: v for k, v in d.items() if k != "densepose_iuv"}, densepose=d["densepose_iuv"]) for d in cases["dts"]]
    engine = dp_coco_eval.DensePoseCocoEvalEngine(
        gts=copy.deepcopy(cases["gts"]), dts=dts, image_sizes=cases["image_sizes"],
        tables=dp_coco_eval.GeodesicMeshTables(**table_kw), dp_eval_mode=mode,
        ignore_regions=rasterize_ignore_regions(cases["ignore_polys"], cases["image_sizes"]),
    )
    engine.evaluate()
    engine.accumulate()
    engine.summarize()
    for key, ref in g["gps"].items():
        img_id, cat_id = (int(v) for v in key.split("_"))
        np.testing.assert_allclose(np.asarray(engine.ious[img_id, cat_id][0]), np.asarray(ref), atol=1e-9, err_msg=key)
    prec = engine.eval["precision"]
    assert abs(float(prec[prec > -1].sum()) - g["precision_sum"]) < 1e-9
    np.testing.assert_allclose(engine.eval["recall"], np.asarray(g["recall"]), atol=1e-9)
    np.testing.assert_allclose(engine.stats, np.asarray(g["stats"]), atol=1e-9)
    assert engine.stats[0] > 0.1


def _grid(iuv_stack, M=16):
    """A quantized ``[3, h, w]`` stack as the model's ``[M, M, 3]`` float
    grid (part, U, V), nearest samples."""
    h, w = iuv_stack.shape[1:]
    ys = np.minimum((np.arange(M) + 0.5) * h / M, h - 1).astype(int)
    xs = np.minimum((np.arange(M) + 0.5) * w / M, w - 1).astype(int)
    s = iuv_stack[:, ys][:, :, xs].astype(np.float32)
    return np.stack([s[0], s[1] / 255.0, s[2] / 255.0], -1)


@pytest.mark.parametrize("storage", ["none", "ram", "file"])
@pytest.mark.parametrize("form", ["quantized", "grid"])
def test_evaluator_matches_jax(scenario, tmp_path, storage, form):
    from detectron2_tpu.projects.densepose.dp_coco_eval import GeodesicMeshTables as JaxTables
    from detectron2_tpu.projects.densepose.evaluation import DensePoseCOCOEvaluator as JaxEvaluator

    cases, table_kw = scenario
    gts_by_image = {}
    for g in cases["gts"]:
        gts_by_image.setdefault(g["image_id"], []).append({k: v for k, v in g.items() if k != "image_id"})
    preds = {}
    for d in cases["dts"]:
        dp = d["densepose_iuv"] if form == "quantized" else _grid(d["densepose_iuv"])
        preds.setdefault(d["image_id"], []).append({"bbox": d["bbox"], "score": d["score"], "densepose": dp})
    ignore = rasterize_ignore_regions(cases["ignore_polys"], cases["image_sizes"])
    jev = JaxEvaluator("dp_eval_unregistered", JaxTables(**table_kw))
    jev.set_ground_truth(copy.deepcopy(gts_by_image), cases["image_sizes"], ignore)
    jev.process(None, [{"image_id": i, "instances": p} for i, p in preds.items()])
    ref = jev.evaluate()
    ev = DensePoseCOCOEvaluator(
        "dp_eval_unregistered", dp_coco_eval.GeodesicMeshTables(**table_kw),
        storage=build_densepose_evaluator_storage(storage, str(tmp_path)),
    )
    ev.set_ground_truth(copy.deepcopy(gts_by_image), cases["image_sizes"], ignore)
    for i, p in preds.items():
        ev.add_predictions(i, p)
    out = ev.evaluate()
    assert list(out) == ["densepose_gps", "densepose_gpsm", "densepose_segm"] == list(ref)
    for sec in out:
        assert list(out[sec]) == list(ref[sec])
        np.testing.assert_allclose([out[sec][k] for k in out[sec]], [ref[sec][k] for k in ref[sec]], atol=1e-9, err_msg=sec)
    # the scenario's stacks reproduce the gt points (the grids' 16x16 samples
    # miss them: AP 0 there, in both packages)
    assert out["densepose_segm"]["AP"] > 10 and (form == "grid" or out["densepose_gps"]["AP"] > 10)


@pytest.mark.parametrize("kind", ["ram", "file"])
def test_spool_round_trip(tmp_path, kind):
    spool = build_densepose_evaluator_storage(kind, str(tmp_path))
    assert isinstance(spool, BlobSpool) and build_densepose_evaluator_storage("none") is None
    rng = np.random.RandomState(0)
    arrays = [rng.randint(0, 256, (3, h, w)).astype(np.uint8) for h, w in ((5, 7), (12, 3), (1, 1))]
    arrays.append(rng.rand(4, 2).astype(np.float32))
    refs = [spool.put(a) for a in arrays]
    assert [r.offset for r in refs] == list(np.cumsum([0] + [a.nbytes for a in arrays[:-1]]))
    spool.finalize_for_read()
    with pytest.raises(AssertionError):
        spool.put(arrays[0])
    for a, r in zip(reversed(arrays), reversed(refs)):
        lazy = LazyBlob(spool, r)
        assert lazy.shape == a.shape
        np.testing.assert_array_equal(np.asarray(lazy), a)
        np.testing.assert_array_equal(lazy[0], a[0])
    if kind == "file":
        assert os.path.getsize(tmp_path / "densepose_eval" / "densepose_eval_spool.bin") == sum(a.nbytes for a in arrays)
    spool.close()


@pytest.fixture(scope="module")
def smpl_root(tmp_path_factory):
    """The synthetic SMPL evaluation files (the full condensed matrix),
    written once for the module."""
    from detectron2_tpu_torch.projects.densepose import evaluation

    root = str(tmp_path_factory.mktemp("datasets"))
    tables = write_synthetic_densepose_eval_data(root, seed=2, vertices_per_part=6)
    yield root, tables
    evaluation._TABLES_CACHE.clear()  # the 1.5 GB matrix stays with the module


def test_smpl_files_load_in_both_packages(smpl_root):
    from detectron2_tpu.projects.densepose.evaluation import load_smpl_mesh_tables as jax_load

    root, written = smpl_root
    data_dir = os.path.join(root, "densepose_eval_data")
    n = written["n_reduced"]
    k = np.concatenate([np.arange(5), np.random.RandomState(0).randint(0, n * (n - 1) // 2, 1000), [n * (n - 1) // 2 - 1]])
    for load in (load_smpl_mesh_tables, jax_load):
        tables = load(data_dir)
        for a, b in zip(tables.part_uvs + tables.part_vert_inds, written["part_uvs"] + written["part_vert_inds"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tables.part_ids, written["part_ids"])
        np.testing.assert_array_equal(tables.pdist_transform, written["pdist_transform"])
        assert tables.n_reduced == n and tables.pdist_matrix.shape == (n * (n - 1) // 2, 1)
        np.testing.assert_array_equal(tables.pdist_matrix[k, 0], synthetic_pdist_values(k))
        # a geodesic query reads the hash at the condensed index
        raw = tables.snap_to_chart_verts(np.array([0.3, 0.7]), np.array([0.2, 0.9]), np.array([3, 17]))
        red = tables.reduce_vert_ids(raw)
        assert (red > 0).all() and tables.geodesic_lookup(red - 1, red[::-1] - 1)[0] > 0
        del tables
        gc.collect()


def _tiny_densepose(root):
    """The tiny R18 DensePose R-CNN of test_torch_densepose_rcnn at small
    test sizes, on 3 synthetic minival images registered under a test name
    in both packages."""
    from detectron2_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from detectron2_tpu.data import MetadataCatalog as JaxMetadataCatalog
    from detectron2_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
    from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from detectron2_tpu_torch.data.datasets.builtin import DENSEPOSE_ANN_KEYS
    from detectron2_tpu_torch.data.datasets.coco import load_coco_json
    from detectron2_tpu_torch.testing import write_synthetic_densepose_coco
    from test_torch_densepose_rcnn import tiny_cfg

    (json_file, image_root), = write_synthetic_densepose_coco(
        root, 3, seed=5, sizes=((96, 128), (128, 96)), splits=("densepose_coco_2014_minival",)
    ).values()
    name = "dp_eval_tiny_minival"
    for catalog, meta, load in ((DatasetCatalog, MetadataCatalog, load_coco_json),
                                (JaxDatasetCatalog, JaxMetadataCatalog, jax_load_coco_json)):
        if name not in catalog.list():
            catalog.register(name, lambda load=load: load(json_file, image_root, name, extra_annotation_keys=DENSEPOSE_ANN_KEYS))
            meta.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="densepose_coco")
    cfg = tiny_cfg("decoder")
    cfg.DATASETS.TEST = (name,)
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 96, 128
    cfg.MODEL.ROI_DENSEPOSE_HEAD.RAW_OUTPUTS = False
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    return cfg, name


def test_correction16_evaluator_scores_the_model(smpl_root, monkeypatch):
    from _torch_port import jax_cfg_from_port, jax_model, jax_random_variables, port_model

    from detectron2_tpu.projects.densepose.trainer import Trainer as JaxTrainer
    from detectron2_tpu_torch.projects.densepose import Trainer

    root, _ = smpl_root
    monkeypatch.setenv("DETECTRON2_DATASETS", root)
    cfg, name = _tiny_densepose(root)
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.05)

    # the JAX trainer: its evaluator cannot read the model's outputs ...
    jcfg = jax_cfg_from_port(cfg)
    with pytest.raises((TypeError, KeyError, IndexError)):
        JaxTrainer.test(jcfg, jm, params=variables)
    gc.collect()
    # ... and, given predictions in the form its process takes, scores none:
    # build_evaluator never gives it the ground truth
    evaluator = JaxTrainer.build_evaluator(jcfg, name)._evaluators[1]
    evaluator.process(None, [{"image_id": 1, "instances": [
        {"bbox": [10.0, 10.0, 40.0, 50.0], "score": 0.9, "densepose": np.zeros((16, 16, 3), np.float32)}]}])
    res = evaluator.evaluate()
    assert list(res) == ["densepose_gps"] and math.isnan(res["densepose_gps"]["AP"])
    del evaluator
    gc.collect()

    # the port: finite GPS, GPSM and segm sections from the model itself
    cfg.defrost()
    cfg.MODEL.DEVICE = "cpu"
    model = port_model(cfg, variables)
    results = Trainer.test(cfg, model)
    assert {"bbox", "densepose_gps", "densepose_gpsm", "densepose_segm"} <= set(results), list(results)
    for sec in ("densepose_gps", "densepose_gpsm", "densepose_segm"):
        assert results[sec] and all(math.isfinite(v) for v in results[sec].values()), (sec, results[sec])
    gc.collect()


@pytest.mark.parametrize("fill,mode,section,floor", [("masks", "iou", "densepose_segm", 100.0),
                                                     ("points", "gps", "densepose_gps", 80.0)])
def test_correction16_evaluator_scores_the_ground_truth(smpl_root, tmp_path, fill, mode, section, floor):
    """The ground truth of a dataset fed back as the model's detections
    (``testing.densepose_ground_truth_outputs``: boxes in an input frame at
    twice the image size, charts in the box frame) through the evaluator's
    ``process`` and ``_load_ground_truth``: the masks match every gt at IoU
    1 (segm AP 100), the nearest points' charts give a GPS AP of at least
    80; with the image ids rotated among the images, AP 0."""
    from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from detectron2_tpu_torch.data.datasets.builtin import DENSEPOSE_ANN_KEYS
    from detectron2_tpu_torch.data.datasets.coco import load_coco_json
    from detectron2_tpu_torch.testing import densepose_ground_truth_outputs, write_synthetic_densepose_coco

    (json_file, image_root), = write_synthetic_densepose_coco(
        str(tmp_path), 2, seed=41, splits=("densepose_coco_2014_minival",)).values()
    name = f"dp_eval_feedback_{fill}"
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name, extra_annotation_keys=DENSEPOSE_ANN_KEYS))
    try:
        tables = load_smpl_mesh_tables(os.path.join(smpl_root[0], "densepose_eval_data"))
        aps = []
        for rotate in (0, 1):
            pairs = densepose_ground_truth_outputs(DatasetCatalog.get(name), fill)
            ids = [inputs["metadata"][0]["image_id"] for inputs, _ in pairs]
            evaluator = DensePoseCOCOEvaluator(name, tables, mode=mode)
            evaluator.reset()
            for (inputs, outputs), image_id in zip(pairs, ids[rotate:] + ids[:rotate]):
                inputs["metadata"][0]["image_id"] = image_id
                evaluator.process(inputs, outputs)
            aps.append(evaluator.evaluate()[section])
        assert len(evaluator._gts) == 2 and sum(map(len, evaluator._gts.values())) > 2
        assert aps[0]["AP"] >= floor and aps[0]["AP50"] == 100.0, aps[0]
        assert aps[1]["AP"] == 0.0, aps[1]
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
