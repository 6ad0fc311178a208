"""The CSE DensePose data of the port against the JAX package, on the CPU:

- the 18 CSE yamls (the 17 of ``configs/DensePose/cse/`` and the CSE
  quick schedule) build after ``add_densepose_config`` (on the meta device)
  and name only registered datasets;
- on synthetic CSE splits (``testing.write_synthetic_densepose_cse``) the
  COCO ``_cse`` json and the DensePose-LVIS json load as the JAX loaders
  load them, and the mapper's and collator's batches ``==`` the JAX ones
  (vertex ids, mesh ids), with and without a flip through a staged symmetry
  table (``testing.write_synthetic_cse_meshes``), and with none staged (the
  ids kept in both);
- correction 17 (ROADMAP C) both ways: the JAX package keeps the raw LVIS
  ids (``gt_classes`` up to 1202 for a 9-class head); the port's DensePose
  trainer reads ``WHITELISTED_CATEGORIES`` and ``CATEGORY_MAPS``: the
  animals become 0..8 in the order of the configs'
  ``CLASS_TO_MESH_NAME_MAPPING``, the other categories are dropped.
"""

import copy
import os

import numpy as np
import pytest
import torch

from _torch_port import n

from detectron2_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.build import get_detection_dataset_dicts as jax_dataset_dicts
from detectron2_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from detectron2_tpu.projects.densepose.dataset_mapper import DensePoseBatchCollator as JaxCollator
from detectron2_tpu.projects.densepose.dataset_mapper import DensePoseDatasetMapper as JaxMapper
from detectron2_tpu.projects.densepose.datasets import load_densepose_lvis_json as jax_load_lvis
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets.builtin import DENSEPOSE_CSE_ANN_KEYS
from detectron2_tpu_torch.data.datasets.coco import load_coco_json
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects.densepose import (
    DensePoseBatchCollator,
    DensePoseDatasetMapper,
    DensePoseROIHeads,
    add_densepose_config,
    densepose_dataset_dicts,
    load_densepose_lvis_json,
)
from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog
from detectron2_tpu_torch.testing import (
    DENSEPOSE_LVIS_ANIMALS,
    write_synthetic_cse_meshes,
    write_synthetic_densepose_cse,
)
from test_torch_densepose_data import CSE, DP_CONFIGS

torch.set_num_threads(1)
SMPL = {"smpl_27554": 300}


def test_the_cse_yaml_set():
    assert len(CSE) == 18 and sum(y.startswith("cse/") for y in CSE) == 17


@pytest.mark.parametrize("yaml", CSE)
def test_cse_yamls_build(yaml):
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(DP_CONFIGS, yaml))
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    heads, h = model.roi_heads, cfg.MODEL.ROI_DENSEPOSE_HEAD
    assert isinstance(heads, DensePoseROIHeads) and type(heads.densepose_predictor).__name__ == "DensePoseEmbeddingPredictor"
    assert heads.densepose_predictor.embed_lowres.out_channels == h.CSE.EMBED_SIZE
    assert heads.cse_mesh_names == tuple(sorted(h.CSE.EMBEDDERS)) and len(heads.cse_mesh_names) >= 1
    assert all(mid == MeshCatalog.get_mesh_id(m) for mid, m in zip(heads.cse_mesh_ids, heads.cse_mesh_names))
    assert set(heads.class_to_mesh_name.values()) <= set(heads.cse_mesh_names)
    assert heads.segm_trained_by_masks == h.COARSE_SEGM_TRAINED_BY_MASKS
    assert (heads.shape2shape_weight > 0) == h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.ENABLED
    assert (heads.pix2shape_weight > 0) == h.CSE.PIX_TO_SHAPE_CYCLE_LOSS.ENABLED
    for name in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST:
        assert name in DatasetCatalog.list(), name


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("densepose_cse"))
    sizes = {**SMPL, **{m: 40 + 5 * i for i, m in enumerate(sorted({a[1] for a in DENSEPOSE_LVIS_ANIMALS.values()}))}}
    splits = write_synthetic_densepose_cse(
        root, 6, seed=0, sizes=((60, 90), (90, 64)), coco_splits=("densepose_coco_2014_train_cse",),
        lvis_splits=("densepose_lvis_v1_ds1_train_v1",), num_vertices=sizes,
    )
    meshes = str(tmp_path_factory.mktemp("meshes"))
    write_synthetic_cse_meshes(meshes, ["smpl_27554"], seed=1, num_vertices=SMPL, feature_dim=8)
    return root, splits, meshes


def test_cse_jsons_load_as_in_jax(synthetic):
    _, splits, _ = synthetic
    json_file, image_root = splits["densepose_coco_2014_train_cse"]
    ours = load_coco_json(json_file, image_root, "synth_dp_cse", extra_annotation_keys=DENSEPOSE_CSE_ANN_KEYS)
    ref = jax_load_coco_json(json_file, image_root, "synth_dp_cse", extra_annotation_keys=DENSEPOSE_CSE_ANN_KEYS)
    assert ours == ref and len(ours) == 6
    with_v = [a for d in ours for a in d["annotations"] if "dp_vertex" in a]
    assert with_v and all(a["ref_model"] == "smpl_27554" and max(a["dp_vertex"]) < 300 for a in with_v)
    json_file, image_root = splits["densepose_lvis_v1_ds1_train_v1"]
    ours = load_densepose_lvis_json(json_file, image_root, "synth_dp_lvis")
    assert ours == jax_load_lvis(json_file, image_root, None) and len(ours) == 6
    cats = {a["category_id"] for d in ours for a in d["annotations"]}
    assert cats - set(DENSEPOSE_LVIS_ANIMALS) and cats & set(DENSEPOSE_LVIS_ANIMALS)  # raw ids, others among them
    assert all(os.path.exists(d["file_name"]) for d in ours)


@pytest.mark.parametrize("flip", ["no_flip", "flip", "flip_unstaged"])
def test_mapper_and_collator_equal_jax(synthetic, flip, monkeypatch, tmp_path):
    root, splits, meshes = synthetic
    monkeypatch.setenv("DETECTRON2_DATASETS", meshes if flip == "flip" else str(tmp_path))
    json_file, image_root = splits["densepose_coco_2014_train_cse"]
    dicts = load_coco_json(json_file, image_root, extra_annotation_keys=DENSEPOSE_CSE_ANN_KEYS)
    prob = 0.0 if flip == "no_flip" else 1.0
    ours = DensePoseDatasetMapper(
        True, augmentations=[T.ResizeShortestEdge((96,), 128, "choice"), T.RandomFlip(prob=prob)], image_format="BGR"
    )
    ref = JaxMapper(
        True, augmentations=[JT.ResizeShortestEdge((96,), 128, "choice"), JT.RandomFlip(prob=prob)], image_format="BGR"
    )
    batch = DensePoseBatchCollator(max_gt_instances=8)([ours(copy.deepcopy(d)) for d in dicts])
    jbatch = JaxCollator(max_gt_instances=8)([ref(copy.deepcopy(d)) for d in dicts])
    assert set(batch) == set(jbatch) and {"gt_dp_vertex", "gt_dp_mesh_id"} <= set(batch)
    for k, v in batch.items():
        if k != "metadata":
            np.testing.assert_array_equal(n(v), np.asarray(jbatch[k]), err_msg=k)
    vert, mesh = n(batch["gt_dp_vertex"]), n(batch["gt_dp_mesh_id"])
    has = (vert >= 0).any(-1)
    assert has.any() and (mesh[has] == MeshCatalog.get_mesh_id("smpl_27554")).all() and (n(batch["gt_dp_part"]) == -1).all()
    unflipped = DensePoseBatchCollator(max_gt_instances=8)([
        DensePoseDatasetMapper(True, augmentations=[T.ResizeShortestEdge((96,), 128, "choice")], image_format="BGR")(
            copy.deepcopy(d)) for d in dicts])
    same = np.array_equal(vert, n(unflipped["gt_dp_vertex"]))
    assert same == (flip != "flip")  # a staged table moves the ids; none keeps them


def _lvis_cfg(name: str, category_maps=None):
    cfg = get_cfg()
    add_densepose_config(cfg)
    cfg.merge_from_file(os.path.join(DP_CONFIGS, "cse", "densepose_rcnn_R_50_FPN_soft_animals_finetune_4k.yaml"))
    whitelist = cfg.DATASETS.WHITELISTED_CATEGORIES["densepose_lvis_v1_ds1_train_v1"]
    cfg.DATASETS.WHITELISTED_CATEGORIES[name] = list(whitelist)
    if category_maps:
        cfg.DATASETS.CATEGORY_MAPS[name] = category_maps
    return cfg


def _register_lvis(name, json_file, image_root):
    if name not in DatasetCatalog.list():
        DatasetCatalog.register(name, lambda: load_densepose_lvis_json(json_file, image_root, name))
        JaxDatasetCatalog.register(name, lambda: jax_load_lvis(json_file, image_root, None))


def test_correction17_category_whitelist_and_maps(synthetic):
    _, splits, _ = synthetic
    json_file, image_root = splits["densepose_lvis_v1_ds1_train_v1"]
    name = "dp_lvis_correction17"
    _register_lvis(name, json_file, image_root)
    raw = [a["category_id"] for d in jax_dataset_dicts([name]) for a in d["annotations"]]
    # the JAX package: raw LVIS ids reach the 9-class head
    assert max(raw) > 9 and set(raw) - set(DENSEPOSE_LVIS_ANIMALS)
    cfg = _lvis_cfg(name)
    dicts = densepose_dataset_dicts(cfg, [name])
    ids = [a["category_id"] for d in dicts for a in d["annotations"]]
    animals = sorted(DENSEPOSE_LVIS_ANIMALS)
    assert sorted(ids) == sorted(animals.index(c) for c in raw if c in DENSEPOSE_LVIS_ANIMALS)
    meta = MetadataCatalog.get(name)
    assert meta.thing_classes == [DENSEPOSE_LVIS_ANIMALS[c][0] for c in animals]
    assert meta.thing_dataset_id_to_contiguous_id == {c: i for i, c in enumerate(animals)}
    # the class order is the configs' mesh order
    mapping = cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING
    assert [mapping[str(i)] for i in range(9)] == [DENSEPOSE_LVIS_ANIMALS[c][1] for c in animals]
    # a category map merges ids before they are made contiguous: cow onto bear
    dicts = densepose_dataset_dicts(_lvis_cfg(name, {"80": 76}), [name])
    merged = [a["category_id"] for d in dicts for a in d["annotations"]]
    assert max(merged) == 7 and sorted(merged) == sorted(
        [0 if c in (76, 80) else animals.index(c) - 1 for c in raw if c in DENSEPOSE_LVIS_ANIMALS]
    )


def test_correction17_in_the_batches(synthetic):
    """The classes the two packages' mappers and collators give the head."""
    _, splits, _ = synthetic
    json_file, image_root = splits["densepose_lvis_v1_ds1_train_v1"]
    name = "dp_lvis_correction17"
    _register_lvis(name, json_file, image_root)
    aug = [T.ResizeShortestEdge((96,), 128, "choice")]
    batch = DensePoseBatchCollator(max_gt_instances=8)(
        [DensePoseDatasetMapper(True, augmentations=aug, image_format="BGR")(d) for d in densepose_dataset_dicts(_lvis_cfg(name), [name])]
    )
    jbatch = JaxCollator(max_gt_instances=8)(
        [JaxMapper(True, augmentations=[JT.ResizeShortestEdge((96,), 128, "choice")], image_format="BGR")(d)
         for d in jax_dataset_dicts([name])]
    )
    ours = n(batch["gt_classes"])[n(batch["gt_valid"])]
    ref = np.asarray(jbatch["gt_classes"])[np.asarray(jbatch["gt_valid"])]
    assert ours.max() <= 8 and ref.max() > 8
    meshes = n(batch["gt_dp_mesh_id"])[n(batch["gt_valid"])]
    names = [DENSEPOSE_LVIS_ANIMALS[c][1] for c in sorted(DENSEPOSE_LVIS_ANIMALS)]
    with_v = meshes >= 0
    assert with_v.any() and all(MeshCatalog.get_mesh_name(m) == names[c] for m, c in zip(meshes[with_v], ours[with_v]))
