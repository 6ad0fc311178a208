"""The port's training data path against the JAX package's on the CPU.

- Loader parity: on the same dataset dicts, with the JAX package drawing
  from numpy's global state after ``np.random.seed(s)`` and the port from
  its loader's ``RandomState(s)`` (config ``SEED``), four padded batches are
  equal: uint8 images ``==`` the JAX float32 images after a cast, gt boxes
  within 1e-6, classes, validity and masks ``==``. Cases: polygon and
  bitmask masks, ``INPUT.CROP`` on and off, aspect-ratio grouping on and
  off; the dataset holds crowd annotations, a non-crowd RLE, and an image
  whose only instance is filtered out.
- The seeded augmentation golden ``tests/goldens/augmentations.npz`` holds
  for the port's ``ResizeShortestEdge`` and ``RandomCrop`` (as
  ``tests/parity/test_reference_goldens.py`` holds it for the JAX package).
- Transforms, ``transform_instance_annotations``,
  ``instances_to_padded_targets``, the samplers and the grouping equal the
  JAX functions on seeded inputs (exactly, except the float bilinear resize:
  OpenCV's ``INTER_LINEAR`` against ``F.interpolate``, 1e-4 of the range).
"""

import copy
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import detectron2_tpu.data.build as jax_build
import detectron2_tpu.data.detection_utils as jax_utils
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.common import AspectRatioGroupedDataset as JaxGrouped
from detectron2_tpu.data.common import DatasetFromList as JaxDatasetFromList
from detectron2_tpu.data.common import MapDataset as JaxMapDataset
from detectron2_tpu.data.samplers import GroupedBatchSampler as JaxGroupedBatchSampler
from detectron2_tpu.data.samplers import RandomSubsetTrainingSampler as JaxRandomSubsetTrainingSampler
from detectron2_tpu.data.samplers import RepeatFactorTrainingSampler as JaxRepeatFactorTrainingSampler
from detectron2_tpu.data.samplers import TrainingSampler as JaxTrainingSampler
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import AspectRatioGroupedDataset, build_detection_train_loader
from detectron2_tpu_torch.data.build import _ThreadPrefetcher
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets import load_coco_json
from detectron2_tpu_torch.data.samplers import (
    GroupedBatchSampler,
    RandomSubsetTrainingSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
)
from detectron2_tpu_torch.evaluation.rle import mask_to_rle
from detectron2_tpu_torch.structures import BoxMode
from detectron2_tpu_torch.testing import write_synthetic_coco

from _torch_port import jax_cfg_from_port, load_golden

SIZES = ((48, 64), (64, 48), (40, 56), (56, 40))


@pytest.fixture(scope="module")
def dataset_dicts(tmp_path_factory):
    """12 small synthetic COCO images (crowd RLEs in images 1 and 9), an
    image whose only object has a zero-width box (filtered out by the
    mapper), and for the bitmask format a non-crowd RLE object in image 2
    (the polygon format refuses RLEs in both packages)."""
    root = tmp_path_factory.mktemp("train_data")
    json_file, image_root = write_synthetic_coco(str(root), 12, seed=3, sizes=SIZES, max_objects=5)
    dicts = load_coco_json(json_file, image_root)
    h, w = dicts[1]["height"], dicts[1]["width"]
    blob = np.zeros((h, w), bool)
    blob[10:30, 5:25] = True
    blob[12:14, 30:40] = True
    rle = mask_to_rle(blob)
    rle["counts"] = rle["counts"].decode("ascii")
    dicts[4]["annotations"] = [
        {"bbox": [10.0, 10.0, 0.0, 12.0], "bbox_mode": BoxMode.XYWH_ABS, "category_id": 1, "iscrowd": 0,
         "segmentation": [[10.0, 10.0, 10.0, 22.0, 10.0, 16.0]]}
    ]
    with_rle = copy.deepcopy(dicts)
    with_rle[1]["annotations"].append(
        {"bbox": [5.0, 10.0, 35.0, 20.0], "bbox_mode": BoxMode.XYWH_ABS, "category_id": 3, "iscrowd": 0, "segmentation": rle}
    )
    return {"polygon": dicts, "bitmask": with_rle}


def _cfg(seed, mask_format="polygon", crop=False, grouping=True):
    cfg = get_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg.SEED = seed
    cfg.MODEL.MASK_ON = True
    cfg.SOLVER.IMS_PER_BATCH = 3
    cfg.INPUT.MIN_SIZE_TRAIN = (32, 40, 48)
    cfg.INPUT.MAX_SIZE_TRAIN = 80
    cfg.INPUT.MASK_FORMAT = mask_format
    cfg.INPUT.CROP.ENABLED = crop
    cfg.INPUT.CROP.TYPE = "relative_range"
    cfg.INPUT.CROP.SIZE = [0.5, 0.6]
    cfg.DATALOADER.ASPECT_RATIO_GROUPING = grouping
    cfg.TPU.MAX_GT_INSTANCES = 6
    return cfg


def _jax_batches(cfg, dicts, n):
    """The JAX train loader's first ``n`` batches, without its prefetch
    thread (which would draw from numpy's global state behind the test)."""
    np.random.seed(cfg.SEED)
    kw = jax_build._train_loader_from_config(jax_cfg_from_port(cfg), dataset=copy.deepcopy(dicts))
    dataset = JaxMapDataset(JaxDatasetFromList(kw["dataset"], copy=False), kw["mapper"])
    it = jax_build.build_batch_data_loader(
        dataset, kw["sampler"], kw["total_batch_size"], aspect_ratio_grouping=kw["aspect_ratio_grouping"],
        collator=kw["collator"], prefetch=0,
    )
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize(
    "mask_format,crop,grouping,seed",
    [
        ("polygon", False, True, 0),
        ("polygon", True, True, 1),
        ("polygon", False, False, 2),
        ("bitmask", False, True, 3),
        ("bitmask", True, False, 4),
    ],
)
def test_train_batches_equal_the_jax_loader(dataset_dicts, mask_format, crop, grouping, seed):
    cfg = _cfg(seed, mask_format, crop, grouping)
    dicts = dataset_dicts[mask_format]
    ref = _jax_batches(cfg, dicts, 4)
    loader = build_detection_train_loader(cfg, dataset=copy.deepcopy(dicts))
    n_valid = 0
    for b_ref in ref:
        b = next(loader)
        assert b["image"].dtype == torch.uint8 and b["image"].shape == b_ref["image"].shape
        np.testing.assert_array_equal(b["image"].numpy().astype(np.float32), b_ref["image"])
        np.testing.assert_array_equal(b["image_sizes"].numpy(), b_ref["image_sizes"])
        assert b["metadata"] == b_ref["metadata"]
        np.testing.assert_allclose(b["gt_boxes"].numpy(), b_ref["gt_boxes"], rtol=0, atol=1e-6)
        for k in ("gt_classes", "gt_valid", "gt_masks"):
            assert b[k].dtype == torch.from_numpy(np.asarray(b_ref[k])).dtype, k
            np.testing.assert_array_equal(b[k].numpy(), b_ref[k], err_msg=k)
        n_valid += int(b["gt_valid"].sum())
    assert n_valid > 0 and set(b) == set(b_ref)


def test_loader_draws_follow_the_config_seed(dataset_dicts):
    """Same SEED, same batches; another SEED, other draws."""
    a, b, c = (next(build_detection_train_loader(_cfg(s), dataset=copy.deepcopy(dataset_dicts["polygon"]))) for s in (5, 5, 6))
    assert torch.equal(a["image"], b["image"]) and a["metadata"] == b["metadata"]
    assert a["metadata"] != c["metadata"] or not torch.equal(a["image"], c["image"])


def test_seeded_augmentations_match_the_golden():
    """tests/parity/test_reference_goldens.py's resize and crop sequences,
    drawn from a RandomState owned by the test (image sizes included)."""
    g = load_golden("augmentations")
    rng = np.random.RandomState(42)
    aug = T.ResizeShortestEdge((480, 800), max_size=1333, sample_style="range")
    aug.set_rng(rng)
    for h, w, nh, nw in g["resize_shortest"]:
        img = np.zeros((rng.randint(200, 1200), rng.randint(200, 1200), 3), np.uint8)
        assert img.shape[:2] == (h, w)
        t = aug.get_transform(img)
        assert (getattr(t, "new_h", h), getattr(t, "new_w", w)) == (nh, nw)
    rng = np.random.RandomState(7)
    i = 0
    for ct, cs in [("relative", (0.7, 0.6)), ("relative_range", (0.4, 0.4)), ("absolute", (300, 250)),
                   ("absolute_range", (200, 400))]:
        aug = T.RandomCrop(ct, cs)
        aug.set_rng(rng)
        img = np.zeros((600, 900, 3), np.uint8)
        for _ in range(5):
            t = aug.get_transform(img)
            np.testing.assert_array_equal([t.x0, t.y0, t.w, t.h], g["random_crop"][i])
            i += 1


def test_augmentation_list_hands_its_rng_to_every_member():
    rng = np.random.RandomState(0)
    inner = T.RandomFlip(prob=1.0)
    augs = T.AugmentationList([T.ResizeShortestEdge((10, 20)), T.RandomApply(inner, 0.5)], rng=rng)
    assert all(a.rng is rng for a in augs.augs) and inner.rng is rng
    # the same draws as numpy's global state after np.random.seed
    img = np.zeros((30, 40, 3), np.uint8)
    ours = [augs(T.AugInput(img.copy())) for _ in range(6)]
    np.random.seed(0)
    ref_augs = JT.AugmentationList([JT.ResizeShortestEdge((10, 20)), JT.RandomApply(JT.RandomFlip(prob=1.0), 0.5)])
    ref = [ref_augs(JT.AugInput(img.copy())) for _ in range(6)]
    for a, b in zip(ours, ref):
        assert [type(t).__name__ for t in a] == [type(t).__name__ for t in b]
        assert (a[0].new_h, a[0].new_w) == (b[0].new_h, b[0].new_w)


def _image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.rand(*shape).astype(dtype) * 10


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,new", [((37, 53, 3), (20, 91)), ((64, 48, 1), (48, 36)), ((30, 41), (61, 17))])
def test_resize_filters_equal_the_jax_package(interp, dtype, shape, new):
    """uint8: PIL's NEAREST and BILINEAR bit for bit; float: OpenCV's
    INTER_NEAREST bit for bit, INTER_LINEAR within 1e-4 of the range."""
    rng = np.random.RandomState(zlib.crc32(f"{interp} {dtype} {shape}".encode()))
    img = _image(rng, shape, dtype)
    h, w = shape[:2]
    ours = T.ResizeTransform(h, w, *new, interp).apply_image(img)
    ref = JT.ResizeTransform(h, w, *new, interp).apply_image(img)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if dtype == np.float32 and interp == "bilinear":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * 10)
    else:
        np.testing.assert_array_equal(ours, ref)
    # the same on a tensor
    t = T.ResizeTransform(h, w, *new, interp).apply_image(torch.from_numpy(img))
    np.testing.assert_array_equal(t.numpy(), ours)


@pytest.mark.parametrize("name", ["hflip", "vflip", "crop", "pad"])
def test_geometric_transforms_equal_the_jax_package(name):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (30, 40, 3)).astype(np.uint8)
    coords = rng.uniform(-5, 45, (20, 2))
    polygons = [rng.uniform(0, 40, 12), rng.uniform(0, 40, 8)]
    make = {
        "hflip": lambda m: m.HFlipTransform(40),
        "vflip": lambda m: m.VFlipTransform(30),
        "crop": lambda m: m.CropTransform(5, 7, 20, 15, 40, 30),
        "pad": lambda m: m.PadTransform(3, 4, 5, 6, 40, 30, pad_value=9),
    }[name]
    ours, ref = make(T), make(JT)
    np.testing.assert_array_equal(ours.apply_image(img), ref.apply_image(img))
    np.testing.assert_array_equal(ours.apply_image(torch.from_numpy(img)).numpy(), ref.apply_image(img))
    np.testing.assert_array_equal(ours.apply_coords(coords), ref.apply_coords(coords))
    np.testing.assert_array_equal(ours.apply_box(coords.reshape(-1, 4)), ref.apply_box(coords.reshape(-1, 4)))
    for a, b in zip(ours.apply_polygons(polygons), ref.apply_polygons(polygons)):
        np.testing.assert_array_equal(a, b)
    inv_ours, inv_ref = ours.inverse(), ref.inverse()
    np.testing.assert_array_equal(inv_ours.apply_coords(coords), inv_ref.apply_coords(coords))


def _annotations(rng, h, w, n):
    annos = []
    for _ in range(n):
        x, y = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
        bw, bh = rng.uniform(2, w - x), rng.uniform(2, h - y)
        k = rng.randint(3, 8)
        poly = np.stack([rng.uniform(x, x + bw, k), rng.uniform(y, y + bh, k)], 1).ravel().tolist()
        annos.append({"bbox": [x, y, bw, bh], "bbox_mode": BoxMode.XYWH_ABS, "category_id": int(rng.randint(5)),
                      "segmentation": [poly], "iscrowd": 0})
    return annos


def _transforms(m, kind):
    return {
        "resize_flip": [m.ResizeTransform(60, 80, 45, 61), m.HFlipTransform(61)],
        "crop_resize": [m.CropTransform(5, 7, 50, 40), m.ResizeTransform(40, 50, 70, 88), m.VFlipTransform(70)],
        "flip_only": [m.HFlipTransform(80)],
    }[kind]


def _out_size(kind):
    return {"resize_flip": (45, 61), "crop_resize": (70, 88), "flip_only": (60, 80)}[kind]


@pytest.mark.parametrize("kind", ["resize_flip", "crop_resize", "flip_only"])
def test_transform_instance_annotations_equals_the_jax_function(kind):
    rng = np.random.RandomState(len(kind))
    annos = _annotations(rng, 60, 80, 6)
    for a in annos:
        ours = utils.transform_instance_annotations(copy.deepcopy(a), T.TransformList(_transforms(T, kind)), _out_size(kind))
        ref = jax_utils.transform_instance_annotations(copy.deepcopy(a), JT.TransformList(_transforms(JT, kind)), _out_size(kind))
        np.testing.assert_array_equal(ours["bbox"], ref["bbox"])
        assert int(ours["bbox_mode"]) == int(ref["bbox_mode"]) == 0
        for p, q in zip(ours["segmentation"], ref["segmentation"]):
            np.testing.assert_array_equal(p, q)


def test_rle_segmentation_transforms_as_the_jax_function():
    """An RLE mask goes through the nearest resize (PIL's on uint8)."""
    rng = np.random.RandomState(4)
    mask = rng.rand(60, 80) < 0.3
    rle = mask_to_rle(mask)
    a = {"bbox": [1.0, 2.0, 30.0, 40.0], "bbox_mode": BoxMode.XYWH_ABS, "category_id": 0, "segmentation": rle}
    ours = utils.transform_instance_annotations(copy.deepcopy(a), _transforms(T, "crop_resize"), (70, 88))
    ref = jax_utils.transform_instance_annotations(copy.deepcopy(a), _transforms(JT, "crop_resize"), (70, 88))
    assert ours["segmentation"].dtype == bool
    np.testing.assert_array_equal(ours["segmentation"], ref["segmentation"])


@pytest.mark.parametrize("mask_format,n,G", [("polygon", 6, 8), ("polygon", 6, 4), ("bitmask", 5, 8), ("polygon", 0, 3)])
def test_instances_to_padded_targets_equals_the_jax_function(mask_format, n, G):
    rng = np.random.RandomState(n + G)
    annos = _annotations(rng, 60, 80, n)
    annos = [jax_utils.transform_instance_annotations(a, [JT.HFlipTransform(80)], (60, 80)) for a in annos]
    ours = utils.instances_to_padded_targets(
        utils.filter_empty_instances(utils.annotations_to_instances(copy.deepcopy(annos), (60, 80), mask_format)), G, 28
    )
    ref = jax_utils.instances_to_padded_targets(
        jax_utils.filter_empty_instances(jax_utils.annotations_to_instances(copy.deepcopy(annos), (60, 80), mask_format)),
        G, 28,
    )
    assert set(ours) == set(ref)
    np.testing.assert_allclose(ours["gt_boxes"], ref["gt_boxes"], rtol=0, atol=1e-6)
    for k in ("gt_classes", "gt_valid", "gt_masks"):
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert int(ours["gt_valid"].sum()) == min(n, G)
    assert n == 0 or ours["gt_masks"].max() == 1.0


def test_recomputed_boxes_and_filtered_instances_equal_the_jax_package():
    rng = np.random.RandomState(9)
    annos = _annotations(rng, 60, 80, 5)
    annos[2]["bbox"] = [10.0, 10.0, 0.0, 5.0]  # an empty box: filtered
    for fmt in ("polygon", "bitmask"):
        ours = utils.annotations_to_instances(copy.deepcopy(annos), (60, 80), fmt)
        ref = jax_utils.annotations_to_instances(copy.deepcopy(annos), (60, 80), fmt)
        np.testing.assert_array_equal(ours.gt_masks.get_bounding_boxes().tensor.numpy(), np.asarray(ref.gt_masks.get_bounding_boxes().tensor))
        kept, m = utils.filter_empty_instances(ours, return_mask=True)
        kept_ref, m_ref = jax_utils.filter_empty_instances(ref, return_mask=True)
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
        assert len(kept) == len(kept_ref) == 4
        np.testing.assert_array_equal(kept.gt_classes.numpy(), np.asarray(kept_ref.gt_classes))


def test_repeat_factor_sampler_equals_the_jax_one():
    rng = np.random.RandomState(0)
    dicts = [{"annotations": [{"category_id": int(c)} for c in rng.choice(6, rng.randint(1, 4), p=[0.5, 0.2, 0.15, 0.1, 0.04, 0.01])]}
             for _ in range(40)]
    ours = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(dicts, 0.3)
    ref = JaxRepeatFactorTrainingSampler.repeat_factors_from_category_frequency(dicts, 0.3)
    np.testing.assert_array_equal(ours, ref)
    assert ours.max() > 1
    a = RepeatFactorTrainingSampler(ours, seed=3)
    b = JaxRepeatFactorTrainingSampler(ref, seed=3)
    assert list(_take(a, 200)) == list(_take(b, 200))


def _take(sampler, n):
    it = iter(sampler)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_training_samplers_equal_the_jax_ones(shuffle):
    assert _take(TrainingSampler(13, shuffle=shuffle, seed=4), 60) == _take(JaxTrainingSampler(13, shuffle=shuffle, seed=4), 60)
    ours = RandomSubsetTrainingSampler(20, 0.4, shuffle=shuffle, seed_shuffle=1, seed_subset=2)
    ref = JaxRandomSubsetTrainingSampler(20, 0.4, shuffle=shuffle, seed_shuffle=1, seed_subset=2)
    assert _take(ours, 40) == _take(ref, 40)
    # without seeds: drawn from numpy's global state, as the JAX sampler's shared seed
    np.random.seed(8)
    ours = _take(TrainingSampler(13, shuffle=shuffle), 30)
    np.random.seed(8)
    assert ours == _take(JaxTrainingSampler(13, shuffle=shuffle), 30)


def test_grouping_equals_the_jax_package():
    rng = np.random.RandomState(2)
    records = [{"width": int(w), "height": int(h), "i": i} for i, (w, h) in enumerate(rng.randint(10, 50, (30, 2)))]
    assert list(AspectRatioGroupedDataset(records, 4)) == list(JaxGrouped(records, 4))
    groups = rng.randint(0, 3, 30)
    ours = GroupedBatchSampler(_take(TrainingSampler(30, seed=1), 90), groups, 5)
    ref = JaxGroupedBatchSampler(_take(JaxTrainingSampler(30, seed=1), 90), groups, 5)
    assert list(ours) == list(ref)


_EXIT_DURING_A_TORCH_CALL = r"""
import torch
torch.set_num_threads(1)
from detectron2_tpu_torch.data.build import _ThreadPrefetcher

def items():
    a = torch.randn(600, 600)
    while True:
        for _ in range(20):
            a = torch.tanh(a @ a / 600)
        yield a.sum()

next(_ThreadPrefetcher(items(), depth=1))
"""


def test_prefetch_thread_stops_at_close_and_before_the_interpreter_exits():
    """The train loader's thread maps the next batch while the program ends.
    Left running, Python finalized with that daemon thread inside a torch
    call and the process aborted (exit 134, "terminate called without an
    active exception") after a finished run; closed at exit, it exits 0.
    ``close()`` stops the thread after the item it is making."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", _EXIT_DURING_A_TORCH_CALL], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    prefetcher = _ThreadPrefetcher(iter(range(100)), depth=1)
    assert next(prefetcher) == 0
    prefetcher.close()
    assert not prefetcher._thread.is_alive()
