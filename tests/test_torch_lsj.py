"""Large-scale jitter (LSJ) in the port against the JAX package, on the CPU.

- Four train batches of ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py``'s
  loader (RandomFlip, ResizeScale 0.1-2.0, FixedSizeCrop with a pad of 128,
  boxes recomputed from the cropped polygons, RGB; the target cut to 128
  pixels so the images stay small) from one synthetic dataset are ``==``
  the JAX loader's: the port's from the loader's ``RandomState(SEED)``, the
  JAX package's from numpy's global state after ``np.random.seed(SEED)``
  (without its prefetch thread). Images, boxes, classes, validity and the
  28x28 masks.
- ``ResizeScale`` and ``FixedSizeCrop`` draw what the JAX policies draw and
  give the same transforms; ``ResizeTransform``'s uint8 bilinear equals
  PIL's at scales up to 2; ``PadTransform`` pads images with 128 and
  polygons shift, as in the JAX package.
"""

import copy

import numpy as np
import pytest

import detectron2_tpu.data.build as jax_build
from detectron2_tpu.config import LazyConfig as JaxLazyConfig
from detectron2_tpu.config import instantiate as jax_instantiate
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.common import DatasetFromList as JaxDatasetFromList
from detectron2_tpu.data.common import MapDataset as JaxMapDataset
from detectron2_tpu.data.datasets import register_coco_instances as jax_register
from detectron2_tpu.data.samplers import TrainingSampler as JaxTrainingSampler
from detectron2_tpu_torch.config import LazyConfig, instantiate
from detectron2_tpu_torch.data import PaddedBatchCollator
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.testing import write_synthetic_coco

CONFIG = "configs/ViTDet/mask_rcnn_vitdet_b_100ep.py"
SEED = 5
S = 128  # the LSJ target, cut from 1024
OVERRIDES = [
    "dataloader.train.dataset.names=lsj_test",
    "dataloader.train.total_batch_size=3",
    f"dataloader.train.mapper.augmentations.1.target_height={S}",
    f"dataloader.train.mapper.augmentations.1.target_width={S}",
    f"dataloader.train.mapper.augmentations.2.crop_size=({S},{S})",
]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("lsj")
    json_file, image_root = write_synthetic_coco(str(root), 10, seed=2, sizes=((100, 130), (120, 90), (96, 128)), max_objects=6)
    register_coco_instances("lsj_test", {}, json_file, image_root)
    jax_register("lsj_test", {}, json_file, image_root)
    return json_file, image_root


def _port_batches(n):
    cfg = LazyConfig.apply_overrides(LazyConfig.load(CONFIG), OVERRIDES).dataloader.train
    cfg.collator = PaddedBatchCollator(mask_size=28)
    cfg.rng = np.random.RandomState(SEED)
    it = iter(instantiate(cfg))
    return [next(it) for _ in range(n)]


def _jax_batches(n):
    cfg = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(CONFIG), OVERRIDES).dataloader.train
    dicts, mapper = jax_instantiate(cfg.dataset), jax_instantiate(cfg.mapper)
    np.random.seed(SEED)
    sampler = JaxTrainingSampler(len(dicts))
    dataset = JaxMapDataset(JaxDatasetFromList(copy.deepcopy(dicts), copy=False), mapper)
    it = jax_build.build_batch_data_loader(
        dataset, sampler, cfg.total_batch_size, collator=jax_build.PaddedBatchCollator(mask_size=28), prefetch=0
    )
    return [next(it) for _ in range(n)]


def test_lsj_batches_equal_the_jax_loader(dataset):
    ours = [{k: v if k == "metadata" else np.asarray(v) for k, v in a.items()} for a in _port_batches(4)]
    ref = _jax_batches(4)
    for a, b in zip(ours, ref):
        assert a["image"].shape == b["image"].shape == (3, S, S, 3)
        np.testing.assert_array_equal(a["image"], b["image"].astype(np.uint8))
        np.testing.assert_array_equal(a["image"].astype(np.float32), b["image"])
        np.testing.assert_array_equal(a["image_sizes"], b["image_sizes"])
        for k in ("gt_classes", "gt_valid", "gt_masks"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["gt_boxes"], b["gt_boxes"], rtol=0, atol=1e-6)
        assert [m["image_id"] for m in a["metadata"]] == [m["image_id"] for m in b["metadata"]]
    assert sum(a["gt_valid"].sum() for a in ours) > 10
    # FixedSizeCrop padded some images with 128 (a scale under 1) and cropped others
    padded = [bool((img[-1] == 128).all() or (img[:, -1] == 128).all()) for a in ours for img in a["image"]]
    assert any(padded) and not all(padded)


def test_recomputed_boxes_bound_the_cropped_polygons(dataset):
    """``recompute_boxes``: each box is its cropped polygons' extent, inside
    the crop."""
    cfg = LazyConfig.apply_overrides(LazyConfig.load(CONFIG), OVERRIDES).dataloader.train
    mapper = instantiate(cfg.mapper)
    mapper.augmentations.set_rng(np.random.RandomState(3))
    dicts = instantiate(cfg.dataset)
    n = 0
    for d in dicts:
        out = mapper(d)
        inst = out["instances"]
        boxes = inst.gt_boxes.tensor.numpy()
        for box, polys in zip(boxes, inst.gt_masks.polygons):
            pts = np.concatenate([np.asarray(p).reshape(-1, 2) for p in polys])
            np.testing.assert_allclose(box, [*pts.min(0), *pts.max(0)], rtol=0, atol=1e-4)
            assert (box >= 0).all() and (box <= S).all()
            n += 1
    assert n > 10


@pytest.mark.parametrize("seed", range(4))
def test_resize_scale_and_fixed_size_crop_draw_as_jax(seed):
    img = np.random.RandomState(seed).randint(0, 256, (90 + 7 * seed, 120 - 5 * seed, 3)).astype(np.uint8)
    polys = [np.array([5.0, 5.0, 60.0, 8.0, 40.0, 70.0, 3.0, 50.0])]
    np.random.seed(seed)
    ref = [JT.ResizeScale(0.1, 2.0, S, S).get_transform(img)]
    ref.append(JT.FixedSizeCrop((S, S)).get_transform(ref[0].apply_image(img)))
    rng = np.random.RandomState(seed)
    ours = [T.ResizeScale(0.1, 2.0, S, S)]
    ours[0].set_rng(rng)
    ours[0] = ours[0].get_transform(img)
    crop = T.FixedSizeCrop((S, S))
    crop.set_rng(rng)
    ours.append(crop.get_transform(ours[0].apply_image(img)))
    a, b = img, img
    pa, pb = polys, polys
    for t_ours, t_ref in zip(ours, ref):
        a, b = t_ours.apply_image(a), t_ref.apply_image(b)
        pa, pb = t_ours.apply_polygons(pa), t_ref.apply_polygons(pb)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(np.concatenate(pa), np.concatenate(pb), rtol=0, atol=1e-9)
    assert a.shape == (S, S, 3)


@pytest.mark.parametrize("scale", [0.1, 0.37, 1.0, 1.33, 1.9, 2.0])
def test_uint8_bilinear_resize_equals_pil_at_lsj_scales(scale):
    img = np.random.RandomState(int(scale * 100)).randint(0, 256, (75, 61, 3)).astype(np.uint8)
    nh, nw = max(1, int(round(75 * scale))), max(1, int(round(61 * scale)))
    ours = T.ResizeTransform(75, 61, nh, nw, "bilinear").apply_image(img)
    ref = JT.ResizeTransform(75, 61, nh, nw, "bilinear").apply_image(img)
    assert ours.shape == (nh, nw, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def test_pad_transform_with_pad_value_128():
    img = np.random.RandomState(0).randint(0, 256, (40, 30, 3)).astype(np.uint8)
    seg = np.random.RandomState(1).randint(0, 5, (40, 30)).astype(np.uint8)
    ours, ref = T.PadTransform(0, 0, 9, 14, 30, 40, 128.0), JT.PadTransform(0, 0, 9, 14, 30, 40, 128.0)
    out = ours.apply_image(img)
    np.testing.assert_array_equal(out, ref.apply_image(img))
    assert out.shape == (54, 39, 3) and (out[40:] == 128).all() and (out[:, 30:] == 128).all()
    np.testing.assert_array_equal(ours.apply_segmentation(seg), ref.apply_segmentation(seg))
    crop = T.FixedSizeCrop((64, 64), seg_pad_value=7)
    assert (crop.pad_value, crop.seg_pad_value) == (128.0, 7)
