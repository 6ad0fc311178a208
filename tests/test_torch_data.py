"""The port's test-time data path against the JAX package's, on the CPU:
the COCO json loader and converter, the catalog, BoxMode, the inference
sampler, the resize augmentation, ``read_image`` with and without PIL, the
PNG codec, and the test loader's padded batches (uint8 in the port, float32
in the JAX package, compared with ``==``), at ``MIN_SIZE_TEST`` 800 /
``MAX_SIZE_TEST`` 1333 over portrait and landscape images. Also the zoo
config against the in-code one and the JAX package's."""

import io
import json
import sys

import numpy as np
import pytest
import torch

from PIL import Image

import detectron2_tpu.data as jax_data
from detectron2_tpu.data import detection_utils as jax_utils
from detectron2_tpu.data.datasets import coco as jax_coco
from detectron2_tpu.data.samplers import InferenceSampler as JaxInferenceSampler
from detectron2_tpu.data.transforms import ResizeShortestEdge as JaxResizeShortestEdge
from detectron2_tpu.structures import BoxMode as JaxBoxMode
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, png
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets import coco
from detectron2_tpu_torch.data.samplers import InferenceSampler
from detectron2_tpu_torch.structures import BoxMode
from detectron2_tpu_torch.testing import write_synthetic_coco

from _torch_port import jax_cfg_from_port, leaf_items

ZOO = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """8 images at the four COCO sizes (portrait and landscape), with crowd
    RLE in images 1 and 9 of every 8, and one annotation whose only
    polygon has too few points (both loaders drop it)."""
    root = tmp_path_factory.mktemp("coco")
    json_file, image_root = write_synthetic_coco(str(root), 9, seed=3)
    with open(json_file) as f:
        d = json.load(f)
    d["annotations"].append({
        "id": len(d["annotations"]) + 1, "image_id": 2, "category_id": 5, "iscrowd": 0,
        "bbox": [1.0, 1.0, 3.0, 3.0], "area": 4.0, "segmentation": [[1.0, 1.0, 4.0, 4.0]],
    })
    with open(json_file, "w") as f:
        json.dump(d, f)
    return json_file, image_root


def _register(name, json_file, image_root):
    if name not in DatasetCatalog:
        coco.register_coco_instances(name, {}, json_file, image_root)
    if name not in jax_data.DatasetCatalog:
        jax_coco.register_coco_instances(name, {}, json_file, image_root)


def test_load_coco_json_equals_the_jax_package(dataset):
    json_file, image_root = dataset
    ours = coco.load_coco_json(json_file, image_root, "port_load")
    ref = jax_coco.load_coco_json(json_file, image_root, "jax_load")
    assert ours == ref
    assert any(a["iscrowd"] and isinstance(a["segmentation"], dict) for r in ours for a in r["annotations"])
    assert sum(len(r["annotations"]) for r in ours) == len(json.load(open(json_file))["annotations"]) - 1
    ours_meta, ref_meta = MetadataCatalog.get("port_load"), jax_data.MetadataCatalog.get("jax_load")
    assert ours_meta.thing_classes == ref_meta.thing_classes and len(ours_meta.thing_classes) == 80
    assert ours_meta.thing_dataset_id_to_contiguous_id == ref_meta.thing_dataset_id_to_contiguous_id


def test_convert_to_coco_dict_equals_the_jax_package(dataset):
    _register("convert_synth", *dataset)
    ours, ref = coco.convert_to_coco_dict("convert_synth"), jax_coco.convert_to_coco_dict("convert_synth")
    for d in (ours, ref):
        d.pop("info")
    assert ours == ref


def test_catalog_refuses_what_the_jax_one_refuses():
    DatasetCatalog.register("catalog_case", lambda: [{"file_name": "x"}])
    with pytest.raises(AssertionError, match="already registered"):
        DatasetCatalog.register("catalog_case", lambda: [])
    with pytest.raises(KeyError, match="not registered"):
        DatasetCatalog.get("catalog_case_missing")
    meta = MetadataCatalog.get("catalog_case").set(thing_classes=["a"])
    with pytest.raises(AssertionError, match="cannot be set"):
        meta.thing_classes = ["b"]
    assert meta.class_names == ["a"]  # the renamed key still reads
    DatasetCatalog.remove("catalog_case")
    assert "catalog_case" not in DatasetCatalog


def test_box_mode_convert_equals_the_jax_package():
    r = np.random.RandomState(0)
    boxes = r.rand(7, 4).astype(np.float32) * 100
    rboxes = np.concatenate([boxes, r.rand(7, 1).astype(np.float32) * 180], 1)
    for a, b, arr in ((0, 1, boxes), (1, 0, boxes), (4, 0, rboxes), (1, 4, boxes), (0, 0, boxes)):
        ours = BoxMode.convert(arr, BoxMode(a), BoxMode(b))
        ref = JaxBoxMode.convert(arr, JaxBoxMode(a), JaxBoxMode(b))
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(BoxMode.convert(torch.from_numpy(arr), BoxMode(a), BoxMode(b)).numpy(), ref)
    assert BoxMode.convert([1.5, 2, 3, 4], BoxMode.XYWH_ABS, BoxMode.XYXY_ABS) == [1.5, 2.0, 4.5, 6.0]
    assert BoxMode.convert((1, 2, 3, 4), BoxMode.XYXY_ABS, BoxMode.XYWH_ABS) == (1.0, 2.0, 2.0, 2.0)
    with pytest.raises(AssertionError, match="Relative"):
        BoxMode.convert(boxes, BoxMode.XYXY_REL, BoxMode.XYXY_ABS)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_inference_sampler_partitions_as_the_jax_package(world):
    for size in (1, 7, 64):
        if size < world:
            continue
        shards = [InferenceSampler._get_local_indices(size, world, rank) for rank in range(world)]
        assert sum(shards, []) == list(range(size))
        assert shards == [JaxInferenceSampler._get_local_indices(size, world, rank) for rank in range(world)]
        assert list(InferenceSampler(size)) == list(range(size))


def test_resize_augmentation_equals_the_jax_package():
    r = np.random.RandomState(1)
    for h, w in ((480, 640), (640, 427), (375, 500), (40, 90)):
        img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
        aug, ref_aug = T.ResizeShortestEdge(800, 1333, "choice"), JaxResizeShortestEdge(800, 1333, "choice")
        tfm, ref_tfm = aug.get_transform(img), ref_aug.get_transform(img)
        assert (tfm.new_h, tfm.new_w) == (ref_tfm.new_h, ref_tfm.new_w)
        out = tfm.apply_image(img)
        assert out.dtype == np.uint8 and np.array_equal(out, ref_tfm.apply_image(img))
        # a tensor stays a tensor, on its device
        assert torch.equal(tfm.apply_image(torch.from_numpy(img)), torch.from_numpy(out))
        aug_input = T.AugInput(img, boxes=np.array([[0.0, 0.0, w, h]]))
        tfms = T.AugmentationList([aug])(aug_input)
        np.testing.assert_allclose(aug_input.boxes, [[0, 0, tfm.new_w, tfm.new_h]], rtol=1e-12)
        assert isinstance(tfms, T.TransformList) and len(tfms) == 1
        np.testing.assert_allclose(tfms.inverse().apply_coords(tfms.apply_coords(np.array([[3.0, 5.0]]))), [[3.0, 5.0]], rtol=1e-12)
    with pytest.raises(NotImplementedError):
        T.ResizeTransform(4, 4, 8, 8).apply_image(np.zeros((4, 4, 3), np.float32))


def _pil_pngs(tmp_path):
    """PNGs written by PIL, gray, gray + alpha, RGB and RGBA, smooth and
    noisy, at several sizes, so that PIL picks several row filters."""
    r = np.random.RandomState(2)
    paths = []
    for i, (mode, c) in enumerate([("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)] * 3):
        h, w = [(17, 23), (64, 48), (33, 90)][i // 4]
        if i % 2:
            arr = r.randint(0, 256, (h, w, c))
        else:
            arr = (np.add.outer(np.arange(h) * 3, np.arange(w) * 5)[:, :, None] + 40 * np.arange(c)) % 256
        arr = arr.astype(np.uint8)
        path = tmp_path / f"pil_{i}_{mode}.png"
        Image.fromarray(arr[:, :, 0] if c == 1 else arr, mode).save(path)
        paths.append(str(path))
    return paths


def _filters_of(path):
    data = open(path, "rb").read()
    chunks = dict(png._chunks(data))
    hdr = png.struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    raw = png.zlib.decompress(b"".join(b for t, b in png._chunks(data) if t == b"IDAT"))
    stride = hdr[0] * png._CHANNELS[hdr[3]] + 1
    return set(raw[::stride])


def test_read_image_without_pil_equals_the_jax_read_image(tmp_path, monkeypatch):
    paths = _pil_pngs(tmp_path)
    r = np.random.RandomState(3)
    for i, c in enumerate((1, 3, 4, 2)):
        arr = r.randint(0, 256, (29, 41, c)).astype(np.uint8) if i % 2 else (np.arange(29 * 41 * c) % 251).astype(np.uint8).reshape(29, 41, c)
        path = tmp_path / f"port_{i}.png"
        png.write_png(str(path), arr[:, :, 0] if c == 1 else arr)
        paths.append(str(path))
        # the same pixels with every row under one filter, Average (which PIL
        # picks rarely) or Paeth
        rows = arr.reshape(29, 41 * c)
        for f in (3, 4):
            path = tmp_path / f"filter{f}_{i}.png"
            path.write_bytes(png._encode(png._filtered(rows, c, f), np.full(29, f), 41, c))
            paths.append(str(path))
    assert set().union(*(_filters_of(p) for p in paths)) == {0, 1, 2, 3, 4}
    formats = ("BGR", "RGB", "L", None, "YUV-BT.601")
    ref = {(p, f): jax_utils.read_image(p, f) for p in paths for f in formats}
    with_pil = {(p, f): utils.read_image(p, f) for p in paths for f in formats}
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    for (p, f), want in ref.items():
        got = utils.read_image(p, f)
        assert got.dtype == want.dtype and got.shape == want.shape, (p, f)
        assert np.array_equal(got, want), (p, f)
        assert np.array_equal(with_pil[p, f], want), (p, f)


def test_read_image_without_pil_refuses_other_formats(tmp_path, monkeypatch):
    path = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        utils.read_image(str(path), "BGR")


def test_png_reader_refuses_what_it_does_not_decode():
    b = io.BytesIO()
    Image.fromarray((np.arange(64) % 4).astype(np.uint8).reshape(8, 8), "L").convert("P").save(b, format="PNG")
    with pytest.raises(ValueError, match="color type 3"):
        png.read_png(b.getvalue())
    b = io.BytesIO()
    Image.new("I;16", (4, 4)).save(b, format="PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(b.getvalue())
    data = bytearray(png.write_png(None, np.zeros((4, 5, 3), np.uint8)))
    data[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(b"GIF89a" + bytes(10))


def _loader_cfg(name):
    cfg = get_cfg()
    cfg.DATASETS.TEST = (name,)
    assert (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST) == (800, 1333)
    return cfg


@pytest.mark.parametrize("batch_size", [1, 3])
def test_test_loader_batches_equal_the_jax_package(dataset, batch_size, monkeypatch):
    """Padded batches of mixed portrait and landscape images: the port's
    uint8 pixels == the JAX package's float32 ones, sizes and metadata ==.
    The port reads the PNGs without PIL."""
    _register("loader_synth", *dataset)
    cfg = _loader_cfg("loader_synth")
    ref = list(jax_data.build_detection_test_loader(jax_cfg_from_port(cfg), "loader_synth", batch_size=batch_size))
    monkeypatch.setitem(sys.modules, "PIL", None)
    ours = list(build_detection_test_loader(cfg, "loader_synth", batch_size=batch_size))
    assert len(ours) == len(ref) == -(-9 // batch_size)
    shapes = set()
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"image", "image_sizes", "metadata"}
        assert a["image"].dtype == torch.uint8 and b["image"].dtype == np.float32
        assert tuple(a["image"].shape) == b["image"].shape
        assert np.array_equal(a["image"].numpy().astype(np.float32), b["image"])
        np.testing.assert_array_equal(a["image_sizes"].numpy(), b["image_sizes"])
        assert a["metadata"] == b["metadata"]
        shapes |= {tuple(hw) for hw in b["image_sizes"].tolist()}
    # 480x640, 640x480, 427x640 and 375x500 at 800 on the short side
    assert shapes == {(800, 1067), (1067, 800), (800, 1199)}


def test_zoo_config_equals_the_in_code_config_and_the_jax_one():
    """Leaf for leaf, except the key the in-code config sets on purpose:
    MODEL.WEIGHTS, empty there (the zoo's ImageNet init is a download)."""
    from detectron2_tpu.model_zoo import get_config as jax_get_config

    cfg = model_zoo.get_config(ZOO)
    ours, in_code = dict(leaf_items(cfg)), dict(leaf_items(model_zoo.mask_rcnn_R_50_FPN_3x_config()))
    assert set(ours) == set(in_code)
    assert {k for k in ours if ours[k] != in_code[k]} == {"MODEL.WEIGHTS"}
    assert ours["MODEL.WEIGHTS"] == "detectron2://ImageNetPretrained/MSRA/R-50.pkl" and in_code["MODEL.WEIGHTS"] == ""
    ref = dict(leaf_items(jax_get_config(ZOO)))
    shared = [k for k in ours if k != "MODEL.DEVICE"]
    assert set(shared) <= set(ref)
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}


def test_zoo_get_builds_the_model_and_refuses_trained_weights():
    model = model_zoo.get(ZOO, device="cpu")
    assert model.device.type == "cpu" and not model.training
    assert sum(p.numel() for p in model.parameters()) > 40_000_000
    with pytest.raises(NotImplementedError, match="download"):
        model_zoo.get_config(ZOO, trained=True)
    with pytest.raises(RuntimeError, match="not available"):
        model_zoo.get_config("COCO-InstanceSegmentation/no_such.yaml")
