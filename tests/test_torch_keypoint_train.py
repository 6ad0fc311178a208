"""Keypoint R-CNN training in the port against the JAX package, on the CPU.

- The encode (``_keypoints_to_heatmap``, ``Keypoints.to_heatmap``) equals
  the JAX function exactly on seeded boxes and points (points on the boxes'
  edges included), passes the edge cases of
  ``tests/structures/test_keypoints.py:20-46`` and reproduces the
  ``enc_indices`` / ``enc_valid`` arrays of ``tests/goldens/keypoints.npz``.
- ``transform_keypoint_annotations`` (with and without a horizontal flip),
  ``create_keypoint_hflip_indices``, ``filter_images_with_few_keypoints``
  and ``instances_to_padded_targets`` with keypoints equal the JAX
  functions; four padded train batches of a keypoint config, flips on,
  are ``==`` the JAX loader's (``prefetch=0`` on the JAX side, as
  ``test_torch_train_data.py`` runs it).
- ``keypoint_rcnn_loss`` under both normalisers: rtol 1e-6.
- The tiny Keypoint R-CNN R18-FPN (``testing.golden_keypoint_config``):
  the five losses rtol 1e-4 and every parameter's gradient within 1e-3 *
  max|g_ref| + 1e-6 against the JAX model's ``value_and_grad`` on the same
  weights and sampler draws (``_torch_port.SameDraws``), as
  ``test_torch_train_step.py`` holds the mask model.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import detectron2_tpu.data.build as jax_build
import detectron2_tpu.data.detection_utils as jax_utils
from detectron2_tpu.data import MetadataCatalog as JaxMetadataCatalog
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.common import DatasetFromList as JaxDatasetFromList
from detectron2_tpu.data.common import MapDataset as JaxMapDataset
from detectron2_tpu.modeling.roi_heads.keypoint_head import keypoint_rcnn_loss as jax_keypoint_loss
from detectron2_tpu.structures import Instances as JaxInstances
from detectron2_tpu.structures import Keypoints as JaxKeypoints
from detectron2_tpu.structures.keypoints import _keypoints_to_heatmap as jax_encode
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import MetadataCatalog, build_detection_train_loader
from detectron2_tpu_torch.data import build as port_build
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.datasets import load_coco_json
from detectron2_tpu_torch.data.datasets.builtin_meta import COCO_PERSON_KEYPOINT_FLIP_MAP, COCO_PERSON_KEYPOINT_NAMES
from detectron2_tpu_torch.modeling.roi_heads import keypoint_rcnn_loss
from detectron2_tpu_torch.structures import Boxes, Instances, Keypoints
from detectron2_tpu_torch.structures.keypoints import _keypoints_to_heatmap
from detectron2_tpu_torch.testing import golden_keypoint_config, synthetic_train_batch, write_synthetic_coco

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)

torch.set_num_threads(1)
NAME = "kpt_train_data"
SIZES = ((48, 64), (64, 48), (40, 56), (56, 40))


def _boxes_and_points(seed, N=40, K=9):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 300, (N, 2))
    wh = rng.uniform(0.0, 150, (N, 2))
    wh[:3] = 0  # zero-width and zero-height boxes
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, (N, K, 2))
    u[:, : K // 3] = rng.randint(0, 2, (N, K // 3, 2))  # on the edges
    pts = rois[:, None, :2] + u * (rois[:, None, 2:] - rois[:, None, :2])
    kpts = np.concatenate([pts, rng.randint(0, 3, (N, K, 1))], -1).astype(np.float32)
    return kpts, rois


@pytest.mark.parametrize("seed,S", [(0, 56), (1, 14), (2, 7)])
def test_encode_equals_the_jax_function(seed, S):
    kpts, rois = _boxes_and_points(seed)
    ref_idx, ref_valid = (np.asarray(a) for a in jax_encode(jnp.asarray(kpts), jnp.asarray(rois), S))
    idx, valid = _keypoints_to_heatmap(t(kpts), t(rois), S)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(n(valid), ref_valid)
    np.testing.assert_array_equal(n(idx), ref_idx)
    # the edge rule is exercised: keypoints on the right or bottom edge, valid
    edge = (kpts[..., 0] == rois[:, None, 2]) | (kpts[..., 1] == rois[:, None, 3])
    assert (edge & ref_valid).sum() > 5
    idx2, valid2 = Keypoints(t(kpts)).to_heatmap(Boxes(t(rois)), S)
    assert torch.equal(idx2, idx) and torch.equal(valid2, valid)


def test_encode_edge_cases():
    """``tests/structures/test_keypoints.py:20-46``: the corner goes to bin
    (0, 0), the box's max to (S-1, S-1), outside or unlabeled is invalid."""
    S = 8
    boxes = Boxes(torch.tensor([[0.0, 0.0, 16.0, 16.0]]))
    kpts = Keypoints(torch.tensor([[
        [0.0, 0.0, 2.0], [15.9, 15.9, 2.0], [16.0, 16.0, 2.0], [8.0, 4.0, 2.0], [20.0, 8.0, 2.0], [8.0, 8.0, 0.0],
    ]]))
    heat, valid = kpts.to_heatmap(boxes, S)
    assert valid.tolist() == [[True, True, True, True, False, False]]
    assert heat[0, :4].tolist() == [0, 7 * S + 7, 7 * S + 7, 2 * S + 4]
    assert heat[0, 4:].tolist() == [0, 0]


def test_encode_reproduces_the_keypoints_golden():
    """The encode half of ``keypoints.npz`` (made by the reference): the
    valid mask exactly, and the bin index wherever valid."""
    g = load_golden("keypoints")
    S = int(g["heatmap_size"][0])
    idx, valid = _keypoints_to_heatmap(t(g["kpts"]), t(g["boxes"]), S)
    v = g["enc_valid"].astype(bool)
    np.testing.assert_array_equal(n(valid), v)
    np.testing.assert_array_equal(n(idx)[v], g["enc_indices"][v])
    assert v.sum() > 20


def _keypoint_annotation(rng, h, w, K=17):
    x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
    bw, bh = rng.uniform(4, w / 2), rng.uniform(4, h / 2)
    vis = rng.randint(0, 3, K)
    x = np.floor(rng.uniform(x0 - 3, x0 + bw + 3, K)) + 0.5
    y = np.floor(rng.uniform(y0 - 3, y0 + bh + 3, K)) + 0.5
    flat = np.stack([np.where(vis > 0, x, 0), np.where(vis > 0, y, 0), vis], 1).ravel()
    return {"bbox": [x0, y0, bw, bh], "bbox_mode": 1, "category_id": 0, "iscrowd": 0, "keypoints": flat.tolist()}


def _flip_indices():
    names = list(COCO_PERSON_KEYPOINT_NAMES)
    flip = dict(COCO_PERSON_KEYPOINT_FLIP_MAP)
    flip.update({v: k for k, v in flip.items()})
    return np.asarray([names.index(flip.get(x, x)) for x in names])


@pytest.mark.parametrize("flip", [False, True])
def test_transform_keypoint_annotations_equals_the_jax_function(flip):
    rng = np.random.RandomState(3 + flip)
    h, w = 60, 80
    port_t = [T.ResizeTransform(h, w, 45, 61, "bilinear")] + ([T.HFlipTransform(61)] if flip else [])
    jax_t = [JT.ResizeTransform(h, w, 45, 61, "bilinear")] + ([JT.HFlipTransform(61)] if flip else [])
    indices = _flip_indices()
    for _ in range(6):
        ann = _keypoint_annotation(rng, h, w)
        ref = jax_utils.transform_instance_annotations(copy.deepcopy(ann), jax_t, (45, 61), keypoint_hflip_indices=indices)
        out = utils.transform_instance_annotations(copy.deepcopy(ann), port_t, (45, 61), keypoint_hflip_indices=indices)
        np.testing.assert_array_equal(out["keypoints"], ref["keypoints"])
        np.testing.assert_array_equal(out["bbox"], ref["bbox"])
        assert (out["keypoints"][:, 2] == 0).any() and (out["keypoints"][:, 2] > 0).any()
    if flip:
        with pytest.raises(ValueError, match="flip indices"):
            utils.transform_keypoint_annotations(ann["keypoints"], port_t, (45, 61))


def test_create_keypoint_hflip_indices_equals_the_jax_function():
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        for name in ("kpt_flip_a", "kpt_flip_b"):
            catalog.get(name).set(keypoint_names=COCO_PERSON_KEYPOINT_NAMES, keypoint_flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP)
        catalog.get("kpt_flip_c").set(keypoint_names=("a", "b", "c"), keypoint_flip_map=(("a", "c"),))
    out = utils.create_keypoint_hflip_indices(["kpt_flip_a", "kpt_flip_b"])
    np.testing.assert_array_equal(out, jax_utils.create_keypoint_hflip_indices(["kpt_flip_a", "kpt_flip_b"]))
    np.testing.assert_array_equal(out, _flip_indices())
    assert out.tolist()[:5] == [0, 2, 1, 4, 3]
    np.testing.assert_array_equal(utils.create_keypoint_hflip_indices("kpt_flip_c"), [2, 1, 0])
    with pytest.raises(ValueError, match="keypoint_names"):
        utils.create_keypoint_hflip_indices(["kpt_flip_a", "kpt_flip_c"])


@pytest.mark.parametrize("count,G", [(0, 4), (3, 4), (6, 4)])
def test_instances_to_padded_targets_with_keypoints_equals_the_jax_function(count, G):
    rng = np.random.RandomState(count)
    boxes = rng.uniform(0, 30, (count, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    kpts = rng.uniform(0, 40, (count, 5, 3)).astype(np.float32)
    port = Instances((48, 64), gt_boxes=Boxes(t(boxes)), gt_classes=torch.arange(count), gt_keypoints=Keypoints(t(kpts)))
    from detectron2_tpu.structures import Boxes as JaxBoxes

    ref_inst = JaxInstances((48, 64))
    ref_inst.gt_boxes, ref_inst.gt_classes, ref_inst.gt_keypoints = JaxBoxes(boxes), np.arange(count), JaxKeypoints(kpts)
    ref = jax_utils.instances_to_padded_targets(ref_inst, G, num_keypoints=5)
    out = utils.instances_to_padded_targets(port, G, num_keypoints=5)
    assert set(out) == set(ref) == {"gt_boxes", "gt_classes", "gt_valid", "gt_keypoints"}
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.fixture(scope="module")
def keypoint_dicts(tmp_path_factory):
    """12 small person-keypoint images (crowd persons in images 1 and 9),
    the dataset's metadata registered in both packages with the flip map."""
    root = tmp_path_factory.mktemp("kpt_train_data")
    json_file, image_root = write_synthetic_coco(str(root), 12, seed=5, sizes=SIZES, max_objects=4, keypoints=True)
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        catalog.get(NAME).set(keypoint_names=COCO_PERSON_KEYPOINT_NAMES, keypoint_flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP)
    return load_coco_json(json_file, image_root)


def test_filter_images_with_few_keypoints_equals_the_jax_function(keypoint_dicts):
    counts = [sum((np.asarray(a["keypoints"][2::3]) > 0).sum() for a in d["annotations"]) for d in keypoint_dicts]
    for m in (1, int(np.median(counts)), max(counts) + 1):
        out = port_build.filter_images_with_few_keypoints(copy.deepcopy(keypoint_dicts), m)
        ref = jax_build.filter_images_with_few_keypoints(copy.deepcopy(keypoint_dicts), m)
        assert [d["image_id"] for d in out] == [d["image_id"] for d in ref]
        assert len(out) == sum(c >= m for c in counts)


def _loader_cfg(seed):
    cfg = get_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg.SEED = seed
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.KEYPOINT_ON = True
    cfg.DATASETS.TRAIN = (NAME,)
    cfg.SOLVER.IMS_PER_BATCH = 3
    cfg.INPUT.MIN_SIZE_TRAIN = (32, 40, 48)
    cfg.INPUT.MAX_SIZE_TRAIN = 80
    cfg.INPUT.RANDOM_FLIP = "horizontal"
    cfg.TPU.MAX_GT_INSTANCES = 6
    return cfg


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoint_train_batches_equal_the_jax_loader(keypoint_dicts, seed):
    cfg = _loader_cfg(seed)
    np.random.seed(cfg.SEED)
    kw = jax_build._train_loader_from_config(jax_cfg_from_port(cfg), dataset=copy.deepcopy(keypoint_dicts))
    it = jax_build.build_batch_data_loader(
        JaxMapDataset(JaxDatasetFromList(kw["dataset"], copy=False), kw["mapper"]), kw["sampler"],
        kw["total_batch_size"], aspect_ratio_grouping=kw["aspect_ratio_grouping"], collator=kw["collator"], prefetch=0,
    )
    ref = [next(it) for _ in range(4)]
    loader = build_detection_train_loader(cfg, dataset=copy.deepcopy(keypoint_dicts))
    n_labeled = 0
    for b_ref in ref:
        b = next(loader)
        assert set(b) == set(b_ref) and "gt_keypoints" in b and "gt_masks" not in b
        np.testing.assert_array_equal(b["image"].numpy().astype(np.float32), b_ref["image"])
        np.testing.assert_allclose(b["gt_boxes"].numpy(), b_ref["gt_boxes"], rtol=0, atol=1e-6)
        for k in ("image_sizes", "gt_classes", "gt_valid", "gt_keypoints"):
            assert b[k].dtype == torch.from_numpy(np.asarray(b_ref[k])).dtype, k
            np.testing.assert_array_equal(b[k].numpy(), b_ref[k], err_msg=k)
        assert b["gt_keypoints"].shape[2:] == (17, 3)
        n_labeled += int((b["gt_keypoints"][..., 2] > 0).sum())
    assert n_labeled > 0


@pytest.mark.parametrize("normalizer", [None, 37.0])
def test_keypoint_rcnn_loss_equals_the_jax_function(normalizer):
    rng = np.random.RandomState(7)
    R, S, K = 12, 14, 5
    logits = rng.standard_normal((R, S, S, K)).astype(np.float32) * 2
    kpts, boxes = _boxes_and_points(8, N=R, K=K)
    fg = rng.rand(R) > 0.3
    ref = float(jax_keypoint_loss(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(kpts), jnp.asarray(fg), normalizer))
    out = keypoint_rcnn_loss(t(logits), t(boxes), t(kpts), t(fg), normalizer)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.item(), ref, rtol=1e-6)
    # no labeled keypoint: zero, not NaN
    empty = keypoint_rcnn_loss(t(logits), t(boxes), t(kpts), torch.zeros(R, dtype=torch.bool))
    assert empty.item() == 0.0


KPT_LOSSES = ("loss_cls", "loss_box_reg", "loss_keypoint", "loss_rpn_cls", "loss_rpn_loc")


def tiny_keypoint_cfg():
    cfg = golden_keypoint_config()
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    return cfg


@pytest.mark.parametrize("by_visible", [True, False])
def test_keypoint_rcnn_losses_and_gradients_match_jax(by_visible):
    cfg = tiny_keypoint_cfg()
    cfg.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = by_visible
    cfg.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0 if by_visible else 4.0
    batch = synthetic_train_batch(num_classes=7, num_keypoints=17, seed=1)
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        variables = jax_random_variables(jax_model(cfg), seed=5, scale=0.1)
        ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
        losses = assert_train_step_matches(port_model(cfg, variables), batch, ref_losses, ref_grads)
    assert set(losses) == set(KPT_LOSSES)
    assert losses["loss_keypoint"] > 0
