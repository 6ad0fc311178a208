"""Precomputed proposals (Fast R-CNN) in the port against the JAX package,
on the CPU (``TRAIN_ON_PRED_BOXES`` is held in ``test_torch_box_losses.py``).

- ``load_proposals_into_dataset`` on a pickle of
  ``testing.write_synthetic_proposals`` (d2's keys, and D1's ``indexes`` and
  ``scores``), ``transform_proposals`` under a resize and a flip, and the
  test mapper's "proposals": ``==`` the JAX functions.
- The collator (ROADMAP C, the tenth correction): the JAX
  ``PaddedBatchCollator`` drops the mapper's proposals, so its batches lack
  the ``proposal_boxes`` / ``proposal_logits`` / ``proposal_valid`` that its
  ``GeneralizedRCNN`` reads; the port's writes them, padded to
  ``DATASETS.PRECOMPUTED_PROPOSAL_TOPK_{TRAIN,TEST}`` as the RPN pads (zero
  boxes, -inf logits, invalid). Both loaders read ``PROPOSAL_FILES_*`` and a
  train batch trains the tiny model.
- A tiny R18-FPN Fast R-CNN (``PrecomputedProposals``, FPN width 32) with
  the JAX model's variables carried across by ``convert_jax_params``, on the
  same padded proposal batch: the detections at the tolerances of
  ``tests/test_torch_panoptic.py`` (classes, validity and box indices
  ``==``, scores rtol 1e-4 and atol 1e-5, boxes atol 1e-3); one training
  step's losses (rtol 1e-4, no RPN loss) and every gradient (1e-3 of
  max|g| + 1e-6) against the JAX ``value_and_grad`` with the same sampler
  draws. Garbage in the padded proposal slots changes nothing.
- The five yamls these options blocked build; the options still not ported
  raise naming their queue items.
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    n,
    port_model,
)

import detectron2_tpu.data.build as jax_build
import detectron2_tpu.data.detection_utils as jax_utils
from detectron2_tpu.data import DatasetCatalog as JaxDatasetCatalog
from detectron2_tpu.data import DatasetMapper as JaxDatasetMapper
from detectron2_tpu.data import transforms as JT
from detectron2_tpu.data.datasets import register_coco_instances as jax_register_coco_instances
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import (
    DatasetCatalog,
    DatasetMapper,
    build_detection_test_loader,
    build_detection_train_loader,
)
from detectron2_tpu_torch.data import detection_utils as utils
from detectron2_tpu_torch.data import transforms as T
from detectron2_tpu_torch.data.build import PaddedBatchCollator, load_proposals_into_dataset
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.testing import synthetic_train_batch, write_synthetic_coco, write_synthetic_proposals

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "precomputed_proposals_synth"
SIZES = ((48, 64), (64, 48), (40, 56))
TOPK_TRAIN, TOPK_TEST = 64, 60


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Six synthetic COCO images registered in both packages, and a
    proposal pickle of 60 boxes an image (more than either top-k)."""
    root = str(tmp_path_factory.mktemp("proposals"))
    json_file, image_root = write_synthetic_coco(root, 6, seed=4, sizes=SIZES, max_objects=4)
    register_coco_instances(NAME, {}, json_file, image_root)
    jax_register_coco_instances(NAME, {}, json_file, image_root)
    pkl = write_synthetic_proposals(root, DatasetCatalog.get(NAME), 60, seed=2)
    with open(pkl, "rb") as f:
        d2 = pickle.load(f)
    d1 = os.path.join(root, "d1.pkl")
    with open(d1, "wb") as f:  # Detectron1's names, ids as ints, no bbox_mode
        pickle.dump({"indexes": [int(i) for i in d2["ids"]], "boxes": d2["boxes"], "scores": d2["objectness_logits"]}, f)
    return {"pkl": pkl, "d1": d1}


def _proposal_fields(records):
    return [
        (r["image_id"], r["proposal_boxes"].tolist(), r["proposal_objectness_logits"].tolist(), int(r["proposal_bbox_mode"]))
        for r in records
    ]


@pytest.mark.parametrize("which", ["pkl", "d1"])
def test_load_proposals_into_dataset_equals_jax(data, which):
    ours = load_proposals_into_dataset(copy.deepcopy(DatasetCatalog.get(NAME)), data[which])
    ref = jax_build.load_proposals_into_dataset(copy.deepcopy(JaxDatasetCatalog.get(NAME)), data[which])
    assert _proposal_fields(ours) == _proposal_fields(ref)
    logits = ours[0]["proposal_objectness_logits"]
    assert len(logits) == 60 and (np.diff(logits) <= 0).all()  # sorted, highest first


def test_transform_proposals_equals_jax(data):
    record = load_proposals_into_dataset(copy.deepcopy(DatasetCatalog.get(NAME)), data["pkl"])[1]
    h, w = record["height"], record["width"]
    for topk in (20, 60):
        ours, ref = copy.deepcopy(record), copy.deepcopy(record)
        tfm = T.TransformList([T.ResizeTransform(h, w, 2 * h, 3 * w), T.HFlipTransform(3 * w)])
        jtfm = JT.TransformList([JT.ResizeTransform(h, w, 2 * h, 3 * w), JT.HFlipTransform(3 * w)])
        utils.transform_proposals(ours, (2 * h, 3 * w), tfm, proposal_topk=topk)
        jax_utils.transform_proposals(ref, (2 * h, 3 * w), jtfm, proposal_topk=topk)
        p, q = ours["proposals"], ref["proposals"]
        assert "proposal_boxes" not in ours and p.image_size == tuple(q.image_size)
        np.testing.assert_array_equal(n(p.proposal_boxes.tensor), np.asarray(q.proposal_boxes.tensor))
        np.testing.assert_array_equal(n(p.objectness_logits), np.asarray(q.objectness_logits))
        assert len(p) <= topk
    assert len(p) < 60  # the clip and the filter of empty boxes dropped some


def _cfg(data):
    cfg = get_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.LOAD_PROPOSALS = True
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (NAME,), (NAME,)
    cfg.DATASETS.PROPOSAL_FILES_TRAIN, cfg.DATASETS.PROPOSAL_FILES_TEST = (data["pkl"],), (data["pkl"],)
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = TOPK_TRAIN
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = TOPK_TEST
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 80
    cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN = (40, 48), 80
    cfg.SOLVER.IMS_PER_BATCH = 2
    return cfg


def test_collator_writes_the_proposals_jax_drops(data):
    """The tenth correction, both ways, on the test mapper's outputs."""
    cfg = _cfg(data)
    dicts = load_proposals_into_dataset(copy.deepcopy(DatasetCatalog.get(NAME)), data["pkl"])
    jdicts = jax_build.load_proposals_into_dataset(copy.deepcopy(JaxDatasetCatalog.get(NAME)), data["pkl"])
    mapper, jmapper = DatasetMapper(cfg, False), JaxDatasetMapper(jax_cfg_from_port(cfg), is_train=False)
    assert mapper.proposal_topk == jmapper.proposal_topk == TOPK_TEST
    mapped, jmapped = [mapper(d) for d in dicts[:3]], [jmapper(d) for d in jdicts[:3]]
    for m, jm in zip(mapped, jmapped):
        np.testing.assert_array_equal(m["image"], jm["image"])
        np.testing.assert_array_equal(n(m["proposals"].proposal_boxes.tensor), np.asarray(jm["proposals"].proposal_boxes.tensor))
        np.testing.assert_array_equal(n(m["proposals"].objectness_logits), np.asarray(jm["proposals"].objectness_logits))

    keys = {"proposal_boxes", "proposal_logits", "proposal_valid"}
    assert not keys & set(jax_build.PaddedBatchCollator()(jmapped))  # the JAX model could not read them
    batch = PaddedBatchCollator(proposal_topk=TOPK_TEST)(mapped)
    assert keys <= set(batch)
    boxes, logits, valid = (n(batch[k]) for k in ("proposal_boxes", "proposal_logits", "proposal_valid"))
    assert boxes.shape == (3, TOPK_TEST, 4) and logits.shape == valid.shape == (3, TOPK_TEST)
    assert boxes.dtype == logits.dtype == np.float32 and valid.dtype == bool
    for i, m in enumerate(mapped):
        k = len(m["proposals"])
        assert valid[i, :k].all() and not valid[i, k:].any()
        np.testing.assert_array_equal(boxes[i, :k], n(m["proposals"].proposal_boxes.tensor))
        np.testing.assert_array_equal(logits[i, :k], n(m["proposals"].objectness_logits))
        assert (boxes[i, k:] == 0).all() and np.isneginf(logits[i, k:]).all()
    assert not valid.all()  # some image kept fewer than the top-k
    with pytest.raises(ValueError, match="do not fit"):
        PaddedBatchCollator(proposal_topk=2)(mapped)


def fast_rcnn_cfg(data=None):
    from test_torch_panoptic import tiny_cfg

    cfg = tiny_cfg()
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    cfg.MODEL.MASK_ON = False
    if data is not None:
        base = _cfg(data)
        cfg.MODEL.LOAD_PROPOSALS = True
        cfg.DATASETS, cfg.INPUT, cfg.SOLVER.IMS_PER_BATCH = base.DATASETS, base.INPUT, 2
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    return cfg


def test_loaders_feed_the_model(data):
    """Both loaders read the proposal files; a train batch trains the tiny
    Fast R-CNN (the path the JAX loader cannot feed)."""
    cfg = fast_rcnn_cfg(data)
    test_batch = next(iter(build_detection_test_loader(cfg, NAME)))
    assert test_batch["proposal_boxes"].shape == (1, TOPK_TEST, 4)
    batch = next(iter(build_detection_train_loader(cfg)))
    assert batch["proposal_boxes"].shape == (2, TOPK_TRAIN, 4) and batch["proposal_valid"].shape == (2, TOPK_TRAIN)
    model = build_model(cfg, device="cpu")
    assert model.proposal_generator is None
    losses = model({k: v for k, v in batch.items() if k != "metadata"}, train=True)
    assert set(losses) == {"loss_cls", "loss_box_reg"} and all(torch.isfinite(v) for v in losses.values())
    out = model({k: v for k, v in test_batch.items() if k != "metadata"})
    assert out["pred_boxes"].shape[:2] == (1, cfg.TEST.DETECTIONS_PER_IMAGE)


def proposal_batch(batch, P=40, seed=6, garbage=False):
    """``batch`` with padded proposals: the gt jittered and random boxes,
    image 1 with only 30 valid slots. With ``garbage`` the padded slots
    hold large finite boxes and logits instead of zeros and -inf."""
    rng = np.random.RandomState(seed)
    B, H, W = batch["image"].shape[:3]
    xy = rng.rand(B, P, 2) * (W - 8)
    boxes = np.concatenate([xy, xy + rng.rand(B, P, 2) * 24 + 2], -1)
    G = batch.get("gt_boxes", np.zeros((B, 0, 4))).shape[1]
    if G:
        boxes[:, :G] = batch["gt_boxes"] + rng.uniform(-2, 2, (B, G, 4))
    logits = rng.standard_normal((B, P))
    valid = np.ones((B, P), bool)
    valid[1, 30:] = False
    fill_boxes, fill_logits = (rng.rand(B, P, 4) * 500, rng.standard_normal((B, P)) * 9) if garbage else (0.0, -np.inf)
    boxes = np.where(valid[..., None], boxes, fill_boxes)
    logits = np.where(valid, logits, fill_logits)
    return {**batch, "proposal_boxes": boxes.astype(np.float32), "proposal_logits": logits.astype(np.float32),
            "proposal_valid": valid}


@pytest.fixture(scope="module")
def fast_rcnn():
    cfg = fast_rcnn_cfg()
    return cfg, jax_random_variables(jax_model(cfg), seed=0, scale=0.1)


def test_fast_rcnn_inference_matches_jax(fast_rcnn):
    cfg, variables = fast_rcnn
    image = np.random.RandomState(1).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    batch = proposal_batch({"image": image, "image_sizes": np.array([[64, 64], [56, 64]], np.int32)})
    ref = jax.tree_util.tree_map(
        np.asarray, jax_model(cfg).apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    )
    model = port_model(cfg, variables)
    out = model(batch)
    assert set(out) == set(ref)
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    assert ref["valid"].sum() > 10
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    # the padded slots are invalid everywhere: garbage in them changes nothing
    again = model(proposal_batch({"image": image, "image_sizes": batch["image_sizes"]}, garbage=True))
    for k in out:
        torch.testing.assert_close(again[k], out[k], rtol=0, atol=0, msg=k)
    assert n(out["box_idx"])[1][n(out["valid"])[1]].max() < 30


def test_fast_rcnn_train_step_matches_jax(fast_rcnn, monkeypatch):
    SameDraws(seed=9).patch(monkeypatch)
    cfg, variables = fast_rcnn
    batch = proposal_batch(synthetic_train_batch(num_classes=8))
    ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    assert set(ref_losses) == {"loss_cls", "loss_box_reg"}
    model = port_model(cfg, variables)
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    model.zero_grad()
    garbage = model(proposal_batch(synthetic_train_batch(num_classes=8), garbage=True), train=True)
    assert {k: v.item() for k, v in garbage.items()} == losses


YAMLS = [
    "COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml",
    "quick_schedules/fast_rcnn_R_50_FPN_inference_acc_test.yaml",
    "quick_schedules/fast_rcnn_R_50_FPN_instant_test.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x_giou.yaml",
    "quick_schedules/mask_rcnn_R_50_FPN_pred_boxes_training_acc_test.yaml",
]


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_builds(yaml):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    model = build_model(cfg, device="cpu")
    heads = model.roi_heads
    if "fast_rcnn" in yaml:
        assert cfg.MODEL.LOAD_PROPOSALS and model.proposal_generator is None and heads.mask_head is None
    else:
        assert model.proposal_generator.box_reg_loss_type == heads.box_predictor.box_reg_loss_type
    if "giou" in yaml:
        assert heads.box_predictor.box_reg_loss_type == "giou" and heads.box_predictor.loss_weight_box == 10.0
        assert model.proposal_generator.loss_weight_loc == 2.0
    assert heads.train_on_pred_boxes == ("pred_boxes" in yaml)


@pytest.mark.parametrize(
    "key, value, item",
    [
        ("MODEL.PROPOSAL_GENERATOR.NAME", "RRPN", "A9"),
        ("MODEL.PROPOSAL_GENERATOR.NAME", "UnregisteredRPN", None),
        ("MODEL.ANCHOR_GENERATOR.NAME", "RotatedAnchorGenerator", "A9"),
        ("MODEL.ROI_BOX_HEAD.NAME", "PointSupBoxHead", None),
        ("MODEL.ROI_MASK_HEAD.NAME", "PointRendMaskHead", None),
        ("MODEL.META_ARCHITECTURE", "UnregisteredArchitecture", None),
    ],
)
def test_options_not_ported_name_their_queue_item(key, value, item):
    """What the JAX package has and the port not yet names its ROADMAP item;
    a name that neither package registers (item None) is refused as such
    (TridentRPN and TensorMask, once here, build: test_torch_tridentnet.py,
    test_torch_tensormask.py)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "Base-RCNN-FPN.yaml"))
    cfg.MODEL.MASK_ON = True
    cfg.merge_from_list([key, value])
    if item is None:
        with pytest.raises(ValueError, match=rf"{value!r} is registered by neither package"):
            build_model(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=rf"not ported yet \(ROADMAP {item}\)"):
        build_model(cfg, device="cpu")


def test_lazy_predictor_takes_the_loss_options():
    from detectron2_tpu_torch.modeling.lazy_modules import fast_rcnn_output_layers

    pred = fast_rcnn_output_layers(num_classes=3, box_reg_loss_type="ciou", loss_weight_cls=0.5)(16)
    assert (pred.box_reg_loss_type, pred.loss_weight_cls) == ("ciou", 0.5)
    with pytest.raises(NotImplementedError, match=r"box_dim=5 is not ported yet \(ROADMAP A9\)"):
        fast_rcnn_output_layers(num_classes=3, box_dim=5)(16)
