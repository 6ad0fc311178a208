"""The port's Panoptic-DeepLab against the JAX package's, in float32 on the
CPU, weights carried across by ``convert_jax_params``.

- ``PanopticDeepLabSemSegHead`` (plain and depthwise-separable) and
  ``PanopticDeepLabInsEmbedHead`` (depthwise-separable) on seeded features: the logits, center and
  offsets within 1e-5 * max|ref| + 1e-6, the losses (hard-pixel CE, the
  weighted center MSE and offset L1) within 1e-5 relative, every gradient
  within 1e-4 of its max; a tiny PanopticDeepLab (the DeepLab trunk of
  ``test_torch_deeplab``): the raw outputs and the losses.
- The fusion, exactly: ``find_instance_center`` with tied peaks (two equal
  neighbours both peaks, equal peaks past the top-k), ``group_pixels``,
  ``get_panoptic_segmentation`` and ``panoptic_deeplab_postprocess``; the
  target generator on a panoptic map with things, a crowd and stuff.
- ``load_cityscapes_panoptic`` on a synthetic tree (``testing.
  write_synthetic_cityscapes_panoptic``) against the JAX loader, the
  ground truth fed back through COCOPanopticEvaluator (PQ 100), and
  ``tools/train_net.py``'s evaluators for a PanopticDeepLab.
- Corrections 20 (the port registers ``cityscapes_fine_panoptic_*``, the
  JAX package does not) and 21 (``DefaultPredictor`` gives a
  PanopticDeepLab's ``panoptic_seg``; the JAX predictor hands its outputs to
  ``detector_postprocess``, which fails on them).
- ``tests/goldens/e2e_panoptic_deeplab_r50.npz`` through the d2 loader and
  its fusion fixture, at the parity test's bounds; the three
  Panoptic-DeepLab yamls on the meta device.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_inference, jax_model, jax_random_variables, load_golden, n, port_model, t
from test_torch_deeplab import FEATURES, assert_grads_match, backbone_cfg, close, converted, head_features, head_pair

import detectron2_tpu.projects.panoptic_deeplab as jpd
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects import panoptic_deeplab as pd
from detectron2_tpu_torch.testing import (
    PANOPTIC_DEEPLAB_FIXTURE,
    compare_with_deeplab_golden,
    golden_panoptic_deeplab_config,
    golden_state_dict,
    same_panoptic_partition,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = (
    "Cityscapes-PanopticSegmentation/panoptic_deeplab_R_52_os16_mg124_poly_90k_bs32_crop_512_1024.yaml",
    "Cityscapes-PanopticSegmentation/panoptic_deeplab_R_52_os16_mg124_poly_90k_bs32_crop_512_1024_dsconv.yaml",
    "COCO-PanopticSegmentation/panoptic_deeplab_R_52_os16_mg124_poly_200k_bs64_crop_640_640_coco_dsconv.yaml",
)
NAMES = ("res2", "res3", "res5")


def pdl_cfg(dsconv=False):
    """The narrow trunk of ``test_torch_deeplab`` under both heads (res2,
    res3, res5), SyncBN, no dropout, float32."""
    cfg = backbone_cfg(out=NAMES)
    pd.add_panoptic_deeplab_config(cfg)
    cfg.MODEL.BACKBONE.NAME = "build_resnet_deeplab_backbone"
    for h, project, convs, head in ((cfg.MODEL.SEM_SEG_HEAD, [8, 16], 16, 16), (cfg.MODEL.INS_EMBED_HEAD, [8, 8], 8, 8)):
        h.IN_FEATURES, h.PROJECT_FEATURES, h.PROJECT_CHANNELS = list(NAMES), ["res2", "res3"], project
        h.ASPP_CHANNELS, h.ASPP_DILATIONS, h.ASPP_DROPOUT = 16, [2, 3, 4], 0.0
        h.CONVS_DIM, h.HEAD_CHANNELS, h.NORM = convs, head, "SyncBN"
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 6
    cfg.MODEL.SEM_SEG_HEAD.USE_DEPTHWISE_SEPARABLE_CONV = dsconv
    cfg.MODEL.PANOPTIC_DEEPLAB.USE_DEPTHWISE_SEPARABLE_CONV = dsconv
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def pdl_targets(seed, b=2, h=64, w=64, classes=6):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, classes, (b, h, w))
    gt[rng.rand(b, h, w) < 0.2] = 255
    return {
        "gt_sem_seg": gt.astype(np.int64),
        "gt_center": rng.rand(b, h, w).astype(np.float32),
        "gt_offset": (rng.standard_normal((b, h, w, 2)) * 8).astype(np.float32),
        "gt_center_weights": rng.choice([0.0, 1.0, 3.0], (b, h, w)).astype(np.float32),
        "gt_offset_weights": rng.choice([0.0, 1.0, 3.0], (b, h, w)).astype(np.float32),
    }


# ------------------------------------------------------------------ heads
@pytest.mark.parametrize("dsconv", [False, True], ids=["plain", "dsconv"])
def test_sem_seg_head(dsconv):
    from detectron2_tpu.modeling.meta_arch.semantic_seg import SEM_SEG_HEADS_REGISTRY as JAX_HEADS
    from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import build_sem_seg_head

    cfg = pdl_cfg(dsconv)
    ph, jh, v = head_pair(build_sem_seg_head, lambda c, s: JAX_HEADS.get(c.MODEL.SEM_SEG_HEAD.NAME).from_config(c, s),
                          cfg, NAMES, "sem_seg_head")
    assert isinstance(ph, pd.PanopticDeepLabSemSegHead)
    assert (hasattr(ph.head, "depthwise") if dsconv else len(ph.head) == 2)
    feats = head_features(NAMES, 30)
    jf = {k: jnp.asarray(x) for k, x in feats.items()}
    ref, _ = jax.jit(lambda v, f: jh.apply(v, f, train=False))(v, jf)
    with torch.no_grad():
        out, _ = ph({k: t(x) for k, x in feats.items()})
    close(out, ref)
    targets = pdl_targets(31)["gt_sem_seg"]

    def loss_fn(params):
        (_, losses), _ = jh.apply({**v, "params": params}, jf, targets=jnp.asarray(targets), train=True,
                                  mutable=["batch_stats"])
        return losses["loss_sem_seg"]

    ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    _, losses = ph({k: t(x) for k, x in feats.items()}, t(targets), train=True)
    assert abs(losses["loss_sem_seg"].item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    losses["loss_sem_seg"].backward()
    assert_grads_match(ph, converted({"params": grads}, "sem_seg_head"))


def test_ins_embed_head():
    """The depthwise-separable variant (its offset tower and ASPP; the
    plain towers are the semantic head's, held above)."""
    cfg = pdl_cfg(dsconv=True)
    name = cfg.MODEL.INS_EMBED_HEAD.NAME
    ph, jh, v = head_pair(lambda c, s: pd.INS_EMBED_BRANCHES_REGISTRY.get(name).from_config(c, s),
                          lambda c, s: jpd.panoptic_seg.INS_EMBED_BRANCHES_REGISTRY.get(name).from_config(c, s),
                          cfg, NAMES, "ins_embed_head")
    assert len(ph.center_head) == 2 and hasattr(ph.offset_head, "depthwise")
    feats = head_features(NAMES, 32)
    jf = {k: jnp.asarray(x) for k, x in feats.items()}
    ref_center, ref_offset, _ = jax.jit(lambda v, f: jh.apply(v, f, train=False))(v, jf)
    with torch.no_grad():
        center, offset, _ = ph({k: t(x) for k, x in feats.items()})
    close(center, ref_center)
    close(offset, ref_offset)
    tg = pdl_targets(33)
    args = [tg[k] for k in ("gt_center", "gt_offset", "gt_center_weights", "gt_offset_weights")]

    def loss_fn(params):
        (_, _, losses), _ = jh.apply({**v, "params": params}, jf, *map(jnp.asarray, args), train=True,
                                     mutable=["batch_stats"])
        return sum(losses.values()), losses

    (_, ref_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    _, _, losses = ph({k: t(x) for k, x in feats.items()}, *map(t, args), train=True)
    assert set(losses) == {"loss_center", "loss_offset"}
    for k, x in ref_losses.items():
        assert abs(losses[k].item() - float(x)) <= 1e-5 * float(x), k
    sum(losses.values()).backward()
    assert_grads_match(ph, converted({"params": grads}, "ins_embed_head"))


def test_tiny_panoptic_deeplab_matches_jax():
    cfg = pdl_cfg(dsconv=True)
    jm = jax_model(cfg)
    v = jax_random_variables(jm, seed=34, scale=0.2)
    model = port_model(cfg, v)
    assert isinstance(model, pd.PanopticDeepLab)
    rng = np.random.RandomState(35)
    batch = {"image": (rng.rand(2, 64, 64, 3) * 255).astype(np.float32), "image_sizes": np.asarray([[64, 64]] * 2, np.int32)}
    ref = jax_inference(jm, v, batch)
    out = model({k: t(x) for k, x in batch.items()})
    assert set(out) == {"sem_seg", "center", "offset"}
    for k in out:
        close(out[k], ref[k])
    batch.update(pdl_targets(36))
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    ref_losses, _ = jax.jit(lambda v: jm.apply(v, jb, train=True, mutable=["batch_stats"]))(v)
    losses = model({k: t(x) for k, x in batch.items()}, train=True)
    assert set(losses) == set(ref_losses) == {"loss_sem_seg", "loss_center", "loss_offset"}
    for k, x in ref_losses.items():
        assert abs(losses[k].item() - float(x)) <= 1e-5 * float(x), k


# ---------------------------------------------------------------- the fusion
def fusion_inputs(seed=40, h=40, w=56):
    """A semantic map of stuff bands and thing blocks, a heatmap with tied
    peaks, and offsets toward the blocks' centres."""
    rng = np.random.RandomState(seed)
    sem = np.zeros((h, w), np.int64)
    sem[h // 2 :] = 1
    heat = (rng.rand(h, w) * 0.05).astype(np.float32)
    offset = (rng.standard_normal((h, w, 2)) * 0.5).astype(np.float32)
    for k, (y0, x0, cls, peak) in enumerate(((2, 3, 5, 0.9), (4, 20, 6, 0.9), (20, 8, 5, 0.7), (22, 30, 7, 0.9),
                                              (10, 40, 8, 0.5), (28, 44, 5, 0.7))):
        sem[y0 : y0 + 9, x0 : x0 + 9] = cls
        cy, cx = y0 + 4, x0 + 4
        heat[cy, cx] = peak
        if k == 0:
            heat[cy, cx + 1] = peak  # two equal neighbours: both are peaks
        ys, xs = np.mgrid[y0 : y0 + 9, x0 : x0 + 9]
        offset[y0 : y0 + 9, x0 : x0 + 9, 0] = cy - ys + rng.standard_normal((9, 9)).astype(np.float32) * 0.3
        offset[y0 : y0 + 9, x0 : x0 + 9, 1] = cx - xs + rng.standard_normal((9, 9)).astype(np.float32) * 0.3
    return sem, heat, offset


@pytest.mark.parametrize("top_k", [3, 5, 200])
def test_find_instance_center_and_group_pixels_exactly(top_k):
    _, heat, offset = fusion_inputs()
    centers, scores = pd.find_instance_center(t(heat), 0.1, 7, top_k)
    ref_centers, ref_scores = jpd.find_instance_center(jnp.asarray(heat), 0.1, 7, top_k)
    np.testing.assert_array_equal(n(centers), np.asarray(ref_centers))
    np.testing.assert_array_equal(n(scores), np.asarray(ref_scores))
    ids = pd.group_pixels(centers, scores, t(offset))
    np.testing.assert_array_equal(n(ids), np.asarray(jpd.group_pixels(ref_centers, ref_scores, jnp.asarray(offset))))
    if top_k == 3:  # three of the four 0.9 peaks (two of them neighbours): the lower indices first
        assert n(scores).tolist() == [np.float32(0.9).item()] * 3
    none = pd.group_pixels(centers, torch.zeros_like(scores), t(offset))
    assert not n(none).any()


@pytest.mark.parametrize("stuff_area", [10, 400])
def test_get_panoptic_segmentation_exactly(stuff_area):
    sem, heat, offset = fusion_inputs()
    pan, scores = pd.get_panoptic_segmentation(t(sem), t(heat), t(offset), [5, 6, 7, 8], 1000, stuff_area, 0.1, 7, 200)
    ref, ref_scores = jpd.get_panoptic_segmentation(jnp.asarray(sem, jnp.int32), jnp.asarray(heat), jnp.asarray(offset),
                                                    [5, 6, 7, 8], 1000, stuff_area, 0.1, 7, 200)
    np.testing.assert_array_equal(n(pan), np.asarray(ref))
    np.testing.assert_array_equal(n(scores), np.asarray(ref_scores))
    assert (n(pan) // 1000 == 5).sum() > 0 and len(np.unique(n(pan)[n(pan) >= 5000])) >= 4


def test_panoptic_deeplab_postprocess_exactly():
    sem, heat, offset = fusion_inputs()
    rng = np.random.RandomState(41)
    logits = rng.standard_normal((48, 64, 9)).astype(np.float32)
    logits[:40, :56][np.arange(40)[:, None], np.arange(56)[None, :], sem] += 10.0  # argmax = sem in the image
    center = np.zeros((48, 64), np.float32)
    center[:40, :56] = heat
    off = np.zeros((48, 64, 2), np.float32)
    off[:40, :56] = offset
    pan, info = pd.panoptic_deeplab_postprocess(t(logits), t(center), t(off), (40, 56), [5, 6, 7, 8], stuff_area=10)
    ref, ref_info = jpd.panoptic_deeplab_postprocess(logits, center, off, (40, 56), [5, 6, 7, 8], stuff_area=10)
    assert pan.dtype == torch.int32
    np.testing.assert_array_equal(n(pan), ref)
    assert info == ref_info


def test_target_generator_exactly():
    from detectron2_tpu.projects.panoptic_deeplab import PanopticDeepLabTargetGenerator as JaxGenerator

    rng = np.random.RandomState(42)
    pan = np.full((60, 80), 3, np.int64)  # stuff
    segments = [{"id": 3, "category_id": 0, "iscrowd": 0}, {"id": 9, "category_id": 4, "iscrowd": 1},
                {"id": 99, "category_id": 5, "iscrowd": 0}]  # 99: absent
    pan[40:, :30] = 9  # a crowd
    for k, (y0, x0, hh, ww) in enumerate(((0, 0, 20, 25), (5, 50, 50, 28), (45, 40, 15, 10))):
        pan[y0 : y0 + hh, x0 : x0 + ww] = 1000 + k
        segments.append({"id": 1000 + k, "category_id": 5 + k % 2, "iscrowd": 0})
    pan[rng.rand(60, 80) < 0.05] = 0  # void
    for ignore_stuff, ignore_crowd in ((True, False), (False, True)):
        kw = dict(sigma=4, ignore_stuff_in_offset=ignore_stuff, small_instance_area=600, small_instance_weight=3,
                  ignore_crowd_in_semantic=ignore_crowd)
        ours = pd.PanopticDeepLabTargetGenerator(255, [4, 5, 6], **kw)(pan, segments)
        ref = JaxGenerator(255, [4, 5, 6], **kw)(pan, segments)
        assert set(ours) == set(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


# --------------------------------------------------------------------- data
@pytest.fixture(scope="module")
def panoptic_tree(tmp_path_factory):
    from detectron2_tpu_torch.testing import write_synthetic_cityscapes, write_synthetic_cityscapes_panoptic

    root = str(tmp_path_factory.mktemp("cityscapes_panoptic"))
    write_synthetic_cityscapes(root, 4, seed=5, n_val=2, size=(96, 192))
    return root, write_synthetic_cityscapes_panoptic(root)


def _split(root, split):
    return (os.path.join(root, "cityscapes", "leftImg8bit", split),
            os.path.join(root, "cityscapes", "gtFine", f"cityscapes_panoptic_{split}"),
            os.path.join(root, "cityscapes", "gtFine", f"cityscapes_panoptic_{split}.json"))


def test_load_cityscapes_panoptic_matches_jax(panoptic_tree):
    from detectron2_tpu.data.datasets.cityscapes_panoptic import load_cityscapes_panoptic as jax_load
    from detectron2_tpu_torch.data.datasets.cityscapes_panoptic import cityscapes_panoptic_meta, load_cityscapes_panoptic

    root, _ = panoptic_tree
    meta = cityscapes_panoptic_meta()
    ours = load_cityscapes_panoptic(*_split(root, "train"), meta)
    assert len(ours) == 4 and ours == jax_load(*_split(root, "train"), meta)
    things = {s["category_id"] for d in ours for s in d["segments_info"] if s["isthing"]}
    assert things and things <= set(range(11, 19))  # d2's train ids


def test_cityscapes_panoptic_ground_truth_scores_pq_100(panoptic_tree):
    from detectron2_tpu_torch.data.datasets.cityscapes_panoptic import cityscapes_panoptic_meta, load_cityscapes_panoptic
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.evaluation import COCOPanopticEvaluator
    from detectron2_tpu_torch.evaluation.panoptic_evaluation import rgb2id

    root, jsons = panoptic_tree
    name = "test_torch_pdl_cityscapes_panoptic_val"
    image_dir, gt_dir, gt_json = _split(root, "val")
    DatasetCatalog.register(name, lambda: load_cityscapes_panoptic(image_dir, gt_dir, gt_json, cityscapes_panoptic_meta()))
    MetadataCatalog.get(name).set(panoptic_root=gt_dir, panoptic_json=gt_json, label_divisor=1000,
                                  evaluator_type="cityscapes_panoptic_seg", **cityscapes_panoptic_meta())
    try:  # the catalogs are the process's: other files' tests list them
        ev = COCOPanopticEvaluator(name)
        ev.reset()
        for d in DatasetCatalog.get(name):
            pan = rgb2id(read_image(d["pan_seg_file_name"], "RGB"))
            info = [{"id": s["id"], "category_id": s["category_id"], "isthing": s["isthing"]} for s in d["segments_info"]]
            ev.process({"metadata": [{"image_id": d["image_id"]}]}, {"panoptic_seg": [(pan, info)]})
        res = ev.evaluate()["panoptic_seg"]
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    assert res["PQ"] == pytest.approx(100.0), res


def test_train_net_evaluators_for_panoptic_deeplab():
    from detectron2_tpu_torch.evaluation import CityscapesSemSegEvaluator, COCOPanopticEvaluator, DatasetEvaluators
    from detectron2_tpu_torch.tools.train_net import build_evaluator

    cfg = get_cfg()
    pd.add_panoptic_deeplab_config(cfg)
    ev = build_evaluator(cfg, "cityscapes_fine_panoptic_val", "/nonexistent")
    assert isinstance(ev, DatasetEvaluators)
    assert [type(e) for e in ev._evaluators] == [CityscapesSemSegEvaluator, COCOPanopticEvaluator]
    assert type(build_evaluator(cfg, "coco_2017_val_panoptic", "/nonexistent")) is COCOPanopticEvaluator


def test_correction_20_cityscapes_panoptic_registered_in_the_port_only():
    """d2's ``builtin.py`` registers ``cityscapes_fine_panoptic_{train,val}``;
    the JAX ``builtin.py:233-239`` never calls ``register_all_cityscapes_panoptic``."""
    from detectron2_tpu.data import DatasetCatalog as JaxCatalog
    import detectron2_tpu.data.datasets  # noqa: F401  (its builtin registrations)

    for split in ("train", "val"):
        name = f"cityscapes_fine_panoptic_{split}"
        assert name in DatasetCatalog.list() and name not in JaxCatalog.list()
        meta = MetadataCatalog.get(name)
        assert meta.evaluator_type == "cityscapes_panoptic_seg" and meta.label_divisor == 1000
        assert len(meta.thing_classes) == 19 and sorted(meta.thing_dataset_id_to_contiguous_id.values()) == list(range(11, 19))


class _OutputsOnly:
    """A stand-in for the JAX PanopticDeepLab under the JAX predictor: no
    parameters, and ``apply`` returns what the model returns (``sem_seg``
    ``[B, H, W, C]``, ``center`` ``[B, H, W]``, ``offset`` ``[B, H, W, 2]``;
    ``test_tiny_panoptic_deeplab_matches_jax`` holds the real model to
    that), so the predictor's own handling runs without compiling a model."""

    def __init__(self, classes):
        self.classes = classes

    def init(self, *args, **kwargs):
        return {}

    def apply(self, params, batch, train=False):
        b, h, w, _ = batch["image"].shape
        return {"sem_seg": jnp.zeros((b, h, w, self.classes)), "center": jnp.zeros((b, h, w)),
                "offset": jnp.zeros((b, h, w, 2))}


def test_correction_21_predictor_returns_panoptic_seg(monkeypatch):
    """d2's predictor returns a PanopticDeepLab's ``panoptic_seg``; the JAX
    one hands the model's outputs to ``detector_postprocess``
    (``engine/defaults.py:185-214``), which has no boxes to read."""
    from _torch_port import jax_cfg_from_port
    import detectron2_tpu.engine.defaults as jax_defaults
    from detectron2_tpu.engine.defaults import DefaultPredictor as JaxPredictor
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import init_weights

    cfg = pdl_cfg()
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 96
    cfg.DATASETS.TRAIN = ("cityscapes_fine_panoptic_train",)
    predictor = DefaultPredictor(cfg, device="cpu")
    init_weights(predictor.model, torch.Generator().manual_seed(0))
    image = np.random.RandomState(43).randint(0, 256, (48, 72, 3)).astype(np.uint8)
    out = predictor(image)
    assert set(out) == {"sem_seg", "panoptic_seg"} and tuple(out["sem_seg"].shape) == (6, 48, 72)
    pan, info = out["panoptic_seg"]
    assert tuple(pan.shape) == (48, 72) and {s["id"] for s in info} == set(np.unique(n(pan))) - {-1}
    monkeypatch.setattr(jax_defaults, "build_model", lambda c: _OutputsOnly(c.MODEL.SEM_SEG_HEAD.NUM_CLASSES))
    with pytest.raises(KeyError, match="valid"):
        JaxPredictor(jax_cfg_from_port(cfg))(image)


# ----------------------------------------------------------- golden, yamls
def test_panoptic_deeplab_golden_through_the_d2_loader(tmp_path):
    from detectron2_tpu_torch.checkpoint import load_d2_checkpoint

    g = load_golden("e2e_panoptic_deeplab_r50")
    path = tmp_path / "panoptic_deeplab.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    cfg = golden_panoptic_deeplab_config()
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    report = load_d2_checkpoint(model, str(path))
    assert report.splitlines() == ["Loaded 425/425 tensors from the checkpoint."], report
    out = model({"image": t(g["image"][None]), "image_sizes": torch.tensor([[256, 256]])})
    errs = compare_with_deeplab_golden(out, g)
    assert errs["center"] < 5e-3 and errs["offset"] < 2e-2
    f = PANOPTIC_DEEPLAB_FIXTURE
    pan, _ = pd.get_panoptic_segmentation(t(g["syn_sem"]), t(g["syn_center"]), t(g["syn_offset"].transpose(1, 2, 0).copy()),
                                          f["thing_ids"], f["label_divisor"], f["stuff_area"], f["threshold"],
                                          f["nms_kernel"], f["top_k"])
    assert same_panoptic_partition(n(pan), g["syn_panoptic"]) >= 3


@pytest.mark.parametrize("yaml", YAMLS, ids=[os.path.basename(y) for y in YAMLS])
def test_panoptic_deeplab_yamls_build(yaml):
    cfg = get_cfg()
    pd.add_panoptic_deeplab_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    model = build_model(cfg, device="meta")
    assert isinstance(model, pd.PanopticDeepLab) and model.metadata_name == cfg.DATASETS.TRAIN[0]
    dsconv = "dsconv" in yaml
    assert hasattr(model.ins_embed_head.offset_head, "depthwise") == dsconv and len(model.ins_embed_head.center_head) == 2
    assert cfg.SOLVER.OPTIMIZER == "ADAM" and cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES == (133 if "coco" in yaml else 19)
    for name in tuple(cfg.DATASETS.TRAIN) + tuple(cfg.DATASETS.TEST):
        assert name in DatasetCatalog.list(), name
    assert FEATURES  # the narrow widths the head tests use
