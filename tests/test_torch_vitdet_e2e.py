"""Mask R-CNN ViTDet as a whole on the CPU: a tiny Mask R-CNN ViTDet (width 64,
4 blocks of 2 heads, 8x8 windows with 2 global blocks, 256x256 inputs,
LayerNorm heads) in float32 against the JAX ``GeneralizedRCNN`` instantiated
from the lazy config with the same overrides and the same seeded weights, at
the tolerances of ``tests/test_torch_e2e.py``; ``model_zoo``'s hyperparameters
against the lazy config's; and the predictor on a built model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_tpu.config import LazyConfig, instantiate
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_state_dict_report
from detectron2_tpu_torch.data import PaddedBatchCollator
from detectron2_tpu_torch.engine import DefaultPredictor
from detectron2_tpu_torch.modeling import init_weights
from detectron2_tpu_torch.structures import BitMasks, Boxes

from _torch_port import n

torch.set_num_threads(1)

LAZY_CONFIG = "configs/ViTDet/mask_rcnn_vitdet_b_100ep.py"
# (path in the model node, value) of the tiny model
TINY = {
    "backbone.net.img_size": 256,
    "backbone.net.embed_dim": 64,
    "backbone.net.depth": 4,
    "backbone.net.num_heads": 2,
    "backbone.net.window_size": 8,
    "backbone.net.window_block_indexes": (0, 2),
    "backbone.out_channels": 32,
    "proposal_generator.head.in_channels": 32,
    "proposal_generator.anchor_generator.sizes": [[16], [32], [64], [128], [256]],
    "proposal_generator.pre_nms_topk_test": 200,
    "proposal_generator.post_nms_topk_test": 50,
    "roi_heads.num_classes": 5,
    "roi_heads.box_head.conv_dims": (32, 32),
    "roi_heads.box_head.fc_dims": (64,),
    "roi_heads.box_predictor.num_classes": 5,
    "roi_heads.box_predictor.test_score_thresh": 0.0,
    "roi_heads.box_predictor.test_topk_per_image": 20,
    "roi_heads.mask_head.num_classes": 5,
    "roi_heads.mask_head.conv_dims": (32, 32, 32),
}


def _leaves(node, prefix=""):
    for k, v in node.items():
        if k == "_target_":
            continue
        if hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _plain(v):
    """Tuples, lists and list configs compare as nested lists."""
    if isinstance(v, (str, bool, int, float)):
        return v
    return [_plain(x) for x in v]


def _set(node, path, value):
    *parents, leaf = path.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value


def test_model_zoo_hyperparameters_equal_the_lazy_config():
    """Every value ``model_zoo`` builds ViTDet-B from is the lazy config's, and
    the lazy config's model node has no value that ``model_zoo`` lacks."""
    ref = {k: _plain(v) for k, v in _leaves(LazyConfig.load(LAZY_CONFIG).model)}
    ours = {k: _plain(v) for k, v in _leaves(model_zoo.mask_rcnn_vitdet_b_hyperparameters())}
    assert ours == ref
    assert len(ours) > 50


@pytest.fixture(scope="module")
def tiny():
    """(port hyperparameters, batch, JAX variables, JAX output), the JAX
    model run once per module."""
    cfg = LazyConfig.load(LAZY_CONFIG)
    hp = model_zoo.mask_rcnn_vitdet_b_hyperparameters()
    for path, value in TINY.items():
        _set(cfg.model, path, value)
        _set(hp, path, value)
    cfg.model.compute_dtype = "float32"
    cfg.model.mask_paste_in_graph = True
    jmodel = instantiate(cfg.model)
    rng = np.random.RandomState(0)
    batch = {
        "image": rng.randint(0, 256, (2, 256, 256, 3)).astype(np.uint8),
        "image_sizes": np.array([[256, 256], [200, 240]], np.int32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jmodel.init(rngs, jbatch, train=False))
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.1), shapes
    )
    out = jmodel.apply(variables, jbatch, train=False)
    return hp, batch, variables, jax.tree_util.tree_map(np.asarray, out)


def _port_model(hp, variables):
    model = model_zoo.build_mask_rcnn_vitdet(hp, "cpu", compute_dtype="float32", mask_paste_in_graph=True)
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    return model


def test_tiny_vitdet_mask_rcnn_matches_jax_model_output(tiny):
    hp, batch, variables, ref = tiny
    out = _port_model(hp, variables)(batch)
    assert set(out) == set(ref)
    assert ref["valid"].sum() >= 20  # the comparison is of real detections
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)
    full = n(out["pred_masks_full"])
    assert full.shape == ref["pred_masks_full"].shape == (2, 20, 256, 256)
    assert (full != ref["pred_masks_full"]).mean() < 1e-4


def test_tiny_vitdet_transposed_factor_layout_gives_the_same_detections(tiny, monkeypatch):
    hp, batch, variables, ref = tiny
    monkeypatch.setenv("D2T_FLASH_V2", "1")
    out = _port_model(hp, variables)(batch)
    np.testing.assert_array_equal(n(out["pred_classes"]), ref["pred_classes"])
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)


def test_predictor_on_a_built_model_pads_to_the_backbone_square(tiny):
    hp = tiny[0]
    model = model_zoo.build_mask_rcnn_vitdet(hp, "cpu", compute_dtype="float32")
    init_weights(model, torch.Generator().manual_seed(0))
    predictor = DefaultPredictor(model=model, min_size_test=256, max_size_test=256)
    assert predictor.input_format == "RGB"
    assert (predictor.collator.square_size, predictor.collator.size_divisibility) == (256, 16)
    img = np.random.RandomState(1).randint(0, 256, (120, 180, 3)).astype(np.uint8)
    inst = predictor(img)["instances"]
    assert inst.image_size == (120, 180) and len(inst) > 0
    assert isinstance(inst.pred_boxes, Boxes) and isinstance(inst.pred_masks, BitMasks)
    assert len(inst.pred_boxes) == len(inst.pred_masks) == len(inst.scores) == len(inst)
    boxes = inst.pred_boxes.tensor
    assert (boxes >= 0).all() and (boxes[:, 0::2] <= 180).all() and (boxes[:, 1::2] <= 120).all()
    assert inst.pred_masks.tensor.shape == (len(inst), 120, 180) and inst.pred_masks.tensor.dtype == torch.bool
    assert (inst.pred_boxes.area() > 0).all() and inst.pred_masks.area().shape == (len(inst),)


def test_init_weights_fills_the_relative_position_tables():
    hp = model_zoo.mask_rcnn_vitdet_b_hyperparameters()
    hp["backbone"]["net"].update(img_size=64, embed_dim=32, depth=2, num_heads=2, window_size=2, window_block_indexes=(0,))
    model = model_zoo.build_mask_rcnn_vitdet(hp, "cpu")
    attn = model.backbone.net.blocks[1].attn
    assert not attn.rel_pos_h.any() and attn.rel_pos_h.shape == (7, 16)
    init_weights(model, torch.Generator().manual_seed(0))
    for p in (attn.rel_pos_h, attn.rel_pos_w, model.backbone.net.blocks[0].attn.rel_pos_h, model.backbone.net.pos_embed):
        assert p.abs().min() > 0 and 0.005 < p.std() < 0.04
    assert 0.015 < model.backbone.net.blocks[0].attn.qkv.weight.std() < 0.025
    assert not model.backbone.net.blocks[0].attn.qkv.bias.any()


def test_structures_index_clip_and_measure():
    b = Boxes(torch.tensor([[-5.0, 2.0, 30.0, 50.0], [1.0, 1.0, 3.0, 4.0], [0.0, 0.0, 0.0, 0.0]]))
    assert len(b) == 3 and b.area().tolist() == [35.0 * 48.0, 6.0, 0.0]
    assert len(b[1]) == 1 and b[1].tensor.shape == (1, 4) and len(b[torch.tensor([True, False, True])]) == 2
    b.clip((40, 20))
    assert b.tensor.tolist() == [[0.0, 2.0, 20.0, 40.0], [1.0, 1.0, 3.0, 4.0], [0.0, 0.0, 0.0, 0.0]]
    assert len(Boxes(torch.zeros(0))) == 0
    m = BitMasks(torch.tensor([[[1, 0], [1, 1]], [[0, 0], [0, 1]]]))
    assert len(m) == 2 and m.tensor.dtype == torch.bool
    assert m.area().tolist() == [3, 1] and len(m[0]) == 1 and len(m[:1]) == 1


def test_collator_pads_to_the_fixed_square():
    images = [torch.ones(100, 60, 3, dtype=torch.uint8), torch.ones(30, 128, 3, dtype=torch.uint8)]
    batch = PaddedBatchCollator(size_divisibility=16, size_bucket=16, square_size=128)(images)
    assert batch["image"].shape == (2, 128, 128, 3) and batch["image_sizes"].tolist() == [[100, 60], [30, 128]]
    assert batch["image"][0, 100:].sum() == 0 and batch["image"][0, :100, :60].all()
    with pytest.raises(ValueError, match="does not fit"):
        PaddedBatchCollator(square_size=64)(images)
