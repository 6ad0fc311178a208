"""The port's Swin Transformer against the JAX package's and d2's order, on
the CPU in float32.

- The d2 golden (``tests/goldens/swin_backbone.npz``): its weights load by
  d2 name (``patch_embed.norm``, ``layers.{i}.blocks.{d}``,
  ``layers.{i}.downsample``, ``norm{i}``) with no key missing or unused, and
  p0-p1 reproduce the reference within 2e-3, the JAX test's bound. A d2
  checkpoint's ``relative_position_index`` buffers are neither loaded nor
  reported unused.
- The JAX module with seeded random variables carried across by
  ``convert_jax_params``, at sizes whose every map is whole windows:
  features within 2e-5 * max|ref|.
- The block's order, both ways. Where a map is whole windows the port's
  block equals the JAX block. Where it pads, the port equals a plain
  statement of d2's order written here (pad, roll, the mask on the padded
  grid, attention, reverse roll, crop), and the JAX block, which rolls
  before it pads, does not.
- A tiny Cascade Mask R-CNN from ``configs/ViTDet/cascade_mask_rcnn_swin_b_
  in21k_50ep.py`` (width 16, 2x2 windows on 128x128 inputs, so that every
  map is whole windows), DropPath off: the detections at the tolerances of
  ``test_torch_vitdet_e2e``, and one train step's losses and gradients at
  ``assert_train_step_matches``'s on shared sampler draws.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_port import (
    SameDraws,
    assert_detections_match,
    assert_features_match,
    assert_golden_features,
    assert_train_step_matches,
    jax_inference,
    jax_module_random_variables,
    jax_random_variables,
    jax_train_step,
    lazy_models,
    load_golden,
    load_jax_variables,
    n,
    t,
)

from detectron2_tpu.modeling.backbone.swin import SwinBlock as JaxSwinBlock
from detectron2_tpu.modeling.backbone.swin import SwinTransformer as JaxSwinTransformer
from detectron2_tpu.modeling.backbone.swin import _rel_pos_index
from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling.backbone import SwinTransformer, padding_constraints
from detectron2_tpu_torch.modeling.backbone.swin import SwinBlock
from detectron2_tpu_torch.testing import golden_state_dict, synthetic_train_batch

torch.set_num_threads(1)

GOLDEN_ARGS = dict(patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4), window_size=7, out_features=("p0", "p1"))
CONFIG = "ViTDet/cascade_mask_rcnn_swin_b_in21k_50ep.py"
TINY = {
    "compute_dtype": "float32",
    "backbone.bottom_up.embed_dim": 16,
    "backbone.bottom_up.depths": (2, 2, 2, 2),
    "backbone.bottom_up.num_heads": (1, 2, 4, 8),
    "backbone.bottom_up.window_size": 2,
    "backbone.bottom_up.drop_path_rate": 0.0,
    "backbone.out_channels": 32,
    "proposal_generator.head.in_channels": 32,
    "proposal_generator.anchor_generator.sizes": [[8], [16], [32], [64], [128]],
    "proposal_generator.pre_nms_topk_test": 200,
    "proposal_generator.post_nms_topk_test": 50,
    "proposal_generator.pre_nms_topk_train": 300,
    "proposal_generator.post_nms_topk_train": 60,
    "roi_heads.num_classes": 5,
    "roi_heads.batch_size_per_image": 64,
    "roi_heads.mask_head.num_classes": 5,
    "roi_heads.mask_head.conv_dims": (16, 16, 16),
    **{f"roi_heads.box_head.{i}.conv_dims": (16, 16) for i in range(3)},
    **{f"roi_heads.box_head.{i}.fc_dims": (32,) for i in range(3)},
    **{f"roi_heads.box_predictor.{i}.num_classes": 5 for i in range(3)},
    **{f"roi_heads.box_predictor.{i}.test_score_thresh": 0.0 for i in range(3)},
    **{f"roi_heads.box_predictor.{i}.test_topk_per_image": 20 for i in range(3)},
}


def test_swin_reproduces_the_golden_through_d2_names():
    assert_golden_features(SwinTransformer(**GOLDEN_ARGS), load_golden("swin_backbone"), GOLDEN_ARGS["out_features"], 2e-3)


def test_a_d2_checkpoint_s_relative_position_index_is_neither_loaded_nor_unused():
    model = SwinTransformer(**GOLDEN_ARGS)
    index = model.layers[0].blocks[0].attn.relative_position_index
    assert torch.equal(index, torch.from_numpy(np.asarray(_rel_pos_index(7))).to(index.dtype))
    assert not any(k.endswith("relative_position_index") for k in model.state_dict())
    state = golden_state_dict(load_golden("swin_backbone"))
    for i, depth in enumerate(GOLDEN_ARGS["depths"]):
        for d in range(depth):
            state[f"layers.{i}.blocks.{d}.attn.relative_position_index"] = index.numpy()
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."]


@pytest.mark.parametrize(
    "hw, args",
    [((224, 224), dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=7)),
     ((64, 128), dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=2, mlp_ratio=2.0))],
    ids=["224_window7", "64x128_window2"],
)
def test_swin_matches_the_jax_module_at_whole_windows(hw, args):
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    jmodel = JaxSwinTransformer(**args)
    variables = jax_module_random_variables(jmodel, x, seed=2)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model = load_jax_variables(SwinTransformer(**args), variables)
    with torch.no_grad():
        out = model(t(x))
    assert_features_match(out, ref)
    assert model.size_divisibility == jmodel.size_divisibility == 32
    assert padding_constraints(model) == {"size_divisibility": 32}
    assert {k: (v.channels, v.stride) for k, v in model.output_shape().items()} == {
        k: (v.channels, v.stride) for k, v in jmodel.output_shape().items()}


# ------------------------------------------------------ pad first, then roll


def _d2_order(block: SwinBlock, x: torch.Tensor) -> torch.Tensor:
    """d2's shifted-window block written out: norm1, zero-pad to whole
    windows, roll by -shift, attention inside each window with the bias
    table and the mask of the padded grid (d2's ``BasicLayer``), roll back,
    crop, residual, MLP."""
    B, H, W, C = x.shape
    ws, s = block.window_size, block.shift_size
    attn = block.attn
    nh, hd = attn.num_heads, C // attn.num_heads
    y = F.layer_norm(x, (C,), block.norm1.weight, block.norm1.bias, 1e-5)
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    y = F.pad(y, (0, 0, 0, Wp - W, 0, Hp - H))
    y = torch.roll(y, (-s, -s), (1, 2))
    img = torch.zeros(Hp, Wp)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
        for wsl in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
            img[hs, wsl] = cnt
            cnt += 1

    def windows(a):  # [B, Hp, Wp, ...] -> [B, nW, ws * ws, ...]
        a = a.reshape(a.shape[0], Hp // ws, ws, Wp // ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
        return a.reshape(a.shape[0], -1, ws * ws, a.shape[-1])

    labels = windows(img[None, :, :, None])[0, :, :, 0]
    mask = torch.where(labels[:, :, None] != labels[:, None, :], -100.0, 0.0)  # [nW, N, N]
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + ws - 1
    bias = attn.relative_position_bias_table[rel[0] * (2 * ws - 1) + rel[1]].permute(2, 0, 1)  # [nh, N, N]
    qkv = F.linear(windows(y), attn.qkv.weight, attn.qkv.bias).reshape(B, -1, ws * ws, 3, nh, hd)
    q, k, v = qkv.unbind(3)  # [B, nW, N, nh, hd]
    scores = torch.einsum("bwqhc,bwkhc->bwhqk", q * hd**-0.5, k) + bias[None, None] + mask[None, :, None]
    o = torch.einsum("bwhqk,bwkhc->bwqhc", scores.softmax(-1), v).reshape(B, -1, ws * ws, C)
    o = F.linear(o, attn.proj.weight, attn.proj.bias).reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    o = o.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    x = x + torch.roll(o, (s, s), (1, 2))[:, :H, :W]
    z = F.layer_norm(x, (C,), block.norm2.weight, block.norm2.bias, 1e-5)
    return x + F.linear(F.gelu(F.linear(z, block.mlp.fc1.weight, block.mlp.fc1.bias)), block.mlp.fc2.weight, block.mlp.fc2.bias)


@pytest.fixture(scope="module")
def shifted_block():
    """A shifted block (window 4, shift 2) with seeded random variables, in
    both packages."""
    jblock = JaxSwinBlock(dim=16, num_heads=2, window_size=4, shift_size=2)
    variables = jax_module_random_variables(jblock, np.zeros((1, 8, 12, 16), np.float32), seed=3, scale=0.3)
    block = SwinBlock(16, 2, window_size=4, shift_size=2)
    return load_jax_variables(block, variables), jblock, variables


def test_the_block_equals_jax_where_the_map_is_whole_windows(shifted_block):
    block, jblock, variables = shifted_block
    x = np.random.RandomState(4).randn(2, 8, 12, 16).astype(np.float32)
    ref = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out, d2 = n(block(t(x))), n(_d2_order(block, t(x)))
    assert np.abs(out - ref).max() <= 2e-5 * np.abs(ref).max()
    assert np.abs(d2 - ref).max() <= 2e-5 * np.abs(ref).max()


def test_the_block_pads_then_rolls_as_d2_where_the_jax_block_does_not(shifted_block):
    """A 10 x 11 map (padded to 12 x 12): the port's block is d2's order;
    the JAX block rolls the unpadded map and differs from it."""
    block, jblock, variables = shifted_block
    x = np.random.RandomState(5).randn(2, 10, 11, 16).astype(np.float32)
    with torch.no_grad():
        out, d2 = n(block(t(x))), n(_d2_order(block, t(x)))
    jax_out = np.asarray(jax.jit(jblock.apply)(variables, jnp.asarray(x)))
    scale = np.abs(d2).max()
    assert np.abs(out - d2).max() <= 2e-5 * scale
    assert np.abs(jax_out - d2).max() > 1e-2 * scale


# ------------------------------------------- a tiny Cascade Mask R-CNN on Swin


@pytest.fixture(scope="module")
def tiny():
    port, jm = lazy_models(CONFIG, TINY)
    return port, jm, jax_random_variables(jm, seed=6, scale=0.1)


def test_tiny_swin_cascade_mask_rcnn_detections_match_jax(tiny):
    port, jm, variables = tiny
    rng = np.random.RandomState(7)
    batch = {"image": rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8),
             "image_sizes": np.array([[128, 128], [100, 120]], np.int32)}
    out = load_jax_variables(port, variables)(batch)
    assert_detections_match(out, jax_inference(jm, variables, batch))


def test_tiny_swin_cascade_mask_rcnn_train_step_matches_jax(tiny, monkeypatch):
    SameDraws(seed=9).patch(monkeypatch)
    port, jm, variables = tiny
    batch = synthetic_train_batch(B=2, H=128, W=128, G=5, num_classes=5, seed=8)
    losses, grads = jax_train_step(jm, variables, batch)
    model = load_jax_variables(port, variables)
    model.zero_grad(set_to_none=True)
    ours = assert_train_step_matches(model, batch, losses, grads)
    assert ours["loss_mask"] > 0 and ours["loss_box_reg_stage2"] > 0
