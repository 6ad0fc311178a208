"""The port's MViTv2 against the JAX package's, on the CPU in float32.

- The d2 golden (``tests/goldens/mvit_backbone.npz``): its weights load by
  d2 name (``blocks.{i}.attn.pool_q``, ``norm_q``, ``rel_pos_h``,
  ``blocks.{i}.proj``, ``scale{n}_norm``) with no key missing or unused, and
  scale2-scale5 reproduce the reference within 3e-3, the JAX test's bound.
- The JAX module with seeded random variables carried across by
  ``convert_jax_params`` (the depthwise pool kernels HWIO -> OIHW) on a
  160x224 input, whose maps pad every window (40x56 under 56x56 windows),
  with and without the bicubic-resized absolute position table: features
  within 2e-5 * max|ref|. The per-block DropPath rates are the JAX blocks'.
- A tiny Mask R-CNN from ``configs/MViTv2/mask_rcnn_mvitv2_t_3x.py``
  (width 16, depths 1-1-2-1, 12x12 windows on 160x160 inputs, so that the
  first stage's 40x40 map pads), DropPath off: the detections at the
  tolerances of ``test_torch_vitdet_e2e``, and one train step's losses and
  gradients at ``assert_train_step_matches``'s on shared sampler draws.
- ``use_checkpoint`` (the H configs') gives the same loss and gradients,
  DropPath's draws included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

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
    t,
)

from detectron2_tpu.modeling.backbone.mvit import MultiScaleBlock as JaxMultiScaleBlock
from detectron2_tpu.modeling.backbone.mvit import MViT as JaxMViT
from detectron2_tpu_torch.modeling.backbone import MViT, padding_constraints
from detectron2_tpu_torch.testing import synthetic_train_batch

torch.set_num_threads(1)

SMALL = dict(img_size=224, embed_dim=32, depths=(1, 2, 2, 1), num_heads=(1, 2, 4, 8), use_rel_pos=True)
CONFIG = "MViTv2/mask_rcnn_mvitv2_t_3x.py"
TINY = {
    "compute_dtype": "float32",
    "backbone.bottom_up.img_size": 160,
    "backbone.bottom_up.embed_dim": 16,
    "backbone.bottom_up.depths": (1, 1, 2, 1),
    "backbone.bottom_up.num_heads": (1, 2, 4, 8),
    "backbone.bottom_up.adaptive_window_size": 12,
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
    "roi_heads.box_head.fc_dims": (32, 32),
    "roi_heads.box_predictor.num_classes": 5,
    "roi_heads.box_predictor.test_score_thresh": 0.0,
    "roi_heads.box_predictor.test_topk_per_image": 20,
    "roi_heads.mask_head.num_classes": 5,
    "roi_heads.mask_head.conv_dims": (16, 16, 16),
}


def test_mvit_reproduces_the_golden_through_d2_names():
    model = MViT(**SMALL)
    assert_golden_features(model, load_golden("mvit_backbone"), ("scale2", "scale3", "scale4", "scale5"), 3e-3)
    assert padding_constraints(model) == {"size_divisibility": 32}


@pytest.mark.parametrize("abs_pos", [False, True], ids=["rel_pos", "abs_and_rel_pos"])
def test_mvit_matches_the_jax_module_where_every_window_pads(abs_pos):
    args = dict(SMALL, use_abs_pos=abs_pos)
    x = np.random.RandomState(1).randn(1, 160, 224, 3).astype(np.float32)
    jmodel = JaxMViT(**args)
    variables = jax_module_random_variables(jmodel, x, seed=2)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model = load_jax_variables(MViT(**args), variables)
    with torch.no_grad():
        out = model(t(x))
    assert_features_match(out, ref)
    assert model.size_divisibility == jmodel.size_divisibility == 32
    assert {k: (v.channels, v.stride) for k, v in model.output_shape().items()} == {
        k: (v.channels, v.stride) for k, v in jmodel.output_shape().items()}


def test_drop_path_rates_are_the_jax_blocks():
    args = dict(SMALL, drop_path_rate=0.4)
    rates = []

    def record(next_fun, args_, kwargs, context):
        if isinstance(context.module, JaxMultiScaleBlock) and context.method_name == "__call__":
            rates.append(context.module.drop_path)
        return next_fun(*args_, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda: JaxMViT(**args).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert [b.drop_path.rate for b in MViT(**args).blocks] == pytest.approx(rates) and rates[-1] == pytest.approx(0.4)


def test_use_checkpoint_gives_the_same_loss_and_gradients():
    """torch.utils.checkpoint recomputes each block in the backward; DropPath
    draws the same masks there from the generator's state before the block."""
    x = torch.randn(2, 64, 96, 3)
    results = []
    for use in (False, True):
        torch.manual_seed(0)
        model = MViT(**dict(SMALL, embed_dim=16, drop_path_rate=0.5, use_checkpoint=use))
        out = model(x, True, torch.Generator().manual_seed(5))
        loss = sum(v.square().mean() for v in out.values())
        loss.backward()
        results.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# --------------------------------------------- a tiny Mask R-CNN on MViTv2


@pytest.fixture(scope="module")
def tiny():
    port, jm = lazy_models(CONFIG, TINY)
    return port, jm, jax_random_variables(jm, seed=6, scale=0.1)


def test_tiny_mvit_mask_rcnn_detections_match_jax(tiny):
    port, jm, variables = tiny
    rng = np.random.RandomState(7)
    batch = {"image": rng.randint(0, 256, (2, 160, 160, 3)).astype(np.uint8),
             "image_sizes": np.array([[160, 160], [120, 150]], np.int32)}
    out = load_jax_variables(port, variables)(batch)
    assert_detections_match(out, jax_inference(jm, variables, batch))


def test_tiny_mvit_mask_rcnn_train_step_matches_jax(tiny, monkeypatch):
    SameDraws(seed=9).patch(monkeypatch)
    port, jm, variables = tiny
    batch = synthetic_train_batch(B=2, H=160, W=160, G=5, num_classes=5, seed=8)
    losses, grads = jax_train_step(jm, variables, batch)
    model = load_jax_variables(port, variables)
    model.zero_grad(set_to_none=True)
    ours = assert_train_step_matches(model, batch, losses, grads)
    assert ours["loss_mask"] > 0 and ours["loss_box_reg"] > 0
