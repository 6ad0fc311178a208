"""The port's RegNet against the JAX package's, on the CPU in float32.

- The width ladder of the zoo's RegNetX-4GF and RegNetY-4GF and a tiny one.
- The d2 golden (``tests/goldens/regnet_backbone.npz``, a RegNetY with SE
  and BN): its weights load by d2 name (``stem.conv``, ``s{i}.b{j}.f.a_bn``,
  ``f.se.f_ex.0`` ...) with no key missing or unused, and s1-s3 reproduce
  the reference within 2e-3, the JAX test's bound.
- The JAX module with seeded random variables carried across by
  ``convert_jax_params``: X (FrozenBN) and Y (SE) at eval, and Y with
  SyncBN under batch statistics (the LSJ recipe's grouped convs and SE),
  features within 2e-5 * max|ref|, the running statistics too.
- A tiny Mask R-CNN on a RegNet FPN, built as the zoo's RegNet configs build
  theirs, ``GeneralizedRCNN.from_config(cfg).clone(backbone=FPN(RegNet(...)))``,
  in both packages: the detections at the tolerances of
  ``test_torch_vitdet_e2e``, and one train step's losses and gradients at
  ``assert_train_step_matches``'s (rtol 1e-4, 1e-3 * max|g|) on shared
  sampler draws, ``freeze_at=2`` taking the gradient from the stem and s1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    SameDraws,
    assert_detections_match,
    assert_features_match,
    assert_golden_features,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_inference,
    jax_module_random_variables,
    jax_random_variables,
    jax_train_step,
    load_golden,
    load_jax_variables,
    n,
    t,
)
from test_torch_train_step import make_batch, tiny_cfg

from detectron2_tpu.modeling import GeneralizedRCNN as JaxGeneralizedRCNN
from detectron2_tpu.modeling.backbone import FPN as JaxFPN
from detectron2_tpu.modeling.backbone import LastLevelMaxPool as JaxLastLevelMaxPool
from detectron2_tpu.modeling.backbone.regnet import RegNet as JaxRegNet
from detectron2_tpu.modeling.backbone.regnet import generate_regnet_parameters as jax_ladder
from detectron2_tpu_torch.checkpoint import convert_jax_params
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling.backbone import FPN, LastLevelMaxPool, RegNet, padding_constraints
from detectron2_tpu_torch.modeling.backbone.regnet import generate_regnet_parameters

torch.set_num_threads(1)

GOLDEN_ARGS = dict(stem_width=16, depth=8, w_a=24.48, w_0=24, w_m=2.54, group_width=8, se_ratio=0.25,
                   out_features=("s1", "s2", "s3"))
# four stages of widths 8, 16, 24, 40 and depths 1, 1, 2, 1
TINY_ARGS = dict(stem_width=8, depth=5, w_a=8, w_0=8, w_m=1.5, group_width=8)
FEATURES = ("s1", "s2", "s3", "s4")


@pytest.mark.parametrize("args", [(38.65, 96, 2.43, 23, 40, 1.0), (31.41, 96, 2.24, 22, 64, 1.0), (8, 8, 1.5, 5, 8, 1.0),
                                  (24.48, 24, 2.54, 8, 8, 0.5)],
                         ids=["regnetx_4gf", "regnety_4gf", "tiny", "golden_half_bottleneck"])
def test_width_ladder_matches_jax(args):
    w_a, w_0, w_m, d, g, bot = args
    ours = generate_regnet_parameters(w_a, w_0, w_m, d, group_width=g, bot_mul=bot)
    assert ours == tuple(jax_ladder(w_a, w_0, w_m, d, group_width=g, bot_mul=bot))


def test_regnet_reproduces_the_golden_through_d2_names():
    model = RegNet(**GOLDEN_ARGS)
    assert_golden_features(model, load_golden("regnet_backbone"), GOLDEN_ARGS["out_features"], 2e-3)
    assert {k: (v.channels, v.stride) for k, v in model.output_shape().items()} == {
        k: (v.channels, v.stride) for k, v in JaxRegNet(**GOLDEN_ARGS).output_shape().items()
    }


@pytest.mark.parametrize(
    "kind, norm, train",
    [("X", "FrozenBN", False), ("Y", "BN", False), ("Y", "SyncBN", True)],
    ids=["x_frozen_bn", "y_bn_eval", "y_syncbn_batch_statistics"],
)
def test_regnet_matches_the_jax_module(kind, norm, train):
    args = dict(TINY_ARGS, norm=norm, se_ratio=0.25 if kind == "Y" else 0.0, out_features=FEATURES)
    x = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    jmodel = JaxRegNet(**args)
    variables = jax_module_random_variables(jmodel, x, seed=2)
    if train:
        ref, updates = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    else:
        ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(variables, jnp.asarray(x))
    model = load_jax_variables(RegNet(**args), variables)
    with torch.no_grad():
        out = model(t(x), train=train)
    assert_features_match(out, ref)
    if train:
        stats = convert_jax_params(jax.tree_util.tree_map(np.asarray, updates))
        own = model.state_dict()
        assert len(stats) == 2 * sum(1 for k in own if k.endswith("running_mean"))
        for name, value in stats.items():
            np.testing.assert_allclose(n(own[name]), n(value), rtol=1e-5, atol=1e-6, err_msg=name)
    assert model.size_divisibility == jmodel.size_divisibility == 32
    assert padding_constraints(model) == {"size_divisibility": 32}


# ------------------------------------------------ a tiny Mask R-CNN on RegNet


def _cfg():
    cfg = tiny_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    return cfg


def _models(freeze_at=0):
    """(port model, JAX model) of ``GeneralizedRCNN.from_config(cfg).clone(
    backbone=FPN(RegNet(...)))``, the zoo configs' builder, at FrozenBN."""
    cfg = _cfg()
    args = dict(TINY_ARGS, norm="FrozenBN", out_features=FEATURES, freeze_at=freeze_at)
    port = build_model(cfg, device="cpu").clone(
        backbone=FPN(RegNet(**args), FEATURES, out_channels=32, top_block=LastLevelMaxPool()))
    jm = JaxGeneralizedRCNN.from_config(jax_cfg_from_port(cfg)).clone(
        backbone=JaxFPN(bottom_up=JaxRegNet(**args), in_features=FEATURES, out_channels=32, top_block=JaxLastLevelMaxPool()))
    return port, jm


@pytest.fixture(scope="module")
def tiny():
    port, jm = _models()
    return port, jm, jax_random_variables(jm, seed=3, scale=0.1)


def test_tiny_regnet_mask_rcnn_detections_match_jax(tiny):
    port, jm, variables = tiny
    rng = np.random.RandomState(4)
    batch = {"image": rng.randint(0, 256, (2, 96, 128, 3)).astype(np.uint8),
             "image_sizes": np.array([[96, 128], [80, 100]], np.int32)}
    out = load_jax_variables(port, variables)(batch)
    assert_detections_match(out, jax_inference(jm, variables, batch))


def test_tiny_regnet_mask_rcnn_train_step_matches_jax(monkeypatch):
    """freeze_at=2: the stem and s1 take no gradient on either side."""
    SameDraws(seed=9).patch(monkeypatch)
    port, jm = _models(freeze_at=2)
    variables = jax_random_variables(jm, seed=5, scale=0.1)
    batch = make_batch()
    losses, grads = jax_train_step(jm, variables, batch)
    model = load_jax_variables(port, variables)
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert frozen and all(k.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.s1.")) for k in frozen)
    ours = assert_train_step_matches(model, batch, losses, grads)
    assert ours["loss_mask"] > 0 and ours["loss_box_reg"] > 0


def test_clone_keeps_every_setting_and_copies_the_kept_children(tiny):
    port = tiny[0]
    again = port.clone()
    assert type(again) is type(port) and again is not port
    assert (again.input_format, again.compute_dtype, again.mask_paste_in_graph, again.training) == (
        port.input_format, port.compute_dtype, port.mask_paste_in_graph, port.training)
    assert torch.equal(again.pixel_mean, port.pixel_mean) and torch.equal(again.pixel_std, port.pixel_std)
    own = dict(port.named_parameters())
    for k, p in again.named_parameters():
        assert torch.equal(p, own[k]) and p.data_ptr() != own[k].data_ptr(), k
    with pytest.raises(TypeError, match="not \\['head'\\]"):
        port.clone(head=None)
    narrow = FPN(RegNet(**dict(TINY_ARGS, out_features=FEATURES)), FEATURES, out_channels=16, top_block=LastLevelMaxPool())
    with pytest.raises(ValueError, match="kept heads"):
        port.clone(backbone=narrow)
