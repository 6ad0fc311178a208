"""A tiny HRFPN DensePose R-CNN in the port against the JAX package, on the
CPU in float32: ``test_torch_densepose_rcnn``'s tiny model (the decoder
with the V1ConvX head) on a narrow HRNet + HRFPN at five levels p1..p5, as
the HRFPN yamls set them, so the box head pools from five levels (strides
4..64) and every norm keeps batch statistics in training. Detections and
the raw DensePose maps at ``test_torch_densepose_rcnn``'s tolerances, and
one train step's losses (1e-4) and every gradient on shared sampler draws,
the JAX step applied with ``mutable=["batch_stats"]``: the gradients no
further from the float64 JAX step than four times the float32 one is (BN
with batch statistics makes them ill-conditioned in float32). Weights at
scale 0.1: at 0.05 the seeded trunk leaves the one-class scores tied to
1e-7, and which tied box comes first is float32 noise.

The JAX loss takes ``gt_dp_part + 1`` as the class (ROADMAP C): its side
of the train step is given ``gt_dp_part - 1``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.config import enable_x64  # a scoped switch; the flag is global otherwise

from _torch_port import SameDraws, jax_inference, jax_model, jax_random_variables, n, port_model
from test_torch_densepose_hrfpn import hrnet_cfg
from test_torch_densepose_rcnn import dp_train_batch, tiny_cfg

from detectron2_tpu_torch.checkpoint import convert_jax_params

torch.set_num_threads(1)


def tiny_hrfpn_cfg():
    """``test_torch_densepose_rcnn``'s tiny DensePose R-CNN (the decoder
    with the V1ConvX head) on a narrow HRNet + HRFPN at five levels, as the
    HRFPN yamls set them."""
    cfg = tiny_cfg("decoder")
    base = hrnet_cfg()
    cfg.MODEL.HRNET = base.MODEL.HRNET
    cfg.MODEL.BACKBONE.NAME = "build_hrfpn_backbone"
    cfg.MODEL.RPN.IN_FEATURES = cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p1", "p2", "p3", "p4", "p5"]
    return cfg


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_hrfpn_cfg()
    jm = jax_model(cfg)
    return cfg, jm, jax_random_variables(jm, seed=0, scale=0.1, image_hw=(128, 192))


def _eval_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.randint(0, 256, (2, 128, 192, 3)).astype(np.uint8),
            "image_sizes": np.array([[128, 192], [120, 170]], np.int32)}


def test_tiny_hrfpn_densepose_rcnn_inference_matches_jax(tiny):
    cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    assert len(model.roi_heads.box_pooler.scales) == 5
    batch = _eval_batch()
    ref = jax_inference(jm, variables, batch)
    out = model(batch)
    assert ref["valid"].sum() >= 10
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    for k, r in ref["pred_densepose_raw"].items():
        np.testing.assert_allclose(n(out["pred_densepose_raw"][k]), r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_tiny_hrfpn_densepose_rcnn_train_step_matches_jax(tiny, monkeypatch):
    cfg, jm, variables = tiny
    SameDraws(0).patch(monkeypatch)
    model = port_model(cfg, variables)
    batch = dp_train_batch()
    batch["image"] = np.random.RandomState(5).randint(0, 256, (2, 128, 192, 3)).astype(np.uint8)
    batch["image_sizes"] = np.array([[128, 192], [128, 192]], np.int32)
    ref_losses, ref32 = _jax_step(jm, variables, batch)
    cfg64 = cfg.clone()
    cfg64.TPU.COMPUTE_DTYPE = "float64"
    with enable_x64(True):
        _, ref64 = _jax_step(jax_model(cfg64), jax.tree_util.tree_map(lambda v: jnp.asarray(np.asarray(v), jnp.float64), variables), batch)
    assert {"loss_densepose_I", "loss_densepose_U"} <= set(ref_losses)
    losses = model(batch, train=True)
    assert set(losses) == set(ref_losses)
    for k, v in ref_losses.items():
        assert math.isclose(losses[k].item(), v, rel_tol=1e-4), (k, losses[k].item(), v)
    sum(losses.values()).backward()
    for name, p in model.named_parameters():
        g64 = n(ref64.get(name, torch.zeros(p.shape))).astype(np.float64)
        g32 = n(ref32.get(name, torch.zeros(p.shape))).astype(np.float64)
        # BN with batch statistics makes these gradients ill-conditioned in
        # float32 (up to ~2% of a parameter's largest gradient apart in two
        # float32 runs): the port is held to the float64 JAX step, no
        # further from it than four times the float32 JAX step is
        err = np.abs(n(p.grad).astype(np.float64) - g64).max()
        jax_err = np.abs(g32 - g64).max()
        assert err <= 4 * jax_err + 1e-4 * np.abs(g64).max() + 1e-6, (name, err, jax_err, np.abs(g64).max())
    moved = [k for k, p in model.named_parameters() if k.startswith("backbone.") and p.grad.abs().sum() > 0]
    assert any(k.startswith("backbone.bottom_up.stage4") for k in moved) and any("interp_conv.3" in k for k in moved)


def _jax_step(jm, variables, batch):
    """The JAX model's training losses and gradients (port names) on
    ``batch``, BN statistics taken from the batch."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["gt_dp_part"] = jnp.asarray(np.where(batch["gt_dp_part"] >= 0, batch["gt_dp_part"] - 1, -1))

    def loss_fn(params):
        losses, _ = jm.apply(params, jbatch, train=True, rngs={"sampling": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    return {k: float(v) for k, v in losses.items()}, convert_jax_params(jax.tree_util.tree_map(np.asarray, grads))
