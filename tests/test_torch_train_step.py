"""The port's Mask R-CNN train step against the JAX package's, on a tiny
R18-FPN model (64x64 images, B=2, G=5 gt slots, one padded) with its weights
carried across by ``convert_jax_params``, in float32 on the CPU.

Both packages' samplers get the same uniform draws
(``_torch_port.SameDraws``): the port's through ``sampling.uniform_draws``,
the JAX package's through the ``jax`` its ``modeling/sampling.py`` sees.
Every image of a batch gets the same draws (JAX calls its sampler once per
image under ``vmap``).

Tolerances: the five losses rtol 1e-4; each parameter's gradient max|Δ| <=
1e-3 * max|g_ref| + 1e-6; each parameter after two SGD steps max|Δ| <= 1e-3 *
max|p_ref - p0| + 1e-6 (matmul and conv sums in another order).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import SameDraws, assert_train_step_matches, jax_cfg_from_port, jax_model, jax_random_variables, port_model

from detectron2_tpu.parallel import TrainState, make_train_step
from detectron2_tpu.solver import build_lr_scheduler as jax_build_lr_scheduler
from detectron2_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_tpu_torch.checkpoint import convert_jax_params
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.engine import SimpleTrainer, hooks
from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer
from detectron2_tpu_torch.testing import synthetic_train_batch

torch.set_num_threads(1)

LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")


def tiny_cfg():
    cfg = get_cfg()
    m = cfg.MODEL
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TRAIN = 200
    m.RPN.POST_NMS_TOPK_TRAIN = 100
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_HEADS.NUM_CLASSES = 8
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 2
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.MASK_ON = True
    cfg.TPU.COMPUTE_DTYPE = "float32"
    s = cfg.SOLVER
    s.BASE_LR = 0.01
    s.MAX_ITER = 10
    s.STEPS = (1,)  # the LR drops between the two compared steps
    s.WARMUP_ITERS = 4
    s.WARMUP_FACTOR = 0.5
    s.BIAS_LR_FACTOR = 2.0
    s.WEIGHT_DECAY_BIAS = 0.0
    return cfg


def make_batch(empty_gt=False):
    """Two 64x64 images, 5 gt slots each (one padded), 8 classes."""
    batch = synthetic_train_batch(num_classes=8)
    if empty_gt:
        batch["gt_valid"][:] = False
        batch["gt_boxes"][:] = 0
    return batch


@pytest.fixture(scope="module")
def draws():
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        yield


@pytest.fixture(scope="module")
def jax_run(draws):
    """The JAX side, once per module: losses and gradients at the initial
    weights (jitted value_and_grad), and the weights after two steps of
    ``make_train_step`` with ``build_optimizer``."""
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=5, scale=0.1)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    key = jax.random.PRNGKey(0)

    def loss_fn(params):
        losses = jm.apply(params, batch, train=True, rngs={"sampling": key})
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    state = TrainState.create(variables, jax_build_optimizer(jax_cfg_from_port(cfg), variables))
    step = make_train_step(jm, donate=False)
    for i in range(2):
        state, _ = step(state, batch, jax.random.fold_in(key, i))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {
        "cfg": cfg,
        "variables": variables,
        "losses": {k: float(v) for k, v in losses.items()},
        "grads": convert_jax_params(as_np(grads)),
        "params0": convert_jax_params(as_np(variables)),
        "params2": convert_jax_params(as_np(state.params)),
    }


def test_losses_and_gradients_match_jax(jax_run):
    """The frozen stem and res2 get no gradient on either side
    (``stop_gradient`` in JAX)."""
    model = port_model(jax_run["cfg"], jax_run["variables"])
    losses = assert_train_step_matches(model, make_batch(), jax_run["losses"], jax_run["grads"])
    assert set(losses) == set(LOSSES)
    assert sum(p.requires_grad for p in model.parameters()) > 30


def test_parameters_after_two_sgd_steps_match_make_train_step(jax_run):
    """The port's SimpleTrainer with build_optimizer and the LRScheduler hook
    against two steps of ``make_train_step`` (warmup, then the LR step at
    iteration 1, bias LR factor 2 and no bias decay). The frozen stem and
    res2 are not in the port's optimizer and stay as they were; the JAX
    package's weight decay still moves them (they are in its param tree with
    zero gradient; a known difference, ROADMAP.md section C), so they are
    compared with the initial weights."""
    cfg = jax_run["cfg"]
    model = port_model(cfg, jax_run["variables"])
    optimizer = build_optimizer(cfg, model)
    trainer = SimpleTrainer(model, [make_batch()] * 2, optimizer)
    trainer.register_hooks([hooks.LRScheduler(optimizer, build_lr_scheduler(cfg, optimizer))])
    trainer.train(0, 2)
    p0, p2 = jax_run["params0"], jax_run["params2"]
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, p0[name]), name
            continue
        moved = (p2[name] - p0[name]).abs().max().item()
        assert moved > 0, name
        assert (p.detach() - p2[name]).abs().max().item() <= 1e-3 * moved + 1e-6, name
    # warmup from 0.5 toward the stepped-down 0.1 over 4 of 10 iterations
    lrs = trainer.storage.history("lr").values()
    assert [i for _, i in lrs] == [0, 1]
    assert math.isclose(lrs[0][0], 0.01 * 0.5) and math.isclose(lrs[1][0], 0.01 * (0.5 - 0.4 * 0.25))


def test_empty_gt_batch_gives_finite_losses(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    losses = model(make_batch(empty_gt=True), train=True)
    assert set(losses) == set(LOSSES)
    assert all(torch.isfinite(v) for v in losses.values())
    # no foreground: no box, mask or anchor regression loss
    assert losses["loss_box_reg"] == 0 and losses["loss_mask"] == 0 and losses["loss_rpn_loc"] == 0
    sum(losses.values()).backward()


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("WarmupMultiStepLR", dict(MAX_ITER=40, STEPS=(10, 25, 60), WARMUP_ITERS=8, WARMUP_FACTOR=0.01)),
        ("WarmupMultiStepLR", dict(MAX_ITER=30, STEPS=(12,), WARMUP_ITERS=5, WARMUP_METHOD="constant")),
        ("WarmupCosineLR", dict(MAX_ITER=30, WARMUP_ITERS=6, BASE_LR_END=0.002)),
    ],
)
def test_lr_multiplier_matches_the_jax_schedule(name, overrides):
    cfg = get_cfg()
    cfg.SOLVER.LR_SCHEDULER_NAME = name
    cfg.SOLVER.BASE_LR = 0.02
    for k, v in overrides.items():
        cfg.SOLVER[k] = v
    ref = jax_build_lr_scheduler(jax_cfg_from_port(cfg))
    param = torch.nn.Parameter(torch.zeros(1))
    optimizer = torch.optim.SGD([param], lr=cfg.SOLVER.BASE_LR)
    scheduler = build_lr_scheduler(cfg, optimizer)
    for it in range(cfg.SOLVER.MAX_ITER + 5):
        assert math.isclose(optimizer.param_groups[0]["lr"], ref(it), rel_tol=1e-12, abs_tol=1e-15), it
        optimizer.step()
        scheduler.step()


def test_simple_trainer_halves_the_loss_on_one_batch(draws):
    """40 steps on one fixed batch (learnable box-shaped gt masks, the same
    sampler draws every step) with global-norm gradient clipping: the mean
    of the last five losses is below half the first."""
    torch.manual_seed(0)
    cfg = tiny_cfg()
    s = cfg.SOLVER
    s.BASE_LR, s.WARMUP_ITERS, s.MAX_ITER, s.STEPS = 0.02, 0, 100, (200,)
    s.CLIP_GRADIENTS.ENABLED, s.CLIP_GRADIENTS.CLIP_TYPE, s.CLIP_GRADIENTS.CLIP_VALUE = True, "norm", 1.0
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_weights(model, gen)
    batch = make_batch()
    batch["gt_masks"][:] = 0
    batch["gt_masks"][:, :, 6:22, 4:24] = 1
    calibrate_frozen_bn(model, batch)
    optimizer = build_optimizer(cfg, model)
    trainer = SimpleTrainer(model, [batch] * 40, optimizer)
    trainer.register_hooks([hooks.IterationTimer(warmup_iter=1), hooks.LRScheduler(optimizer, build_lr_scheduler(cfg, optimizer))])
    trainer.train(0, 40)
    losses = [v for v, _ in trainer.storage.history("total_loss").values()]
    assert len(losses) == 40 and len(trainer.storage.history("time").values()) == 39
    assert np.mean(losses[-5:]) < 0.5 * losses[0], losses


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, batch, train=False, generator=None):
        return {"loss_mse": ((batch["x"] * self.w).sum(-1) - batch["y"]).pow(2).mean() * batch.get("scale", 1.0)}


def test_hooks_run_in_order_and_a_non_finite_loss_raises():
    x = torch.rand(8, 4)
    batch = {"x": x, "y": (2 * x).sum(-1)}
    model = _Toy()
    trainer = SimpleTrainer(model, [batch] * 3, torch.optim.SGD(model.parameters(), lr=0.05))
    calls = []
    trainer.register_hooks(
        [
            hooks.CallbackHook(
                before_train=lambda t: calls.append("bt"),
                before_step=lambda t: calls.append("bs"),
                after_step=lambda t: calls.append("as"),
                after_train=lambda t: calls.append("at"),
            )
        ]
    )
    trainer.train(0, 3)
    assert calls == ["bt"] + ["bs", "as"] * 3 + ["at"]
    assert trainer.iter == 3

    bad = SimpleTrainer(model, [dict(batch, scale=float("nan"))], torch.optim.SGD(model.parameters(), lr=0.05))
    with pytest.raises(FloatingPointError, match="iteration=0"):
        bad.train(0, 1)
