"""ViTDet training in the port against the JAX package, on the CPU.

- The train flag reaches the backbone: ``GeneralizedRCNN.forward(train=True)``
  runs the ViT's DropPath (it ran with DropPath off before), so a ViT with
  ``drop_path_rate > 0`` gives another training loss than with DropPath off,
  and one that the generator reproduces.
- A tiny ViTDet from ``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py`` in both
  packages (width 32, depth 3 with one global block, 128x128 inputs, LN
  heads), the JAX weights carried across by ``convert_jax_params``: at
  ``drop_path_rate`` 0 the training losses and every gradient agree in
  float32 at 1e-4 / 1e-3, on shared sampler draws.
- DropPath at rate 0.5: the per-block rates equal the JAX ViT's, the drop is
  per sample, survivors are scaled by 1 / keep, the mean is kept; the draws
  come from the passed generator; ``use_checkpoint`` gives the same loss and
  gradients, DropPath included.
- The layer-wise AdamW: every ViTDet-B parameter's LR factor equals the JAX
  ``make_optimizer``'s label of the same parameter; three steps of the port's
  optimizer equal the optax chain's at 1e-6 on the same gradients (the
  multiplier at 1); the port's LR follows the config's ``LRMultiplier``
  through the warmup and the steps; the config's own ``make_optimizer``
  steps every group at ``base_lr`` (its lambdas bind late), a fault of the
  reference the port does not copy.
- ``lazyconfig_train_net`` on the CPU with jax blocked: four steps,
  checkpoints, ``--resume``, ``--eval-only``.
"""

import copy
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from detectron2_tpu.config import LazyConfig as JaxLazyConfig
from detectron2_tpu.config import instantiate as jax_instantiate
from detectron2_tpu.modeling.backbone.vit import get_vit_lr_decay_rate as jax_lr_decay_rate
from detectron2_tpu.solver.lr_scheduler import LRMultiplier as JaxLRMultiplier
from detectron2_tpu_torch import model_zoo
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_state_dict_report
from detectron2_tpu_torch.checkpoint.jax_params import flax_path_to_d2_name
from detectron2_tpu_torch.config import LazyConfig, instantiate
from detectron2_tpu_torch.layers import DropPath
from detectron2_tpu_torch.modeling.backbone.vit import ViT, get_vit_lr_decay_rate
from detectron2_tpu_torch.solver import AdamWGroupClip, vit_layerwise_adamw
from detectron2_tpu_torch.testing import synthetic_train_batch

from _torch_port import SameDraws, assert_train_step_matches, n

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/ViTDet/mask_rcnn_vitdet_b_100ep.py")
TINY = [
    "model.compute_dtype=float32",
    "model.backbone.net.img_size=128",
    "model.backbone.net.embed_dim=32",
    "model.backbone.net.depth=3",
    "model.backbone.net.num_heads=2",
    "model.backbone.net.window_size=4",
    "model.backbone.net.window_block_indexes=(0,2)",
    "model.backbone.net.drop_path_rate=0.0",
    "model.backbone.out_channels=32",
    "model.proposal_generator.head.in_channels=32",
    "model.proposal_generator.anchor_generator.sizes=[[8],[16],[32],[64],[128]]",
    "model.proposal_generator.pre_nms_topk_train=300",
    "model.proposal_generator.post_nms_topk_train=60",
    "model.roi_heads.num_classes=5",
    "model.roi_heads.batch_size_per_image=64",
    "model.roi_heads.box_head.conv_dims=(32,32)",
    "model.roi_heads.box_head.fc_dims=(64,)",
    "model.roi_heads.box_predictor.num_classes=5",
    "model.roi_heads.mask_head.num_classes=5",
    "model.roi_heads.mask_head.conv_dims=(32,32,32)",
]


def _configs(extra=()):
    """The tiny model's node in the port's config and in the JAX package's."""
    port = LazyConfig.apply_overrides(LazyConfig.load(CONFIG), TINY + list(extra)).model
    ref = JaxLazyConfig.apply_overrides(JaxLazyConfig.load(CONFIG), TINY + list(extra)).model
    return port, ref


def _batch():
    return synthetic_train_batch(B=2, H=128, W=128, G=5, num_classes=5, seed=3)


@pytest.fixture(scope="module")
def tiny():
    """(the port's tiny model with the JAX weights, JAX model, JAX variables)."""
    port_cfg, jax_cfg = _configs()
    jm = jax_instantiate(jax_cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, batch, train=False))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)
    model = instantiate(port_cfg)
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    return model, jm, variables


def test_tiny_vitdet_train_losses_and_gradients_match_jax(tiny, monkeypatch):
    model, jm, variables = tiny
    batch = _batch()
    SameDraws(seed=9).patch(monkeypatch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        losses = jm.apply(params, jbatch, train=True, rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    ref_losses = {k: float(v) for k, v in losses.items()}
    ref_grads = convert_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    model.zero_grad(set_to_none=True)
    ours = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert set(ours) == {"loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"}
    assert ours["loss_mask"] > 0 and ours["loss_box_reg"] > 0


def _vit(rate, depth=4, use_checkpoint=False):
    torch.manual_seed(0)
    return ViT(img_size=32, patch_size=8, embed_dim=16, depth=depth, num_heads=2, drop_path_rate=rate,
               use_rel_pos=True, window_size=2, window_block_indexes=(0, 2), use_checkpoint=use_checkpoint)


def test_train_flag_reaches_the_backbone_and_droppath_changes_the_loss(tiny):
    """The repair: GeneralizedRCNN's training forward passes train=True and
    the generator to the backbone; with DropPath at 0.5 the loss differs
    from DropPath off and the same generator seed reproduces it."""
    port_cfg, _ = _configs(["model.backbone.net.drop_path_rate=0.5"])
    model = instantiate(port_cfg)
    model.load_state_dict(tiny[0].state_dict())
    batch = _batch()
    seen = []
    model.backbone.register_forward_pre_hook(lambda m, args, kwargs: seen.append(kwargs), with_kwargs=True)

    def loss(m, seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return sum(m(batch, train=True, generator=gen).values()).item()

    dropped = loss(model, 1)
    assert seen[0]["train"] is True and isinstance(seen[0]["generator"], torch.Generator)
    assert loss(model, 1) == dropped
    assert loss(tiny[0], 1) != dropped
    assert any(loss(model, s) != dropped for s in (2, 3))


def test_droppath_rates_per_sample_scaling_and_mean():
    from flax import linen as nn

    from detectron2_tpu.modeling.backbone.vit import Block as JaxBlock
    from detectron2_tpu.modeling.backbone.vit import ViT as JaxViT

    jvit = JaxViT(img_size=32, patch_size=8, embed_dim=16, depth=4, num_heads=2, drop_path_rate=0.5)
    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBlock) and context.method_name == "__call__":
            rates.append(context.module.drop_path)
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda: jvit.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    vit = _vit(0.5)
    assert [b.drop_path.rate for b in vit.blocks] == rates == [0.0, 0.5 / 3, 1.0 / 3, 0.5]

    drop = DropPath(0.5)
    x = torch.ones(4000, 3, 5)
    y = drop(x, True, torch.Generator().manual_seed(0))
    per_sample = y.reshape(4000, -1)
    assert set(per_sample[:, 0].tolist()) == {0.0, 2.0}
    assert (per_sample == per_sample[:, :1]).all()  # the whole sample is dropped or kept
    assert abs(y.mean().item() - 1.0) < 0.05
    assert torch.equal(drop(x, True, torch.Generator().manual_seed(0)), y)
    assert torch.equal(drop(x, False), x) and torch.equal(DropPath(0.0)(x, True), x)


def test_use_checkpoint_gives_the_same_loss_and_gradients():
    """torch.utils.checkpoint recomputes each block in the backward; DropPath
    draws the same masks there from the generator's state before the block."""
    x = torch.randn(3, 32, 32, 3)
    outs = []
    for use in (False, True):
        vit = _vit(0.5, use_checkpoint=use)
        gen = torch.Generator().manual_seed(5)
        y = vit(x, True, gen)["last_feat"]
        y.square().sum().backward()
        outs.append((y.detach(), [p.grad.clone() for p in vit.parameters()], gen.get_state()))
    (y0, g0, s0), (y1, g1, s1) = outs
    assert torch.equal(y0, y1)
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)  # the recompute leaves the generator where it found it


def _jax_vitdet_b_labels(lr_decay_rate=0.7, num_layers=12):
    """The JAX make_optimizer's label of every ViTDet-B parameter, by the
    port's name."""
    cfg = JaxLazyConfig.load(CONFIG)
    jm = jax_instantiate(cfg.model)
    batch = {"image": jnp.zeros((1, 1024, 1024, 3)), "image_sizes": jnp.asarray([[1024, 1024]], jnp.int32)}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, batch))
    labels = {}

    def label(path, leaf):
        keys = [p.key if hasattr(p, "key") else str(p) for p in path]
        labels[flax_path_to_d2_name(tuple(keys[1:]))] = round(jax_lr_decay_rate("/".join(keys), lr_decay_rate, num_layers), 6)

    jax.tree_util.tree_map_with_path(label, shapes)
    return labels


def test_every_vitdet_b_lr_factor_equals_the_jax_label():
    ref = _jax_vitdet_b_labels()
    model = model_zoo.mask_rcnn_vitdet_b(device="cpu")
    ours = {k: round(get_vit_lr_decay_rate(k, 0.7, 12), 6) for k, _ in model.named_parameters()}
    assert set(ours) == set(ref) and len(ours) == 245
    assert {k for k in ours if ours[k] != ref[k]} == set()
    assert len(set(ours.values())) == 14  # the embeddings, 12 blocks, the rest
    opt = vit_layerwise_adamw(model)
    assert [g["lr_factor"] for g in opt.param_groups] == sorted(set(ours.values()))
    assert sum(len(g["params"]) for g in opt.param_groups) == 245


def _optax_layerwise(params, base_lr, lrs=None, weight_decay=0.1, lr_decay_rate=0.7, num_layers=12):
    """The optax chain of the config's ``make_optimizer``
    (``configs/ViTDet/mask_rcnn_vitdet_b_100ep.py:39-59``): a group per
    label, each clipped to a global norm of 1 and stepped by AdamW with
    weight decay on every leaf; group g at ``base_lr * g``, or at
    ``lrs[g]``."""

    def label(path, leaf):
        keys = "/".join(p.key if hasattr(p, "key") else str(p) for p in path)
        return round(jax_lr_decay_rate(keys, lr_decay_rate, num_layers), 6)

    labels = jax.tree_util.tree_map_with_path(label, params)
    groups = sorted(set(jax.tree_util.tree_leaves(labels)))
    lrs = lrs or {g: base_lr * g for g in groups}
    transforms = {
        g: optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(learning_rate=lrs[g], b1=0.9, b2=0.999, weight_decay=weight_decay),
        )
        for g in groups
    }
    return optax.multi_transform(transforms, labels), groups


def _steps(tx, params, grads_list):
    @jax.jit
    def step(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    for grads in grads_list:
        params, state = step(params, state, grads)
    return params


def _seeded_grads(params, steps=3):
    rng = np.random.RandomState(4)
    return [jax.tree_util.tree_map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)
            for _ in range(steps)]


def test_three_layerwise_adamw_steps_equal_the_optax_chain(tiny):
    """The port's counterpart of make_optimizer, instantiated from the
    config, against the optax chain on the same seeded gradients (norms of
    a few units, so the per-group clip acts), multiplier at 1."""
    model, _, variables = tiny
    model = copy.deepcopy(model)
    grads_list = _seeded_grads(variables)
    tx, groups = _optax_layerwise(variables, 1e-2, num_layers=3)
    ref = convert_jax_params(jax.tree_util.tree_map(np.asarray, _steps(tx, variables, grads_list)))
    cfg = LazyConfig.load(CONFIG)
    cfg.optimizer.update(params=model, base_lr=1e-2, num_layers=3)
    opt = instantiate(cfg.optimizer)
    assert isinstance(opt, AdamWGroupClip) and [g["lr_factor"] for g in opt.param_groups] == groups
    named = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    for grads in grads_list:
        for k, g in convert_jax_params(jax.tree_util.tree_map(np.asarray, grads)).items():
            named[k].grad = g.clone()
        opt.step()
    errs = {k: np.abs(n(p) - n(ref[k])).max() for k, p in named.items()}
    assert max(errs.values()) <= 1e-6, max(errs.items(), key=lambda kv: kv[1])
    assert all((p - before[k]).abs().max() > 1e-6 for k, p in named.items())


def test_the_configs_make_optimizer_runs_every_group_at_base_lr(tiny):
    """A fault of the JAX reference, which the port does not copy: the
    config's lambdas ``lambda s: base_lr * g`` bind ``g`` late, so every
    group steps at ``base_lr`` times the largest factor (1), and the
    layer-wise decay is lost. The port gives group g ``base_lr * g``."""
    _, _, variables = tiny
    make_optimizer = JaxLazyConfig.load(CONFIG).optimizer._target_
    grads_list = _seeded_grads(variables)
    got = _steps(make_optimizer(variables, base_lr=1e-2, num_layers=3), variables, grads_list)
    tx, groups = _optax_layerwise(variables, 1e-2, num_layers=3)
    flat, intended = (_steps(t, variables, grads_list) for t in (
        _optax_layerwise(variables, 1e-2, lrs={g: 1e-2 for g in groups}, num_layers=3)[0], tx))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(flat)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    diff = max(float(jnp.abs(a - b).max()) for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(intended)))
    assert diff > 1e-3


def test_lr_follows_the_configs_multiplier_through_warmup_and_steps():
    cfg = LazyConfig.load(CONFIG)
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))
    opt = torch.optim.AdamW([{"params": [model[0].weight], "lr": 1e-4}, {"params": [model[0].bias], "lr": 0.5e-4}])
    sched = instantiate(cfg.lr_multiplier).bind(opt)
    ref = jax_instantiate(JaxLazyConfig.load(CONFIG).lr_multiplier)
    assert isinstance(ref, JaxLRMultiplier)
    for it in (0, 1, 125, 249, 250, 251, 163888, 163889, 177545, 177546, 184374):
        sched.last_epoch = it - 1
        sched.step()
        want = ref(it)
        assert math.isclose(opt.param_groups[0]["lr"], want, rel_tol=1e-9), (it, opt.param_groups[0]["lr"], want)
        assert math.isclose(opt.param_groups[1]["lr"], want / 2, rel_tol=1e-9), it
    assert math.isclose(ref(0), 1e-7) and math.isclose(ref(170000), 1e-5) and math.isclose(ref(180000), 1e-6)


_TOOL_RUN = textwrap.dedent(
    """
    import gc, json, os, sys, weakref
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "detectron2_tpu"):
                raise ImportError(f"blocked: {name}")
    sys.meta_path.insert(0, _Block())
    import torch
    torch.set_num_threads(2)
    from detectron2_tpu_torch.testing import write_synthetic_coco
    from detectron2_tpu_torch.tools import lazyconfig_train_net as tool
    from detectron2_tpu_torch.utils.events import CommonMetricPrinter, JSONWriter

    # the tensorboard writer would import TensorFlow
    tool.default_writers = lambda out, max_iter: [CommonMetricPrinter(max_iter), JSONWriter(os.path.join(out, "metrics.json"))]
    work = sys.argv[1]
    json_file, root = write_synthetic_coco(work, 6, seed=0, sizes=((100, 130), (120, 90)), max_objects=4)
    S = 128
    opts = [
        "train.device=cpu", "train.seed=0", "model.compute_dtype=float32", "model.backbone.net.embed_dim=32",
        "model.backbone.net.depth=3", "model.backbone.net.num_heads=2", f"model.backbone.net.img_size={S}",
        "model.backbone.net.window_size=4", "model.backbone.net.window_block_indexes=(0,2)",
        "dataloader.train.dataset.names=syn", "dataloader.test.dataset.names=syn", "dataloader.evaluator.dataset_name=syn",
        f"dataloader.train.mapper.augmentations.1.target_height={S}", f"dataloader.train.mapper.augmentations.1.target_width={S}",
        f"dataloader.train.mapper.augmentations.2.crop_size=({S},{S})",
        f"dataloader.test.mapper.augmentations.0.short_edge_length={S}", f"dataloader.test.mapper.augmentations.0.max_size={S}",
        "dataloader.train.total_batch_size=2", "train.checkpointer.period=2", "train.eval_period=0",
        f"train.output_dir={work}/out", "train.log_period=1", "model.roi_heads.box_predictor.test_score_thresh=0.0",
        "model.proposal_generator.pre_nms_topk_train=200", "model.proposal_generator.post_nms_topk_train=50",
        "model.proposal_generator.pre_nms_topk_test=200", "model.proposal_generator.post_nms_topk_test=50",
        "model.roi_heads.batch_size_per_image=32",
    ]
    cfg_file = "configs/ViTDet/mask_rcnn_vitdet_b_100ep.py"
    parse = tool.argument_parser().parse_args
    trainer = tool.main(parse(["--config-file", cfg_file, "--dataset", "syn", json_file, root] + opts + ["train.max_iter=4"]))
    gc.disable()  # the trainer is dropped below: freed by reference counting alone
    first = {"iters": [i for _, i in trainer.storage.history("total_loss").values()],
             "losses": [v for v, _ in trainer.storage.history("total_loss").values()],
             "optimizer": type(trainer.optimizer).__name__, "groups": len(trainer.optimizer.param_groups),
             "device": str(trainer.model.device)}
    refs = [weakref.ref(trainer.model), weakref.ref(next(trainer.model.parameters())), weakref.ref(trainer.optimizer)]
    del trainer
    first_freed = all(r() is None for r in refs)
    gc.enable()
    second = tool.main(parse(["--config-file", cfg_file, "--resume"] + opts + ["train.max_iter=6"]))
    final = torch.load(f"{work}/out/model_final.pth", weights_only=False)
    evaluated = tool.main(parse(["--config-file", cfg_file, "--eval-only"] + opts + [f"train.init_checkpoint={work}/out/model_final.pth"]))
    json.dump({
        "first_iters": first["iters"],
        "second_iters": [i for _, i in second.storage.history("total_loss").values()],
        "losses": first["losses"] + [v for v, _ in second.storage.history("total_loss").values()],
        "files": sorted(os.listdir(f"{work}/out")),
        "final_iteration": final["iteration"],
        "optimizer": first["optimizer"],
        "groups": first["groups"],
        "device": first["device"],
        "first_freed": first_freed,
        "eval": {t: sorted(r) for t, r in evaluated.items()},
        "eval_after_train": sorted(k for k in second.storage.latest() if k.endswith("/AP")),
    }, open(f"{work}/result.json", "w"))
    """
)


def test_lazyconfig_train_net_trains_resumes_and_evaluates_without_jax(tmp_path):
    """The tool on the CPU (``train.device=cpu``) in a process where jax and
    the JAX package cannot be imported: four steps of the zoo config (cut
    to a tiny width) with checkpoints every 2, ``--resume`` to step 6, then
    ``--eval-only`` from the final checkpoint. The first run's trainer,
    dropped with ``gc`` disabled, frees its model, parameters and optimizer
    (ROADMAP C: its checkpointer held it)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", _TOOL_RUN, str(tmp_path)], check=True, env=env, cwd=ROOT, timeout=600)
    r = json.loads((tmp_path / "result.json").read_text())
    assert r["first_iters"] == [0, 1, 2, 3] and r["second_iters"] == [4, 5]
    assert all(math.isfinite(v) for v in r["losses"])
    assert {"model_0000001.pth", "model_0000003.pth", "model_0000005.pth", "model_final.pth", "last_checkpoint",
            "metrics.json", "config.yaml"} <= set(r["files"])
    assert r["final_iteration"] == 5
    assert (r["optimizer"], r["groups"], r["device"]) == ("AdamWGroupClip", 5, "cpu")
    assert r["first_freed"]  # the first run's trainer: its model, a parameter, its optimizer
    assert set(r["eval"]) == {"bbox", "segm"} and "AP" in r["eval"]["bbox"]
    assert r["eval_after_train"] == ["bbox/AP", "segm/AP"]
