"""Training with norms that keep batch statistics, against the JAX package,
in float32 on the CPU: a tiny R18-FPN Mask R-CNN (``test_torch_train_step``'s
model, batch with its one padded gt slot, and ``SameDraws``) with
``norm="SyncBN"`` in the backbone, the FPN, the 2-conv box head and the mask
head, its weights and running statistics carried across by
``convert_jax_params``.

- Every leaf of the JAX ``params`` and ``batch_stats`` collections lands on a
  port parameter or buffer (none left at its initial value).
- The losses and every gradient at the initial weights; the parameters and
  every running statistic after two steps of the port's ``SimpleTrainer``
  against two of the JAX ``make_train_step``; the eval forward (running
  statistics) from the carried-across ``batch_stats``. A BN's backward
  subtracts the cotangent's per-channel mean and its projection on the
  normalized input, and in this tiny model (res5 normalizes 8 values a
  channel) that cancellation makes the float32 gradient ill-conditioned:
  the JAX package's own float32 gradients are up to ~1% of their max off
  its float64 ones. So gradients, parameters and statistics are held to
  the JAX model run in float64 (``TPU.COMPUTE_DTYPE = "float64"`` under
  x64), no further from it than four times the JAX float32 run is, plus
  a margin. The box head's
  statistics cover every sampled slot and the mask head's every slot of the
  foreground budget, padding included, on both sides (ROADMAP C).
- Frozen stages (``FREEZE_AT = 2``): their parameters stay, their BNs still
  normalize with batch statistics and update the running ones, as under the
  JAX package's ``stop_gradient`` (ROADMAP C).
- ``PreciseBN`` writes the mean over the batches of each BN's batch
  statistics; the JAX hook writes ``0.9 * old + 0.1 * mean`` (ROADMAP C).
- The optimizer's norm groups: BN, GN and LN parameters take
  ``weight_decay_norm``; ``DefaultTrainer.build_hooks`` adds ``PreciseBN``
  only with ``TEST.PRECISE_BN.ENABLED`` and a BN in the model.

Tolerances: losses rtol 1e-4 (against the JAX float32 run); each gradient,
parameter after two steps and running statistic: max|port - ref64| <= 4 *
max|jax32 - ref64| + margin, the margin 1e-4 * max|g64| + 1e-7 for a
gradient, 1e-3 * max|p64 - p0| + 1e-6 for a parameter (as
``test_torch_train_step``), 1e-4 * max|ref| + 1e-6 for a statistic; the
statistics of frozen stages and PreciseBN's (forward only) <= 1e-4 * max|ref|
+ 1e-6 of the float32 run; eval scores rtol 1e-4, atol 1e-5, boxes atol 1e-3
px.
"""

import multiprocessing
import types
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import SameDraws, _param_shapes, jax_cfg_from_port, jax_inference, jax_model, n, port_model
from test_torch_train_step import make_batch, tiny_cfg

from jax._src.config import enable_x64  # a scoped switch; the flag is global otherwise

from detectron2_tpu.checkpoint.d2_converter import _path_entry_str
from detectron2_tpu.engine.hooks import PreciseBN as JaxPreciseBN
from detectron2_tpu.parallel import TrainState, make_train_step
from detectron2_tpu.solver import build_optimizer as jax_build_optimizer
from detectron2_tpu_torch.checkpoint import convert_jax_params
from detectron2_tpu_torch.engine import SimpleTrainer, hooks
from detectron2_tpu_torch.layers import BatchNorm2d, FrozenBatchNorm2d, GroupNorm, LayerNorm, get_bn_modules
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer, get_default_optimizer_params

torch.set_num_threads(1)

STATS = ("running_mean", "running_var")


def bn_cfg(freeze_at=0):
    cfg = tiny_cfg()
    m = cfg.MODEL
    m.BACKBONE.FREEZE_AT = freeze_at
    m.RESNETS.NORM = m.FPN.NORM = m.ROI_BOX_HEAD.NORM = m.ROI_MASK_HEAD.NORM = "SyncBN"
    m.ROI_BOX_HEAD.NUM_CONV, m.ROI_BOX_HEAD.CONV_DIM, m.ROI_BOX_HEAD.NUM_FC = 2, 32, 1
    return cfg


def bn_variables(jm, seed=5):
    """Seeded JAX variables: weights normal * 0.1, BN scales 1 + normal * 0.1,
    running means normal * 0.1, running variances |normal| * 0.1 + 0.5."""
    rng = np.random.RandomState(seed)

    def leaf(path, sds):
        keys = [_path_entry_str(p) for p in path]
        v = rng.standard_normal(sds.shape).astype(np.float32) * 0.1
        if keys[-1] == "var":
            v = np.abs(v) + 0.5
        elif keys[-1] == "scale" and any(k.startswith("BatchNorm") for k in keys):
            v = v + 1.0
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(leaf, _param_shapes(jm))


def as_port(tree):
    """JAX arrays -> port tensors (float64 ones stay float64)."""
    return convert_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def eval_batch():
    b = make_batch()
    return {"image": b["image"], "image_sizes": b["image_sizes"]}


def stats_close(out, ref, name):
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-6, (name, err)


def near_f64(port, ref32, ref64, margin, name):
    """``port`` no further from the float64 reference than four times the
    JAX float32 run is, plus ``margin`` (two float32 runs of an
    ill-conditioned computation round differently: measured up to 3.2x)."""
    ref64 = ref64.double()
    err = (port.double() - ref64).abs().max().item()
    jax_err = (ref32.double() - ref64).abs().max().item()
    assert err <= 4 * jax_err + margin, (name, err, jax_err, margin)


@pytest.fixture(scope="module")
def draws():
    with pytest.MonkeyPatch.context() as mp:
        same = SameDraws(seed=9)
        same.patch(mp)
        yield same


def _frozen_step():
    """One JAX ``make_train_step`` step of the ``FREEZE_AT = 2`` model from
    its seeded variables: (variables, params after the step)."""
    cfg = bn_cfg(freeze_at=2)
    jm = jax_model(cfg)
    variables = bn_variables(jm, seed=6)
    state = TrainState.create(variables, jax_build_optimizer(jax_cfg_from_port(cfg), variables))
    state, _ = make_train_step(jm, donate=False)(state, {k: jnp.asarray(v) for k, v in make_batch().items()},
                                                 jax.random.PRNGKey(0))
    return variables, state.params


def _precise_bn_reference(jm, variables, batches):
    """The JAX BN's batch statistics of each of ``batches`` from one
    ``mutable`` apply each, and what the JAX ``PreciseBN`` hook writes over
    them (on a stand-in trainer holding ``variables``)."""
    stats_step = jax.jit(lambda v, b: jm.apply(v, b, train=True, rngs={"sampling": jax.random.PRNGKey(0)},
                                               mutable=["batch_stats"])[1])
    per_batch = [stats_step(variables, {k: jnp.asarray(v) for k, v in b.items()}) for b in batches]
    jax_hook = JaxPreciseBN(period=0, model=jm, data_loader=[{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                            num_iter=len(batches))
    holder = types.SimpleNamespace(state=TrainState(step=jnp.zeros((), jnp.int32), params=variables, opt_state=None, tx=None))
    holder._trainer = holder
    jax_hook.trainer = holder
    jax_hook.update_stats()
    return per_batch, holder.state.params


def precise_bn_batches():
    return [make_batch()] + [
        dict(make_batch(), image=np.random.RandomState(s).randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)) for s in (1, 2)
    ]


def _grads_of(jm, variables, batch, key):
    def loss_fn(params):
        losses, _ = jm.apply(params, batch, train=True, rngs={"sampling": key}, mutable=["batch_stats"])
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    return losses, {"params": grads["params"]}


def _two_steps(cfg, jm, variables, batch, key):
    state = TrainState.create(variables, jax_build_optimizer(jax_cfg_from_port(cfg), variables))
    step = make_train_step(jm, donate=False)
    for i in range(2):
        state, _ = step(state, batch, jax.random.fold_in(key, i))
    return state.params


def _jax_job(job: str):
    """One of ``jax_run``'s JAX runs, alone in its process, with the samplers
    on ``SameDraws(9)``: its results as numpy, and the draws it made."""
    with pytest.MonkeyPatch.context() as mp:
        same = SameDraws(seed=9)
        same.patch(mp)
        if job == "frozen":
            out = _frozen_step()
        else:
            cfg = bn_cfg()
            jm = jax_model(cfg)
            variables = bn_variables(jm)
            batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
            key = jax.random.PRNGKey(0)
            if job == "grads":
                out = _grads_of(jm, variables, batch, key)
            elif job == "steps":
                params2 = _two_steps(cfg, jm, variables, batch, key)
                out = params2, jax_inference(jm, params2, eval_batch())  # jitted: op by op it takes several times as long
            elif job == "precise_bn":
                out = _precise_bn_reference(jm, variables, precise_bn_batches())
            else:  # float64, under x64
                cfg64 = cfg.clone()
                cfg64.TPU.COMPUTE_DTYPE = "float64"
                jm64 = jax_model(cfg64)
                with enable_x64(True):
                    v64 = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), variables)
                    out = _grads_of(jm64, v64, batch, key) if job == "grads64" else _two_steps(cfg, jm64, v64, batch, key)
        return jax.tree_util.tree_map(np.asarray, out), same.made()


@pytest.fixture(scope="module")
def jax_run(draws):
    """The JAX side: losses and gradients at the initial weights, the state
    after two ``make_train_step`` steps, and the eval forward from it, in
    float32 and (but the eval) float64; the frozen-stage model's step and
    the PreciseBN references. The runs are independent, and each runs alone
    in a process of its own (tracing holds the GIL, so threads would trace
    by turns) and computes what it would in this one. They all draw the same
    row lengths in the same order, so their draws agree; the port's samplers
    get those draws."""
    cfg = bn_cfg()
    jm = jax_model(cfg)
    jobs = ("grads", "steps", "grads64", "steps64", "frozen", "precise_bn")
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {job: pool.submit(_jax_job, job) for job in jobs}
        variables = bn_variables(jm)
        done = {job: f.result() for job, f in futures.items()}
    made = [d for _, d in done.values()]
    assert all(d.keys() == made[0].keys() and all(np.array_equal(d[k][i], made[0][k][i]) for k in d for i in (0, 1))
               for d in made), "the JAX runs drew differently"
    draws.load(made[0])
    done = {job: out for job, (out, _) in done.items()}
    (losses, grads), (params2, out) = done["grads"], done["steps"]
    per_batch, jax_written = done["precise_bn"]
    return {
        "cfg": cfg,
        "jm": jm,
        "variables": variables,
        "losses": {k: float(v) for k, v in losses.items()},
        "grads": as_port(grads),
        "grads64": as_port(done["grads64"][1]),
        "state0": as_port(variables),
        "state2": as_port(params2),
        "state2_64": as_port(done["steps64"]),
        "params2": params2,
        "eval": out,
        "frozen": done["frozen"],
        "precise_bn": ([as_port(b) for b in per_batch], as_port(jax_written)),
    }


def test_every_jax_leaf_lands_on_the_port_model(jax_run):
    """``params`` and ``batch_stats`` (the nested ``norm/BatchNorm_0`` scope
    of the JAX ``SyncBatchNorm``) name every port tensor once."""
    model = port_model(jax_run["cfg"], jax_run["variables"])  # asserts every tensor loaded
    state = model.state_dict()
    assert set(jax_run["state0"]) == set(state)
    bns = [name for name, m in model.named_modules() if isinstance(m, BatchNorm2d)]
    prefixes = ("backbone.bottom_up.stem", "backbone.bottom_up.res5", "backbone.fpn_output2", "roi_heads.box_head.conv2",
                "roi_heads.mask_head.mask_fcn2")
    assert all(any(b.startswith(p) for b in bns) for p in prefixes), bns
    fresh = build_model(jax_run["cfg"], device="cpu").state_dict()
    for name in bns:
        for k in STATS:
            assert not torch.equal(state[f"{name}.{k}"], fresh[f"{name}.{k}"]), f"{name}.{k} left at its initial value"
    n_stats = sum(len(jax.tree_util.tree_leaves(v)) for v in [jax_run["variables"]["batch_stats"]])
    assert n_stats == 2 * len(bns) and not any(isinstance(m, FrozenBatchNorm2d) for m in model.modules())


def test_losses_and_gradients_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    losses = model(make_batch(), train=True)
    assert set(losses) == set(jax_run["losses"])
    for k, v in jax_run["losses"].items():
        assert losses[k].item() == pytest.approx(v, rel=1e-4), k
    sum(losses.values()).backward()
    g32, g64 = jax_run["grads"], jax_run["grads64"]
    for name, p in model.named_parameters():
        near_f64(p.grad, g32[name], g64[name], 1e-4 * g64[name].abs().max().item() + 1e-7, name)


def test_two_steps_parameters_and_running_statistics_match_make_train_step(jax_run):
    """Parameters and every running statistic after two steps. The box
    head's BN sees all B * 64 sampled slots and the mask head's all B * 16
    foreground-budget slots, of which fewer are real (padding included, as
    in the JAX package)."""
    cfg = jax_run["cfg"]
    model = port_model(cfg, jax_run["variables"])
    seen = {}

    def rows(name):
        def hook(module, args):
            seen.setdefault(name, args[0].shape[0])

        return hook

    model.roi_heads.box_head.conv1.norm.register_forward_pre_hook(rows("box"))
    model.roi_heads.mask_head.mask_fcn1.norm.register_forward_pre_hook(rows("mask"))
    optimizer = build_optimizer(cfg, model)
    trainer = SimpleTrainer(model, [make_batch()] * 2, optimizer)
    trainer.register_hooks([hooks.LRScheduler(optimizer, build_lr_scheduler(cfg, optimizer))])
    trainer.train(0, 2)
    B, budget = 2, model.roi_heads.fg_budget
    assert seen == {"box": B * cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE, "mask": B * budget}
    p0, p2, p64 = jax_run["state0"], jax_run["state2"], jax_run["state2_64"]
    for name, p in model.named_parameters():
        moved = (p64[name] - p0[name].double()).abs().max().item()
        assert moved > 0, name
        near_f64(p.detach(), p2[name], p64[name], 1e-3 * moved + 1e-6, name)
    bn_buffers = [k for k in model.state_dict() if k.endswith(STATS)]
    assert len(bn_buffers) == 2 * len(get_bn_modules(model)) > 40
    for k in bn_buffers:
        buf = model.state_dict()[k]
        assert not torch.equal(buf, p0[k]), k
        near_f64(buf, p2[k], p64[k], 1e-4 * p64[k].abs().max().item() + 1e-6, k)


def test_eval_forward_from_the_carried_across_batch_stats_matches_jax(jax_run):
    model = port_model(jax_run["cfg"], jax.tree_util.tree_map(np.asarray, jax_run["params2"]))
    out, ref = model(eval_batch()), jax_run["eval"]
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)


def test_frozen_stages_keep_their_parameters_and_update_their_statistics(jax_run):
    """``FREEZE_AT = 2``: one step. The stem's and res2's parameters do not
    move on the port (the JAX optimizer still decays them: ROADMAP C), and
    their BNs' running statistics move as the JAX package's do."""
    cfg = bn_cfg(freeze_at=2)
    variables, params = jax_run["frozen"]
    ref, p0 = as_port(params), as_port(variables)
    model = port_model(cfg, variables)
    optimizer = build_optimizer(cfg, model)
    SimpleTrainer(model, [make_batch()], optimizer).train(0, 1)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(k.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")) for k in frozen)
    params = dict(model.named_parameters())
    for k in frozen:
        assert torch.equal(params[k], p0[k]), k
    frozen_stats = [k for k in model.state_dict() if k.endswith(STATS) and k.startswith(
        ("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))]
    assert len(frozen_stats) == 2 * (1 + 4)
    for k in frozen_stats:
        buf = model.state_dict()[k]
        assert not torch.equal(buf, p0[k]), k
        stats_close(buf, ref[k], k)


def test_precise_bn_is_the_mean_of_the_batch_statistics(jax_run):
    """Three batches. The JAX BN's own batch statistics of batch i are
    ``(s_i - 0.9 * old) / 0.1`` from one ``mutable`` apply; the port's
    PreciseBN equals their mean, and the JAX hook's result is
    ``0.9 * old + 0.1 * mean``: they differ by ``0.9 * (old - mean)``."""
    variables = jax_run["variables"]
    batches = precise_bn_batches()
    old = as_port(variables)
    # the JAX hook ran on a stand-in trainer holding the same variables (the fixture)
    per_batch, jax_written = jax_run["precise_bn"]
    names = [k for k in per_batch[0] if k.endswith(STATS)]
    mean = {k: sum((s[k] - 0.9 * old[k]) / 0.1 for s in per_batch) / len(batches) for k in names}

    model = port_model(jax_run["cfg"], variables)
    hook = hooks.PreciseBN(period=0, model=model, data_loader=iter(batches), num_iter=len(batches))
    hook.trainer = types.SimpleNamespace(iter=4, max_iter=5)
    hook.after_step()  # the last step: the hook runs
    state = model.state_dict()
    assert all(bn.momentum == 0.9 for bn in get_bn_modules(model))
    gaps = []
    for k in names:
        stats_close(state[k], mean[k], k)
        stats_close(jax_written[k], 0.9 * old[k] + 0.1 * mean[k], k)
        stats_close(jax_written[k] - state[k], 0.9 * (old[k] - mean[k]), k)
        gaps.append((jax_written[k] - state[k]).abs().max().item())
    assert min(gaps) > 1e-3  # the two hooks write different numbers


def test_precise_bn_disables_itself_without_batch_statistics(caplog):
    model = build_model(tiny_cfg(), device="cpu")  # FrozenBN
    with caplog.at_level("INFO"):
        hook = hooks.PreciseBN(period=1, model=model, data_loader=[], num_iter=3)
    assert "PreciseBN is disabled" in caplog.text
    hook.trainer = types.SimpleNamespace(iter=0, max_iter=1)
    hook.after_step()  # nothing to run, no batch drawn


def test_default_trainer_adds_precise_bn_only_when_enabled_with_a_bn(tmp_path, monkeypatch):
    """Between LRScheduler and PeriodicCheckpointer, as d2's build_hooks."""
    from detectron2_tpu_torch.engine import DefaultTrainer

    monkeypatch.setattr(DefaultTrainer, "build_train_loader", classmethod(lambda cls, cfg: iter([make_batch()] * 8)))
    monkeypatch.setattr(DefaultTrainer, "build_writers", lambda self: [])
    kinds = {}
    for name, (norm, enabled) in {"syncbn": ("SyncBN", True), "off": ("SyncBN", False), "frozen": ("FrozenBN", True)}.items():
        cfg = bn_cfg()
        cfg.MODEL.DEVICE = "cpu"
        cfg.MODEL.RESNETS.NORM = norm
        cfg.MODEL.FPN.NORM = cfg.MODEL.ROI_BOX_HEAD.NORM = cfg.MODEL.ROI_MASK_HEAD.NORM = "" if norm == "FrozenBN" else norm
        cfg.TEST.PRECISE_BN.ENABLED = enabled
        cfg.OUTPUT_DIR = str(tmp_path / name)
        kinds[name] = [type(h).__name__ for h in DefaultTrainer(cfg)._hooks]
    assert kinds["syncbn"] == ["IterationTimer", "LRScheduler", "PreciseBN", "PeriodicCheckpointer", "EvalHook", "PeriodicWriter"]
    assert kinds["off"] == kinds["frozen"] == ["IterationTimer", "LRScheduler", "PeriodicCheckpointer", "EvalHook", "PeriodicWriter"]


@pytest.mark.parametrize("norm", ["SyncBN", "BN", "GN", "LN"])
def test_norm_parameters_take_weight_decay_norm(norm):
    """d2's groups (``configs/common/optim.py``: ``weight_decay_norm = 0``):
    every norm's weight and bias lands in the undecayed group, as the JAX
    package labels every parameter under a ``...Norm`` scope."""
    cfg = bn_cfg()
    cfg.MODEL.RESNETS.NORM = "GN" if norm == "LN" else norm
    cfg.MODEL.FPN.NORM = cfg.MODEL.ROI_BOX_HEAD.NORM = cfg.MODEL.ROI_MASK_HEAD.NORM = norm
    model = build_model(cfg, device="cpu")
    groups = get_default_optimizer_params(model, 0.1, 4e-5, 0.0, 1.0, None)
    decay = {id(p): g["weight_decay"] for g in groups for p in g["params"]}
    types_ = (BatchNorm2d, GroupNorm, LayerNorm)
    norm_params = [p for m in model.modules() if isinstance(m, types_) for p in m.parameters(recurse=False)]
    assert len(norm_params) > 20
    assert all(decay[id(p)] == 0.0 for p in norm_params)
    others = [p for m in model.modules() if not isinstance(m, types_) for p in m.parameters(recurse=False)]
    assert all(decay[id(p)] == 4e-5 for p in others)
