"""Shared helpers of the tests/test_torch_*.py files: mirror a port config
into the JAX package's config, build JAX variables from d2 or seeded random
weights, and move arrays between the two frameworks as numpy."""

import os
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# keys of the port config that the JAX config spells differently or lacks
_PORT_ONLY = ("MODEL.DEVICE",)


def load_golden(name):
    return np.load(os.path.join(GOLDENS, name + ".npz"))


def leaf_items(node, prefix=""):
    """(dotted key, value) of every leaf of a CfgNode."""
    for k, v in node.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaf_items(v, key + ".")
        else:
            yield key, v


def jax_cfg_from_port(port_cfg):
    """The JAX package's config with every key of ``port_cfg`` copied over."""
    from detectron2_tpu.config import get_cfg

    cfg = get_cfg()
    for key, value in leaf_items(port_cfg):
        if key in _PORT_ONLY:
            continue
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        assert leaf in node, key
        node[leaf] = value
    return cfg


def jax_model(port_cfg):
    from detectron2_tpu.modeling import build_model

    return build_model(jax_cfg_from_port(port_cfg))


def _param_shapes(model, image_hw=(64, 64), train_batch=None):
    """The variables' shapes, from an eval init or, given ``train_batch``, a
    training one (which also makes a dense detector's ``meters``)."""
    batch = {
        "image": jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32),
        "image_sizes": jnp.asarray([list(image_hw)], jnp.int32),
    }
    train = train_batch is not None
    if train:
        batch = {k: jnp.asarray(v) for k, v in train_batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: model.init(rngs, batch, train=train))


def jax_variables_from_d2(model, state_dict):
    """JAX variables for ``model`` from a d2 state dict, through the JAX
    package's own name mapping and layout rules."""
    from detectron2_tpu.checkpoint.d2_converter import (
        _path_entry_str,
        _to_flax_layout,
        flax_path_to_d2_name,
    )

    shapes = _param_shapes(model)

    def leaf(path, sds):
        keys = tuple(_path_entry_str(p) for p in path)
        name = flax_path_to_d2_name(tuple(k for k in keys if k not in ("params", "batch_stats")))
        deconv = any(k.startswith("ConvTranspose") for k in keys)
        return jnp.asarray(_to_flax_layout(state_dict[name], sds.shape, conv_transpose=deconv).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_random_variables(model, seed=0, scale=0.1, train_batch=None):
    """Seeded random JAX variables; FrozenBN and BN variances kept positive
    and a dense detector's ``loss_normalizer`` at its initial 100. With
    ``train_batch`` the shapes come from a training init."""
    from detectron2_tpu.checkpoint.d2_converter import _path_entry_str

    shapes = _param_shapes(model, train_batch=train_batch)
    rng = np.random.RandomState(seed)

    def leaf(path, sds):
        v = rng.standard_normal(sds.shape).astype(np.float32) * scale
        name = _path_entry_str(path[-1])
        if name == "running_var" or (name == "var" and _path_entry_str(path[0]) == "batch_stats"):
            v = np.abs(v) + 0.5
        elif name == "loss_normalizer":
            v = np.full(sds.shape, 100.0, np.float32)
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_model(port_cfg, jax_variables):
    """The port's model on the CPU with weights carried across from JAX."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params, load_state_dict_report
    from detectron2_tpu_torch.modeling import build_model

    model = build_model(port_cfg, device="cpu")
    report = load_state_dict_report(model, convert_jax_params(jax.tree_util.tree_map(np.asarray, jax_variables)))
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."], report
    return model


class SameDraws:
    """Seeded uniform draws by row length N, handed to both packages'
    samplers: :meth:`patch` makes the port's ``sampling.uniform_draws``
    return them (the same row for every image) and gives the JAX package's
    ``modeling/sampling.py`` a ``jax`` whose ``random.uniform`` returns them,
    so each package runs its own sampler on identical draws. The JAX sampler
    runs once per image under ``vmap``, hence one row for all images."""

    def __init__(self, seed: int):
        self._rng = np.random.RandomState(seed)
        self._draws = {}

    def __call__(self, N: int):
        if N not in self._draws:
            self._draws[N] = (self._rng.rand(N).astype(np.float32), self._rng.rand(N).astype(np.float32))
        return self._draws[N]

    def port_uniform_draws(self, shape, generator, device):
        B, N = shape
        return tuple(torch.from_numpy(np.tile(r, (B, 1))).to(device) for r in self(N))

    def jax_module(self):
        random = types.SimpleNamespace(
            split=lambda key: (0, 1), uniform=lambda k, shape: jnp.asarray(self(shape[0])[k])
        )
        return types.SimpleNamespace(random=random, lax=jax.lax)

    def patch(self, monkeypatch) -> None:
        import detectron2_tpu.modeling.sampling as jax_sampling
        from detectron2_tpu_torch.modeling import sampling

        monkeypatch.setattr(sampling, "uniform_draws", self.port_uniform_draws)
        monkeypatch.setattr(jax_sampling, "jax", self.jax_module())


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_losses_and_grads(port_cfg, jax_variables, batch, seed=0):
    """The JAX model's training losses and their gradients (as the port's
    state-dict names) on ``batch``, jitted ``value_and_grad`` of
    ``apply(train=True)``; the samplers draw from ``PRNGKey(seed)`` (or
    from a :class:`SameDraws` patch)."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    jm = jax_model(port_cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(seed)

    def loss_fn(params):
        losses = jm.apply(params, jbatch, train=True, rngs={"sampling": key})
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax_variables)
    return {k: float(v) for k, v in losses.items()}, convert_jax_params(jax.tree_util.tree_map(np.asarray, grads))


def assert_train_step_matches(model, batch, ref_losses, ref_grads, loss_rtol=1e-4, grad_rtol=1e-3):
    """The port's losses on ``batch`` within ``loss_rtol`` of the JAX ones,
    and every parameter's gradient within ``grad_rtol * max|g_ref| + 1e-6``
    (frozen parameters: no gradient on either side). Returns the losses."""
    import math

    losses = model(batch, train=True)
    assert set(losses) == set(ref_losses), (sorted(losses), sorted(ref_losses))
    for k, v in ref_losses.items():
        assert math.isclose(losses[k].item(), v, rel_tol=loss_rtol), (k, losses[k].item(), v)
    sum(losses.values()).backward()
    trainable = 0
    for name, p in model.named_parameters():
        ref = n(ref_grads[name])
        if not p.requires_grad:
            assert p.grad is None and not ref.any(), name
            continue
        trainable += 1
        err = np.abs(n(p.grad) - ref).max()
        assert err <= grad_rtol * np.abs(ref).max() + 1e-6, (name, err, np.abs(ref).max())
    assert trainable > 0
    return {k: v.item() for k, v in losses.items()}


def assert_dense_golden_detections(inst, golden, max_count_diff, min_taken):
    """A dense detector's postprocessed detections against a golden's, by
    the JAX golden tests' set matching (``tests/parity/test_e2e_retinanet_
    golden.py``): each reference detection needs one of ours of its class
    with the score within 1e-3 relative + 1e-4 and the box within 0.05, and
    one that finds none is forgiven only when an unmatched detection of ours
    ties its score to 2e-3 (random deep weights leave clusters of anchors
    whose NMS survivors are float32 ordering noise)."""
    scores, boxes, classes = n(inst.scores), n(inst.pred_boxes.tensor), n(inst.pred_classes)
    assert abs(len(scores) - len(golden["out_scores"])) <= max_count_diff, (len(scores), len(golden["out_scores"]))
    taken = np.zeros(len(scores), bool)
    unmatched = []
    for rs, rc, rbx in zip(golden["out_scores"], golden["out_classes"], golden["out_boxes"]):
        cand = (
            (classes == rc)
            & ~taken
            & (np.abs(scores - rs) < 1e-3 * abs(rs) + 1e-4)
            & (np.abs(boxes - rbx).max(axis=1) < 0.05)
        )
        idx = np.where(cand)[0]
        if len(idx) == 0:
            unmatched.append((rs, rc, rbx))
            continue
        taken[idx[0]] = True
    extras = scores[~taken]
    hard = [u for u in unmatched if not (len(extras) and np.abs(extras - u[0]).min() < 2e-3)]
    assert not hard, hard
    assert taken.sum() >= min_taken, taken.sum()
