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


def _param_shapes(model, image_hw=(64, 64)):
    batch = {
        "image": jnp.zeros((1,) + tuple(image_hw) + (3,), jnp.float32),
        "image_sizes": jnp.asarray([list(image_hw)], jnp.int32),
    }
    rngs = {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: model.init(rngs, batch, train=False))


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


def jax_random_variables(model, seed=0, scale=0.1):
    """Seeded random JAX variables; FrozenBN variances kept positive."""
    from detectron2_tpu.checkpoint.d2_converter import _path_entry_str

    shapes = _param_shapes(model)
    rng = np.random.RandomState(seed)

    def leaf(path, sds):
        v = rng.standard_normal(sds.shape).astype(np.float32) * scale
        if _path_entry_str(path[-1]) == "running_var":
            v = np.abs(v) + 0.5
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
