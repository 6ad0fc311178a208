"""Shared helpers of the tests/test_torch_*.py files: mirror a port config
into the JAX package's config, build JAX variables from d2 or seeded random
weights, and move arrays between the two frameworks as numpy."""

import os
import threading
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# keys of the port config that the JAX config spells differently or lacks
_PORT_ONLY = ("MODEL.DEVICE", "BOOTSTRAP_MODEL.DEVICE")


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
    """The JAX package's config with every key of ``port_cfg`` copied over
    (a project's keys added first: DensePose, PointRend, PointSup, DeepLab,
    Panoptic-DeepLab, TridentNet, TensorMask)."""
    from detectron2_tpu.config import get_cfg

    cfg = get_cfg()
    if "ROI_DENSEPOSE_HEAD" in port_cfg.MODEL:
        from detectron2_tpu.projects.densepose import add_densepose_config

        add_densepose_config(cfg)
    if "POINT_HEAD" in port_cfg.MODEL:
        from detectron2_tpu.projects.point_rend import add_pointrend_config

        add_pointrend_config(cfg)
    if "POINT_SUP" in port_cfg.INPUT:
        from detectron2_tpu.projects.point_sup import add_point_sup_config

        add_point_sup_config(cfg)
    if "INS_EMBED_HEAD" in port_cfg.MODEL:
        from detectron2_tpu.projects.panoptic_deeplab import add_panoptic_deeplab_config

        add_panoptic_deeplab_config(cfg)
    elif "RES5_MULTI_GRID" in port_cfg.MODEL.RESNETS:
        from detectron2_tpu.projects.deeplab import add_deeplab_config

        add_deeplab_config(cfg)
    if "TRIDENT" in port_cfg.MODEL:
        from detectron2_tpu.projects.tridentnet import add_tridentnet_config

        add_tridentnet_config(cfg)
    if "TENSOR_MASK" in port_cfg.MODEL:
        from detectron2_tpu.projects.tensormask import add_tensormask_config

        add_tensormask_config(cfg)
    for key, value in leaf_items(port_cfg):
        if key in _PORT_ONLY:
            continue
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            if p not in node and node.is_new_allowed():  # a key of a new_allowed node (CSE.EMBEDDERS)
                node[p] = type(node)(new_allowed=True)
            node = node[p]
        assert leaf in node or node.is_new_allowed(), key
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
        # a PrecomputedProposals model reads its proposals from the batch;
        # the others ignore these keys
        "proposal_boxes": jnp.zeros((1, 8, 4), jnp.float32),
        "proposal_logits": jnp.zeros((1, 8), jnp.float32),
        "proposal_valid": jnp.zeros((1, 8), bool),
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


def jax_random_variables(model, seed=0, scale=0.1, train_batch=None, image_hw=(64, 64)):
    """Seeded random JAX variables; FrozenBN and BN variances kept positive
    and a dense detector's ``loss_normalizer`` at its initial 100. With
    ``train_batch`` the shapes come from a training init, else from an eval
    init on one ``image_hw`` image."""
    from detectron2_tpu.checkpoint.d2_converter import _path_entry_str

    shapes = _param_shapes(model, image_hw=image_hw, train_batch=train_batch)
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
    runs once per image under ``vmap``, hence one row for all images. The
    draws of a row length are made at its first request, whichever package
    or thread makes it, so runs that request the same lengths in the same
    order get the same draws however they interleave."""

    def __init__(self, seed: int):
        self._rng = np.random.RandomState(seed)
        self._draws = {}
        self._lock = threading.Lock()  # JAX traces may ask from several threads

    def __call__(self, N: int):
        with self._lock:
            if N not in self._draws:
                self._draws[N] = (self._rng.rand(N).astype(np.float32), self._rng.rand(N).astype(np.float32))
            return self._draws[N]

    def made(self) -> dict:
        """The draws made so far, by row length."""
        with self._lock:
            return dict(self._draws)

    def load(self, draws: dict) -> None:
        """Hand out ``draws`` (another instance's :meth:`made`, say from
        another process) for their row lengths; none made here yet."""
        with self._lock:
            assert not self._draws, sorted(self._draws)
            self._draws.update(draws)

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


class PointDraws:
    """Seeded uniform draws by shape for PointRend's random points, handed
    to both packages: :meth:`patch` makes the port's
    ``point_features.point_draws`` return them and gives the JAX package's
    PointRend modules a ``jax`` whose ``random.uniform`` returns them (its
    ``random.split`` hands out placeholder keys; the rest is ``jax``)."""

    _JAX_MODULES = ("point_features", "roi_heads", "semantic_seg")

    def __init__(self, seed: int):
        self._rng = np.random.RandomState(seed)
        self._draws = {}

    def __call__(self, shape):
        shape = tuple(int(s) for s in shape)
        if shape not in self._draws:
            self._draws[shape] = self._rng.rand(*shape).astype(np.float32)
        return self._draws[shape]

    def jax_module(self):
        random = types.SimpleNamespace(split=lambda key: (0, 1), uniform=lambda key, shape: jnp.asarray(self(shape)))
        return types.SimpleNamespace(**{k: getattr(jax, k) for k in ("vmap", "lax", "image", "nn", "tree_util")},
                                     random=random)

    def patch(self, monkeypatch) -> None:
        import importlib

        from detectron2_tpu_torch.projects.point_rend import point_features

        monkeypatch.setattr(point_features, "point_draws", lambda shape, generator, device: torch.from_numpy(self(shape)).to(device))
        for name in self._JAX_MODULES:
            module = importlib.import_module(f"detectron2_tpu.projects.point_rend.{name}")
            monkeypatch.setattr(module, "jax", self.jax_module())


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_losses_and_grads(port_cfg, jax_variables, batch, seed=0):
    """The JAX model of ``port_cfg``'s training losses and gradients on
    ``batch`` (:func:`jax_train_step`)."""
    return jax_train_step(jax_model(port_cfg), jax_variables, batch, seed)


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


def jax_module_random_variables(module, x, seed, scale=0.1):
    """Seeded random variables of a JAX module applied to ``x``: every leaf
    a normal at ``scale``, BN variances kept positive."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)

    def leaf(path, sds):
        v = rng.standard_normal(sds.shape).astype(np.float32) * scale
        return jnp.asarray(np.abs(v) + 0.5 if getattr(path[-1], "key", None) in ("var", "running_var") else v)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_jax_variables(model, variables):
    """``convert_jax_params`` of ``variables`` into ``model``; every tensor
    of the model is loaded and none is left over."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params, load_state_dict_report

    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    return model


def assert_features_match(out, ref, rtol=2e-5):
    """Every feature map of ``ref`` (a JAX module's NHWC outputs) in ``out``,
    its max error within ``rtol * max|ref|``."""
    assert set(out) == set(ref), (sorted(out), sorted(ref))
    for name, r in ref.items():
        r = np.asarray(r)
        assert tuple(out[name].shape) == r.shape, (name, tuple(out[name].shape), r.shape)
        err = np.abs(n(out[name]) - r).max()
        assert err <= rtol * np.abs(r).max(), (name, err, np.abs(r).max())


def assert_golden_features(model, golden, names, bound):
    """The golden's ``synth_weight_value`` weights load into ``model`` by
    their d2 names with none missing and none unused, and its features on
    the golden's image reproduce the reference's within ``bound``."""
    from detectron2_tpu_torch.checkpoint import load_state_dict_report
    from detectron2_tpu_torch.testing import golden_state_dict

    state = golden_state_dict(golden)
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    with torch.no_grad():
        out = model.eval()(t(golden["image"][None].astype(np.float32)))
    assert set(out) == set(names), sorted(out)
    for name in names:
        ref = golden[f"feat_{name}"].transpose(0, 2, 3, 1)
        assert tuple(out[name].shape) == ref.shape, (name, tuple(out[name].shape), ref.shape)
        err = np.abs(n(out[name]) - ref).max()
        assert err < bound, (name, err)


def jax_inference(model, variables, batch):
    """The JAX model's detections dict on a host ``batch``, jitted (eager
    tracing of a whole R-CNN takes several times as long on the CPU)."""
    out = jax.jit(lambda v, b: model.apply(v, b, train=False))(variables, {k: jnp.asarray(x) for k, x in batch.items()})
    return jax.tree_util.tree_map(np.asarray, out)


def assert_detections_match(out, ref, min_valid=10):
    """An R-CNN's padded detections dict against the JAX model's, at the
    tolerances of ``tests/test_torch_vitdet_e2e.py``."""
    assert set(out) == set(ref), (sorted(out), sorted(ref))
    assert ref["valid"].sum() >= min_valid  # the comparison is of real detections
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["scores"]), ref["scores"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(n(out["pred_masks"]), ref["pred_masks"], rtol=0, atol=1e-4)


def edit_config(node, edits):
    """Set ``{dotted path: value}`` in a lazy config node; an integer part
    indexes a list (a cascade's per-stage heads)."""
    for path, value in edits.items():
        *parents, leaf = path.split(".")
        target = node
        for p in parents:
            target = target[int(p)] if p.isdigit() else target[p]
        if leaf.isdigit():
            target[int(leaf)] = value
        else:
            target[leaf] = value
    return node


def lazy_models(config, edits):
    """(port model, JAX model) instantiated from the repo's lazy ``config``
    (a path under ``configs/``) with ``edits`` (see :func:`edit_config`)
    applied to the model node in both packages."""
    from detectron2_tpu.config import LazyConfig as JaxLazyConfig
    from detectron2_tpu.config import instantiate as jax_instantiate
    from detectron2_tpu_torch.config import LazyConfig, instantiate

    path = os.path.join(os.path.dirname(GOLDENS), "..", "configs", config)
    port = instantiate(edit_config(LazyConfig.load(path).model, edits))
    jm = jax_instantiate(edit_config(JaxLazyConfig.load(path).model, edits))
    return port, jm


def jax_train_step(model, variables, batch, seed=0):
    """The JAX model's training losses and their gradients (as the port's
    state-dict names) on ``batch``, jitted ``value_and_grad`` of
    ``apply(train=True)`` with the samplers drawing from ``PRNGKey(seed)``
    (or from a :class:`SameDraws` patch)."""
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        losses = model.apply(params, jbatch, train=True, rngs={"sampling": jax.random.PRNGKey(seed)})
        return sum(jax.tree_util.tree_leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
    return {k: float(v) for k, v in losses.items()}, convert_jax_params(jax.tree_util.tree_map(np.asarray, grads))
