"""Recursive instantiation of ``_target_`` config dicts (counterpart of
``detectron2_tpu/config/instantiate.py``).

A mapping with a ``_target_`` becomes an object: its other keys are
instantiated first and passed as keyword arguments to the target. A string
target resolves through the table of :mod:`~detectron2_tpu_torch.config.
lazy_targets` (JAX dotted names), any other dotted name through ``pydoc``.
A function defined in a config file either has a counterpart in the port
(matched by name and parameter names; the config's arguments are bound to
the function's own signature, so its defaults apply, and the counterpart
runs in its place), or runs as it is when its body uses only names the
table resolves. One whose body imports ``jax``, ``optax`` or ``flax`` and
has no counterpart raises ``NotImplementedError`` naming itself, before
running.
"""

import ast
import collections.abc as abc
import dataclasses
import inspect
import logging
import pydoc
import textwrap
from typing import Any

from detectron2_tpu_torch.config import lazy_targets
from detectron2_tpu_torch.config.lazy import is_config_namespace, patch_import

__all__ = ["dump_dataclass", "instantiate"]

_JAX_ROOTS = ("jax", "optax", "flax")


def dump_dataclass(obj: Any):
    """A dataclass, recursively, as a dict that :func:`instantiate` rebuilds."""
    assert dataclasses.is_dataclass(obj) and not isinstance(obj, type), (
        f"dump_dataclass() requires an instance of a dataclass. Got {obj}"
    )
    ret = {"_target_": f"{type(obj).__module__}.{type(obj).__qualname__}"}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = dump_dataclass(v)
        if isinstance(v, (list, tuple)):
            v = [dump_dataclass(x) if dataclasses.is_dataclass(x) else x for x in v]
        ret[f.name] = v
    return ret


def _imports_jax(fn) -> bool:
    """Whether ``fn``'s body imports jax, optax or flax."""
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return any(n in _JAX_ROOTS for n in fn.__code__.co_names)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(a.name.split(".")[0] in _JAX_ROOTS for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").split(".")[0] in _JAX_ROOTS:
            return True
    return False


def _locate(name: str) -> Any:
    if name.split(".")[0] == "detectron2_tpu":
        return lazy_targets.resolve(name)
    obj = pydoc.locate(name)
    if obj is None:
        raise ImportError(f"Cannot locate object '{name}'!")
    return obj


def _call(cls, cls_name: str, kwargs: dict):
    if inspect.isfunction(cls) and is_config_namespace(cls.__globals__):
        counterpart = lazy_targets.config_callable_counterpart(cls)
        if counterpart is not None:
            bound = inspect.signature(cls).bind(**kwargs)
            bound.apply_defaults()
            return counterpart(**bound.arguments)
        if _imports_jax(cls):
            raise NotImplementedError(
                f"{cls.__qualname__}, defined in {cls.__code__.co_filename}, imports jax/optax/flax and has no "
                "counterpart in the port (detectron2_tpu_torch/config/lazy_targets.py CONFIG_CALLABLES)"
            )
    try:
        return cls(**kwargs)
    except TypeError:
        logging.getLogger(__name__).error(f"Error when instantiating {cls_name}!")
        raise


def _instantiate(cfg: Any) -> Any:
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(_instantiate(x) for x in cfg)
    if isinstance(cfg, abc.Mapping) and "_target_" in cfg:
        cls = cfg["_target_"]
        newargs = {k: _instantiate(v) for k, v in cfg.items() if k != "_target_"}
        if isinstance(cls, str):
            cls_name = cls
            cls = _locate(cls_name)
        else:
            cls = _instantiate(cls) if isinstance(cls, abc.Mapping) else cls
            cls_name = getattr(cls, "__qualname__", str(cls))
        if not callable(cls):
            raise TypeError(f"_target_ {cls_name} does not define a callable object")
        return _call(cls, cls_name, newargs)
    if isinstance(cfg, abc.Mapping):
        return {k: _instantiate(v) for k, v in cfg.items()}
    return cfg


def instantiate(cfg: Any) -> Any:
    """Recursively instantiate ``cfg``: a mapping with ``_target_`` becomes
    the target called with its (instantiated) other keys; lists and tuples
    elementwise; other mappings keep their keys; anything else as it is.
    Config files' own imports resolve through the table meanwhile."""
    with patch_import():
        return _instantiate(cfg)
