"""Lazy, python-first configuration (counterpart of
``detectron2_tpu/config/lazy.py``).

``LazyCall`` wraps a callable into an attribute-dict with a ``_target_`` key;
``LazyConfig.load`` executes a python config file in a synthetic module
namespace with patched imports; ``apply_overrides`` implements the
``a.b.c=value`` override grammar; ``save`` / ``to_py`` write a config back.

The repo's configs import ``detectron2_tpu.*`` (the JAX package). Inside a
config file, and only there, the patched ``__import__`` resolves those names
through one table, :mod:`detectron2_tpu_torch.config.lazy_targets`, to the
port's objects; ``jax``, ``optax`` and ``flax`` and any name missing from the
table raise ``ImportError`` naming it. ``_target_`` strings keep the JAX
package's dotted names, so a config saved by either package loads in the
other. The patch stays on while :func:`~detectron2_tpu_torch.config.instantiate`
runs, so a function defined in a config file resolves its own imports the
same way when it is called there.
"""

import ast
import builtins
import copy as copy_module
import importlib.machinery
import importlib.util
import logging
import os
import pickle
import pydoc
import threading
import uuid
from collections import abc
from contextlib import contextmanager
from typing import Any, Dict, List

import yaml

from detectron2_tpu_torch.config import lazy_targets

__all__ = ["LazyCall", "LazyConfig", "DictConfig", "ListConfig"]


class DictConfig(dict):
    """A dict with attribute access, the node type of lazy configs (stands in
    for omegaconf's ``DictConfig``)."""

    def __init__(self, init: Dict[str, Any] = None, flags: Dict[str, bool] = None):
        init = init or {}
        super().__init__()
        for k, v in init.items():
            self[k] = _to_config(v)
        self.__dict__["_flags"] = flags or {}

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"key '{name}' not found in config. Available: {sorted(self.keys())}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _to_config(value)

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __deepcopy__(self, memo):
        new = DictConfig()
        for k, v in self.items():
            new[k] = copy_module.deepcopy(v, memo)
        new.__dict__["_flags"] = dict(self.__dict__.get("_flags", {}))
        return new


class ListConfig(list):
    """A list node of lazy configs."""

    def __init__(self, init=None):
        super().__init__(_to_config(v) for v in (init or []))


def _to_config(value: Any) -> Any:
    """Plain dicts and lists become config nodes, recursively; callables,
    tuples and other objects stay as they are."""
    if isinstance(value, (DictConfig, ListConfig)):
        return value
    if isinstance(value, dict):
        return DictConfig(value)
    if isinstance(value, list):
        return ListConfig(value)
    return value


class LazyCall:
    """Wrap a callable so that calling it returns a :class:`DictConfig` that
    describes the call::

        layer_cfg = L(ViT)(embed_dim=768)
        layer_cfg.embed_dim = 1024     # modify it afterwards
        layer = instantiate(layer_cfg)

    A target from the table keeps its JAX dotted name; a function defined in
    a config file stays the function itself."""

    def __init__(self, target):
        if not (callable(target) or isinstance(target, (str, abc.Mapping))):
            raise TypeError(f"target of LazyCall must be a callable or defines a callable! Got {target}")
        self._target = target

    def __call__(self, **kwargs):
        target = self._target
        if not isinstance(target, (str, abc.Mapping)):
            target = lazy_targets.target_name(target) or _dotted_name(target) or target
        kwargs["_target_"] = target
        return DictConfig(init=kwargs, flags={"allow_objects": True})


def _dotted_name(obj) -> str:
    """The shortest ``module.qualname`` that locates ``obj``, as the JAX
    package names targets; None when no name does (a function defined in a
    config file)."""
    module, qualname = getattr(obj, "__module__", None), getattr(obj, "__qualname__", None)
    if not module or not qualname or is_config_namespace({"__package__": module}):
        return None
    parts = module.split(".")
    for k in range(1, len(parts) + 1):
        candidate = f"{'.'.join(parts[:k])}.{qualname}"
        if pydoc.locate(candidate) is obj:
            return candidate
    return None


def _validate_py_syntax(filename: str) -> None:
    with open(filename) as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f"Config file {filename} has syntax error!") from e


_CFG_PACKAGE_NAME = "detectron2_tpu_torch._cfg_loader"
"""The namespace every loaded config file is put in."""


def _random_package_name(filename: str) -> str:
    return _CFG_PACKAGE_NAME + str(uuid.uuid4())[:4] + "." + os.path.basename(filename)


def is_config_namespace(globals_dict) -> bool:
    """Whether ``globals_dict`` is the namespace of a loaded config file."""
    return globals_dict is not None and (globals_dict.get("__package__", "") or "").startswith(_CFG_PACKAGE_NAME)


def _find_relative_file(original_file: str, relative_import_path: str, level: int) -> str:
    # "from . import x" is refused: it is unclear whether x is a module or a DictConfig
    relative_import_err = (
        "Relative import of directories is not allowed within config files. "
        "Within a config file, relative import can only import other config files."
    )
    if not len(relative_import_path):
        raise ImportError(relative_import_err)
    cur_file = os.path.dirname(original_file)
    for _ in range(level - 1):
        cur_file = os.path.dirname(cur_file)
    for part in relative_import_path.lstrip(".").split("."):
        cur_file = os.path.join(cur_file, part)
    if not cur_file.endswith(".py"):
        cur_file += ".py"
    if not os.path.isfile(cur_file):
        cur_file_no_suffix = cur_file[: -len(".py")]
        if os.path.isdir(cur_file_no_suffix):
            raise ImportError(f"Cannot import from {cur_file_no_suffix}." + relative_import_err)
        raise ImportError(
            f"Cannot import name {relative_import_path} from {original_file}: {cur_file} does not exist."
        )
    return cur_file


_patch_lock = threading.RLock()
_patch_depth = 0
_default_import = builtins.__import__


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    if not is_config_namespace(globals):
        return _default_import(name, globals, locals, fromlist=fromlist, level=level)
    if level != 0:
        # another config file, loaded fresh (no module cache): its dicts
        # become DictConfig
        cur_file = _find_relative_file(globals["__file__"], name, level)
        _validate_py_syntax(cur_file)
        spec = importlib.machinery.ModuleSpec(_random_package_name(cur_file), None, origin=cur_file)
        module = importlib.util.module_from_spec(spec)
        module.__file__ = cur_file
        with open(cur_file) as f:
            content = f.read()
        exec(compile(content, cur_file, "exec"), module.__dict__)
        for name_ in fromlist:
            module.__dict__[name_] = _to_config(module.__dict__[name_])
        return module
    if lazy_targets.is_resolved_root(name):
        return lazy_targets.import_module(name, fromlist)
    return _default_import(name, globals, locals, fromlist=fromlist, level=level)


@contextmanager
def patch_import():
    """Config files import other config files by relative path (no package,
    no module cache) and resolve ``detectron2_tpu.*`` through the table.
    Re-entrant: :func:`instantiate` enters it too."""
    global _patch_depth
    with _patch_lock:
        if _patch_depth == 0:
            builtins.__import__ = _config_import
        _patch_depth += 1
    try:
        yield
    finally:
        with _patch_lock:
            _patch_depth -= 1
            if _patch_depth == 0:
                builtins.__import__ = _default_import


class LazyConfig:
    """Load, save and override lazy configurations."""

    @staticmethod
    def load_rel(filename: str, keys=None):
        """Like :meth:`load`, with ``filename`` relative to the caller's file."""
        import inspect

        caller_fname = inspect.stack()[1][0].f_code.co_filename
        assert caller_fname != "<string>", "load_rel Unable to find caller"
        return LazyConfig.load(os.path.join(os.path.dirname(caller_fname), filename), keys)

    @staticmethod
    def load(filename: str, keys=None):
        """Load a ``.py`` or ``.yaml`` config. Without ``keys``, the
        top-level config objects (dicts and lists whose names do not start
        with ``_``) in a :class:`DictConfig`; with ``keys`` (a name or a
        tuple of names), those values."""
        has_keys = keys is not None
        filename = filename.replace("/./", "/")
        if os.path.splitext(filename)[1] not in [".py", ".yaml", ".yml"]:
            raise ValueError(f"Config file {filename} has to be a python or yaml file.")
        if filename.endswith(".py"):
            _validate_py_syntax(filename)
            with patch_import():
                module_namespace = {"__file__": filename, "__package__": _random_package_name(filename)}
                with open(filename) as f:
                    content = f.read()
                exec(compile(content, filename, "exec"), module_namespace)
            ret = module_namespace
        else:
            with open(filename) as f:
                obj = yaml.unsafe_load(f)
            ret = DictConfig(obj)

        if has_keys:
            if isinstance(keys, str):
                return _to_config(ret[keys])
            return tuple(_to_config(ret[a]) for a in keys)
        if filename.endswith(".py"):
            ret = DictConfig(
                {
                    name: _to_config(value)
                    for name, value in ret.items()
                    if isinstance(value, (DictConfig, ListConfig, dict, list)) and not name.startswith("_")
                },
                flags={"allow_objects": True},
            )
        return ret

    @staticmethod
    def save(cfg, filename: str) -> None:
        """Save a config to yaml (to ``filename + ".pkl"`` by pickle when it
        holds objects yaml cannot write)."""
        logger = logging.getLogger(__name__)
        try:
            cfg = copy_module.deepcopy(cfg)
        except Exception:
            pass
        try:
            dumped = yaml.dump(_to_plain(cfg), default_flow_style=False, allow_unicode=True, width=9999)
            with open(filename, "w") as f:
                f.write(dumped)
            try:
                yaml.unsafe_load(dumped)
            except Exception:
                logger.warning(
                    "The config contains objects that cannot serialize to a valid yaml. "
                    f"{filename} is human-readable but cannot be loaded."
                )
        except Exception:
            logger.exception("Unable to serialize the config to yaml. Error:")
            new_filename = filename + ".pkl"
            try:
                with open(new_filename, "wb") as f:
                    pickle.dump(cfg, f)
                logger.warning(f"Config is saved using pickle at {new_filename}.")
            except Exception:
                pass

    @staticmethod
    def apply_overrides(cfg, overrides: List[str]):
        """Override ``cfg`` in place with ``a.b.c=value`` strings; values are
        python literals where they parse as one, else strings."""
        for o in overrides:
            if "=" not in o:
                raise ValueError(f"Cannot parse override: {o}; expected key=value")
            key, value = o.split("=", 1)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass
            _set_dotted(cfg, key, value)
        return cfg

    @staticmethod
    def to_py(cfg, prefix: str = "cfg.") -> str:
        """The config as python-like pseudocode."""

        def _to_str(obj, prefix=None, inside_call=False):
            if prefix is None:
                prefix = []
            if isinstance(obj, abc.Mapping) and "_target_" in obj:
                target = obj["_target_"]
                args = [f"{k}={_to_str(v, inside_call=True)}" for k, v in sorted(obj.items()) if k != "_target_"]
                return "".join(prefix) + f"{target}({', '.join(args)})"
            elif isinstance(obj, abc.Mapping) and not inside_call:
                key_list = []
                for k, v in sorted(obj.items()):
                    if isinstance(v, abc.Mapping) and "_target_" not in v:
                        key_list.append(_to_str(v, prefix=prefix + [k + "."]))
                    else:
                        key_list.append(f"{''.join(prefix) + k}={_to_str(v)}")
                return "\n".join(key_list)
            elif isinstance(obj, abc.Mapping):
                return "dict(" + ",".join(f"{k}={_to_str(v, inside_call=True)}" for k, v in sorted(obj.items())) + ")"
            elif isinstance(obj, (list, tuple)):
                inner = ",".join(_to_str(x, inside_call=inside_call) for x in obj)
                return ("[" + inner + "]") if isinstance(obj, list) else ("(" + inner + ")")
            return repr(obj)

        py_str = _to_str(cfg, prefix=[prefix])
        try:
            import black

            return black.format_str(py_str, mode=black.Mode())
        except Exception:
            return py_str


def _set_dotted(cfg, dotted_key: str, value) -> None:
    keys = dotted_key.split(".")
    cur = cfg
    for k in keys[:-1]:
        if isinstance(cur, abc.Mapping):
            if k not in cur:
                cur[k] = DictConfig()
            cur = cur[k]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(k)]
        else:
            cur = getattr(cur, k)
    last = keys[-1]
    if isinstance(cur, abc.MutableMapping):
        cur[last] = _to_config(value)
    elif isinstance(cur, list):
        cur[int(last)] = _to_config(value)
    else:
        setattr(cur, last, value)


def _to_plain(obj: Any) -> Any:
    """Config nodes back to plain containers, for yaml."""
    if isinstance(obj, abc.Mapping):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = list if isinstance(obj, list) else tuple
        return t(_to_plain(v) for v in obj)
    return obj
