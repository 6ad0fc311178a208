"""A yacs-style hierarchical config node.

The port's own copy of the CfgNode semantics the JAX package implements in
``detectron2_tpu/config/cfg_node.py``: attribute access, freezing,
typed merging, ``_BASE_`` yaml inheritance and ``merge_from_list``.
``yaml`` is imported only by :meth:`CfgNode.merge_from_file`, so configs built
in code need no PyYAML.
"""

import copy
import os
from ast import literal_eval
from typing import Any, Dict, List, Optional

__all__ = ["CfgNode"]

_VALID_TYPES = {tuple, list, str, int, float, bool, type(None)}
BASE_KEY = "_BASE_"


def _decode_cfg_value(value: Any) -> Any:
    if isinstance(value, dict):
        return CfgNode(value)
    if not isinstance(value, str):
        return value
    try:
        return literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(replacement: Any, original: Any, full_key: str) -> Any:
    """Check that `replacement`'s type matches `original`'s; coerce int to
    float and list to tuple (and back)."""
    if type(replacement) is type(original) or original is None:
        return replacement
    if type(original) is float and type(replacement) is int:
        return float(replacement)
    for from_type, to_type in ((tuple, list), (list, tuple)):
        if type(replacement) is from_type and type(original) is to_type:
            return to_type(replacement)
    raise ValueError(
        f"Type mismatch ({type(original)} vs. {type(replacement)}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}"
    )


class CfgNode(dict):
    """A dict with attribute access that only accepts known keys on merge,
    or new ones too where it was made with ``new_allowed``."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Optional[Dict[str, Any]] = None, new_allowed: bool = False):
        init_dict = copy.deepcopy(init_dict or {})
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                init_dict[k] = CfgNode(v)
            elif not isinstance(v, CfgNode) and type(v) not in _VALID_TYPES:
                raise TypeError(f"Key {k} with value {type(v)} is not a valid type")
        super().__init__(init_dict)
        self.__dict__[CfgNode.IMMUTABLE] = False
        self.__dict__[CfgNode.NEW_ALLOWED] = new_allowed

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Attribute '{name}' does not exist in CfgNode")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Attempted to set '{name}' to '{value}', but CfgNode is immutable")
        if not (isinstance(value, CfgNode) or type(value) in _VALID_TYPES):
            raise TypeError(f"Invalid type {type(value)} for key {name}")
        self[name] = value

    def freeze(self) -> None:
        self._immutable(True)

    def defrost(self) -> None:
        self._immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def is_new_allowed(self) -> bool:
        return self.__dict__.get(CfgNode.NEW_ALLOWED, False)

    def _immutable(self, is_immutable: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = is_immutable
        for v in self.values():
            if isinstance(v, CfgNode):
                v._immutable(is_immutable)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def dump(self, **kwargs) -> str:
        """The config as a yaml string (needs PyYAML)."""
        import yaml

        def to_dict(node):
            return {k: to_dict(v) for k, v in node.items()} if isinstance(node, dict) else node

        kwargs.setdefault("default_flow_style", None)
        return yaml.safe_dump(to_dict(self), **kwargs)

    def merge_from_other_cfg(self, cfg_other: "CfgNode") -> None:
        _merge_a_into_b(cfg_other, self, [])

    def merge_from_list(self, cfg_list: List[Any]) -> None:
        """Merge (key, value) pairs, e.g. ``["MODEL.MASK_ON", "True"]``."""
        if len(cfg_list) % 2:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            *parents, leaf = full_key.split(".")
            for subkey in parents:
                if subkey not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[subkey]
            if leaf not in d:
                raise KeyError(f"Non-existent key: {full_key}")
            d[leaf] = _coerce(_decode_cfg_value(v), d[leaf], full_key)

    @classmethod
    def load_yaml_with_base(cls, filename: str) -> Dict[str, Any]:
        """Load a yaml file, resolving ``_BASE_`` relative to it."""
        import yaml

        with open(filename, "r") as f:
            cfg = yaml.safe_load(f) or {}

        def merge_a_into_b(a, b):
            for k, v in a.items():
                if isinstance(v, dict) and k in b and isinstance(b[k], dict):
                    merge_a_into_b(v, b[k])
                else:
                    b[k] = v

        if BASE_KEY in cfg:
            bases = cfg.pop(BASE_KEY)
            base_cfg: Dict[str, Any] = {}
            for base in bases if isinstance(bases, list) else [bases]:
                base = os.path.expanduser(base)
                if not os.path.isabs(base):
                    base = os.path.join(os.path.dirname(filename), base)
                merge_a_into_b(cls.load_yaml_with_base(base), base_cfg)
            merge_a_into_b(cfg, base_cfg)
            return base_cfg
        return cfg

    def merge_from_file(self, cfg_filename: str) -> None:
        """Merge a yaml config (``_BASE_`` supported). Only version-2 configs
        are accepted: the port carries no upgrade path for older schemas."""
        loaded = type(self)(self.load_yaml_with_base(cfg_filename))
        version = loaded.get("VERSION", self.VERSION)
        if version != self.VERSION:
            raise ValueError(f"{cfg_filename}: config VERSION {version}, expected {self.VERSION}")
        self.merge_from_other_cfg(loaded)


def _merge_a_into_b(a: CfgNode, b: CfgNode, key_list: List[str]) -> None:
    for k, v_ in a.items():
        full_key = ".".join(key_list + [k])
        v = _decode_cfg_value(copy.deepcopy(v_))
        if k not in b:
            if not b.is_new_allowed():
                raise KeyError(f"Non-existent config key: {full_key}")
            b[k] = v
            continue
        v = _coerce(v, b[k], full_key)
        if isinstance(v, CfgNode):
            _merge_a_into_b(v, b[k], key_list + [k])
        else:
            b[k] = v
