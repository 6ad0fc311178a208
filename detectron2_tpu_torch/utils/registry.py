"""Name -> object registry (counterpart of ``detectron2_tpu/utils/registry.py``):
config strings such as ``MODEL.ROI_HEADS.NAME`` pick a registered class."""

from typing import Any, Dict

__all__ = ["Registry"]


class Registry:
    """``REG = Registry("ROI_HEADS")``; ``@REG.register()`` on a class or
    function registers it under its ``__name__``; ``REG.get(name)``."""

    def __init__(self, name: str) -> None:
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Any = None) -> Any:
        if obj is None:
            return self.register
        if obj.__name__ in self._obj_map:
            raise ValueError(f"An object named {obj.__name__!r} was already registered in {self._name!r} registry!")
        self._obj_map[obj.__name__] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"No object named {name!r} found in {self._name!r} registry! Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map
