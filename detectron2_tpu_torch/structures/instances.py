"""A minimal Instances: per-image detections as named tensor fields."""

from typing import Any, Tuple

__all__ = ["Instances"]


class Instances:
    """``image_size`` (h, w) plus fields of equal length, read and set as
    attributes (``inst.pred_boxes``, ``inst.scores``, ...)."""

    def __init__(self, image_size: Tuple[int, int], **fields: Any):
        object.__setattr__(self, "image_size", tuple(image_size))
        object.__setattr__(self, "_fields", dict(fields))

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(f"Instances has no field {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._fields[name] = value

    def has(self, name: str) -> bool:
        return name in self._fields

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0
