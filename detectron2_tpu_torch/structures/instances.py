"""Instances: per-image fields of equal length (counterpart of
``detectron2_tpu/structures/instances.py``: the detections of inference and
the ground truth the training mapper builds)."""

from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["Instances"]


def _index(value: Any, item: Any) -> Any:
    """``value[item]`` for a field: tensors take numpy masks and index arrays
    as tensors, numpy arrays take tensor ones as numpy, plain lists are
    picked from element by element."""
    if isinstance(item, np.ndarray) and isinstance(value, torch.Tensor):
        return value[torch.from_numpy(item)]
    if isinstance(item, torch.Tensor) and isinstance(value, np.ndarray):
        return value[item.cpu().numpy()]
    if isinstance(value, list) and not isinstance(item, slice):
        idx = item.cpu().numpy() if isinstance(item, torch.Tensor) else np.asarray(item)
        if idx.dtype == np.bool_:
            idx = np.nonzero(idx)[0]
        return [value[int(i)] for i in idx]
    return value[item]


class Instances:
    """``image_size`` (h, w) plus fields of equal length, read and set as
    attributes (``inst.pred_boxes``, ``inst.gt_classes``, ...). Indexing by an
    int, a slice, an index array or a bool mask (numpy or tensor) indexes
    every field."""

    def __init__(self, image_size: Tuple[int, int], **fields: Any):
        object.__setattr__(self, "image_size", tuple(image_size))
        object.__setattr__(self, "_fields", dict(fields))

    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(f"Instances has no field {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self.set(name, value)

    def set(self, name: str, value: Any) -> None:
        if self._fields and len(value) != len(self):
            raise ValueError(f"Adding a field of length {len(value)} to Instances of length {len(self)}")
        self._fields[name] = value

    def has(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str) -> Any:
        return self._fields[name]

    def remove(self, name: str) -> None:
        del self._fields[name]

    def __getitem__(self, item) -> "Instances":
        if type(item) is int:
            if item >= len(self) or item < -len(self):
                raise IndexError("Instances index out of range!")
            item = slice(item, None, len(self))
        return Instances(self.image_size, **{k: _index(v, item) for k, v in self._fields.items()})

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0

    def __repr__(self) -> str:
        return (
            f"Instances(num_instances={len(self)}, image_height={self.image_size[0]}, "
            f"image_width={self.image_size[1]}, fields=[{', '.join(self._fields)}])"
        )
