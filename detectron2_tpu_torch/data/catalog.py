"""Dataset and metadata catalogs (a copy of ``detectron2_tpu/data/catalog.py``,
which the port cannot import: that package's ``__init__`` imports jax)."""

import copy
import logging
import types
from collections import Counter
from typing import Any, Callable, Dict, List

__all__ = ["DatasetCatalog", "MetadataCatalog", "Metadata"]

_LOG_COUNTER: Counter = Counter()


def log_first_n(lvl: int, msg: str, n: int = 1) -> None:
    """Log ``msg`` the first ``n`` times it is seen."""
    _LOG_COUNTER[msg] += 1
    if _LOG_COUNTER[msg] <= n:
        logging.getLogger(__name__).log(lvl, msg)


class _DatasetCatalog:
    """A global catalog mapping dataset names to functions that load the
    dataset as list[dict] in the common format."""

    def __init__(self):
        self._registered: Dict[str, Callable] = {}

    def register(self, name: str, func: Callable) -> None:
        assert callable(func), "You must register a function with `DatasetCatalog.register`!"
        assert name not in self._registered, f"Dataset '{name}' is already registered!"
        self._registered[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registered[name]
        except KeyError as e:
            raise KeyError(
                f"Dataset '{name}' is not registered! Available datasets are: "
                f"{', '.join(sorted(self._registered.keys()))}"
            ) from e
        return f()

    def list(self) -> List[str]:
        return sorted(self._registered.keys())

    def remove(self, name: str) -> None:
        self._registered.pop(name)

    def clear(self) -> None:
        self._registered.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._registered

    def __str__(self):
        return "DatasetCatalog(registered datasets: {})".format(", ".join(self.list()))

    __repr__ = __str__


class Metadata(types.SimpleNamespace):
    """Supports simple attribute setter/getter; an uniform way to obtain
    information about a dataset (reference catalog.py:91)."""

    name: str = "N/A"

    _RENAMED = {
        "class_names": "thing_classes",
        "dataset_id_to_contiguous_id": "thing_dataset_id_to_contiguous_id",
        "stuff_class_names": "stuff_classes",
    }

    def __getattr__(self, key):
        if key in self._RENAMED:
            log_first_n(
                logging.WARNING, f"Metadata '{key}' was renamed to '{self._RENAMED[key]}'!", n=10
            )
            return getattr(self, self._RENAMED[key])
        # sys._getframe check etc. skipped; give a helpful error
        raise AttributeError(
            f"Attribute '{key}' does not exist in the metadata of dataset '{self.name}'. "
            f"Available keys are {sorted(self.__dict__.keys())}."
        )

    def __setattr__(self, key, val):
        if key in self._RENAMED:
            log_first_n(
                logging.WARNING, f"Metadata '{key}' was renamed to '{self._RENAMED[key]}'!", n=10
            )
            setattr(self, self._RENAMED[key], val)
            return
        # ensure that metadata of the same name stays consistent
        try:
            oldval = getattr(self, key)
            assert oldval == val, (
                f"Attribute '{key}' in the metadata of '{self.name}' cannot be set "
                f"to a different value!\n{oldval} != {val}"
            )
        except AttributeError:
            super().__setattr__(key, val)

    def as_dict(self) -> Dict[str, Any]:
        return copy.copy(self.__dict__)

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        try:
            return getattr(self, key)
        except AttributeError:
            return default


class _MetadataCatalog:
    """Global catalog mapping dataset names to their Metadata."""

    def __init__(self):
        self._metadata: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        assert len(name)
        if name not in self._metadata:
            self._metadata[name] = Metadata(name=name)
        return self._metadata[name]

    def list(self) -> List[str]:
        return list(self._metadata.keys())

    def remove(self, name: str) -> None:
        self._metadata.pop(name)

    def clear(self) -> None:
        self._metadata.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._metadata

    def __str__(self):
        return "MetadataCatalog(registered metadata: {})".format(", ".join(self.list()))

    __repr__ = __str__


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
