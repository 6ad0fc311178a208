"""Dataset wrappers (``MapDataset``, ``DatasetFromList`` and its serialized
list, copied from ``detectron2_tpu/data/common.py``)."""

import copy
import logging
import pickle
import random
from typing import Callable

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["MapDataset", "DatasetFromList"]


class MapDataset:
    """Map a function over a dataset; if the map returns None (a bad sample),
    retry with other random indices (the data pipeline's fault tolerance)."""

    def __init__(self, dataset, map_func: Callable):
        self._dataset = dataset
        self._map_func = map_func
        self._rng = random.Random(42)
        self._fallback_candidates = set(range(len(dataset)))

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, idx: int):
        retry_count = 0
        cur_idx = int(idx)
        while True:
            data = self._map_func(self._dataset[cur_idx])
            if data is not None:
                self._fallback_candidates.add(cur_idx)
                return data

            # _map_func fails for this idx; use a random new index
            retry_count += 1
            self._fallback_candidates.discard(cur_idx)
            cur_idx = self._rng.sample(sorted(self._fallback_candidates), k=1)[0]

            if retry_count >= 3:
                logger.warning(
                    "Failed to apply `_map_func` for idx: %s, retry count: %s", idx, retry_count
                )


class _NumpySerializedList:
    """Serialize list elements to numpy uint8 to avoid per-element python
    object overhead when shared across workers (d2's ``_TorchSerializedList``
    in numpy)."""

    def __init__(self, lst: list):
        def _serialize(data):
            buffer = pickle.dumps(data, protocol=-1)
            return np.frombuffer(buffer, dtype=np.uint8)

        logger.info(
            "Serializing {} elements to byte tensors and concatenating them all ...".format(len(lst))
        )
        self._lst = [_serialize(x) for x in lst]
        self._addr = np.asarray([len(x) for x in self._lst], dtype=np.int64)
        self._addr = np.cumsum(self._addr)
        self._lst = np.concatenate(self._lst)
        logger.info("Serialized dataset takes {:.2f} MiB".format(len(self._lst) / 1024**2))

    def __len__(self) -> int:
        return len(self._addr)

    def __getitem__(self, idx: int):
        start_addr = 0 if idx == 0 else self._addr[idx - 1].item()
        end_addr = self._addr[idx].item()
        return pickle.loads(memoryview(self._lst[start_addr:end_addr]))


class DatasetFromList:
    """Wrap a list into a dataset, with optional serialization and copying."""

    def __init__(self, lst: list, copy: bool = True, serialize: bool = True):
        self._copy = copy
        self._serialize = serialize
        if self._serialize:
            self._data = _NumpySerializedList(lst)
        else:
            self._data = lst

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, idx: int):
        if self._copy and not self._serialize:
            return copy.deepcopy(self._data[idx])
        return self._data[idx]
