"""The trainer's metric store (a minimal counterpart of
``detectron2_tpu/utils/events.py``): scalars by name, each with the
iteration it was recorded at. It belongs to the trainer that creates it;
there is no global storage stack."""

import statistics
from typing import Dict, List, Tuple

__all__ = ["EventStorage", "HistoryBuffer"]


class HistoryBuffer:
    """The (value, iteration) pairs of one scalar, in the order recorded."""

    def __init__(self):
        self._data: List[Tuple[float, int]] = []

    def update(self, value: float, iteration: int) -> None:
        self._data.append((float(value), iteration))

    def values(self) -> List[Tuple[float, int]]:
        return list(self._data)

    def median(self, window_size: int) -> float:
        return statistics.median(v for v, _ in self._data[-window_size:])


class EventStorage:
    """Scalars of a training run; ``iter`` is the current iteration, which
    the trainer advances."""

    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._history: Dict[str, HistoryBuffer] = {}

    def put_scalar(self, name: str, value: float) -> None:
        """Record ``value`` under ``name`` at the current iteration."""
        self._history.setdefault(name, HistoryBuffer()).update(value, self.iter)

    def put_scalars(self, **kwargs) -> None:
        for name, value in kwargs.items():
            self.put_scalar(name, value)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric available for {name}!")
        return self._history[name]
