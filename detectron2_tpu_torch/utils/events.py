"""The trainer's metric store and its writers (a copy of
``detectron2_tpu/utils/events.py``): :class:`EventStorage` keeps each
scalar's history with its iteration and smoothing hint, and is entered as a
context (the trainer does) so that :func:`get_event_storage` finds it;
:class:`JSONWriter`, :class:`CommonMetricPrinter` and
:class:`TensorboardXWriter` write what it holds. Values are Python or numpy
numbers or one-element tensors (read with ``float``, one host sync each).
"""

import datetime
import json
import logging
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CommonMetricPrinter",
    "EventStorage",
    "EventWriter",
    "HistoryBuffer",
    "JSONWriter",
    "TensorboardXWriter",
    "get_event_storage",
]

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    """The innermost :class:`EventStorage` entered."""
    assert len(_CURRENT_STORAGE_STACK), "get_event_storage() has to be called inside a 'with EventStorage(...)' context!"
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """The (value, iteration) pairs of one scalar, the last ``max_length``
    of them, and the running mean of all."""

    def __init__(self, max_length: int = 1000000) -> None:
        self._max_length = max_length
        self._data: List[Tuple[float, float]] = []
        self._count = 0
        self._global_avg = 0.0

    def update(self, value: float, iteration: Optional[float] = None) -> None:
        if iteration is None:
            iteration = self._count
        if len(self._data) == self._max_length:
            self._data.pop(0)
        self._data.append((value, iteration))
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count

    def latest(self) -> float:
        return self._data[-1][0]

    def median(self, window_size: int) -> float:
        return float(np.median([x[0] for x in self._data[-window_size:]]))

    def avg(self, window_size: int) -> float:
        return float(np.mean([x[0] for x in self._data[-window_size:]]))

    def global_avg(self) -> float:
        return self._global_avg

    def values(self) -> List[Tuple[float, float]]:
        return self._data


class EventWriter:
    """Writes what the current :class:`EventStorage` holds."""

    def write(self):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends one json line per iteration to ``json_file``: every scalar
    recorded at that iteration since the last write, median-smoothed over
    ``window_size`` iterations where its hint says so."""

    def __init__(self, json_file: str, window_size: int = 20):
        self._file_handle = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self):
        storage = get_event_storage()
        to_save = defaultdict(dict)
        for k, (v, itr) in storage.latest_with_smoothing_hint(self._window_size).items():
            if itr <= self._last_write:
                continue
            to_save[itr][k] = v
        if len(to_save):
            self._last_write = max(to_save)
        for itr, scalars_per_iter in to_save.items():
            scalars_per_iter["iteration"] = itr
            self._file_handle.write(json.dumps(scalars_per_iter, sort_keys=True) + "\n")
        self._file_handle.flush()
        try:
            os.fsync(self._file_handle.fileno())
        except (AttributeError, OSError):
            pass

    def close(self):
        self._file_handle.close()


class TensorboardXWriter(EventWriter):
    """Writes the scalars to a tensorboard event file in ``log_dir``;
    constructing it fails where ``torch.utils.tensorboard`` does not
    import."""

    def __init__(self, log_dir: str, window_size: int = 20, **kwargs):
        from torch.utils.tensorboard import SummaryWriter

        self._window_size = window_size
        self._writer = SummaryWriter(log_dir, **kwargs)
        self._last_write = -1

    def write(self):
        storage = get_event_storage()
        new_last_write = self._last_write
        for k, (v, itr) in storage.latest_with_smoothing_hint(self._window_size).items():
            if itr > self._last_write:
                self._writer.add_scalar(k, v, itr)
                new_last_write = max(new_last_write, itr)
        self._last_write = new_last_write

    def close(self):
        self._writer.close()


class CommonMetricPrinter(EventWriter):
    """Logs the iteration, the ETA, the smoothed losses, the step and data
    times and the LR."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self.logger = logging.getLogger("detectron2_tpu_torch.utils.events")
        self._max_iter = max_iter
        self._window_size = window_size
        self._last_write = None  # (iter, time) of the last call

    def _get_eta(self, storage) -> Optional[str]:
        if self._max_iter is None:
            return ""
        iteration = storage.iter
        try:
            eta_seconds = storage.history("time").median(1000) * (self._max_iter - iteration - 1)
            storage.put_scalar("eta_seconds", eta_seconds, smoothing_hint=False)
            return str(datetime.timedelta(seconds=int(eta_seconds)))
        except KeyError:
            # no step times yet: estimate from the calls of this writer
            eta_string = None
            if self._last_write is not None:
                estimate_iter_time = (time.perf_counter() - self._last_write[1]) / (iteration - self._last_write[0])
                eta_seconds = estimate_iter_time * (self._max_iter - iteration - 1)
                eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
            self._last_write = (iteration, time.perf_counter())
            return eta_string

    def write(self):
        storage = get_event_storage()
        iteration = storage.iter
        if iteration == self._max_iter:
            return

        def latest(name, smoothed=None):
            try:
                h = storage.history(name)
            except KeyError:
                return None
            return smoothed(h) if smoothed else h.latest()

        avg_data_time = latest("data_time", lambda h: h.avg(storage.count_samples("data_time", self._window_size)))
        last_data_time = latest("data_time")
        iter_time = latest("time", lambda h: h.global_avg())
        last_iter_time = latest("time")
        lr = latest("lr")
        eta_string = self._get_eta(storage)

        def medians(select):
            return "  ".join(
                "{}: {:.4g}".format(k, v.median(storage.count_samples(k, self._window_size)))
                for k, v in storage.histories().items()
                if select(k)
            )

        parts = [
            f"eta: {eta_string}  " if eta_string else "",
            f"iter: {iteration}  ",
            medians(lambda k: "loss" in k) + "  ",
            medians(lambda k: "[metric]" in k) + "  ",
            f"time: {iter_time:.4f}  " if iter_time is not None else "",
            f"last_time: {last_iter_time:.4f}  " if last_iter_time is not None else "",
            f"data_time: {avg_data_time:.4f}  " if avg_data_time is not None else "",
            f"last_data_time: {last_data_time:.4f}  " if last_data_time is not None else "",
            f"lr: {lr:.5g}" if lr is not None else "lr: N/A",
        ]
        self.logger.info("".join(parts))


class EventStorage:
    """Scalars of a training run: each name's :class:`HistoryBuffer`, its
    latest (value, iteration) and its smoothing hint. ``iter`` is the
    current iteration, which the trainer advances. Entered as a context, it
    is what :func:`get_event_storage` returns."""

    def __init__(self, start_iter: int = 0):
        self._history = defaultdict(HistoryBuffer)
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, Tuple[float, int]] = {}
        self._iter = start_iter
        self._current_prefix = ""

    def put_scalar(self, name: str, value, smoothing_hint: bool = True, cur_iter: Optional[int] = None) -> None:
        """Record ``value`` under ``name`` at ``cur_iter`` (default: the
        current iteration). ``smoothing_hint`` says whether writers may
        report the median over a window instead; it is fixed per name."""
        name = self._current_prefix + name
        cur_iter = self._iter if cur_iter is None else cur_iter
        value = float(value)
        self._history[name].update(value, cur_iter)
        self._latest_scalars[name] = (value, cur_iter)
        existing_hint = self._smoothing_hints.get(name)
        if existing_hint is not None:
            assert existing_hint == smoothing_hint, f"Scalar {name} was put with a different smoothing_hint!"
        else:
            self._smoothing_hints[name] = smoothing_hint

    def put_scalars(self, *, smoothing_hint: bool = True, cur_iter: Optional[int] = None, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v, smoothing_hint=smoothing_hint, cur_iter=cur_iter)

    def history(self, name: str) -> HistoryBuffer:
        ret = self._history.get(name, None)
        if ret is None:
            raise KeyError(f"No history metric available for {name}!")
        return ret

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, Tuple[float, int]]:
        """Each scalar's most recent (value, iteration)."""
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20) -> Dict[str, Tuple[float, int]]:
        """As :meth:`latest`, with the median over the last ``window_size``
        iterations where a scalar's hint asks for smoothing."""
        result = {}
        for k, (v, itr) in self._latest_scalars.items():
            smoothed = self._history[k].median(self.count_samples(k, window_size))
            result[k] = (smoothed if self._smoothing_hints[k] else v, itr)
        return result

    def count_samples(self, name: str, window_size: int = 20) -> int:
        """How many of ``name``'s values were recorded within the last
        ``window_size`` iterations."""
        samples = 0
        data = self._history[name].values()
        for _, iter_ in reversed(data):
            if iter_ > data[-1][1] - window_size:
                samples += 1
            else:
                break
        return samples

    @property
    def iter(self) -> int:
        return self._iter

    @iter.setter
    def iter(self, val: int) -> None:
        self._iter = int(val)

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        assert _CURRENT_STORAGE_STACK[-1] == self
        _CURRENT_STORAGE_STACK.pop()

    @contextmanager
    def name_scope(self, name: str):
        """Within it, every scalar's name is prefixed with ``name/``."""
        old_prefix = self._current_prefix
        self._current_prefix = name.rstrip("/") + "/"
        yield
        self._current_prefix = old_prefix
