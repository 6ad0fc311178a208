"""Learning-rate schedules (counterpart of ``detectron2_tpu/solver/lr_scheduler.py``).

A schedule is a multiplier of each parameter group's initial LR, a function
of the progress ``where = min(iteration / max_iter, 1)``: a warmup prefix
composed onto a base schedule, with the JAX package's (and fvcore's)
semantics. :class:`LRMultiplier` drives it as a ``LambdaLR``, so the
multiplier in effect at iteration t equals the JAX schedule's at step t.
"""

import math
from bisect import bisect_right
from typing import List

import torch

__all__ = [
    "MultiStepParamScheduler",
    "CosineParamScheduler",
    "WarmupParamScheduler",
    "LRMultiplier",
    "LazyLRMultiplier",
    "WarmupMultiStepLR",
    "WarmupCosineLR",
]


class CosineParamScheduler:
    def __init__(self, start_value: float, end_value: float):
        self._start = start_value
        self._end = end_value

    def __call__(self, where: float) -> float:
        return self._end + 0.5 * (self._start - self._end) * (1 + math.cos(math.pi * where))


class MultiStepParamScheduler:
    """Piecewise constant: ``values[i]`` from milestone ``i - 1`` on."""

    def __init__(self, values: List[float], num_updates: int, milestones: List[int]):
        milestones = list(milestones)
        if len(milestones) == len(values):  # a trailing milestone is allowed
            milestones = milestones[:-1]
        assert len(milestones) == len(values) - 1
        self._values = values
        self._milestones = milestones
        self._num_updates = num_updates

    def __call__(self, where: float) -> float:
        return self._values[bisect_right(self._milestones, int(where * self._num_updates))]


class WarmupParamScheduler:
    """A linear (or constant) warmup from ``warmup_factor * scheduler(0)``
    to ``scheduler(warmup_length)`` over the first ``warmup_length`` of
    progress, then ``scheduler``."""

    def __init__(self, scheduler, warmup_factor: float, warmup_length: float, warmup_method: str = "linear"):
        assert warmup_method in ("linear", "constant"), warmup_method
        self._scheduler = scheduler
        self._warmup_factor = warmup_factor
        self._warmup_length = warmup_length
        self._warmup_method = warmup_method

    def __call__(self, where: float) -> float:
        if where >= self._warmup_length:
            return self._scheduler(where)
        start_value = self._warmup_factor * self._scheduler(0.0)
        if self._warmup_method == "constant":
            return start_value
        end_value = self._scheduler(self._warmup_length)
        alpha = where / max(self._warmup_length, 1e-12)
        return start_value + (end_value - start_value) * alpha


class _Factor:
    """``multiplier(min(t / max_iter, 1))``: ``LambdaLR``'s function, which
    holds no reference to the scheduler (a bound method would make a cycle
    that keeps the optimizer, and so the model's parameters and their
    state, alive after a trainer is dropped, until a ``gc.collect()``)."""

    def __init__(self, multiplier, max_iter: int):
        self.multiplier = multiplier
        self.max_iter = max_iter

    def __call__(self, iteration: int) -> float:
        return self.multiplier(min(iteration / self.max_iter, 1.0))


class LRMultiplier(torch.optim.lr_scheduler.LambdaLR):
    """Each group's LR at iteration t is its initial LR times
    ``multiplier(min(t / max_iter, 1))``. Step it once per iteration, after
    ``optimizer.step()`` (the ``LRScheduler`` hook does)."""

    def __init__(self, optimizer: torch.optim.Optimizer, multiplier, max_iter: int):
        self.multiplier = multiplier
        self.max_iter = max_iter
        super().__init__(optimizer, _Factor(multiplier, max_iter))

    def state_dict(self) -> dict:
        """The iteration and the LRs; the multiplier is stateless and stays
        out, so a checkpoint holds tensors and numbers only."""
        return {"base_lrs": self.base_lrs, "last_epoch": self.last_epoch, "_last_lr": self._last_lr}

    def load_state_dict(self, state_dict: dict) -> None:
        self.__dict__.update(state_dict)


class LazyLRMultiplier:
    """A lazy config's ``lr_multiplier`` before it has an optimizer: the
    arguments of the JAX package's ``LRMultiplier(multiplier, max_iter,
    base_lr)``. :meth:`bind` makes the :class:`LRMultiplier` that steps
    ``optimizer``'s groups, each from its own initial LR: ``base_lr`` is
    accepted and the optimizer's groups carry the LR, as in d2."""

    def __init__(self, multiplier, max_iter: int, base_lr: float = 1.0):
        self.multiplier = multiplier
        self.max_iter = max_iter

    def bind(self, optimizer: torch.optim.Optimizer) -> LRMultiplier:
        return LRMultiplier(optimizer, self.multiplier, self.max_iter)


def _warmup(sched, max_iter, warmup_factor, warmup_iters, warmup_method):
    return WarmupParamScheduler(sched, warmup_factor, min(warmup_iters / max_iter, 1.0), warmup_method)


def WarmupMultiStepLR(
    optimizer: torch.optim.Optimizer,
    milestones: List[int],
    max_iter: int,
    gamma: float = 0.1,
    warmup_factor: float = 0.001,
    warmup_iters: int = 1000,
    warmup_method: str = "linear",
) -> LRMultiplier:
    """The classic detection schedule: warmup, then x ``gamma`` at each milestone."""
    values = [gamma**k for k in range(len(milestones) + 1)]
    sched = MultiStepParamScheduler(values, num_updates=max_iter, milestones=milestones)
    return LRMultiplier(optimizer, _warmup(sched, max_iter, warmup_factor, warmup_iters, warmup_method), max_iter)


def WarmupCosineLR(
    optimizer: torch.optim.Optimizer,
    max_iter: int,
    warmup_factor: float = 0.001,
    warmup_iters: int = 1000,
    warmup_method: str = "linear",
    end_lr_fraction: float = 0.0,
) -> LRMultiplier:
    """Warmup, then a cosine decay to ``end_lr_fraction`` of the base LR."""
    sched = CosineParamScheduler(1.0, end_lr_fraction)
    return LRMultiplier(optimizer, _warmup(sched, max_iter, warmup_factor, warmup_iters, warmup_method), max_iter)
