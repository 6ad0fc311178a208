"""Trainer hooks (counterpart of ``detectron2_tpu/engine/hooks.py``):
``CallbackHook``, ``IterationTimer`` and ``LRScheduler``. Checkpoint,
evaluation and writer hooks come with ``DefaultTrainer``."""

import datetime
import logging
import time

import torch

from detectron2_tpu_torch.engine.train_loop import HookBase

__all__ = ["CallbackHook", "IterationTimer", "LRScheduler"]

logger = logging.getLogger(__name__)


class CallbackHook(HookBase):
    """A hook from callbacks, each called with the trainer."""

    def __init__(self, *, before_train=None, after_train=None, before_step=None, after_step=None):
        self._before_train = before_train
        self._before_step = before_step
        self._after_step = after_step
        self._after_train = after_train

    def before_train(self):
        if self._before_train:
            self._before_train(self.trainer)

    def after_train(self):
        if self._after_train:
            self._after_train(self.trainer)
        # the callbacks may be closures that hold the trainer
        del self._before_train, self._after_train
        del self._before_step, self._after_step

    def before_step(self):
        if self._before_step:
            self._before_step(self.trainer)

    def after_step(self):
        if self._after_step:
            self._after_step(self.trainer)


class IterationTimer(HookBase):
    """Records each step's wall time as the scalar ``time``, after
    ``warmup_iter`` steps, and logs the totals at the end. A step ends when
    ``after_step`` runs; ``SimpleTrainer`` reads its losses back first, so
    the device has finished the step's work by then."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._step_start = time.perf_counter()
        self._start_time = time.perf_counter()
        self._total_step_time = 0.0

    def before_train(self):
        self._start_time = time.perf_counter()
        self._total_step_time = 0.0

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        iter_done = self.trainer.storage.iter - self.trainer.start_iter + 1
        sec = time.perf_counter() - self._step_start
        if iter_done > self._warmup_iter:
            self._total_step_time += sec
            self.trainer.storage.put_scalars(time=sec)
        else:
            self._start_time = time.perf_counter()
            self._total_step_time = 0.0

    def after_train(self):
        total_time = time.perf_counter() - self._start_time
        num_iter = self.trainer.storage.iter + 1 - self.trainer.start_iter - self._warmup_iter
        if num_iter > 0 and self._total_step_time > 0:
            logger.info(
                "Overall training speed: %d iterations in %s (%.4f s / it)",
                num_iter, datetime.timedelta(seconds=int(self._total_step_time)), self._total_step_time / num_iter,
            )
        logger.info(
            "Total training time: %s (%s on hooks)",
            datetime.timedelta(seconds=int(total_time)),
            datetime.timedelta(seconds=int(total_time - self._total_step_time)),
        )


class LRScheduler(HookBase):
    """Records the LR of the largest parameter group as ``lr``, then steps
    the scheduler, after every step."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler: torch.optim.lr_scheduler.LRScheduler):
        self._optimizer = optimizer
        self._scheduler = scheduler
        self._group = max(range(len(optimizer.param_groups)), key=lambda i: len(optimizer.param_groups[i]["params"]))

    def after_step(self):
        lr = self._optimizer.param_groups[self._group]["lr"]
        self.trainer.storage.put_scalar("lr", lr)
        self._scheduler.step()
