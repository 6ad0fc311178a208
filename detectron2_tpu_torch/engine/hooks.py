"""Trainer hooks (counterpart of ``detectron2_tpu/engine/hooks.py``):
``CallbackHook``, ``IterationTimer``, ``LRScheduler``, ``PeriodicWriter``
:118, ``PeriodicCheckpointer`` :140, ``BestCheckpointer`` :158,
``EvalHook`` :267, ``PreciseBN`` :306, ``MemoryStats`` :370 and
``TorchProfiler`` (the JAX package's ``JaxProfiler`` :229 over
``torch.profiler``). ``PreciseBN`` writes the true mean of the batch
statistics (d2's and fvcore's ``update_bn_stats``), not the JAX hook's
average of one-momentum-step updates (ROADMAP C)."""

import datetime
import itertools
import logging
import math
import operator
import os
import time
from typing import Callable, List, Optional

import torch

from detectron2_tpu_torch.checkpoint import PeriodicCheckpointer as _PeriodicCheckpointer
from detectron2_tpu_torch.engine.train_loop import HookBase
from detectron2_tpu_torch.layers import get_bn_modules
from detectron2_tpu_torch.evaluation.testing import flatten_results_dict
from detectron2_tpu_torch.utils.events import EventWriter

__all__ = [
    "BestCheckpointer",
    "CallbackHook",
    "EvalHook",
    "IterationTimer",
    "LRScheduler",
    "MemoryStats",
    "PeriodicCheckpointer",
    "PeriodicWriter",
    "PreciseBN",
    "TorchProfiler",
    "update_bn_stats",
]

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
        self.trainer.storage.put_scalar("lr", lr, smoothing_hint=False)
        self._scheduler.step()

    def state_dict(self):
        return self._scheduler.state_dict()

    def load_state_dict(self, state_dict):
        self._scheduler.load_state_dict(state_dict)


class PeriodicWriter(HookBase):
    """Calls every writer's ``write`` each ``period`` iterations and at the
    last one, and ``write`` then ``close`` after training."""

    def __init__(self, writers: List[EventWriter], period: int = 20):
        for w in writers:
            assert isinstance(w, EventWriter), w
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or self.trainer.iter == self.trainer.max_iter - 1:
            for writer in self._writers:
                writer.write()

    def after_train(self):
        for writer in self._writers:
            writer.write()
            writer.close()


class PeriodicCheckpointer(HookBase):
    """Runs a :class:`checkpoint.PeriodicCheckpointer` after every step."""

    def __init__(self, checkpointer, period: int, max_iter: Optional[int] = None, max_to_keep=None, file_prefix="model"):
        self._pc = _PeriodicCheckpointer(checkpointer, period, max_iter, max_to_keep, file_prefix)

    def before_train(self):
        if self._pc.max_iter is None:
            self._pc.max_iter = self.trainer.max_iter

    def after_step(self):
        self._pc.step(self.trainer.iter)


class BestCheckpointer(HookBase):
    """Saves ``{file_prefix}.pth`` whenever the stored ``val_metric`` (put
    by an :class:`EvalHook`) beats the best so far ("max" or "min"), checked
    every ``eval_period`` iterations and after training."""

    def __init__(self, eval_period: int, checkpointer, val_metric: str, mode: str = "max", file_prefix: str = "model_best"):
        assert mode in ("max", "min")
        self._period = eval_period
        self._val_metric = val_metric
        self._compare = operator.gt if mode == "max" else operator.lt
        self._checkpointer = checkpointer
        self._file_prefix = file_prefix
        self.best_metric = None
        self.best_iter = None

    def _update_best(self, val, iteration) -> bool:
        if math.isnan(val) or math.isinf(val):
            return False
        self.best_metric, self.best_iter = val, iteration
        return True

    def _best_checking(self):
        metric_tuple = self.trainer.storage.latest().get(self._val_metric)
        if metric_tuple is None:
            logger.warning(
                f"Given val metric {self._val_metric} does not seem to be computed/stored. "
                "Will not be checkpointing based on it."
            )
            return
        latest_metric, metric_iter = metric_tuple
        if self.best_metric is None:
            if self._update_best(latest_metric, metric_iter):
                self._checkpointer.save(self._file_prefix)
                logger.info(f"Saved first model at {self.best_metric:0.5f} @ {self.best_iter} steps")
        elif self._compare(latest_metric, self.best_metric):
            self._checkpointer.save(self._file_prefix)
            logger.info(
                f"Saved best model as latest eval score for {self._val_metric} is {latest_metric:0.5f}, "
                f"better than last best score {self.best_metric:0.5f} @ iteration {self.best_iter}."
            )
            self._update_best(latest_metric, metric_iter)

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if self._period > 0 and next_iter % self._period == 0 and next_iter != self.trainer.max_iter:
            self._best_checking()

    def after_train(self):
        if self.trainer.iter + 1 >= self.trainer.max_iter:
            self._best_checking()


class EvalHook(HookBase):
    """Runs ``eval_function`` every ``eval_period`` iterations (not at the
    last one) and after training, and stores its nested dict of numbers as
    flattened scalars ("bbox/AP", ...)."""

    def __init__(self, eval_period: int, eval_function: Callable, eval_after_train: bool = True):
        self._period = eval_period
        self._func = eval_function
        self._eval_after_train = eval_after_train

    def _do_eval(self):
        results = self._func()
        if results:
            assert isinstance(results, dict), f"Eval function must return a dict. Got {results} instead."
            flattened = flatten_results_dict(results)
            for k, v in flattened.items():
                try:
                    float(v)
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        f"[EvalHook] eval_function should return a nested dict of float. Got '{k}: {v}' instead."
                    ) from e
            self.trainer.storage.put_scalars(**flattened, smoothing_hint=False)

    def after_step(self):
        next_iter = self.trainer.iter + 1
        if self._period > 0 and next_iter % self._period == 0 and next_iter != self.trainer.max_iter:
            self._do_eval()

    def after_train(self):
        # iter + 1 < max_iter: training failed; no evaluation then
        if self._eval_after_train and self.trainer.iter + 1 >= self.trainer.max_iter:
            self._do_eval()
        del self._func  # it may hold the trainer


@torch.no_grad()
def update_bn_stats(model, data_loader, num_iter: int, generator: Optional[torch.Generator] = None) -> None:
    """Set every BN with batch statistics (``get_bn_modules``) to the mean,
    over ``num_iter`` training forwards of ``model`` on batches of
    ``data_loader`` (without gradients), of its batch mean and biased batch
    variance: the running statistics start at 0 and batch ``i`` enters with
    the cumulative momentum ``i / (i + 1)`` on the kept value (flax's
    convention; ``1 / (i + 1)`` on the batch's). The samplers draw from
    ``generator``. Each BN's momentum is restored afterwards, and so is
    every other buffer of the model (a dense detector's ``loss_normalizer``):
    only the BN statistics change, as the JAX package makes only
    ``batch_stats`` mutable here."""
    bns = get_bn_modules(model)
    momenta = [bn.momentum for bn in bns]
    bn_buffers = {id(b) for bn in bns for b in bn.buffers()}
    kept = [(b, b.clone()) for b in model.buffers() if id(b) not in bn_buffers]
    for bn in bns:
        bn.running_mean.zero_()
        bn.running_var.zero_()
    done = 0
    try:
        for i, batch in enumerate(itertools.islice(data_loader, num_iter)):
            for bn in bns:
                bn.momentum = i / (i + 1)
            model({k: v for k, v in batch.items() if k != "metadata"}, train=True, generator=generator)
            done += 1
    finally:
        for bn, m in zip(bns, momenta):
            bn.momentum = m
        with torch.no_grad():
            for b, value in kept:
                b.copy_(value)
    if done != num_iter:
        raise ValueError(f"the data loader stopped after {done} of {num_iter} batches")


class PreciseBN(HookBase):
    """Recompute the running statistics of every BN with batch statistics
    after step ``period`` (every ``period`` steps; 0: never) and after the
    last step: ``num_iter`` training forwards on ``data_loader``'s batches,
    through :func:`update_bn_stats` (the samplers draw from a generator
    seeded 0 on the model's device, anew at each update, so that the
    trainer's draws are untouched). A model without such a BN disables the
    hook with a log line. The data loader is iterated at the first update
    only."""

    def __init__(self, period: int, model, data_loader, num_iter: int):
        self._disabled = not get_bn_modules(model)
        if self._disabled:
            logger.info("PreciseBN is disabled because the model has no BN layer with batch statistics.")
            return
        self._period = period
        self._model = model
        self._data_loader = data_loader
        self._num_iter = num_iter
        self._data_iter = None

    def after_step(self):
        next_iter = self.trainer.iter + 1
        is_final = next_iter == self.trainer.max_iter
        if is_final or (self._period > 0 and next_iter % self._period == 0):
            self.update_stats()

    def update_stats(self):
        if self._disabled:
            return
        if self._data_iter is None:
            self._data_iter = iter(self._data_loader)
        logger.info(f"Running precise-BN for {self._num_iter} iterations...")
        generator = torch.Generator(device=self._model.device)
        generator.manual_seed(0)
        update_bn_stats(self._model, self._data_iter, self._num_iter, generator)


class MemoryStats(HookBase):
    """Every ``period`` iterations, stores the CUDA allocator's bytes in use
    and its peak, in MiB (nothing on a CPU run)."""

    def __init__(self, period: int = 20):
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period != 0 or not torch.cuda.is_initialized():
            return
        self.trainer.storage.put_scalars(
            device_bytes_in_use=torch.cuda.memory_allocated() / 2**20,
            device_peak_bytes=torch.cuda.max_memory_allocated() / 2**20,
            smoothing_hint=False,
        )


class TorchProfiler(HookBase):
    """``torch.profiler`` (CPU, and CUDA where the card is in use) over the
    iterations where ``enable_predicate(trainer)`` holds; on leaving them it
    writes a chrome trace ``profiler-trace-iter{N}.json`` to ``output_dir``."""

    def __init__(self, enable_predicate: Callable, output_dir: str):
        self._enable_predicate = enable_predicate
        self._output_dir = output_dir
        self._profiler = None

    def before_step(self):
        if self._profiler is None and self._enable_predicate(self.trainer):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_initialized():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()

    def after_step(self):
        if self._profiler is not None and not self._enable_predicate(self.trainer):
            self._stop()

    def after_train(self):
        if self._profiler is not None:
            self._stop()

    def _stop(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._profiler.__exit__(None, None, None)
        os.makedirs(self._output_dir, exist_ok=True)
        path = os.path.join(self._output_dir, f"profiler-trace-iter{self.trainer.iter}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info(f"Saved profiler trace to {path}")
