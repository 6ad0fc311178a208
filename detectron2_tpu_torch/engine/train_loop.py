"""Training loop: HookBase, TrainerBase and SimpleTrainer (counterpart of
``detectron2_tpu/engine/train_loop.py``).

One step is eager PyTorch: a padded batch from the data loader, the model's
forward in training mode, the sum of its losses, backward and
``optimizer.step()``. Metrics are read back after every step (one host
sync), and a non-finite total loss raises ``FloatingPointError``.
"""

import logging
import math
import time
import weakref
from typing import Dict, List

import torch

from detectron2_tpu_torch.utils.events import EventStorage

__all__ = ["HookBase", "TrainerBase", "SimpleTrainer"]

logger = logging.getLogger(__name__)


class HookBase:
    """Called by :class:`TrainerBase` around training and around each step."""

    trainer: "TrainerBase" = None

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_backward(self):
        pass

    def after_step(self):
        pass


class TrainerBase:
    """``before_train -> {before_step, run_step, after_step} * n -> after_train``,
    with an :class:`EventStorage` for the run in ``self.storage``."""

    def __init__(self) -> None:
        self._hooks: List[HookBase] = []
        self.iter: int = 0
        self.start_iter: int = 0
        self.max_iter: int = 0
        self.storage: EventStorage = None

    def register_hooks(self, hooks) -> None:
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            if not isinstance(h, HookBase):
                raise TypeError(f"{h!r} is not a HookBase")
            # a weak reference: hooks must not keep the trainer alive
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int) -> None:
        logger.info("Starting training from iteration %d", start_iter)
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        self.storage = EventStorage(start_iter)
        try:
            self.before_train()
            for self.iter in range(start_iter, max_iter):
                self.before_step()
                self.run_step()
                self.after_step()
            # iter == max_iter tells after_train that training finished
            self.iter += 1
        except Exception:
            logger.exception("Exception during training:")
            raise
        finally:
            self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_backward(self):
        for h in self._hooks:
            h.after_backward()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError


class SimpleTrainer(TrainerBase):
    """Single-cost training of ``model`` (whose ``forward(batch, train=True)``
    returns a dict of scalar losses) with ``optimizer``, over
    ``data_loader``, any iterable of padded batch dicts."""

    def __init__(self, model: torch.nn.Module, data_loader, optimizer: torch.optim.Optimizer):
        super().__init__()
        self.model = model
        self.data_loader = data_loader
        self.optimizer = optimizer
        self._data_loader_iter_obj = None

    @property
    def _data_loader_iter(self):
        if self._data_loader_iter_obj is None:
            self._data_loader_iter_obj = iter(self.data_loader)
        return self._data_loader_iter_obj

    def run_step(self):
        start = time.perf_counter()
        batch = next(self._data_loader_iter)
        data_time = time.perf_counter() - start

        loss_dict = self.model(batch, train=True)
        losses = sum(loss_dict.values())
        self.optimizer.zero_grad(set_to_none=True)
        losses.backward()
        self.after_backward()
        self.optimizer.step()
        self._write_metrics(loss_dict, data_time)

    def _write_metrics(self, loss_dict: Dict[str, torch.Tensor], data_time: float) -> None:
        values = torch.stack([v.detach().float() for v in loss_dict.values()]).tolist()  # one host sync
        metrics = dict(zip(loss_dict, values))
        total = sum(values)
        if not math.isfinite(total):
            raise FloatingPointError(
                f"Loss became infinite or NaN at iteration={self.iter}!\nloss_dict = {metrics}"
            )
        self.storage.put_scalar("data_time", data_time)
        self.storage.put_scalar("total_loss", total)
        if len(metrics) > 1:
            self.storage.put_scalars(**metrics)
