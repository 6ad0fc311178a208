"""Training loop: HookBase, TrainerBase and SimpleTrainer (counterpart of
``detectron2_tpu/engine/train_loop.py``).

One step is eager PyTorch: a padded batch from the data loader, the model's
forward in training mode, the sum of its losses, backward and
``optimizer.step()``. Metrics are read back after every step (one host
sync), and a non-finite total loss raises ``FloatingPointError``. Trainers
and hooks save and load their state (``state_dict``) for the checkpointer.
"""

import gc
import logging
import math
import time
import weakref
from typing import Dict, List, Optional

import torch

from detectron2_tpu_torch.utils.events import EventStorage, get_event_storage

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

    def state_dict(self) -> Dict:
        """A hook's state to checkpoint; none by default."""
        return {}

    def load_state_dict(self, state_dict: Dict) -> None:
        pass


_DYNAMO_READY = []


def _import_dynamo_once() -> None:
    """Import ``torch._dynamo`` and collect once, with the first trainer.

    A ``torch.optim`` optimizer's first construction imports
    ``torch._dynamo``, and a ``torch.fx.wrap`` call in that import keeps its
    own frame in a local (``inspect.currentframe()``), a reference cycle
    that holds the whole stack that built the optimizer: the model and the
    trainer stay alive after they are dropped, until a ``gc.collect()``.
    Collecting once after that import frees the finished frame, so a
    dropped trainer is freed by reference counting."""
    if not _DYNAMO_READY:
        import torch._dynamo  # noqa: F401

        gc.collect()
        _DYNAMO_READY.append(True)


class TrainerBase:
    """``before_train -> {before_step, run_step, after_step} * n -> after_train``,
    inside an :class:`EventStorage` for the run, kept in ``self.storage``."""

    def __init__(self) -> None:
        _import_dynamo_once()
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
        with EventStorage(start_iter) as self.storage:
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
        # None when an outer trainer drives this one (DefaultTrainer's
        # inner SimpleTrainer): the outer loop owns the storage
        if self.storage is not None:
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

    def state_dict(self) -> Dict:
        """The iteration and, by class name, each hook's non-empty state."""
        ret = {"iteration": self.iter}
        hooks_state = {type(h).__qualname__: h.state_dict() for h in self._hooks if h.state_dict()}
        if hooks_state:
            ret["hooks"] = hooks_state
        return ret

    def load_state_dict(self, state_dict: Dict) -> None:
        self.iter = state_dict["iteration"]
        for key, value in state_dict.get("hooks", {}).items():
            for h in self._hooks:
                if type(h).__qualname__ == key:
                    h.load_state_dict(value)
                    break
            else:
                logger.warning(f"Cannot find the hook '{key}', its state_dict is ignored.")


class SimpleTrainer(TrainerBase):
    """Single-cost training of ``model`` (whose ``forward(batch, train=True)``
    returns a dict of scalar losses) with ``optimizer``, over
    ``data_loader``, any iterable of padded batch dicts. Given ``generator``,
    the model's samplers draw from it (``forward(..., generator=)``);
    otherwise from the device's default generator."""

    def __init__(
        self,
        model: torch.nn.Module,
        data_loader,
        optimizer: torch.optim.Optimizer,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.model = model
        self.data_loader = data_loader
        self.optimizer = optimizer
        self.generator = generator
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

        loss_dict = self.model(batch, train=True, generator=self.generator)
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
        storage = get_event_storage()
        storage.put_scalar("data_time", data_time)
        storage.put_scalar("total_loss", total)
        if len(metrics) > 1:
            storage.put_scalars(**metrics)

    def state_dict(self) -> Dict:
        """Adds the optimizer's state and the samplers' generator state."""
        ret = super().state_dict()
        ret["optimizer"] = self.optimizer.state_dict()
        if self.generator is not None:
            ret["generator"] = self.generator.get_state()
        return ret

    def load_state_dict(self, state_dict: Dict) -> None:
        super().load_state_dict(state_dict)
        self.optimizer.load_state_dict(state_dict["optimizer"])
        if self.generator is not None and "generator" in state_dict:
            self.generator.set_state(state_dict["generator"].cpu())
