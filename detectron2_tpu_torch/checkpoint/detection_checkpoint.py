"""Checkpoints of training runs (counterpart of
``detectron2_tpu/checkpoint/detection_checkpoint.py:30-190``): save, load
and resume with the ``last_checkpoint`` tag, a d2 ``.pkl`` as initial
weights, and periodic saves.

A checkpoint is ``{save_dir}/{name}.pth``, written with ``torch.save``:

    {"model": model.state_dict(),
     each checkpointable: its state_dict() (a trainer's holds "iteration",
         "optimizer", the samplers' "generator" state and the hooks' states,
         among them the LR scheduler's),
     plus what the caller adds ("iteration" for periodic saves)}

Loads map every tensor to the model's device. A ``.pkl`` is a d2 zoo file
loaded by name (``load_d2_checkpoint``); one that matches no tensor of the
model raises.
"""

import logging
import os
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from detectron2_tpu_torch.checkpoint.d2_loader import load_d2_checkpoint, load_state_dict_report

__all__ = ["Checkpointer", "DetectionCheckpointer", "PeriodicCheckpointer"]

logger = logging.getLogger(__name__)


class Checkpointer:
    """Saves and loads ``model`` and the ``checkpointables`` (objects with
    ``state_dict`` / ``load_state_dict``) under ``save_dir``."""

    def __init__(self, model: nn.Module, save_dir: str = "", **checkpointables):
        self.model = model
        self.save_dir = save_dir
        self.checkpointables = dict(checkpointables)
        self.last_report = None

    def _device(self) -> torch.device:
        return next(iter(self.model.state_dict().values())).device

    def save(self, name: str, **kwargs) -> None:
        """Write ``{save_dir}/{name}.pth`` and tag it as the last checkpoint."""
        if not self.save_dir:
            return
        data: Dict[str, Any] = {"model": self.model.state_dict()}
        for key, obj in self.checkpointables.items():
            data[key] = obj.state_dict()
        data.update(kwargs)
        basename = f"{name}.pth"
        save_file = os.path.join(self.save_dir, basename)
        os.makedirs(self.save_dir, exist_ok=True)
        logger.info(f"Saving checkpoint to {save_file}")
        torch.save(data, save_file)
        self.tag_last_checkpoint(basename)

    def load(self, path: str, checkpointables: Optional[List[str]] = None) -> Dict[str, Any]:
        """Load ``path`` into the model and the named checkpointables (all
        of them when None); returns what is left of the checkpoint (e.g.
        "iteration"). An empty path loads nothing."""
        if not path:
            logger.info("No checkpoint given; the model keeps its initialization.")
            return {}
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Checkpoint {path} not found!")
        logger.info(f"Loading checkpoint from {path}")
        if path.endswith(".pkl"):
            self.last_report = load_d2_checkpoint(self.model, path)
            return {}
        data = torch.load(path, map_location=self._device(), weights_only=True)
        self.last_report = load_state_dict_report(self.model, data.pop("model"))
        for key in list(self.checkpointables) if checkpointables is None else checkpointables:
            if key in data:
                self.checkpointables[key].load_state_dict(data.pop(key))
        return data

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def get_checkpoint_file(self) -> str:
        """The last checkpoint saved in ``save_dir``, or "" without one."""
        try:
            with open(os.path.join(self.save_dir, "last_checkpoint")) as f:
                last_saved = f.read().strip()
        except OSError:
            return ""
        return os.path.join(self.save_dir, last_saved)

    def resume_or_load(self, path: str, *, resume: bool = True) -> Dict[str, Any]:
        """With ``resume`` and a checkpoint in ``save_dir``: load the last
        one, checkpointables included. Otherwise load ``path`` as weights
        only."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file())
        return self.load(path, checkpointables=[])

    def tag_last_checkpoint(self, last_filename_basename: str) -> None:
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(last_filename_basename)


class DetectionCheckpointer(Checkpointer):
    """The checkpointer of detection models: d2 ``.pkl`` zoo files load by
    name (the port's modules keep d2's names), port checkpoints by
    ``torch.load``. One process writes (the distributed slice is ROADMAP
    A6)."""


class PeriodicCheckpointer:
    """Saves ``{file_prefix}_{iteration:07d}`` every ``period`` iterations
    and ``{file_prefix}_final`` at the last one, keeping the newest
    ``max_to_keep`` periodic files when it is set."""

    def __init__(
        self,
        checkpointer: Checkpointer,
        period: int,
        max_iter: Optional[int] = None,
        max_to_keep: Optional[int] = None,
        file_prefix: str = "model",
    ):
        self.checkpointer = checkpointer
        self.period = int(period)
        self.max_iter = max_iter
        self.max_to_keep = max_to_keep
        self.recent_checkpoints: List[str] = []
        self.file_prefix = file_prefix

    def step(self, iteration: int, **kwargs) -> None:
        iteration = int(iteration)
        additional_state = {"iteration": iteration, **kwargs}
        if (iteration + 1) % self.period == 0:
            self.checkpointer.save(f"{self.file_prefix}_{iteration:07d}", **additional_state)
            if self.max_to_keep is not None:
                self.recent_checkpoints.append(self.checkpointer.get_checkpoint_file())
                if len(self.recent_checkpoints) > self.max_to_keep:
                    file_to_delete = self.recent_checkpoints.pop(0)
                    if os.path.exists(file_to_delete) and not file_to_delete.endswith(f"{self.file_prefix}_final.pth"):
                        os.remove(file_to_delete)
        if self.max_iter is not None and iteration >= self.max_iter - 1:
            self.checkpointer.save(f"{self.file_prefix}_final", **additional_state)
