from detectron2_tpu_torch.engine import hooks
from detectron2_tpu_torch.engine.defaults import (
    DefaultPredictor,
    DefaultTrainer,
    default_argument_parser,
    default_setup,
    default_writers,
)
from detectron2_tpu_torch.engine.train_loop import HookBase, SimpleTrainer, TrainerBase

__all__ = [
    "DefaultPredictor",
    "DefaultTrainer",
    "default_argument_parser",
    "default_setup",
    "default_writers",
    "HookBase",
    "SimpleTrainer",
    "TrainerBase",
    "hooks",
]
