from detectron2_tpu_torch.engine import hooks
from detectron2_tpu_torch.engine.defaults import (
    DefaultPredictor,
    DefaultTrainer,
    default_argument_parser,
    default_setup,
    default_writers,
    eval_predictor,
)
from detectron2_tpu_torch.engine.train_loop import HookBase, SimpleTrainer, TrainerBase

__all__ = [
    "DefaultPredictor",
    "DefaultTrainer",
    "default_argument_parser",
    "default_setup",
    "default_writers",
    "eval_predictor",
    "HookBase",
    "SimpleTrainer",
    "TrainerBase",
    "hooks",
]
