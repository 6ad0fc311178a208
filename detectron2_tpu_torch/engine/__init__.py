from detectron2_tpu_torch.engine import hooks
from detectron2_tpu_torch.engine.defaults import DefaultPredictor
from detectron2_tpu_torch.engine.train_loop import HookBase, SimpleTrainer, TrainerBase

__all__ = ["DefaultPredictor", "HookBase", "SimpleTrainer", "TrainerBase", "hooks"]
