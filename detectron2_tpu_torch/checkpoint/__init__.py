from detectron2_tpu_torch.checkpoint.d2_loader import load_d2_checkpoint, load_state_dict_report
from detectron2_tpu_torch.checkpoint.detection_checkpoint import (
    Checkpointer,
    DetectionCheckpointer,
    PeriodicCheckpointer,
)
from detectron2_tpu_torch.checkpoint.jax_params import convert_jax_params, flax_path_to_d2_name

__all__ = [
    "Checkpointer",
    "DetectionCheckpointer",
    "PeriodicCheckpointer",
    "load_d2_checkpoint",
    "load_state_dict_report",
    "convert_jax_params",
    "flax_path_to_d2_name",
]
