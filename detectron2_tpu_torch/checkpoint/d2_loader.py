"""Load detectron2 ``.pkl`` checkpoints into the port (counterpart of
``detectron2_tpu/checkpoint/detection_checkpoint.py``).

The port's modules use d2 names and layouts, so a d2 state dict loads by
name with no mapping. Unused keys are reported both ways: checkpoint tensors
the model does not have, and model tensors the checkpoint does not hold.
"""

import logging
import pickle
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_d2_checkpoint", "load_state_dict_report"]

logger = logging.getLogger(__name__)

# buffers d2 checkpoints carry that have no tensor in the port
_IGNORED = ("pixel_mean", "pixel_std", "anchors", "cell_anchors", "num_batches_tracked")


def load_state_dict_report(model: nn.Module, state_dict: Mapping) -> str:
    """Copy every tensor whose name and shape match into ``model``; return a
    report of what was loaded, left out and left over. Raises on a shape
    mismatch or when nothing matched."""
    own = model.state_dict()
    loaded, mismatched = [], []
    with torch.no_grad():
        for name, value in state_dict.items():
            if name not in own:
                continue
            if not isinstance(value, torch.Tensor):
                value = torch.as_tensor(np.asarray(value))
            if tuple(value.shape) != tuple(own[name].shape):
                mismatched.append(f"{name}: checkpoint {tuple(value.shape)} vs model {tuple(own[name].shape)}")
                continue
            own[name].copy_(value.to(own[name].dtype))
            loaded.append(name)
    if mismatched:
        raise ValueError("shape mismatch loading checkpoint:\n" + "\n".join(mismatched))
    if not loaded:
        raise RuntimeError("checkpoint matched 0 tensors of the model")
    missing = sorted(set(own) - set(loaded))
    unused = sorted(k for k in set(state_dict) - set(loaded) if not any(s in k for s in _IGNORED))
    lines = [f"Loaded {len(loaded)}/{len(own)} tensors from the checkpoint."]
    if missing:
        lines.append(f"Not found in the checkpoint: {missing}")
    if unused:
        lines.append(f"Unused checkpoint keys: {unused}")
    report = "\n".join(lines)
    logger.info(report)
    return report


def load_d2_checkpoint(model: nn.Module, path: str) -> str:
    """Load a d2 ``.pkl`` (``{"model": {name: ndarray}}`` or a bare state
    dict) into ``model``; returns the report."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    state_dict: Dict = data.get("model", data)
    return load_state_dict_report(model, state_dict)
