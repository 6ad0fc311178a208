"""BoxMode and Boxes (counterparts of ``detectron2_tpu/structures/boxes.py``:
``BoxMode`` whole, and of ``Boxes`` :120 the part inference results need)."""

import math
from enum import IntEnum, unique
from typing import Tuple

import numpy as np
import torch

__all__ = ["BoxMode", "Boxes"]


@unique
class BoxMode(IntEnum):
    """Ways to represent a box; the values are d2's, so serialized datasets
    interoperate."""

    XYXY_ABS = 0
    """(x0, y0, x1, y1) in absolute floating point coordinates."""
    XYWH_ABS = 1
    """(x0, y0, w, h) in absolute floating point coordinates."""
    XYXY_REL = 2
    """Not supported: (x0, y0, x1, y1) in [0, 1] relative to the image size."""
    XYWH_REL = 3
    """Not supported: (x0, y0, w, h) in [0, 1] relative to the image size."""
    XYWHA_ABS = 4
    """(xc, yc, w, h, a) in absolute coordinates; the angle a in ccw degrees."""

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode"):
        """Convert a k-tuple/list, an ``[N, k]`` numpy array or an ``[N, k]``
        tensor (k = 4 or 5) between modes; returns the input's container
        type. The relative modes raise, as in d2."""
        if from_mode == to_mode:
            return box
        original_type = type(box)
        single_box = isinstance(box, (list, tuple))
        if single_box:
            assert len(box) in (4, 5), (
                "BoxMode.convert takes either a k-tuple/list or an Nxk array/tensor, where k == 4 or 5"
            )
            arr = torch.tensor(box, dtype=torch.float64)[None, :]
        elif isinstance(box, np.ndarray):
            arr = torch.from_numpy(np.asarray(box)).clone()
        else:
            arr = box.clone()
        assert to_mode not in (BoxMode.XYXY_REL, BoxMode.XYWH_REL) and from_mode not in (
            BoxMode.XYXY_REL,
            BoxMode.XYWH_REL,
        ), "Relative mode not yet supported!"

        original_dtype = arr.dtype
        if from_mode == BoxMode.XYWHA_ABS and to_mode == BoxMode.XYXY_ABS:
            assert arr.shape[-1] == 5, "The last dimension of input shape must be 5 for XYWHA format"
            arr = arr.double()
            cx, cy, w, h, a = arr.unbind(-1)
            c = torch.abs(torch.cos(a * math.pi / 180.0))
            s = torch.abs(torch.sin(a * math.pi / 180.0))
            # the horizontal bounding rectangle of the rotated box
            new_w, new_h = c * w + s * h, c * h + s * w
            x0, y0 = cx - new_w / 2.0, cy - new_h / 2.0
            arr = torch.stack([x0, y0, x0 + new_w, y0 + new_h], dim=-1).to(original_dtype)
        elif from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYWHA_ABS:
            arr = arr.double()
            cx, cy = arr[:, 0] + arr[:, 2] / 2.0, arr[:, 1] + arr[:, 3] / 2.0
            arr = torch.stack([cx, cy, arr[:, 2], arr[:, 3], torch.zeros_like(cx)], dim=-1).to(original_dtype)
        elif to_mode == BoxMode.XYXY_ABS and from_mode == BoxMode.XYWH_ABS:
            arr = torch.stack([arr[:, 0], arr[:, 1], arr[:, 0] + arr[:, 2], arr[:, 1] + arr[:, 3]], dim=-1)
        elif from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            arr = torch.stack([arr[:, 0], arr[:, 1], arr[:, 2] - arr[:, 0], arr[:, 3] - arr[:, 1]], dim=-1)
        else:
            raise NotImplementedError(f"Conversion from BoxMode {from_mode} to {to_mode} is not supported yet")

        if single_box:
            return original_type(arr.flatten().tolist())
        if isinstance(box, np.ndarray):
            return arr.numpy()
        return arr


class Boxes:
    """``tensor`` is ``[N, 4]`` float (x0, y0, x1, y1) in absolute pixels."""

    def __init__(self, tensor: torch.Tensor):
        tensor = torch.as_tensor(tensor, dtype=torch.float32)
        if tensor.numel() == 0:
            tensor = tensor.reshape(-1, 4)
        assert tensor.dim() == 2 and tensor.shape[-1] == 4, tuple(tensor.shape)
        self.tensor = tensor

    def area(self) -> torch.Tensor:
        b = self.tensor
        return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])

    def clip(self, box_size: Tuple[int, int]) -> None:
        """Clip, in place, to an image of size (h, w)."""
        h, w = box_size
        b = self.tensor
        self.tensor = torch.stack(
            [b[:, 0].clamp(0, w), b[:, 1].clamp(0, h), b[:, 2].clamp(0, w), b[:, 3].clamp(0, h)], dim=-1
        )

    def __getitem__(self, item) -> "Boxes":
        """An int picks one box (still ``[1, 4]``); a slice, an index tensor
        or a bool mask picks several."""
        if isinstance(item, int):
            return Boxes(self.tensor[item][None, :])
        return Boxes(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]
