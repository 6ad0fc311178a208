"""Boxes: an ``[N, 4]`` XYXY tensor holder (counterpart of
``detectron2_tpu/structures/boxes.py:120``, the part inference results need)."""

from typing import Tuple

import torch

__all__ = ["Boxes"]


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
