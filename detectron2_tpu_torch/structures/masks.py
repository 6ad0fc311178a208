"""BitMasks: an ``[N, H, W]`` bool tensor holder (counterpart of
``detectron2_tpu/structures/masks.py:83``, the part inference results need)."""

import torch

__all__ = ["BitMasks"]


class BitMasks:
    """``tensor`` is ``[N, H, W]`` bool, one full-image mask per instance."""

    def __init__(self, tensor: torch.Tensor):
        tensor = torch.as_tensor(tensor).bool()
        assert tensor.dim() == 3, tuple(tensor.shape)
        self.tensor = tensor

    def area(self) -> torch.Tensor:
        """Pixels set in each mask, ``[N]`` int64."""
        return self.tensor.flatten(1).sum(dim=1)

    def __getitem__(self, item) -> "BitMasks":
        """An int picks one mask (still ``[1, H, W]``); a slice, an index
        tensor or a bool mask picks several."""
        if isinstance(item, int):
            return BitMasks(self.tensor[item][None])
        return BitMasks(self.tensor[item])

    def __len__(self) -> int:
        return self.tensor.shape[0]
