"""Batch collation (counterpart of ``PaddedBatchCollator``,
``detectron2_tpu/data/build.py:199``, for images only)."""

from typing import Dict, List

import torch

__all__ = ["PaddedBatchCollator"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


class PaddedBatchCollator:
    """Pad ``[h, w, C]`` images into one ``[B, H, W, C]`` batch, H and W
    rounded up to ``size_divisibility`` and then to ``size_bucket``. A
    positive ``square_size`` pads to that fixed square first (ViT backbones:
    ``padding_constraints["square_size"]``), as the JAX package's
    ``ImageList.from_tensors`` does."""

    def __init__(
        self, size_divisibility: int = 32, size_bucket: int = 32, pad_value: float = 0.0, square_size: int = 0
    ):
        self.size_divisibility = size_divisibility
        self.size_bucket = size_bucket
        self.pad_value = pad_value
        self.square_size = square_size

    def __call__(self, images: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        sizes = [(im.shape[0], im.shape[1]) for im in images]
        max_h, max_w = max(s[0] for s in sizes), max(s[1] for s in sizes)
        if self.square_size > 0:
            if max(max_h, max_w) > self.square_size:
                raise ValueError(f"an image of {max_h}x{max_w} does not fit the {self.square_size} square")
            max_h = max_w = self.square_size
        H = _round_up(_round_up(max_h, self.size_divisibility), self.size_bucket)
        W = _round_up(_round_up(max_w, self.size_divisibility), self.size_bucket)
        first = images[0]
        batch = torch.full(
            (len(images), H, W, first.shape[2]), self.pad_value, dtype=first.dtype, device=first.device
        )
        for i, im in enumerate(images):
            batch[i, : im.shape[0], : im.shape[1]] = im
        image_sizes = torch.tensor(sizes, dtype=torch.int32, device=first.device)
        return {"image": batch, "image_sizes": image_sizes}
