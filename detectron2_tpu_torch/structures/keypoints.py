"""Keypoints and the heatmap decode (counterpart of
``detectron2_tpu/structures/keypoints.py:24-166``).

The decode keeps the JAX package's fixed shapes: every ``S x S`` heatmap is
upsampled bilinearly by a static factor (4) and its argmax mapped back through
the roi, where the reference resizes each roi's maps to the roi's own pixel
size (``keypoints.py:165-222`` of d2; ROADMAP C "Known differences").
"""

from typing import List

import torch

__all__ = ["Keypoints", "heatmaps_to_keypoints"]


class Keypoints:
    """``[N, K, 3]`` float32 tensor of (x, y, visibility) per keypoint of N
    instances."""

    def __init__(self, keypoints):
        device = keypoints.device if isinstance(keypoints, torch.Tensor) else torch.device("cpu")
        keypoints = torch.as_tensor(keypoints, dtype=torch.float32, device=device)
        assert keypoints.dim() == 3 and keypoints.shape[2] == 3, keypoints.shape
        self.tensor = keypoints

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def to(self, *args, **kwargs) -> "Keypoints":
        return type(self)(self.tensor.to(*args, **kwargs))

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    def __getitem__(self, item) -> "Keypoints":
        if isinstance(item, int):
            return Keypoints(self.tensor[item][None])
        return Keypoints(self.tensor[item])

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(num_instances={len(self.tensor)})"

    @staticmethod
    def cat(keypoints_list: List["Keypoints"]) -> "Keypoints":
        assert len(keypoints_list) > 0 and all(isinstance(k, Keypoints) for k in keypoints_list)
        return Keypoints(torch.cat([k.tensor for k in keypoints_list], dim=0))


def _bilinear_upsample(maps: torch.Tensor, U: int) -> torch.Tensor:
    """``[..., S, S]`` -> ``[..., U, U]``: bilinear with half-pixel centres,
    one axis at a time, as ``jax.image.resize(..., "bilinear")`` upsamples.
    Past the outer pixel centres a sample is that pixel exactly (the source
    coordinate is clamped, so its second tap has weight 0): the samples
    there tie exactly, as in the JAX package, and the argmax takes the first
    of them. ``F.interpolate`` mixes the edge pixel with itself, w0 * x + w1
    * x, which rounds and breaks such ties at random."""
    S = maps.shape[-1]
    src = ((torch.arange(U, device=maps.device, dtype=torch.float32) + 0.5) * (S / U) - 0.5).clamp(0, S - 1)
    i0 = src.floor().long()
    i1 = (i0 + 1).clamp_max(S - 1)
    w1 = src - i0
    w0 = 1 - w1
    x = maps[..., i0] * w0 + maps[..., i1] * w1
    return x[..., i0, :] * w0[:, None] + x[..., i1, :] * w1[:, None]


def heatmaps_to_keypoints(maps: torch.Tensor, rois: torch.Tensor, upsample: int = 4, chunk: int = 256) -> torch.Tensor:
    """Keypoint locations from heatmaps.

    Args:
        maps: ``[N, K, S, S]`` keypoint logits.
        rois: ``[N, 4]`` boxes.
        upsample: static bilinear upsampling factor of each map.
        chunk: rois decoded at a time, which bounds the memory of the
            ``[chunk, K, S * upsample, S * upsample]`` float32 upsample.

    Returns:
        ``[N, K, 4]`` float32 (x, y, logit, prob) in the image frame, at the
        +0.5 pixel-centre convention: the argmax of the upsampled map (the
        first index on a tie), its logit, and its softmax probability over
        the upsampled map.
    """
    maps = maps.float()
    rois = rois.float()
    N, K, S, _ = maps.shape
    U = S * upsample
    pos, max_logit, max_prob = [], [], []
    for start in range(0, N, chunk):
        m = maps[start : start + chunk]
        flat = _bilinear_upsample(m, U).reshape(m.shape[0], K, U * U)
        p = flat.argmax(dim=-1)  # the first index of the maximum, as jnp.argmax
        top = torch.gather(flat, -1, p[..., None])
        pos.append(p)
        max_logit.append(top[..., 0])
        # the softmax at the argmax: exp(0) / sum(exp(x - max))
        max_prob.append(1.0 / torch.exp(flat - top).sum(dim=-1))
    if N == 0:
        return maps.new_zeros((0, K, 4))
    pos, max_logit, max_prob = torch.cat(pos), torch.cat(max_logit), torch.cat(max_prob)
    r = rois[:, None, :]
    widths = (r[..., 2] - r[..., 0]).clamp_min(1.0)
    heights = (r[..., 3] - r[..., 1]).clamp_min(1.0)
    x = ((pos % U).float() + 0.5) / U * widths + r[..., 0]
    y = (torch.div(pos, U, rounding_mode="floor").float() + 0.5) / U * heights + r[..., 1]
    return torch.stack([x, y, max_logit, max_prob], dim=-1)
