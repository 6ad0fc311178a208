"""Box head (counterpart of ``detectron2_tpu/modeling/roi_heads/box_head.py``).

The FPN head is 0 convs + 2 fc, ViTDet's 4 convs with LayerNorm + 1 fc. The
convs run in the input's dtype. Pooled features ``[R, h, w, C]`` are
flattened in CHW order, the layout of d2's fc1 weight. The fc layers run in
float32: flax's Dense promotes a bf16 input with its float32 kernel, so the
JAX package runs them in float32 too.
"""

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers import Conv2d, get_norm

__all__ = ["FastRCNNConvFCHead", "build_box_head"]


class FastRCNNConvFCHead(nn.Module):
    def __init__(self, in_channels: int, resolution: int, fc_dims=(1024, 1024), conv_dims=(), conv_norm: str = ""):
        super().__init__()
        self.conv_dims = tuple(conv_dims)
        self.fc_dims = tuple(fc_dims)
        for i, dim in enumerate(self.conv_dims):
            self.add_module(
                f"conv{i + 1}",
                Conv2d(in_channels, dim, 3, padding=1, bias=not conv_norm,
                       norm=get_norm(conv_norm, dim), activation=F.relu),
            )
            in_channels = dim
        in_dim = in_channels * resolution * resolution
        for i, dim in enumerate(self.fc_dims):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim, dim))
            in_dim = dim

    @property
    def output_dim(self) -> int:
        return self.fc_dims[-1]

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x: ``[R, h, w, C]`` -> ``[R, output_dim]`` float32; ``train``
        selects batch statistics in the convs' norms (over every roi of
        ``x``, padded slots included, as in the JAX package)."""
        x = x.permute(0, 3, 1, 2)
        for i in range(len(self.conv_dims)):
            x = getattr(self, f"conv{i + 1}")(x, train)
        x = x.reshape(x.shape[0], -1).float()
        for i in range(len(self.fc_dims)):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


def build_box_head(cfg, in_channels: int) -> FastRCNNConvFCHead:
    h = cfg.MODEL.ROI_BOX_HEAD
    if h.NAME not in ("", "FastRCNNConvFCHead") or not h.NUM_FC:
        raise NotImplementedError("only FastRCNNConvFCHead with at least one fc is ported yet")
    return FastRCNNConvFCHead(
        in_channels, h.POOLER_RESOLUTION, [h.FC_DIM] * h.NUM_FC, [h.CONV_DIM] * h.NUM_CONV, h.NORM
    )
