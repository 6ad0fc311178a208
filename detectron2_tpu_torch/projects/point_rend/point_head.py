"""Point heads (counterpart of the JAX package's
``projects/point_rend/point_head.py``): the per-point MLP over fine-grained
and coarse features, and Implicit PointRend's MLP whose weights each
instance predicts.

d2's names and layouts: the layers are ``Conv1d`` weights ``[out, in, 1]``
(``fc1`` .. ``fcN``, ``predictor``) applied point-major to ``[R, P, C]``,
and Implicit PointRend's Gaussian matrix ``[2, 128]`` is the head's buffer
``positional_encoding_gaussian_matrix``. Both heads run in float32, as the
JAX heads do (their inputs are float32 samples).
"""

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detectron2_tpu_torch.layers.losses import binary_cross_entropy_with_logits
from detectron2_tpu_torch.utils.registry import Registry

POINT_HEAD_REGISTRY = Registry("POINT_HEAD")

__all__ = ["POINT_HEAD_REGISTRY", "StandardPointHead", "ImplicitPointHead", "build_point_head", "roi_mask_point_loss"]


def _pointwise(layer: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 ``Conv1d`` on point-major ``[R, P, Cin]``."""
    return F.linear(x, layer.weight[..., 0], layer.bias)


@POINT_HEAD_REGISTRY.register()
class StandardPointHead(nn.Module):
    """``num_fc`` layers with ReLU and a predictor; the coarse prediction is
    joined to every layer's input with ``coarse_pred_each_layer``, else to
    the first only."""

    def __init__(self, in_channels: int, num_classes: int, fc_dim: int = 256, num_fc: int = 3,
                 coarse_pred_each_layer: bool = True, cls_agnostic: bool = False):
        super().__init__()
        num_coarse = 1 if cls_agnostic else num_classes
        self.num_fc = num_fc
        self.coarse_pred_each_layer = coarse_pred_each_layer
        cin = in_channels + num_coarse
        for k in range(num_fc):
            fc = nn.Conv1d(cin, fc_dim, kernel_size=1)
            nn.init.kaiming_normal_(fc.weight, mode="fan_out", nonlinearity="relu")
            nn.init.zeros_(fc.bias)
            self.add_module(f"fc{k + 1}", fc)
            cin = fc_dim + (num_coarse if coarse_pred_each_layer else 0)
        self.predictor = nn.Conv1d(cin, num_coarse, kernel_size=1)
        nn.init.normal_(self.predictor.weight, std=0.001)
        nn.init.zeros_(self.predictor.bias)

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "StandardPointHead":
        h = cfg.MODEL.POINT_HEAD
        return cls(in_channels, h.NUM_CLASSES, h.FC_DIM, h.NUM_FC, h.COARSE_PRED_EACH_LAYER, h.CLS_AGNOSTIC_MASK)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
        """fine ``[R, P, Cf]``, coarse ``[R, P, C]`` -> point logits ``[R,
        P, C]`` float32."""
        fine, coarse = fine.float(), coarse.float()
        x = torch.cat([fine, coarse], dim=-1)
        for k in range(self.num_fc):
            x = F.relu(_pointwise(getattr(self, f"fc{k + 1}"), x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], dim=-1)
        return _pointwise(self.predictor, x)


@POINT_HEAD_REGISTRY.register()
class ImplicitPointHead(nn.Module):
    """A per-point MLP whose weights and biases come from each instance's
    parameter vector ``[R, num_params]`` (all weights first, then all
    biases; each weight ``[out, in]``), over the Fourier features of the
    point coordinates (a fixed Gaussian matrix) and the sampled image
    features; one batched product a layer."""

    def __init__(self, num_classes: int, num_fc: int = 3, channels: int = 256, image_feature_channels: int = 256,
                 image_feature_enabled: bool = True, positional_encoding_enabled: bool = True, cls_agnostic: bool = False):
        super().__init__()
        self.num_layers = num_fc + 1
        assert self.num_layers >= 2
        self.channels = channels
        self.num_outputs = 1 if cls_agnostic else num_classes
        self.image_feature_enabled = image_feature_enabled
        self.positional_encoding_enabled = positional_encoding_enabled
        self.in_channels = image_feature_channels if image_feature_enabled else 0
        if positional_encoding_enabled:
            self.in_channels += 256
            self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, 128)))
        assert self.in_channels > 0

    @classmethod
    def from_config(cls, cfg, in_channels: int) -> "ImplicitPointHead":
        h, imp = cfg.MODEL.POINT_HEAD, cfg.MODEL.IMPLICIT_POINTREND
        return cls(h.NUM_CLASSES, h.NUM_FC, h.FC_DIM, in_channels, imp.IMAGE_FEATURE_ENABLED, imp.POS_ENC_ENABLED,
                   h.CLS_AGNOSTIC_MASK)

    def _layer_shapes(self) -> List[Tuple[int, int]]:
        """(in, out) of each layer."""
        return [
            (self.in_channels if k == 0 else self.channels, self.num_outputs if k == self.num_layers - 1 else self.channels)
            for k in range(self.num_layers)
        ]

    @property
    def num_params(self) -> int:
        return sum(cin * cout + cout for cin, cout in self._layer_shapes())

    def forward(self, fine: torch.Tensor, point_coords: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
        """fine ``[R, P, Cf]``, box-relative points ``[R, P, 2]`` and the
        instances' parameters ``[R, num_params]`` -> ``[R, P, outputs]``
        float32."""
        R, P = point_coords.shape[:2]
        feats = []
        if self.positional_encoding_enabled:
            loc = (2.0 * point_coords.reshape(-1, 2).float() - 1.0) @ self.positional_encoding_gaussian_matrix
            loc = 2.0 * math.pi * loc
            feats.append(torch.cat([torch.sin(loc), torch.cos(loc)], dim=-1).reshape(R, P, 256))
        if self.image_feature_enabled:
            feats.append(fine.float())
        x = torch.cat(feats, dim=-1)
        shapes = self._layer_shapes()
        sizes = [cin * cout for cin, cout in shapes] + [cout for _, cout in shapes]
        chunks = torch.split(parameters.float(), sizes, dim=1)
        for k, (cin, cout) in enumerate(shapes):
            w = chunks[k].reshape(R, cout, cin)
            b = chunks[self.num_layers + k].reshape(R, 1, cout)
            x = torch.einsum("rpc,rdc->rpd", x, w) + b
            if k < self.num_layers - 1:
                x = F.relu(x)
        return x


def roi_mask_point_loss(point_logits: torch.Tensor, gt_classes: torch.Tensor, gt_point_labels: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy at the sampled points of each roi's class
    (``[R, P, C or 1]`` logits, classes ``[R]``, {0, 1} labels ``[R, P]``),
    a mean over the valid rois' points."""
    C = point_logits.shape[-1]
    if C == 1:
        sel = point_logits[..., 0]
    else:
        cls = gt_classes.clamp(0, C - 1).long()
        sel = torch.gather(point_logits, 2, cls[:, None, None].expand(-1, point_logits.shape[1], 1))[..., 0]
    bce = binary_cross_entropy_with_logits(sel, gt_point_labels.float())
    w = valid.float()[:, None]
    return (bce * w).sum() / (w.sum() * point_logits.shape[1]).clamp_min(1.0)


def build_point_head(cfg, in_channels: int) -> nn.Module:
    """``POINT_HEAD.NAME`` of ``POINT_HEAD_REGISTRY`` over ``in_channels``
    sampled feature channels."""
    return POINT_HEAD_REGISTRY.get(cfg.MODEL.POINT_HEAD.NAME).from_config(cfg, in_channels)
