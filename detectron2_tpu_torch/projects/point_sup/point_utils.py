"""Point annotations in the proposal frame (counterpart of the JAX
package's ``projects/point_sup/point_utils.py:15``). Every instance carries
P point slots, padded with label -1."""

import torch

__all__ = ["get_point_coords_from_point_annotation"]


def get_point_coords_from_point_annotation(
    proposal_boxes: torch.Tensor, gt_point_coords: torch.Tensor, gt_point_labels: torch.Tensor
):
    """Proposals ``[R, 4]`` (absolute XYXY), their matched gt's points
    ``[R, P, 2]`` (absolute xy) and labels ``[R, P]`` (1, 0, -1) -> (coords
    ``[R, P, 2]`` box-relative in [0, 1], labels ``[R, P]`` in {0, 1},
    weights ``[R, P]``: 0 for padding and for points outside the proposal)."""
    x0, y0, x1, y1 = proposal_boxes.unbind(-1)
    w = (x1 - x0).clamp_min(1e-4)[:, None]
    h = (y1 - y0).clamp_min(1e-4)[:, None]
    cx = (gt_point_coords[..., 0] - x0[:, None]) / w
    cy = (gt_point_coords[..., 1] - y0[:, None]) / h
    inside = (cx >= 0) & (cx <= 1) & (cy >= 0) & (cy <= 1)
    weights = ((gt_point_labels >= 0) & inside).float()
    coords = torch.stack([cx.clamp(0.0, 1.0), cy.clamp(0.0, 1.0)], dim=-1)
    labels = gt_point_labels.clamp_min(0).float()
    return coords, labels, weights
