"""Point sampling (counterpart of the JAX package's
``projects/point_rend/point_features.py:26`` ``point_sample``; the rest of
PointRend is ROADMAP A10).

``point_sample`` is an explicit 4-tap bilinear gather with the
align_corners=False pixel-centre convention and zeros outside the map, as
``F.grid_sample``'s defaults and the JAX function compute it.
"""

import torch

__all__ = ["point_sample"]


def point_sample(x: torch.Tensor, coords: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample per-roi maps at normalized points.

    Args:
        x: ``[R, H, W, C]`` maps.
        coords: ``[R, P, 2]`` (x, y) in [0, 1]; pixel i's centre is at
            ``(i + 0.5) / size``.
        mode: "bilinear", or "nearest" (for label maps).

    Returns:
        ``[R, P, C]`` in ``x``'s dtype promoted with float32.
    """
    R, H, W, C = x.shape
    px = coords[..., 0].float() * W - 0.5
    py = coords[..., 1].float() * H - 0.5
    rows = torch.arange(R, device=x.device)[:, None]
    if mode == "nearest":
        yi = torch.round(py).long().clamp(0, H - 1)
        xi = torch.round(px).long().clamp(0, W - 1)
        return x[rows, yi, xi]
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = x[rows, yi.long().clamp(0, H - 1), xi.long().clamp(0, W - 1)]  # [R, P, C]
        return v * inside[..., None]

    return (
        tap(y0, x0) * (1 - wy) * (1 - wx)
        + tap(y0, x0 + 1) * (1 - wy) * wx
        + tap(y0 + 1, x0) * wy * (1 - wx)
        + tap(y0 + 1, x0 + 1) * wy * wx
    )
