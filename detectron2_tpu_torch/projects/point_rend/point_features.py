"""Point sampling (counterpart of the JAX package's
``projects/point_rend/point_features.py``).

``point_sample`` is an explicit 4-tap bilinear gather with the
align_corners=False pixel-centre convention and zeros outside the map, as
``F.grid_sample``'s defaults and the JAX function compute it;
``point_sample_fine_grained_features`` is the same gather over image-level
maps ``[B, H, W, C]``, each roi reading its own image. The top-k of the
uncertainty goes through ``ops/topk.py``: a 2x bilinear upsample leaves
many equal values, and ``torch.topk`` promises no order among them, while
``lax.top_k`` takes the lower index first. Every random draw goes through
:func:`point_draws`, so that a test can hand both packages the same numbers.
"""

from typing import Optional, Sequence, Tuple

import torch

from detectron2_tpu_torch.ops.topk import top_k

__all__ = [
    "point_sample",
    "point_sample_fine_grained_features",
    "generate_regular_grid_point_coords",
    "get_uncertain_point_coords_with_randomness",
    "get_uncertain_point_coords_on_grid",
    "get_point_coords_wrt_image",
    "point_draws",
]


def point_draws(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape``: every random point of PointRend."""
    return torch.rand(shape, generator=generator, device=device)


def _bilinear_taps(px: torch.Tensor, py: torch.Tensor, H: int, W: int, gather) -> torch.Tensor:
    """The zero-padded 4-tap bilinear sum at pixel coordinates ``px, py``
    ``[R, P]``; ``gather(yi, xi)`` reads ``[R, P, C]`` at clamped indices."""
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[..., None]
    wy = (py - y0)[..., None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return gather(yi.long().clamp(0, H - 1), xi.long().clamp(0, W - 1)) * inside[..., None]

    return (
        tap(y0, x0) * (1 - wy) * (1 - wx)
        + tap(y0, x0 + 1) * (1 - wy) * wx
        + tap(y0 + 1, x0) * wy * (1 - wx)
        + tap(y0 + 1, x0 + 1) * wy * wx
    )


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
    return _bilinear_taps(px, py, H, W, lambda yi, xi: x[rows, yi, xi])


def generate_regular_grid_point_coords(R: int, side_size: int, device=None) -> torch.Tensor:
    """The cell centres of a ``side_size`` grid in [0, 1]^2, x fastest:
    ``[R, side^2, 2]``."""
    c = (torch.arange(side_size, dtype=torch.float32, device=device) + 0.5) / side_size
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    grid = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    return grid[None].expand(R, side_size * side_size, 2)


def get_point_coords_wrt_image(boxes: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Box-relative [0, 1] points ``[R, P, 2]`` of boxes ``[R, 4]`` ->
    image coordinates."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    ax = coords[..., 0] * (x1 - x0)[:, None] + x0[:, None]
    ay = coords[..., 1] * (y1 - y0)[:, None] + y0[:, None]
    return torch.stack([ax, ay], dim=-1)


def point_sample_fine_grained_features(
    features: Sequence[torch.Tensor],
    scales: Sequence[float],
    boxes: torch.Tensor,
    batch_idx: torch.Tensor,
    coords: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear samples of image-level maps ``[B, Hl, Wl, C]`` (one a level,
    ``scales`` their 1 / stride) at box-relative points ``[R, P, 2]`` of
    boxes ``[R, 4]`` of images ``batch_idx`` ``[R]``: (``[R, P, sum C]``,
    the image coordinates ``[R, P, 2]``)."""
    abs_coords = get_point_coords_wrt_image(boxes, coords)
    b = batch_idx.long()[:, None]
    outs = []
    for feat, scale in zip(features, scales):
        _, H, W, _ = feat.shape
        # image point -> the level's pixel frame, as the JAX function rounds it
        px = abs_coords[..., 0] * scale / W * W - 0.5
        py = abs_coords[..., 1] * scale / H * H - 0.5
        outs.append(_bilinear_taps(px, py, H, W, lambda yi, xi, feat=feat: feat[b, yi, xi]))
    return torch.cat(outs, dim=-1), abs_coords


def _uncertainty(logits: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """-|logit| of each roi's class ``[R]`` in ``[R, P, C]``: most uncertain
    near 0."""
    C = logits.shape[-1]
    if C == 1:
        return -logits[..., 0].abs()
    cls = classes.clamp(0, C - 1).long()
    return -torch.gather(logits, 2, cls[:, None, None].expand(-1, logits.shape[1], 1))[..., 0].abs()


def sample_uncertain_points(uncertainty, coarse_logits, num_points, oversample_ratio, importance_sample_ratio, generator):
    """The shared draw: ``num_points * oversample_ratio`` uniform candidates
    per row of ``coarse_logits`` ``[R, h, w, C]``, the ``importance *
    num_points`` most uncertain of them by ``uncertainty`` (of the sampled
    logits ``[R, n, C]``), then fresh uniform points: ``[R, num_points, 2]``."""
    R = coarse_logits.shape[0]
    device = coarse_logits.device
    cand = point_draws((R, int(num_points * oversample_ratio), 2), generator, device)
    unc = uncertainty(point_sample(coarse_logits, cand))
    n_unc = int(importance_sample_ratio * num_points)
    _, idx = top_k(unc, n_unc)
    picked = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2))
    if num_points > n_unc:
        picked = torch.cat([picked, point_draws((R, num_points - n_unc, 2), generator, device)], dim=1)
    return picked


def get_uncertain_point_coords_with_randomness(
    coarse_logits: torch.Tensor,
    classes: torch.Tensor,
    num_points: int,
    oversample_ratio: int = 3,
    importance_sample_ratio: float = 0.75,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Training points: ``oversample_ratio * num_points`` uniform
    candidates, the ``importance_sample_ratio * num_points`` most uncertain
    of them (-|logit| of each roi's class ``[R]`` in ``coarse_logits`` ``[R,
    h, w, C]``), then fresh uniform points to ``num_points``: ``[R,
    num_points, 2]`` box-relative, drawn from ``generator``."""
    return sample_uncertain_points(
        lambda logits: _uncertainty(logits, classes), coarse_logits, num_points, oversample_ratio,
        importance_sample_ratio, generator,
    )


def get_uncertain_point_coords_on_grid(uncertainty: torch.Tensor, num_points: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_points`` most uncertain cells of ``uncertainty`` ``[R, H,
    W]``, ties to the lower index: (flat indices ``[R, N]``, their centres
    ``[R, N, 2]`` normalized)."""
    R, H, W = uncertainty.shape
    _, idx = top_k(uncertainty.reshape(R, H * W), min(num_points, H * W))
    ys = torch.div(idx, W, rounding_mode="floor").float()
    xs = (idx % W).float()
    return idx, torch.stack([(xs + 0.5) / W, (ys + 0.5) / H], dim=-1)
