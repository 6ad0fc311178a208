"""Deformable convolution v1 and v2 (counterpart of
``detectron2_tpu/ops/deform_conv.py``).

The JAX op is XLA with no Pallas kernel: a bilinear gather at the offset
sample locations into an im2col tensor, then one grouped product. This is
the same formulation in plain PyTorch, with the JAX op's semantics:

- input NHWC ``[B, H, W, C]``; offsets ``[B, Ho, Wo, 2 * dg * K]``, per
  deformable group and tap the pair (dy, dx); weight HWIO
  ``[kh, kw, C // groups, Cout]``;
- a corner outside the map contributes 0;
- the modulation mask (v2) multiplies the sampled values, after sampling;
- the sample coordinates, bilinear weights and the im2col tensor are float32
  (float64 for a float64 input), as the JAX op's type promotion makes them;
  the product runs in that type and is cast once to the input's dtype, then
  the bias is added.

With ``groups`` > 1 the product groups the weight as d2 and a grouped
convolution do (output channel o reads input group ``o // (Cout /
groups)``). The JAX op reshapes the HWIO weight to ``[K, groups, C /
groups, Cout / groups]``, which mixes the groups (ROADMAP C): on the
weight whose ``[C / groups, groups, Cout / groups]`` axes are swapped to
``[groups, C / groups, Cout / groups]`` it computes what this op computes.

Two things differ from the JAX formulation and change no number:

- each deformable group gathers its own ``C / dg`` channels (the JAX op
  gathers all C for every group and keeps its slice through an identity
  einsum), so the im2col tensor is ``dg`` times smaller;
- under autograd the op is recomputed in the backward
  (``torch.utils.checkpoint``): the four corner gathers of a stage of R50 at
  16 x 800x1344 would keep tens of GiB alive for the backward, and the
  recompute keeps only the inputs.
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["deform_conv2d"]


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    weight: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    groups: int = 1,
    deformable_groups: int = 1,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deformable conv (v1), or modulated deformable conv (v2) when ``mask``
    is given.

    Args:
        x: ``[B, H, W, C]``.
        offset: ``[B, Ho, Wo, 2 * deformable_groups * kh * kw]``; per tap (dy, dx).
        weight: ``[kh, kw, C // groups, Cout]``.
        mask: optional ``[B, Ho, Wo, deformable_groups * kh * kw]`` modulation
            (already through the caller's sigmoid).
        bias: optional ``[Cout]``.

    Returns:
        ``[B, Ho, Wo, Cout]`` in ``x``'s dtype.
    """
    args = (x, offset, weight, mask, stride, padding, dilation, groups, deformable_groups, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, offset, weight, mask, bias)):
        return checkpoint(_deform_conv2d, *args, use_reentrant=False)
    return _deform_conv2d(*args)


def _deform_conv2d(x, offset, weight, mask, stride, padding, dilation, groups, deformable_groups, bias):
    B, H, W, C = x.shape
    kh, kw, cin_g, Cout = weight.shape
    assert C % groups == 0 and cin_g == C // groups, (x.shape, weight.shape, groups)
    dg = deformable_groups
    assert C % dg == 0, (C, dg)
    K, Cdg = kh * kw, C // dg
    Ho = (H + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    assert offset.shape == (B, Ho, Wo, 2 * dg * K), (offset.shape, (B, Ho, Wo, 2 * dg * K))
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device

    # the sampling grid of every output position and tap, [Ho, Wo, K]
    ys = torch.arange(Ho, dtype=ct, device=dev) * stride - padding
    xs = torch.arange(Wo, dtype=ct, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=ct, device=dev) * dilation
    kx = torch.arange(kw, dtype=ct, device=dev) * dilation
    base_y = (ys[:, None, None, None] + ky[None, None, :, None]).expand(Ho, Wo, kh, kw).reshape(Ho, Wo, K)
    base_x = (xs[None, :, None, None] + kx[None, None, None, :]).expand(Ho, Wo, kh, kw).reshape(Ho, Wo, K)

    off = offset.reshape(B, Ho, Wo, dg, K, 2).to(ct)
    samp_y = base_y[None, :, :, None, :] + off[..., 0]  # [B, Ho, Wo, dg, K]
    samp_x = base_x[None, :, :, None, :] + off[..., 1]
    y0 = torch.floor(samp_y)
    x0 = torch.floor(samp_x)
    fy = samp_y - y0
    fx = samp_x - x0
    y0i = y0.long()
    x0i = x0.long()

    # row (pixel * dg + group) of each group's own channel slice
    flat = x.reshape(B * H * W * dg, Cdg)
    base = (torch.arange(B, device=dev) * (H * W)).view(B, 1, 1, 1, 1)
    group = torch.arange(dg, device=dev).view(1, 1, 1, dg, 1)

    def corner(yi, xi, w):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        rows = (base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)) * dg + group
        g = flat.index_select(0, rows.reshape(-1)).view(B, Ho, Wo, dg, K, Cdg)
        return g * torch.where(inside, w, torch.zeros_like(w))[..., None]

    val = (
        corner(y0i, x0i, (1 - fy) * (1 - fx))
        + corner(y0i, x0i + 1, (1 - fy) * fx)
        + corner(y0i + 1, x0i, fy * (1 - fx))
        + corner(y0i + 1, x0i + 1, fy * fx)
    )  # [B, Ho, Wo, dg, K, Cdg]
    if mask is not None:
        val = val * mask.reshape(B, Ho, Wo, dg, K)[..., None]

    # im2col [N, K, C] (C group-major), then the grouped product
    val = val.transpose(3, 4).reshape(B * Ho * Wo, K, groups, cin_g)
    w2 = weight.reshape(K, cin_g, groups, Cout // groups).transpose(1, 2).to(ct)
    out = torch.einsum("nkgi,kgio->ngo", val, w2).reshape(B, Ho, Wo, Cout).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out

