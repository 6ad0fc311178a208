"""``swap_align2nat`` (counterpart of the JAX package's
``projects/tensormask/layers.py``; d2's ``SwapAlign2Nat``, a CUDA kernel
there).

It takes sliding-window masks from the *aligned* form (each location's
``[V, U]`` window in its own frame, on the fine grid) to the *natural* one
(a ``[V*λ, U*λ]`` window on a λ-times coarser grid): ``out[n, y, x, v, u]``
samples the input quadrilinearly at

    oy = y·λ + v − V·λ/2 + 0.5,   ox = x·λ + u − U·λ/2 + 0.5   (H, W axes)
    ov = (v + 0.5)/λ − 0.5,       ou = (u + 0.5)/λ − 0.5       (V, U axes)

with ``pad_val`` for every tap outside the tensor. The taps of (y, v) and
those of (x, u) are independent, and so are their weights and in-range
masks, so the sixteen taps factor into two passes of four: a gather over
(H, V) per output (v, y), weighted, then one over (W, U) per (u, x). With
``s_yv`` and ``s_xu`` the summed in-range weights of each pass, the padding
adds ``pad_val * (1 - s_yv * s_xu)``. Plain PyTorch; the gradient is
autograd's.
"""

from typing import Tuple

import torch
from torch import nn

__all__ = ["swap_align2nat", "SwapAlign2Nat"]


def _axis_taps(pos, win, size: int, wsize: int):
    """The four (position, window) taps of one axis pair: for each, the
    clamped position and window indices and the weight, zero where either
    index falls outside the tensor."""
    pf, wf = torch.floor(pos), torch.floor(win)
    pw, ww = pos - pf, win - wf
    pf, wf = pf.long(), wf.long()
    taps = []
    for pi, pwt in ((pf, 1.0 - pw), (pf + 1, pw)):
        for wi, wwt in ((wf, 1.0 - ww), (wf + 1, ww)):
            ok = (pi >= 0) & (pi < size) & (wi >= 0) & (wi < wsize)
            taps.append((pi.clamp(0, size - 1), wi.clamp(0, wsize - 1), torch.where(ok, pwt * wwt, torch.zeros_like(pwt))))
    return taps


def swap_align2nat(x: torch.Tensor, lambda_val: int, pad_val: float = -6.0, vu_shape: Tuple[int, int] = None) -> torch.Tensor:
    """
    Args:
        x: ``[N, H, W, V*U]`` aligned mask logits (NHWC).
        lambda_val: the unit-length ratio λ >= 1.
        vu_shape: ``(V, U)``; a square window ``V = U = sqrt(C)`` by default.
    Returns:
        ``[N, ceil(H/λ), ceil(W/λ), (V*λ)*(U*λ)]`` natural mask logits, in
        ``x``'s dtype.
    """
    N, H, W, C = x.shape
    V, U = vu_shape if vu_shape is not None else (int(round(C**0.5)),) * 2
    assert V * U == C, (V, U, C)
    lam = int(lambda_val)
    Vo, Uo, Ho, Wo = V * lam, U * lam, -(-H // lam), -(-W // lam)
    f32 = dict(dtype=torch.float32, device=x.device)
    v, u = torch.arange(Vo, **f32), torch.arange(Uo, **f32)
    oy = torch.arange(Ho, **f32)[None, :] * lam + v[:, None] - Vo / 2 + 0.5  # [Vo, Ho]
    ox = torch.arange(Wo, **f32)[None, :] * lam + u[:, None] - Uo / 2 + 0.5  # [Uo, Wo]
    ov = ((v + 0.5) / lam - 0.5)[:, None].expand(Vo, Ho)
    ou = ((u + 0.5) / lam - 0.5)[:, None].expand(Uo, Wo)
    xg = x.reshape(N, H, W, V, U)

    # pass 1, (y, v): [Vo, Ho, N, W, U]
    t = None
    s_yv = torch.zeros((Vo, Ho), **f32)
    for yi, vi, w in _axis_taps(oy, ov, H, V):
        s_yv = s_yv + w
        term = xg[:, yi, :, vi, :] * w.to(x.dtype)[:, :, None, None, None]
        t = term if t is None else t + term
    # pass 2, (x, u): [Vo, Ho, N, Uo, Wo]
    out = None
    s_xu = torch.zeros((Uo, Wo), **f32)
    for xi, ui, w in _axis_taps(ox, ou, W, U):
        s_xu = s_xu + w
        term = t[:, :, :, xi, ui] * w.to(x.dtype)
        out = term if out is None else out + term
    pad = pad_val * (1.0 - s_yv[:, :, None, None, None] * s_xu)
    out = out + pad.to(x.dtype)
    return out.permute(2, 1, 4, 0, 3).reshape(N, Ho, Wo, Vo * Uo)


class SwapAlign2Nat(nn.Module):
    """Module form of :func:`swap_align2nat` (d2's ``SwapAlign2Nat``)."""

    def __init__(self, lambda_val: int, pad_val: float = -6.0):
        super().__init__()
        self.lambda_val, self.pad_val = lambda_val, pad_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swap_align2nat(x, self.lambda_val, self.pad_val)
