"""Attention with a decomposed relative-position bias: the CUDA kernels'
wrappers and their plain PyTorch versions.

Counterpart of ``detectron2_tpu/ops/attention.py``. For q, k, v ``[B, S, D]``
(B = batch * heads) and the two bias factors of ViTDet's decomposed relative
position,

    out = softmax(q * scale @ k^T + rel_h[:, :, :, None] + rel_w[:, :, None, :]) @ v

with ``rel_h`` ``[B, S, Hk]``, ``rel_w`` ``[B, S, Wk]`` and ``Hk * Wk = S``
(the key at row h2, column w2 of the token grid gets ``rel_h[q, h2] +
rel_w[q, w2]``), or the same factors transposed, ``[B, Hk, S]`` and
``[B, Wk, S]``.

:func:`attention_with_rel_pos` is differentiable. On CUDA tensors its forward
always launches a kernel of ``csrc/flash_attention.cu`` (or raises), which
never stores the ``[S, S]`` scores; on CPU tensors it runs the plain version.
There is no backward kernel, as in the JAX package: the backward
differentiates the plain version on the saved inputs.
"""

import ctypes
import os
from typing import Optional

import torch

from detectron2_tpu_torch.ops._build import load_kernel

__all__ = [
    "attention_with_rel_pos",
    "attention_plain",
    "attention_plain_t",
    "flash_attention_cuda",
    "flash_attention_t_cuda",
    "use_transposed_factors",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def use_transposed_factors() -> bool:
    """Whether the model should produce the bias factors transposed and take
    the transposed-layout kernel: the JAX package's switch, ``D2T_FLASH_V2=1``.
    The default is the standard layout."""
    return os.environ.get("D2T_FLASH_V2", "0") == "1"


def _softmax_av(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(s, dim=-1).to(v.dtype)
    if v.dtype in (torch.float32, torch.float64):
        return torch.einsum("bqk,bkc->bqc", p, v)
    # low-precision operands, float32 accumulation, one rounding at the end
    return torch.einsum("bqk,bkc->bqc", p.float(), v.float()).to(v.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(q * scale) @ k^T with q scaled in its own dtype (the scale rounded to
    it first) and the product accumulated in float32."""
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if q.dtype in (torch.float32, torch.float64):
        return torch.einsum("bqc,bkc->bqk", qs, k)
    return torch.einsum("bqc,bkc->bqk", qs.float(), k.float())


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: Optional[torch.Tensor],
    rel_w: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """The exact formulation, step by step as ``_attn_xla`` of the JAX
    package: it stores the ``[B, S, S]`` scores. The bias is summed in the
    factors' dtype and then cast to the scores' (in bfloat16 that rounds once
    more than the kernel does)."""
    s = _scores(q, k, scale)
    if rel_h is not None:
        B, S, _ = q.shape
        bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(B, S, S)
        s = s + bias.to(s.dtype)
    return _softmax_av(s, v)


def attention_plain_t(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_ht: Optional[torch.Tensor],
    rel_wt: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """:func:`attention_plain` with the factors transposed, ``[B, Hk, S]`` and
    ``[B, Wk, S]`` (``_attn_xla_t`` of the JAX package)."""
    s = _scores(q, k, scale)
    if rel_ht is not None:
        B, S, _ = q.shape
        bias = (rel_ht.transpose(1, 2)[:, :, :, None] + rel_wt.transpose(1, 2)[:, :, None, :]).reshape(B, S, S)
        s = s + bias.to(s.dtype)
    return _softmax_av(s, v)


def _kernel_fn(name: str):
    if name not in _fns:
        fn = getattr(load_kernel("flash_attention"), name)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _launch(who: str, entry: str, q, k, v, rel_h, rel_w, scale: float, transposed: bool) -> torch.Tensor:
    def check(cond, msg):
        if not cond:
            raise ValueError(f"{who}: {msg}")

    check(q.dim() == 3, f"q, k, v [B, S, D], got q {tuple(q.shape)}")
    B, S, D = q.shape
    device = q.device
    check(device.type == "cuda", f"q on {device}, expected cuda")
    check(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    check(D in _HEAD_DIMS, f"head dim {D} (one of {_HEAD_DIMS})")
    check((rel_h is None) == (rel_w is None), "both factors or neither")
    tensors = {"q": q, "k": k, "v": v}
    if rel_h is not None:
        tensors.update(rel_h=rel_h, rel_w=rel_w)
        Hk, Wk = (rel_h.shape[1], rel_w.shape[1]) if transposed else (rel_h.shape[2], rel_w.shape[2])
        want_h, want_w = ((B, Hk, S), (B, Wk, S)) if transposed else ((B, S, Hk), (B, S, Wk))
        check(tuple(rel_h.shape) == want_h and tuple(rel_w.shape) == want_w,
              f"factors {tuple(rel_h.shape)}, {tuple(rel_w.shape)}, expected {want_h}, {want_w}")
        check(Hk * Wk == S, f"Hk * Wk = {Hk} * {Wk} != S = {S}")
    else:
        Hk = Wk = 0
    for name, t in tensors.items():
        check(t.device == device and t.dtype == q.dtype, f"{name}: one device and one dtype for all inputs")
        check(t.is_contiguous(), f"{name} must be contiguous")
        check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    check(k.shape == q.shape and v.shape == q.shape, "q, k, v of one shape")

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel_fn(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rel_h.data_ptr() if rel_h is not None else None,
            rel_w.data_ptr() if rel_w is not None else None,
            out.data_ptr(), B, S, D, Hk, Wk, float(scale), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed: cudaError {err}")
    return out


def flash_attention_cuda(q, k, v, rel_h=None, rel_w=None, *, scale: float) -> torch.Tensor:
    """Launch ``d2t_flash_attn_fwd`` on the current stream: q, k, v
    ``[B, S, D]`` and factors ``[B, S, Hk]``, ``[B, S, Wk]`` (or None), all
    contiguous on one CUDA device in one dtype, float32 or bfloat16, D in
    (32, 64, 128). Any S; Hk * Wk must equal S. Every launch adds one to
    ``flash_attention_cuda.launches``."""
    out = _launch("flash_attention_cuda", "d2t_flash_attn_fwd", q, k, v, rel_h, rel_w, scale, False)
    if out.numel():
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_t_cuda(q, k, v, rel_ht=None, rel_wt=None, *, scale: float) -> torch.Tensor:
    """Launch ``d2t_flash_attn_fwd_t``: as :func:`flash_attention_cuda` with
    the factors transposed, ``[B, Hk, S]`` and ``[B, Wk, S]``. Every launch
    adds one to ``flash_attention_t_cuda.launches``."""
    out = _launch("flash_attention_t_cuda", "d2t_flash_attn_fwd_t", q, k, v, rel_ht, rel_wt, scale, True)
    if out.numel():
        flash_attention_t_cuda.launches += 1
    return out


flash_attention_t_cuda.launches = 0


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention_with_rel_pos: unsupported device {t.device}")
    return t.device.type


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, transposed):
        if _device_type(q) == "cuda":
            fwd = flash_attention_t_cuda if transposed else flash_attention_cuda
            out = fwd(q, k, v, rel_h, rel_w, scale=scale)
        else:
            out = (attention_plain_t if transposed else attention_plain)(q, k, v, rel_h, rel_w, scale)
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        ctx.config = (scale, transposed)
        return out

    @staticmethod
    def backward(ctx, grad):
        scale, transposed = ctx.config
        plain = attention_plain_t if transposed else attention_plain
        inputs = [None if t is None else t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = plain(*inputs, scale)
        wanted = [(i, t) for i, t in enumerate(inputs) if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * 5
        if wanted:
            for (i, _), g in zip(wanted, torch.autograd.grad(out, [t for _, t in wanted], grad)):
                grads[i] = g
        return (*grads, None, None)


def attention_with_rel_pos(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: Optional[torch.Tensor] = None,
    rel_w: Optional[torch.Tensor] = None,
    *,
    scale: float,
    factors_transposed: bool = False,
) -> torch.Tensor:
    """softmax(q k^T * scale + decomposed relative-position bias) v.

    Args:
        q, k, v: ``[B, S, D]``, contiguous.
        rel_h, rel_w: the bias factors or None: ``[B, S, Hk]`` and
            ``[B, S, Wk]`` with ``Hk * Wk == S`` or, with
            ``factors_transposed``, ``[B, Hk, S]`` and ``[B, Wk, S]``.
        scale: applied to q, in q's dtype, before the score product.

    Returns:
        ``[B, S, D]`` in v's dtype. On CUDA tensors the forward is the kernel
        of the given layout, for every S; on CPU tensors the plain version.
    """
    return _Attention.apply(q, k, v, rel_h, rel_w, float(scale), bool(factors_transposed))
