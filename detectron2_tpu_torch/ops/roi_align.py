"""Multilevel RoIAlign, forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions, and the single-channel crop of the mask targets.

Counterpart of ``detectron2_tpu/ops/roi_align.py``. Semantics are those of
``_roi_align_multilevel_xla`` (the exact formulation):

- ``aligned=True`` (ROIAlignV2): continuous coordinate c maps to pixel c - 0.5;
  ``aligned=False`` (ROIAlign, v1 grid): no offset, rois clamped to >= 1x1;
- each output bin averages ``s*s`` bilinear samples on a regular sub-grid,
  with ``s = sampling_ratio`` or a static 2 when it is 0;
- a sample outside ``[-1, size]`` on either axis contributes 0.

Layout: levels are NHWC ``[B, Hl, Wl, C]``, output ``[R, ph, pw, C]`` in the
feature dtype.

:func:`roi_align_multilevel` is differentiable in the features. On CUDA
tensors its forward launches ``csrc/roi_align.cu``'s forward kernel and its
backward that file's backward kernel (or raise); on CPU tensors both run the
plain versions. Boxes, batch indices and levels get no gradient, as every
caller of the JAX package stops theirs (``roi_align.py:722-723``).
"""

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import torch

from detectron2_tpu_torch.ops._build import load_kernel

__all__ = [
    "roi_align_multilevel",
    "roi_align_multilevel_cuda",
    "roi_align_multilevel_plain",
    "roi_align_multilevel_backward_cuda",
    "roi_align_multilevel_backward_plain",
    "roi_align_sample_taps",
    "roi_align_separable",
]

_MAX_LEVELS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pair(output_size) -> Tuple[int, int]:
    if isinstance(output_size, int):
        return output_size, output_size
    return int(output_size[0]), int(output_size[1])


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"roi_align_multilevel: unsupported device {t.device}")
    return t.device.type


class _RoIAlignMultilevel(torch.autograd.Function):
    """Saves only the boxes, indices and level shapes: the backward reads no
    feature."""

    @staticmethod
    def forward(ctx, boxes, batch_indices, level_assignments, scales, output_size, sampling_ratio, aligned, *features):
        args = (boxes, batch_indices, level_assignments, scales, output_size, sampling_ratio, aligned)
        fwd = roi_align_multilevel_cuda if _device_type(features[0]) == "cuda" else roi_align_multilevel_plain
        out = fwd(list(features), *args)
        ctx.save_for_backward(boxes, batch_indices, level_assignments)
        ctx.level_shapes = [tuple(f.shape) for f in features]
        ctx.config = (scales, output_size, sampling_ratio, aligned)
        return out

    @staticmethod
    def backward(ctx, grad):
        boxes, batch_indices, level_assignments = ctx.saved_tensors
        bwd = (
            roi_align_multilevel_backward_cuda
            if _device_type(grad) == "cuda"
            else roi_align_multilevel_backward_plain
        )
        grads = bwd(grad.contiguous(), ctx.level_shapes, boxes, batch_indices, level_assignments, *ctx.config)
        return (None,) * 7 + tuple(grads)


def roi_align_multilevel(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """Pool each roi from its assigned level.

    Args:
        features: per-level ``[B, Hl, Wl, C]`` maps, in assignment order.
        boxes: ``[R, 4]`` XYXY in image coordinates.
        batch_indices: ``[R]`` image index of each roi.
        level_assignments: ``[R]`` level index of each roi, in ``[0, L)``.
        scales: per-level 1/stride.

    Returns:
        ``[R, ph, pw, C]`` in the features' dtype, differentiable in the
        features.
    """
    return _RoIAlignMultilevel.apply(
        boxes, batch_indices, level_assignments, tuple(scales), output_size, sampling_ratio, aligned, *features
    )


class _Levels(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p * _MAX_LEVELS),
        ("H", ctypes.c_int * _MAX_LEVELS),
        ("W", ctypes.c_int * _MAX_LEVELS),
        ("scale", ctypes.c_float * _MAX_LEVELS),
        ("row_base", ctypes.c_longlong * _MAX_LEVELS),
        ("num_levels", ctypes.c_int),
    ]


def _levels_struct(level_shapes, scales, ptrs=None) -> _Levels:
    lv = _Levels()
    base = 0
    for i, shape in enumerate(level_shapes):
        B, H, W = shape[0], shape[1], shape[2]
        lv.ptr[i] = ptrs[i] if ptrs is not None else None
        lv.H[i] = H
        lv.W[i] = W
        lv.scale[i] = float(scales[i])
        lv.row_base[i] = base
        base += B * H * W
    lv.num_levels = len(level_shapes)
    return lv


_fn = None
_bwd_fn = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = load_kernel("roi_align").d2t_roi_align_fwd
        fn.argtypes = [ctypes.POINTER(_Levels), _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.POINTER(_I)]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        lib = load_kernel("roi_align")
        scratch = lib.d2t_roi_align_bwd_scratch
        scratch.argtypes = [ctypes.POINTER(_Levels), _I, _I, _I, _I, _I]
        scratch.restype = ctypes.c_longlong
        fn = lib.d2t_roi_align_bwd
        fn.argtypes = [
            ctypes.POINTER(_Levels), _I, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _P, ctypes.POINTER(_I),
        ]
        fn.restype = ctypes.c_int
        _bwd_fn = (scratch, fn)
    return _bwd_fn


def _check(cond: bool, msg: str, who: str = "roi_align_multilevel_cuda") -> None:
    if not cond:
        raise ValueError(f"{who}: " + msg)


def _check_rois(boxes, batch_indices, level_assignments, device, who):
    R = boxes.shape[0]
    _check(boxes.shape == (R, 4) and boxes.dtype == torch.float32, "boxes float32 [R, 4]", who)
    for name, t in (("batch_indices", batch_indices), ("level_assignments", level_assignments)):
        _check(t.shape == (R,) and t.dtype == torch.int32, f"{name} int32 [R]", who)
    for t in (boxes, batch_indices, level_assignments):
        _check(t.device == device and t.is_contiguous(), "boxes/indices contiguous on the features' device", who)
    return R


# the kernels' paths, by the code they report: 16 bytes of channels per
# thread, or one channel
_PATHS = {0: "scalar", 1: "vector"}


def roi_align_multilevel_cuda(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """Launch ``csrc/roi_align.cu``'s forward kernel on the current stream.

    Takes float32 or bfloat16 contiguous NHWC levels on one CUDA device,
    float32 ``[R, 4]`` boxes and int32 ``[R]`` indices, all contiguous.
    Batch and level indices must be in range: the kernel reads them as given.
    The kernel moves 16 bytes per thread (``"vector"``) when a pixel's
    channels are whole 16-byte words (C a multiple of 8 in bfloat16, of 4 in
    float32) and every level's and the output's pointer is 16-byte aligned,
    else one channel per thread (``"scalar"``): it decides, and reports which.
    Every launch adds one to ``roi_align_multilevel_cuda.launches``, names
    its path in ``roi_align_multilevel_cuda.last_path`` and adds one to that
    path's entry of ``roi_align_multilevel_cuda.paths``.
    """
    ph, pw = _pair(output_size)
    L = len(features)
    _check(1 <= L <= _MAX_LEVELS, f"1..{_MAX_LEVELS} levels, got {L}")
    _check(len(scales) == L, "one scale per level")
    f0 = features[0]
    device = f0.device
    _check(f0.dtype in _DTYPE_CODE, f"feature dtype {f0.dtype} (float32 or bfloat16)")
    _check(device.type == "cuda", f"features on {device}, expected cuda")
    B, C = f0.shape[0], f0.shape[-1]
    for f in features:
        _check(f.device == device and f.dtype == f0.dtype, "all levels on one device, one dtype")
        _check(f.dim() == 4 and f.shape[0] == B and f.shape[-1] == C, "levels [B, Hl, Wl, C]")
        _check(f.is_contiguous(), "levels must be contiguous NHWC")
    R = _check_rois(boxes, batch_indices, level_assignments, device, "roi_align_multilevel_cuda")
    _check(ph >= 1 and pw >= 1 and ph <= 65535, "output size")

    out = torch.empty((R, ph, pw, C), dtype=f0.dtype, device=device)
    if R == 0:
        return out
    lv = _levels_struct([f.shape for f in features], scales, [f.data_ptr() for f in features])
    fn = _kernel_fn()
    ran = _I(-1)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            ctypes.byref(lv), boxes.data_ptr(), batch_indices.data_ptr(), level_assignments.data_ptr(),
            out.data_ptr(), R, C, ph, pw, int(sampling_ratio), int(bool(aligned)), _DTYPE_CODE[f0.dtype], stream,
            ctypes.byref(ran),
        )
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
    path = _PATHS[ran.value]
    roi_align_multilevel_cuda.launches += 1
    roi_align_multilevel_cuda.last_path = path
    roi_align_multilevel_cuda.paths[path] = roi_align_multilevel_cuda.paths.get(path, 0) + 1
    return out


roi_align_multilevel_cuda.launches = 0
roi_align_multilevel_cuda.last_path = None
roi_align_multilevel_cuda.paths = {}


def roi_align_multilevel_backward_cuda(
    grad: torch.Tensor,
    level_shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> List[torch.Tensor]:
    """Launch ``csrc/roi_align.cu``'s backward kernels on the current stream:
    the features' gradient, one ``[B, Hl, Wl, C]`` tensor per level of
    ``level_shapes``, in ``grad``'s dtype (float32 or bfloat16).

    ``grad`` is the contiguous ``[R, ph, pw, C]`` cotangent of the forward's
    output. The kernels list, per 16x16 pixel tile of each level plane, the
    rois whose taps reach it, in roi order, then gather each tile's gradient
    in registers in that fixed order and write it once: no float32
    accumulator, no atomics, the same bits from every launch. The output and
    an int32 scratch (axis tables, tile lists) are allocated here. A pixel's
    channels move 16 bytes at a time (``"vector"``) when C is whole 16-byte
    words and ``grad`` and the output are 16-byte aligned, else one channel
    at a time (``"scalar"``): the kernel decides, and reports which. Every
    call adds one to ``roi_align_multilevel_backward_cuda.launches`` and names
    its path in ``roi_align_multilevel_backward_cuda.last_path``.
    """
    who = "roi_align_multilevel_backward_cuda"
    ph, pw = _pair(output_size)
    L = len(level_shapes)
    _check(1 <= L <= _MAX_LEVELS, f"1..{_MAX_LEVELS} levels, got {L}", who)
    _check(len(scales) == L, "one scale per level", who)
    device = grad.device
    _check(device.type == "cuda", f"grad on {device}, expected cuda", who)
    _check(grad.dtype in _DTYPE_CODE, f"grad dtype {grad.dtype} (float32 or bfloat16)", who)
    _check(grad.is_contiguous(), "grad must be contiguous", who)
    R = _check_rois(boxes, batch_indices, level_assignments, device, who)
    B, C = level_shapes[0][0], level_shapes[0][-1]
    for s in level_shapes:
        _check(len(s) == 4 and s[0] == B and s[-1] == C, "levels [B, Hl, Wl, C]", who)
    _check(tuple(grad.shape) == (R, ph, pw, C), f"grad {tuple(grad.shape)}, expected {(R, ph, pw, C)}", who)
    _check(ph * pw * C < 2**31, "one roi's cotangent must have fewer than 2^31 elements (int32 offsets)", who)

    rows = [s[0] * s[1] * s[2] for s in level_shapes]
    out = torch.empty((sum(rows), C), dtype=grad.dtype, device=device)
    lv = _levels_struct(level_shapes, scales)
    scratch_fn, fn = _bwd_kernel_fn()
    n_scratch = scratch_fn(ctypes.byref(lv), B, R, ph, pw, int(sampling_ratio))
    _check(n_scratch < 2**31, f"{n_scratch} int32 of scratch: too many rois or tiles for int32 offsets", who)
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=device)
    ran = _I(-1)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            ctypes.byref(lv), B, boxes.data_ptr(), batch_indices.data_ptr(), level_assignments.data_ptr(),
            grad.data_ptr(), out.data_ptr(), scratch.data_ptr(), R, C, ph, pw, int(sampling_ratio),
            int(bool(aligned)), _DTYPE_CODE[grad.dtype], stream, ctypes.byref(ran),
        )
    if err != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: cudaError {err}")
    roi_align_multilevel_backward_cuda.launches += 1
    roi_align_multilevel_backward_cuda.last_path = _PATHS[ran.value]
    return [part.reshape(tuple(s)) for part, s in zip(out.split(rows), level_shapes)]


roi_align_multilevel_backward_cuda.launches = 0
roi_align_multilevel_backward_cuda.last_path = None


def roi_align_sample_taps(
    level_shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> Dict[str, torch.Tensor]:
    """The sample grid of the exact formulation, over levels of the given
    ``[B, Hl, Wl, C]`` shapes flattened into one ``[sum(B*Hl*Wl), C]``
    buffer: per roi its image plane's first row ``base`` and width ``W``
    ``[R]``; per sample row ``ylo``, ``yhi``, ``yfrac``, ``yin`` ``[R, ph*s]``;
    per sample column ``xlo``, ``xhi``, ``xfrac``, ``xin`` ``[R, pw*s]``. Tap
    (y, x) of roi r is row ``base[r] + y * W[r] + x``. Tensors lie on the
    boxes' device."""
    ph, pw = _pair(output_size)
    s = int(sampling_ratio) if sampling_ratio > 0 else 2
    device = boxes.device
    R = boxes.shape[0]
    bases, hs, ws = [], [], []
    base = 0
    for shape in level_shapes:
        bases.append(base)
        hs.append(shape[1])
        ws.append(shape[2])
        base += shape[0] * shape[1] * shape[2]
    lvl = level_assignments.long()
    as_t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    roi_scale = as_t(list(scales), torch.float32)[lvl]
    roi_H = as_t(hs, torch.int64)[lvl]
    roi_W = as_t(ws, torch.int64)[lvl]

    b = boxes.float()
    off = 0.5 if aligned else 0.0
    x0 = b[:, 0] * roi_scale - off
    y0 = b[:, 1] * roi_scale - off
    x1 = b[:, 2] * roi_scale - off
    y1 = b[:, 3] * roi_scale - off
    roi_w = x1 - x0
    roi_h = y1 - y0
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    # divide by full tensors: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one rounding away from the true quotient
    # that XLA and the kernel compute, and a coordinate one ulp off can pick
    # another tap at a bin edge
    bin_h = roi_h / torch.full_like(roi_h, ph)
    bin_w = roi_w / torch.full_like(roi_w, pw)

    py = torch.arange(ph, dtype=torch.float32, device=device)
    px = torch.arange(pw, dtype=torch.float32, device=device)
    sub = torch.arange(s, dtype=torch.float32, device=device) + 0.5
    sub = sub / torch.full_like(sub, s)
    ys = (y0[:, None, None] + (py[None, :, None] + sub[None, None, :]) * bin_h[:, None, None]).reshape(R, ph * s)
    xs = (x0[:, None, None] + (px[None, :, None] + sub[None, None, :]) * bin_w[:, None, None]).reshape(R, pw * s)

    def prep(coords, size):
        sizef = size.to(torch.float32)[:, None]
        inside = (coords >= -1.0) & (coords <= sizef)
        c = torch.minimum(coords.clamp_min(0.0), sizef - 1.0)
        lo = torch.floor(c)
        frac = c - lo
        lo = lo.long()
        hi = torch.minimum(lo + 1, size[:, None] - 1)
        return lo, hi, frac, inside

    ylo, yhi, yfrac, yin = prep(ys, roi_H)
    xlo, xhi, xfrac, xin = prep(xs, roi_W)
    return {
        "base": as_t(bases, torch.int64)[lvl] + batch_indices.long() * roi_H * roi_W,
        "W": roi_W,
        "ylo": ylo, "yhi": yhi, "yfrac": yfrac, "yin": yin,
        "xlo": xlo, "xhi": xhi, "xfrac": xfrac, "xin": xin,
    }


def roi_align_multilevel_plain(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
    chunk: int = 512,
) -> torch.Tensor:
    """Transcription of ``_roi_align_multilevel_xla``: one gather over all
    levels flattened into one buffer, interpolation in the feature dtype and
    the bin mean in float32 (float64 for float64 features), ``chunk`` rois
    at a time."""
    ph, pw = _pair(output_size)
    s = int(sampling_ratio) if sampling_ratio > 0 else 2
    C = features[0].shape[-1]
    dtype = features[0].dtype
    mean_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    device = features[0].device
    R = boxes.shape[0]
    if R == 0:
        return torch.zeros((0, ph, pw, C), dtype=dtype, device=device)
    flat = torch.cat([f.reshape(-1, C) for f in features], dim=0)
    t = roi_align_sample_taps(
        [f.shape for f in features], boxes, batch_indices, level_assignments, scales, output_size,
        sampling_ratio, aligned,
    )

    out = torch.empty((R, ph, pw, C), dtype=dtype, device=device)
    for start in range(0, R, chunk):
        sl = slice(start, min(start + chunk, R))
        n = sl.stop - sl.start
        cbase, cW = t["base"][sl], t["W"][sl]

        def gather(yi, xi):
            idx = cbase[:, None, None] + yi[sl][:, :, None] * cW[:, None, None] + xi[sl][:, None, :]
            return flat[idx.reshape(-1)].reshape(n, ph * s, pw * s, C)

        wy1 = t["yfrac"][sl][:, :, None, None].to(dtype)
        wy0 = 1.0 - wy1
        wx1 = t["xfrac"][sl][:, None, :, None].to(dtype)
        wx0 = 1.0 - wx1
        ylo, yhi, xlo, xhi = t["ylo"], t["yhi"], t["xlo"], t["xhi"]
        val = (
            gather(ylo, xlo) * (wy0 * wx0)
            + gather(ylo, xhi) * (wy0 * wx1)
            + gather(yhi, xlo) * (wy1 * wx0)
            + gather(yhi, xhi) * (wy1 * wx1)
        )
        inside = (t["yin"][sl][:, :, None] & t["xin"][sl][:, None, :])[..., None]
        val = torch.where(inside, val, torch.zeros((), dtype=dtype, device=device))
        val = val.reshape(n, ph, s, pw, s, C).to(mean_dtype).mean(dim=(2, 4))
        out[sl] = val.to(dtype)
    return out


def roi_align_multilevel_backward_plain(
    grad: torch.Tensor,
    level_shapes: Sequence[Sequence[int]],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    level_assignments: torch.Tensor,
    scales: Sequence[float],
    output_size: Union[int, Tuple[int, int]],
    sampling_ratio: int = 0,
    aligned: bool = True,
    chunk: int = 512,
) -> List[torch.Tensor]:
    """The adjoint of the exact formulation in the features: each bin's
    cotangent, divided by s², is added through the 4 bilinear taps of each
    inside sample (``index_add_``) into a float32 buffer over all levels
    (float64 for a float64 ``grad``), returned per level in ``grad``'s
    dtype. The weights are the float32 forward's, so this is the exact
    adjoint of the float32 forward and of the CUDA kernel's."""
    ph, pw = _pair(output_size)
    s = int(sampling_ratio) if sampling_ratio > 0 else 2
    R, C = grad.shape[0], grad.shape[-1]
    acc_dtype = torch.float64 if grad.dtype == torch.float64 else torch.float32
    device = grad.device
    rows = [sh[0] * sh[1] * sh[2] for sh in level_shapes]
    acc = torch.zeros((sum(rows), C), dtype=acc_dtype, device=device)
    if R:
        t = roi_align_sample_taps(
            level_shapes, boxes, batch_indices, level_assignments, scales, output_size, sampling_ratio, aligned
        )
        for start in range(0, R, chunk):
            sl = slice(start, min(start + chunk, R))
            n = sl.stop - sl.start
            g = grad[sl].to(acc_dtype)
            g = g / torch.full_like(g, s * s)
            g = g[:, :, None, :, None, :].expand(n, ph, s, pw, s, C).reshape(n, ph * s, pw * s, C)
            inside = (t["yin"][sl][:, :, None] & t["xin"][sl][:, None, :])[..., None]
            g = torch.where(inside, g, torch.zeros((), dtype=acc_dtype, device=device))
            wy1 = t["yfrac"][sl].to(acc_dtype)
            wx1 = t["xfrac"][sl].to(acc_dtype)
            cbase, cW = t["base"][sl], t["W"][sl]
            for yi, wy in ((t["ylo"][sl], 1.0 - wy1), (t["yhi"][sl], wy1)):
                for xi, wx in ((t["xlo"][sl], 1.0 - wx1), (t["xhi"][sl], wx1)):
                    idx = cbase[:, None, None] + yi[:, :, None] * cW[:, None, None] + xi[:, None, :]
                    w = (wy[:, :, None] * wx[:, None, :])[..., None]
                    acc.index_add_(0, idx.reshape(-1), (g * w).reshape(-1, C))
    out = acc.to(grad.dtype)
    return [part.reshape(tuple(sh)) for part, sh in zip(out.split(rows), level_shapes)]


def roi_align_separable(
    maps: torch.Tensor,
    boxes: torch.Tensor,
    src_indices: torch.Tensor,
    output_size,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """RoIAlign over a stack of single-channel maps (counterpart of
    ``detectron2_tpu/ops/roi_align.py:180``): roi r pools
    ``maps[src_indices[r]]``. The JAX package writes it as two batched
    matmuls for the TPU's matrix unit; here it is
    :func:`roi_align_multilevel_plain` on one level of one channel, the same
    coordinates, border rule and bin mean. ``boxes`` are in map pixel
    coordinates.

    Args:
        maps: ``[N, Hm, Wm]``.
        boxes: ``[R, 4]`` XYXY.
        src_indices: ``[R]`` map of each roi.

    Returns:
        ``[R, ph, pw]`` float32.
    """
    R = boxes.shape[0]
    levels = torch.zeros((R,), dtype=torch.int32, device=boxes.device)
    out = roi_align_multilevel_plain(
        [maps.float()[..., None]], boxes.float().contiguous(), src_indices.int(), levels, (1.0,),
        output_size, sampling_ratio, aligned,
    )
    return out[..., 0]
