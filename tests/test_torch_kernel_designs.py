"""What the CUDA kernels' designs rest on, checked without a card: the
arithmetic of the two bfloat16 attention kernels emulated in plain torch and
held to the bounds the card holds the kernels to, the RoIAlign kernel's per-roi
axis table against the plain version's sample grid, and the wrappers'
refusals. Which kernel a shape takes is decided in the CUDA sources and
reported per launch: the card tests hold it to the expected names.

The emulations repeat, step by step, what ``csrc/flash_attention.cu`` does
(which keys go together, where the bias enters, what is rounded to bfloat16);
each must pass ``testing.attention_bf16_bounds`` and fail it once a tile, the
tail keys or the bias is dropped.
"""

import math

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.ops import attention as port_attn
from detectron2_tpu_torch.ops import roi_align as port_ra
from detectron2_tpu_torch.testing import attention_bf16_bounds

LOG2E = math.log2(math.e)


def _bf16_inputs(B, S, D, Hk, Wk, bias_std, seed):
    r = np.random.RandomState(seed)
    mk = lambda *shape, std=1.0: torch.from_numpy((r.randn(*shape) * std).astype(np.float32)).bfloat16()  # noqa: E731
    return mk(B, S, D), mk(B, S, D), mk(B, S, D), mk(B, S, Hk, std=bias_std), mk(B, S, Wk, std=bias_std)


def _scaled_q(q, scale):
    """q * scale in q's dtype (the scale rounded to it first), as float32."""
    return (q * torch.tensor(scale, dtype=q.dtype)).float()


def folded_bias_operands(rel_h, rel_w, ext=32):
    """The window kernel's extra channels: ``qe`` ``[B, S, ext]``, the query
    rows of rel_h | rel_w | 0, and the selector ``ke`` ``[S, ext]`` with
    channel j // Wk and channel Hk + j % Wk of key j set to 1."""
    B, S, Hk = rel_h.shape
    Wk = rel_w.shape[2]
    assert Hk * Wk == S and Hk + Wk <= ext
    qe = torch.zeros(B, S, ext)
    qe[:, :, :Hk] = rel_h.float()
    qe[:, :, Hk : Hk + Wk] = rel_w.float()
    ke = torch.zeros(S, ext)
    j = torch.arange(S)
    ke[j, j // Wk] = 1.0
    ke[j, Hk + j % Wk] = 1.0
    return qe, ke


def _running_softmax_av(scores, v, chunks, drop_chunk=None):
    """Online softmax over key chunks as both kernels run it: per chunk the
    new maximum, the older sums rescaled, probabilities rounded to bfloat16
    for the p.v product and summed unrounded; the division last, one rounding
    of the output."""
    B, S, _ = scores.shape
    m = torch.full((B, S, 1), -float("inf"))
    l = torch.zeros(B, S, 1)
    o = torch.zeros(B, S, v.shape[-1])
    for i, (a, b) in enumerate(chunks):
        if i == drop_chunk:
            continue
        s = scores[:, :, a:b]
        mn = torch.maximum(m, s.max(-1, keepdim=True).values)
        c = torch.exp2((m - mn) * LOG2E)
        p = torch.exp2(s * LOG2E - mn * LOG2E)
        l = l * c + p.sum(-1, keepdim=True)
        o = o * c + torch.einsum("bqk,bkc->bqc", p.bfloat16().float(), v[:, a:b].float())
        m = mn
    return (o / l).bfloat16()


def as_the_window_kernel(q, k, v, rel_h, rel_w, scale, fault=None):
    """``flash_window_bf16_kernel``: the bias as 32 more channels of the first
    product, all keys in one pass up to 128 of them and in two halves beyond
    (7 and the remaining steps of 16 keys)."""
    B, S, _ = q.shape
    s = torch.einsum("bqc,bkc->bqk", _scaled_q(q, scale), k.float())
    if rel_h is not None and fault != "no_bias":
        qe, ke = folded_bias_operands(rel_h, rel_w)
        if fault == "no_w_selector":
            ke[:, rel_h.shape[2] :] = 0
        s = s + torch.einsum("bqc,kc->bqk", qe, ke)
    if fault == "tail_keys":
        s[:, :, -4:] = -float("inf")
    steps = -(-S // 16)
    chunks = [(0, S)] if steps <= 8 else [(0, 16 * ((steps + 1) // 2)), (16 * ((steps + 1) // 2), S)]
    return _running_softmax_av(s, v, chunks, drop_chunk=1 if fault == "second_half" else None)


def as_the_wgmma_kernel(q, k, v, rel_h, rel_w, scale, fault=None):
    """``flash_wgmma_bf16_kernel``: key tiles of 128. With Wk of 32 or 64 the
    scores go to units of log2 e with the w term in one multiply-add, the h
    term of a grid row joins that row's maximum and its exponents' offset;
    otherwise h and w are added to each score."""
    B, S, _ = q.shape
    s = torch.einsum("bqc,bkc->bqk", _scaled_q(q, scale), k.float())
    tiles = [(a, min(a + 128, S)) for a in range(0, S, 128)]
    drop = 1 if fault == "one_tile" else None
    if rel_h is None or fault == "no_bias":
        return _running_softmax_av(s, v, tiles, drop)
    Hk, Wk = rel_h.shape[2], rel_w.shape[2]
    j = torch.arange(S)
    if Wk not in (32, 64):
        s = s + rel_h.float()[:, :, j // Wk] + rel_w.float()[:, :, j % Wk]
        return _running_softmax_av(s, v, tiles, drop)
    wl = (rel_w.float() * LOG2E)[:, :, j % Wk]
    hl = (rel_h.float() * LOG2E)[:, :, j // Wk]
    if fault == "no_h":
        hl = torch.zeros_like(hl)
    u = s * LOG2E + wl  # (s + w) log2 e
    m = torch.full((B, S, 1), -float("inf"))
    l = torch.zeros(B, S, 1)
    o = torch.zeros(B, S, v.shape[-1])
    for i, (a, b) in enumerate(tiles):
        if i == drop:
            continue
        # per grid row: the maximum over its keys, plus its h term
        rows = range(a // Wk, -(-b // Wk))
        mx = torch.stack(
            [u[:, :, h * Wk : min((h + 1) * Wk, b)].max(-1).values + hl[:, :, h * Wk] for h in rows], -1
        ).max(-1, keepdim=True).values
        mn = torch.maximum(m, mx)
        c = torch.exp2(m - mn)
        p = torch.exp2(u[:, :, a:b] + (hl[:, :, a:b] - mn))
        l = l * c + p.sum(-1, keepdim=True)
        o = o * c + torch.einsum("bqk,bkc->bqc", p.bfloat16().float(), v[:, a:b].float())
        m = mn
    return (o / l).bfloat16()


def _check_against_bounds(out, q, k, v, rel_h, rel_w, scale, should_pass):
    args32 = [_scaled_q(q, scale), k.float(), v.float(), rel_h.float(), rel_w.float()]
    ref32 = port_attn.attention_plain(*args32, 1.0)
    args32[2] = args32[2].abs()
    weight = port_attn.attention_plain(*args32, 1.0)
    bias_max = rel_h.float().abs().max().item() + rel_w.float().abs().max().item()
    tol32, tol16 = attention_bf16_bounds(ref32, weight, v.float().abs().max().item(), bias_max)
    assert (ref32.abs() > tol32).float().mean().item() > 0.5  # the bound lies below a typical |ref|
    ok32 = bool(((out.float() - ref32).abs() <= tol32).all())
    if should_pass:
        ref16 = port_attn.attention_plain(q, k, v, rel_h, rel_w, scale).float()
        assert ok32 and ((out.float() - ref16).abs() <= tol16).all()
    else:
        assert not ok32


# (S, Hk, Wk): one pass with a tail, one pass exactly, two halves with the
# ViTDet window, two halves at the path's largest S; even and odd Wk
WINDOW_SHAPES = [(63, 7, 9), (128, 8, 16), (196, 14, 14), (208, 16, 13)]


WINDOW_CASES = [
    (shape, fault)
    for shape in WINDOW_SHAPES
    for fault in (None, "no_bias", "no_w_selector", "tail_keys", "second_half")
    if not (fault == "second_half" and shape[0] <= 128)  # one pass: there is no second half
]


@pytest.mark.parametrize("shape, fault", WINDOW_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_window_kernel_arithmetic_passes_the_card_bounds_and_a_broken_one_fails(shape, fault):
    S, Hk, Wk = shape
    q, k, v, rel_h, rel_w = _bf16_inputs(4, S, 64, Hk, Wk, 0.5, seed=S)
    out = as_the_window_kernel(q, k, v, rel_h, rel_w, 0.125, fault)
    _check_against_bounds(out, q, k, v, rel_h, rel_w, 0.125, should_pass=fault is None)


@pytest.mark.parametrize("shape", [(14, 14), (7, 9), (16, 13), (1, 5), (28, 4)], ids=lambda s: "x".join(map(str, s)))
def test_folded_bias_is_the_decomposed_bias_exactly(shape):
    """q' . k' over the 32 extra channels equals rel_h[q, j // Wk] +
    rel_w[q, j % Wk] bit for bit: every product has a factor 1 or 0 and two
    terms are not zero."""
    Hk, Wk = shape
    _, _, _, rel_h, rel_w = _bf16_inputs(2, Hk * Wk, 8, Hk, Wk, 0.5, seed=3)
    qe, ke = folded_bias_operands(rel_h, rel_w)
    assert ke.sum(1).eq(2).all() and ke[:, Hk + Wk :].eq(0).all()
    folded = torch.einsum("bqc,kc->bqk", qe, ke)
    S = Hk * Wk
    bias = (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(2, S, S)
    assert torch.equal(folded, bias)


@pytest.mark.parametrize("Hk", [64, 63, 17, 2, 1])
def test_global_folded_bias_selects_each_tiles_rows_and_columns(Hk):
    """``flash_wgmma_bf16_kernel<3>``: per key tile of 128, q's rows gain the
    64 w terms and the 16 h terms of step t // 8, and key n of tile t selects
    channel n % 64 of the former and 2 (t % 8) + n // 64 of the latter. Over
    the keys below S that is the decomposed bias bit for bit; tail keys (an
    odd Hk) select a zero channel or are masked."""
    Wk, S = 64, Hk * 64
    _, _, _, rel_h, rel_w = _bf16_inputs(2, S, 8, Hk, Wk, 0.5, seed=Hk)
    fh = torch.zeros(2, S, 64)
    fh[:, :, :Hk] = rel_h.float()
    n = torch.arange(128)
    selw = torch.zeros(128, 64)
    selw[n, n % 64] = 1.0
    bias = (rel_h.float()[:, :, :, None] + rel_w.float()[:, :, None, :]).reshape(2, S, S)
    for t in range(-(-S // 128)):
        selh = torch.zeros(128, 16)
        selh[n, 2 * (t % 8) + n // 64] = 1.0
        step = fh[:, :, 16 * (t // 8) : 16 * (t // 8) + 16]
        folded = torch.einsum("bqc,kc->bqk", rel_w.float(), selw) + torch.einsum("bqc,kc->bqk", step, selh)
        keys = min(128, S - 128 * t)
        assert torch.equal(folded[:, :, :keys], bias[:, :, 128 * t : 128 * t + keys])
        assert folded[:, :, keys:].eq(rel_w.float()[:, :, : 128 - keys]).all()  # past S: row Hk's zero channel


# (S, Hk, Wk): w terms in registers (Wk 32, 64) with whole tiles, with a
# ragged last tile; any other Wk
WGMMA_SHAPES = [(256, 8, 32), (320, 5, 64), (416, 13, 32), (231, 11, 21)]


WGMMA_CASES = [
    (shape, fault)
    for shape in WGMMA_SHAPES
    for fault in (None, "no_bias", "no_h", "one_tile")
    if not (fault == "no_h" and shape[2] not in (32, 64))  # h and w enter together on that path
]


@pytest.mark.parametrize("shape, fault", WGMMA_CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_wgmma_kernel_arithmetic_passes_the_card_bounds_and_a_broken_one_fails(shape, fault):
    S, Hk, Wk = shape
    q, k, v, rel_h, rel_w = _bf16_inputs(3, S, 64, Hk, Wk, 0.5, seed=S)
    out = as_the_wgmma_kernel(q, k, v, rel_h, rel_w, 0.125, fault)
    _check_against_bounds(out, q, k, v, rel_h, rel_w, 0.125, should_pass=fault is None)


def test_both_emulations_agree_without_a_bias():
    q, k, v, _, _ = _bf16_inputs(2, 196, 64, 14, 14, 0.5, seed=9)
    a = as_the_window_kernel(q, k, v, None, None, 0.125).float()
    b = as_the_wgmma_kernel(q, k, v, None, None, 0.125).float()
    ref = port_attn.attention_plain(q.float() * 0.125, k.float(), v.float(), None, None, 1.0)
    assert (a - ref).abs().max() < 2.0**-7 and (b - ref).abs().max() < 2.0**-7


def test_attention_wrappers_refuse_without_a_card():
    q = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="expected cuda"):
        port_attn.flash_attention_cuda(q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="expected cuda"):
        port_attn.flash_attention_t_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16(), scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        port_attn.flash_attention_cuda(q[..., :48], q[..., :48], q[..., :48], scale=1.0)
    with pytest.raises(ValueError, match="bfloat16"):
        port_attn.flash_attention_cuda(q.half(), q.half(), q.half(), scale=1.0)
    with pytest.raises(ValueError, match="both factors"):
        port_attn.flash_attention_cuda(q, q, q, torch.zeros(2, 16, 4), None, scale=1.0)
    assert port_attn.flash_attention_cuda.launches == 0 or port_attn.flash_attention_cuda.last_path is not None


# ---------------------------------------------------------------- RoIAlign

LEVELS = [(2, 40, 56, 8), (2, 20, 28, 8), (2, 1, 14, 8)]
SCALES = (0.25, 0.125, 0.0625)


def roi_align_axis_table(start, extent, bins, s, size):
    """One axis of one roi as the forward kernel of ``csrc/roi_align.cu``
    tabulates it (``d2t_axis``), entry by entry in float32: ``bins * s``
    samples ``(lo, hi, frac, inside)`` of a roi that starts at ``start``
    (already scaled and offset) and spans ``extent`` (already clamped for the
    v1 grid) on a level ``size`` pixels long."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    bin_size = f32(extent) / f32(float(bins))
    sizef = f32(float(size))
    table = []
    for k in range(bins * s):
        b, sub = divmod(k, s)
        coord = f32(start) + (f32(float(b)) + (f32(float(sub)) + f32(0.5)) / f32(float(s))) * bin_size
        inside = bool(coord >= -1.0) and bool(coord <= sizef)
        c = torch.minimum(torch.maximum(coord, f32(0.0)), sizef - f32(1.0))
        lo = torch.floor(c)
        table.append((int(lo), min(int(lo) + 1, size - 1), float(c - lo), inside))
    return table


def _rois(seed, R=40):
    """Rois inside, partly and fully off the map, zero-area and zero rows."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-60, 230, (R, 2)).astype(np.float32)
    wh = rng.uniform(0, 160, (R, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[3, 2:] = boxes[3, :2]  # zero area
    boxes[4, 2] = boxes[4, 0]  # zero width
    boxes[5] = [-300, -200, -250, -120]  # off the map
    boxes[6] = [500, 400, 700, 650]
    boxes[-4:] = 0
    bidx = rng.randint(0, 2, R).astype(np.int32)
    lvl = rng.randint(0, len(LEVELS), R).astype(np.int32)
    return torch.from_numpy(boxes), torch.from_numpy(bidx), torch.from_numpy(lvl)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "v1"])
@pytest.mark.parametrize("sampling_ratio", [0, 2, 3])
@pytest.mark.parametrize("size", [(7, 7), (14, 14), (3, 5)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_axis_table_equals_the_plain_sample_grid(aligned, sampling_ratio, size):
    """The kernel's per-roi table, written once in Python entry by entry
    (``roi_align_axis_table``), picks the taps, fractions and inside flags of
    ``roi_align_sample_taps`` exactly."""
    boxes, bidx, lvl = _rois(seed=sampling_ratio + 10 * aligned)
    taps = port_ra.roi_align_sample_taps(LEVELS, boxes, bidx, lvl, SCALES, size, sampling_ratio, aligned)
    s = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    for r in range(boxes.shape[0]):
        scale = torch.tensor(SCALES[int(lvl[r])], dtype=torch.float32)
        x0, y0, x1, y1 = (boxes[r, i] * scale - off for i in range(4))
        w, h = x1 - x0, y1 - y0
        if not aligned:
            w, h = w.clamp_min(1.0), h.clamp_min(1.0)
        _, H, W, _ = LEVELS[int(lvl[r])]
        for axis, start, extent, bins, length in (("y", y0, h, size[0], H), ("x", x0, w, size[1], W)):
            table = roi_align_axis_table(float(start), float(extent), bins, s, length)
            assert [e[0] for e in table] == taps[axis + "lo"][r].tolist()
            assert [e[1] for e in table] == taps[axis + "hi"][r].tolist()
            assert [e[2] for e in table] == taps[axis + "frac"][r].tolist()
            assert [e[3] for e in table] == taps[axis + "in"][r].tolist()


def test_axis_table_of_a_roi_off_the_map_is_all_outside():
    table = roi_align_axis_table(-40.0, 10.0, 7, 2, 20)
    assert not any(e[3] for e in table) and all(e[0] == 0 for e in table)
    table = roi_align_axis_table(30.0, 10.0, 7, 2, 20)
    assert not any(e[3] for e in table) and all(e[0] == 19 and e[1] == 19 for e in table)
    # a level one pixel long: both taps are that pixel
    assert all(e[:2] == (0, 0) for e in roi_align_axis_table(-0.5, 0.9, 7, 2, 1))


def test_roi_align_wrapper_refuses_without_a_card():
    feats = [torch.zeros(s) for s in LEVELS]
    boxes, bidx, lvl = _rois(0, R=8)
    with pytest.raises(ValueError, match="expected cuda"):
        port_ra.roi_align_multilevel_cuda(feats, boxes, bidx, lvl, SCALES, 7)
    with pytest.raises(ValueError, match="bfloat16"):
        port_ra.roi_align_multilevel_cuda([f.half() for f in feats], boxes, bidx, lvl, SCALES, 7)
    with pytest.raises(ValueError, match="one scale per level"):
        port_ra.roi_align_multilevel_cuda(feats, boxes, bidx, lvl, SCALES[:2], 7)
    # the entry point takes the plain version on CPU tensors, and counts no launch
    before = port_ra.roi_align_multilevel_cuda.launches
    out = port_ra.roi_align_multilevel(feats, boxes, bidx, lvl, SCALES, 7)
    assert out.shape == (8, 7, 7, 8) and port_ra.roi_align_multilevel_cuda.launches == before
