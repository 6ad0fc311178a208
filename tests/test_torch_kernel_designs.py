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


# ------------------------------------------------- RoIAlign backward design
#
# ``csrc/roi_align.cu``'s backward, step by step in plain torch: each roi's
# axis tables and the rectangle of pixels its inside samples tap (prep), per
# D2T_TILE x D2T_TILE tile of each (image, level) plane the rois whose
# rectangle meets it, in roi order (bin), and per tile pixel the ordered sum
# over those rois of each bin's cotangent times (wy * wx) / s^2, wy and wx
# the bin's samples' axis weights summed in sample order (accumulate).

BWD_TILE = 16


def _roi_tables(boxes, lvl, r, size, s, aligned, levels=LEVELS, scales=SCALES):
    """Roi r's (y table, x table) as the kernel tabulates them."""
    scale = torch.tensor(scales[int(lvl[r])], dtype=torch.float32)
    off = 0.5 if aligned else 0.0
    x0, y0, x1, y1 = (boxes[r, i] * scale - off for i in range(4))
    w, h = x1 - x0, y1 - y0
    if not aligned:
        w, h = w.clamp_min(1.0), h.clamp_min(1.0)
    _, H, W, _ = levels[int(lvl[r])]
    return (
        roi_align_axis_table(float(y0), float(h), size[0], s, H),
        roi_align_axis_table(float(x0), float(w), size[1], s, W),
    )


def bwd_prep(boxes, lvl, size, s, aligned, levels=LEVELS, scales=SCALES, fault=None):
    """Per roi its tables and {ymin, ymax, xmin, xmax} of the pixels its
    inside samples tap, None when no sample is inside (``d2t_bwd_prep_kernel``).
    ``off_by_one``: the rectangle ends at the last lower tap, not upper."""
    out = []
    for r in range(boxes.shape[0]):
        ytab, xtab = _roi_tables(boxes, lvl, r, size, s, aligned, levels, scales)
        ins_y = [e for e in ytab if e[3]]
        ins_x = [e for e in xtab if e[3]]
        end = 0 if fault == "off_by_one" else 1
        rect = None
        if ins_y and ins_x:
            rect = (min(e[0] for e in ins_y), max(e[end] for e in ins_y), min(e[0] for e in ins_x), max(e[end] for e in ins_x))
        out.append((ytab, xtab, rect))
    return out


def bwd_tile_lists(bidx, lvl, prep, levels=LEVELS, tile=BWD_TILE):
    """{(level, image, tile row, tile column): rois whose rectangle meets the
    tile, in roi order} over every tile (``d2t_bwd_bin_kernel``)."""
    lists = {}
    for l, (B, H, W, _) in enumerate(levels):
        for b in range(B):
            for ty in range(-(-H // tile)):
                for tx in range(-(-W // tile)):
                    y0, x0 = ty * tile, tx * tile
                    lists[(l, b, ty, tx)] = [
                        r for r, (_, _, rect) in enumerate(prep)
                        if int(lvl[r]) == l and int(bidx[r]) == b and rect is not None
                        and rect[0] < y0 + tile and rect[1] >= y0 and rect[2] < x0 + tile and rect[3] >= x0
                    ]
    return lists


def _axis_weights(tab, first, tile, bins, s, dtype):
    """[tile, bins]: per pixel first + i and bin, the lower-tap weights
    (1 - frac) of the bin's inside samples whose lower tap is the pixel, then
    the upper-tap weights (frac), in sample order, summed in ``dtype``."""
    w = torch.zeros(tile, bins, dtype=dtype)
    one = torch.tensor(1.0, dtype=dtype)
    for part in (0, 1):
        for k, (lo, hi, frac, inside) in enumerate(tab):
            p = (lo, hi)[part] - first
            if inside and 0 <= p < tile:
                f = torch.tensor(frac, dtype=dtype)
                w[p, k // s] += f if part else one - f
    return w


def bwd_tile_sum(g, lists, prep, size, s, levels=LEVELS, tile=BWD_TILE, dtype=torch.float64, drop_tile=None):
    """The gradient per level: every tile's pixels, the ordered sum over its
    list (``d2t_roi_align_bwd_kernel``), written once; a bin's weight is
    wy * (wx / s^2). In float64 as einsum; in float32 one fused multiply-add
    per bin, in the kernel's order (x bins, then y bins)."""
    ph, pw = size
    C = g.shape[-1]
    count = torch.tensor(float(s * s), dtype=dtype)
    grads = [torch.full((B, H, W, C), float("nan"), dtype=dtype) for B, H, W, _ in levels]
    for key, rois in lists.items():
        l, b, ty, tx = key
        acc = torch.zeros(tile, tile, C, dtype=dtype)
        if key != drop_tile:
            for r in rois:
                ytab, xtab, _ = prep[r]
                wy = _axis_weights(ytab, ty * tile, tile, ph, s, dtype)
                wx = _axis_weights(xtab, tx * tile, tile, pw, s, dtype)
                w = wy[:, None, :, None] * (wx / count)[None, :, None, :]  # [y, x, by, bx]
                gr = g[r].to(dtype)
                if dtype == torch.float64:
                    acc += torch.einsum("yxpq,pqc->yxc", w, gr)
                    continue
                for bx in range(pw):
                    for by in range(ph):  # a fused multiply-add: one rounding of the exact sum
                        acc = (acc.double() + gr[by, bx].double() * w[:, :, by, bx, None].double()).float()
        _, H, W, _ = levels[l]
        y0, x0 = ty * tile, tx * tile
        grads[l][b, y0 : y0 + tile, x0 : x0 + tile] = acc[: H - y0, : W - x0]
    return grads


def _bwd_case(seed, edge, R=40, C=LEVELS[0][3]):
    boxes, bidx, lvl = _rois(seed, R)
    if edge == "whole_level":  # over all of level 0, 56x40 at 1/4
        boxes[:8] = torch.tensor([-2.0, -2.0, 226.0, 162.0])
        lvl[:8] = 0
    elif edge == "stacked":  # many rois on one tile
        boxes[:] = torch.tensor([10.0, 12.0, 40.0, 30.0]) + torch.arange(R, dtype=torch.float32)[:, None] * 0.25
        lvl[:], bidx[:] = 0, 1
    elif edge == "none":
        boxes, bidx, lvl = boxes[:0], bidx[:0], lvl[:0]
    g = torch.from_numpy(np.random.RandomState(seed).standard_normal((boxes.shape[0], 7, 7, C)))
    return boxes, bidx, lvl, g


BWD_CASES = [
    (aligned, sr, edge)
    for aligned in (True, False)
    for sr in (0, 2, 3)
    for edge in ("mixed", "whole_level", "stacked", "none")
    if edge == "mixed" or sr == 0
]


@pytest.mark.parametrize("aligned, sampling_ratio, edge", BWD_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("tile", [8, 16])
def test_backward_tile_gather_is_the_plain_backward(aligned, sampling_ratio, edge, tile):
    """The emulated design in float64 equals ``roi_align_multilevel_backward_plain``
    in float64 to 1e-12, writing every pixel once (zeros where no roi taps);
    its lists hold each roi only on tiles its rectangle meets, in roi order,
    and every inside tap lies in a tile that lists its roi. The mixed rois
    include ones partly and fully off the map, zero-area, zero-width and
    all-zero ones (the v1 grid clamps those to 1x1)."""
    boxes, bidx, lvl, g = _bwd_case(sampling_ratio + 7 * aligned, edge)
    s = sampling_ratio if sampling_ratio > 0 else 2
    prep = bwd_prep(boxes, lvl, (7, 7), s, aligned)
    lists = bwd_tile_lists(bidx, lvl, prep, tile=tile)
    for rois in lists.values():
        assert rois == sorted(set(rois))
    taps = port_ra.roi_align_sample_taps(LEVELS, boxes, bidx, lvl, SCALES, (7, 7), sampling_ratio, aligned)
    for r in range(boxes.shape[0]):
        ys = {int(y) for part in ("ylo", "yhi") for y, i in zip(taps[part][r], taps["yin"][r]) if i}
        xs = {int(x) for part in ("xlo", "xhi") for x, i in zip(taps[part][r], taps["xin"][r]) if i}
        listed = {(ty, tx) for (l, b, ty, tx), rois in lists.items() if r in rois}
        assert listed == {(y // tile, x // tile) for y in range(min(ys), max(ys) + 1) for x in range(min(xs), max(xs) + 1)} if ys and xs else not listed
    got = bwd_tile_sum(g, lists, prep, (7, 7), s, tile=tile)
    ref = port_ra.roi_align_multilevel_backward_plain(g, LEVELS, boxes, bidx, lvl, SCALES, (7, 7), sampling_ratio, aligned)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64 and not a.isnan().any()
        assert (a - b).abs().max().item() <= 1e-12
    if edge == "none":
        assert all(a.eq(0).all() for a in got)


@pytest.mark.parametrize("fault", ["drop_tile", "off_by_one"])
def test_backward_tile_gather_fails_when_broken(fault):
    """A dropped tile or rectangles one pixel short (the last lower tap, not
    the last upper one) lose taps: the float64 comparison fails."""
    boxes, bidx, lvl, g = _bwd_case(1, "mixed")
    prep = bwd_prep(boxes, lvl, (7, 7), 2, True, fault=fault)
    lists = bwd_tile_lists(bidx, lvl, prep)
    drop = next(k for k, rois in lists.items() if rois) if fault == "drop_tile" else None
    got = bwd_tile_sum(g, lists, prep, (7, 7), 2, drop_tile=drop)
    ref = port_ra.roi_align_multilevel_backward_plain(g, LEVELS, boxes, bidx, lvl, SCALES, (7, 7), 0, True)
    assert max((a - b).abs().max().item() for a, b in zip(got, ref)) > 1e-3


def test_backward_tile_order_fixes_the_float32_bits():
    """In float32 the ordered sum gives the same bits every time and is
    within 1e-5 of the sum of |terms| of the exact one; the same lists walked
    in another order give other bits: the order is what makes the kernel's
    gradient reproducible."""
    boxes, bidx, lvl, g = _bwd_case(5, "stacked", R=24)
    prep = bwd_prep(boxes, lvl, (7, 7), 2, True)
    lists = bwd_tile_lists(bidx, lvl, prep)
    g32 = g.float()
    once = bwd_tile_sum(g32, lists, prep, (7, 7), 2, dtype=torch.float32)
    again = bwd_tile_sum(g32, lists, prep, (7, 7), 2, dtype=torch.float32)
    shuffled = {k: v[::-1] for k, v in lists.items()}
    other = bwd_tile_sum(g32, shuffled, prep, (7, 7), 2, dtype=torch.float32)
    args = (LEVELS, boxes, bidx, lvl, SCALES, (7, 7), 0, True)
    ref = port_ra.roi_align_multilevel_backward_plain(g32.double(), *args)
    bound = port_ra.roi_align_multilevel_backward_plain(g32.double().abs(), *args)
    assert all(torch.equal(a, b) for a, b in zip(once, again))
    assert not all(torch.equal(a, b) for a, b in zip(once, other))
    for a, r, A in zip(once, ref, bound):
        assert ((a.double() - r).abs() <= 1e-5 * A + 1e-7).all()
    assert max((a.double() - r).abs().max().item() for a, r in zip(other, ref)) <= 1e-4


def test_backward_wrapper_refuses_without_a_card():
    boxes, bidx, lvl = _rois(0, R=8)
    g = torch.zeros(8, 7, 7, 8)
    before = port_ra.roi_align_multilevel_backward_cuda.launches
    with pytest.raises(ValueError, match="expected cuda"):
        port_ra.roi_align_multilevel_backward_cuda(g, LEVELS, boxes, bidx, lvl, SCALES, 7)
    assert port_ra.roi_align_multilevel_backward_cuda.launches == before
