#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one GPU
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns: R50 forward, train step, ViTDet forward,
                                     # and one RoIAlign backward call per timed pool
    python3 chip_smoke.py --ptxas --kernels-only  # while working on a kernel: registers, spills and the
                                     # compiler's warnings per kernel, then phases 3, 8 and 6 alone

Phases, in order; any failure exits non-zero:

1. card: name and power limit; TF32 off for the comparisons;
2. build: every CUDA kernel of the port, one nvcc per source, in parallel;
3. kernel vs plain: the RoIAlign kernel against its plain PyTorch version in
   float32 and bfloat16, aligned and v1 grids, sampling_ratio 0 and 2, at the
   Mask R-CNN R50-FPN main-path shapes (box pool 16000 rois at 7x7, mask pool
   1600 rois at 14x14 over p2-p5 of 16 images at 800x1344, C=256), with
   rois partly off the map, zero-area rois and padded zero rows; times the
   kernel and the plain version with CUDA events;
4. golden: the R18-FPN fixture of tests/goldens/e2e_maskrcnn_r18.npz run on
   the card in float32 must reproduce the reference detections;
5. main path: the full-width R50-FPN Mask R-CNN (3x config, bf16, masks
   pasted on the device, seeded random weights) answers 3 DefaultPredictor
   requests, then runs the batch forward at 16 x 800x1344; the kernel's
   launch count must show that both pools of every forward went through it,
   and the kernel is held once more against the plain version on the
   pooler inputs the main path produced;
6. backward kernel vs plain: the RoIAlign backward kernel against its plain
   version at the R50-FPN train shapes (box pool 4096 rois at 7x7, mask pool
   1024 rois at 14x14 over p2-p5 of 8 images at 800x1344, C=256), float32
   and bfloat16 cotangents, both grids, sampling_ratio 0 and 2; every case
   on the 16-byte path and bitwise equal over two launches; timed with CUDA
   events beside its bound and its time before the redesign;
7. training, full width: the R50-FPN Mask R-CNN (3x config, bf16, seeded
   weights) takes 10 steps of the port's SimpleTrainer with build_optimizer
   and the LRScheduler hook (warmup over 100 steps, not 1000) on a
   synthetic padded batch of 8 x 800x1344 with 5-50 valid gt per image; every loss is finite at every step, each kernel
   launches twice per step, every trainable parameter moves and the frozen
   stem and res2 do not; both kernels are held against their plain versions
   on the pooler inputs and cotangents the first step recorded (each
   cotangent scaled exactly, by a power of two, to a max in [1, 2)), the
   backward there on the 16-byte path and bitwise equal over two launches,
   and held once more on the same rois and cotangent in float32 and
   bfloat16, on both grids, at sampling ratios 0 and 2;
8. attention kernels vs plain: both entry points of csrc/flash_attention.cu
   (standard and transposed bias factors) against their plain PyTorch
   versions at the two ViTDet-B shapes, global [96, 4096, 64] with 64x64
   factors and windowed [2400, 196, 64] with 14x14, with and without bias,
   in float32 and bfloat16; timed with CUDA events beside the bound and
   beside one F.scaled_dot_product_attention call with the bias
   materialised as attn_mask (measured here only, used nowhere in the port);
   each launch must take the kernel its shape is dispatched to (float32 the
   SIMT one, bfloat16 the wgmma kernel at the global shape and the
   whole-window kernel at the windowed one);
9. ViTDet main path, full width: Mask R-CNN ViTDet-B (12 blocks of width
   768, 14x14 windows, 4 global blocks; bf16, masks pasted on the device,
   seeded random weights) runs 4 batch forwards at 8 x 1024x1024, then
   answers 3 requests of differing sizes through the predictor (resize to
   1024, pad to the square, forward, postprocess); every forward must launch
   the attention kernel 12 times (8 windowed + 4 global blocks) and the
   RoIAlign kernel twice; the kernels are held once more against their
   plain versions on the q, k, v and factors the first windowed and the
   first global block produced and on the pooler inputs; one more forward
   with the transposed factor layout (D2T_FLASH_V2=1) must launch the
   transposed kernel 12 times and detect what the standard layout detected;
   in every forward the 4 global launches must have taken the wgmma kernel
   and the 8 windowed ones the whole-window kernel, in both layouts;
10. COCO evaluation, full width (``tools/train_net.py --eval-only`` on the
   port): a synthetic COCO-format dataset of 64 PNGs at COCO's image sizes
   (written without PIL, 1-12 rectangle and polygon objects each over the
   80 categories, crowd RLE in every eighth image) registered with
   register_coco_instances; the zoo's R50-FPN 3x yaml in bf16 with phase
   5's seeded weights and FrozenBN statistics; DefaultTrainer.test with
   COCOEvaluator over the test loader. Every metric of the csv table must
   be finite and in [0, 100], the RoIAlign kernel must launch twice per
   batch (box and mask pool) on its 16-byte path, the ground truth fed back
   as detections must score AP 100 (bbox and segm), and on four images the
   eval path's Instances must equal DefaultPredictor's (classes equal,
   boxes within 1e-3 px, scores within 1e-4, masks on 99.9% of pixels).
   The RoIAlign kernel is held once more against its plain version on the
   pooler inputs of the loader's first batch, in bf16 as run and in
   float32. Logs the eval loop's img/s, its data/compute/evaluator seconds per
   image, COCOeval's wall time and the peak memory.

Phase 8 also holds both entry points at ViT-H's head dim 80, [16, 4096, 80]
(global) and [400, 196, 80] (windowed), in float32 and bfloat16 with the
bias, and requires the kernels of those shapes (``simt_f32``, ``mma_tiled``).

Beside each main-path time of the RoIAlign forward and backward and the
attention kernels the run logs the time before their redesign (constants
below); the JSON line
of the kernels holds only what this run measured, and the bounds.
The line before the last is the JSON of the ported kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 on the tensor cores, H100 SXM data sheet
F32_TOL = 1e-5
B, H, W, C = 16, 800, 1344, 256
STRIDES = (4, 8, 16, 32)
BOX_ROIS, BOX_RES = 1000, 7  # per image
MASK_ROIS, MASK_RES = 100, 14
# training: ROI_HEADS.BATCH_SIZE_PER_IMAGE box rois and its positive
# fraction (the mask branch's foreground budget) per image
TRAIN_B, TRAIN_BOX_ROIS, TRAIN_MASK_ROIS, TRAIN_G = 8, 512, 128, 50
TRAIN_STEPS = 10
LOSSES = ("loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc")
# phase 10: the synthetic COCO it evaluates on, and the zoo config
EVAL_IMAGES = 64
EVAL_CONFIG = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"
EVAL_KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl")  # what print_csv_format prints
# Kernel times before the redesign of the RoIAlign forward and the attention
# kernels, ms on the main paths' own inputs, taken with this script on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6 keeps them as the earlier
# times). Logged beside this run's times, never put into the kernels line.
PREV_MS_FROM = "H100 80GB HBM3, 700 W, before the redesign (PERF.md section 6)"
PREV_ROI_FWD_MS = {
    "inference": {7: 3.5450, 14: 1.3832},
    "train": {7: 0.9203, 14: 0.8904},
    "vitdet": {7: 1.7566, 14: 0.6972},
}
# the RoIAlign backward before its redesign as a per-tile gather (PERF.md
# section 6; "synthetic": phase 6's inputs, "train": phase 7's recorded ones)
PREV_ROI_BWD_MS = {
    "synthetic": {7: 2.0382, 14: 1.6619},
    "train": {7: 2.2919, 14: 1.9864},
}
PREV_ATTN_MS = {
    False: {"global": 2.5888, "windowed": 0.3990},
    True: {"global": 2.5581, "windowed": 0.3931},
}
# the kernel of csrc/flash_attention.cu each ViTDet-B main-path shape must take
ATTN_MAIN_PATHS = {"global": "wgmma", "windowed": "mma_window"}


def log(*args):
    print(*args, flush=True)


def check(cond, msg="") -> None:
    """A failed check fails the run (not an assert: it must hold under -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def event_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_rois(gen, n_per_image: int, device, batch: int = B):
    """Boxes like a detector's over 800x1344 images: log-uniform sizes 2-900 px,
    aspect 1/3-3, centres spread 10% past each edge; 2% zero-area and the last
    5% of every image's slots padded with zero rows."""
    import torch

    n = batch * n_per_image
    u = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    size = torch.exp(u(n) * (np.log(900.0) - np.log(2.0)) + np.log(2.0))
    aspect = torch.exp((u(n) * 2 - 1) * np.log(3.0))
    w, h = size * aspect.sqrt(), size / aspect.sqrt()
    cx = u(n) * W * 1.2 - 0.1 * W
    cy = u(n) * H * 1.2 - 0.1 * H
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], 1)
    zero_area = u(n) < 0.02
    boxes[zero_area, 2] = boxes[zero_area, 0]
    boxes = boxes.reshape(batch, n_per_image, 4)
    boxes[:, int(n_per_image * 0.95) :] = 0
    bidx = torch.arange(batch, device=device, dtype=torch.int32).repeat_interleave(n_per_image)
    return boxes.reshape(-1, 4).contiguous(), bidx


def roi_taps(shapes, boxes, bidx, levels, scales, res, sr, aligned):
    """(feature rows some inside sample taps, inside samples) on these inputs."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_sample_taps

    t = roi_align_sample_taps(shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    inside = t["yin"][:, :, None] & t["xin"][:, None, :]
    rows = []
    for y in (t["ylo"], t["yhi"]):
        for x in (t["xlo"], t["xhi"]):
            idx = t["base"][:, None, None] + y[:, :, None] * t["W"][:, None, None] + x[:, None, :]
            rows.append(idx[inside])
    return torch.unique(torch.cat(rows)).numel(), int(inside.sum().item())


def roi_align_cost(feats, boxes, bidx, levels, scales, res, sr, aligned):
    """(bytes, flops) the forward needs on these inputs: each feature row that
    some inside sample taps, read once; boxes and indices read once; the
    output written once; 2 flops per tap and channel for inside samples."""
    shapes = [tuple(f.shape) for f in feats]
    touched, inside = roi_taps(shapes, boxes, bidx, levels, scales, res, sr, aligned)
    item = feats[0].element_size()
    R, C = boxes.shape[0], shapes[0][-1]
    nbytes = touched * C * item + R * (16 + 4 + 4) + R * res * res * C * item
    return nbytes, 2 * 4 * inside * C


# The backward's geometry in csrc/roi_align.cu, for the traffic model below:
# pixels of a list tile (D2T_TILE) and of the block of pixel rows x columns
# that shares one read of each cotangent word (D2T_BWD_WARPS x D2T_BWD_COLS).
ROI_BWD_TILE = 16
ROI_BWD_BLOCK = (8, 4)


def roi_align_backward_cost(g, shapes, boxes, bidx, levels, scales, res, sr, aligned):
    """(bytes, flops, design_bytes) of the backward on these inputs. The
    bound's bytes are what the function must move: the cotangent, boxes and
    indices read once and the dense gradient over every level written once
    in the cotangent's dtype; 2 flops per tap and channel for inside
    samples. ``design_bytes`` is the least traffic the kernel's own design
    adds on top, which the bound does not count: every ``ROI_BWD_BLOCK`` of
    pixels reads the cotangent words of each bin whose inside samples tap it
    (counted here beyond the one read of the bound), and the int32 scratch
    (axis tables, rectangles, planes, the counts and offsets of the
    ``ROI_BWD_TILE`` tiles, the lists) is written once and read once. A
    model, not a measurement: it is logged, never put into the kernels line."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_sample_taps

    t = roi_align_sample_taps(shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    inside = int((t["yin"][:, :, None] & t["xin"][:, None, :]).sum().item())
    item = g.element_size()
    R, C = boxes.shape[0], shapes[0][-1]
    total = sum(s[0] * s[1] * s[2] for s in shapes) * C
    nbytes = g.numel() * item + R * (16 + 4 + 4) + total * item
    s_ = sr if sr > 0 else 2
    tile, block = ROI_BWD_TILE, ROI_BWD_BLOCK

    def spans(lo, hi, ins, size, groups):
        """[R, groups]: how many ``size``-pixel bands the inside taps of each
        group of samples (bins, or the whole roi) span."""
        big = torch.iinfo(torch.int64).max
        first = torch.where(ins, lo, big).reshape(R, groups, -1).min(-1).values
        last = torch.where(ins, hi, -1).reshape(R, groups, -1).max(-1).values
        return torch.where(last >= 0, last // size - first.clamp_max(big - 1) // size + 1, 0)

    y = (t["ylo"], t["yhi"], t["yin"])
    x = (t["xlo"], t["xhi"], t["xin"])
    reread = int((spans(*y, block[0], res).sum(1) * spans(*x, block[1], res).sum(1)).sum().item()) * C * item
    pairs = int((spans(*y, tile, 1) * spans(*x, tile, 1)).sum().item())  # list entries
    n_tiles = sum(s[0] * -(-s[1] // tile) * -(-s[2] // tile) for s in shapes)
    scratch = R * 2 * res * s_ * 16 + R * (16 + 4) + (2 * n_tiles + 1) * 4 + pairs * 4
    design = max(reread - g.numel() * item, 0) + 2 * scratch
    return nbytes, 2 * 4 * inside * C, design


def bound(nbytes, flops, peak_flops=H100_F32_FLOPS):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, label, timing=False, prev_ms=None):
    """Kernel vs plain on identical inputs; ``prev_ms``, the kernel's time
    on these inputs before its redesign, marks a main-path pool, which must
    take the 16-byte path. float32: |diff| <= 1e-5. bfloat16:
    the plain version interpolates in bf16 like the XLA path while the
    kernel accumulates in f32, so (a) against plain-bf16 the bound is
    8 roundings of 2^-9 relative to the largest tap, max|f| / 64, and
    (b) against the plain version run in f32 on the same bf16 inputs the
    only difference is the kernel's one output rounding, at most half a
    bf16 ulp, 2^-8 * |ref| per element, plus 1e-5 for the f32 sum order."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda, roi_align_multilevel_plain

    args = (feats, boxes, bidx, levels, scales, (res, res), sr, aligned)
    out = roi_align_multilevel_cuda(*args)
    torch.cuda.synchronize()
    ref = roi_align_multilevel_plain(*args)
    check(out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape))
    check(torch.isfinite(out.float()).all(), label)
    err = (out.float() - ref.float()).abs().max().item()
    if feats[0].dtype == torch.float32:
        tol = F32_TOL
        line = f"{label}: max_abs_err {err:.3e} (tol {tol:.1e})"
    else:
        tol = max(f.abs().max().item() for f in feats) / 64
        ref32 = roi_align_multilevel_plain([f.float() for f in feats], *args[1:])
        diff32 = (out.float() - ref32).abs()
        err32 = diff32.max().item()
        excess = (diff32 - (2.0**-8 * ref32.abs() + 1e-5)).max().item()
        line = (
            f"{label}: max_abs_err vs bf16 plain {err:.3e} (tol {tol:.3e}), "
            f"vs f32 plain {err32:.3e} (tol 2^-8*|ref|+1e-5 per element)"
        )
        check(excess <= 0, line)
    check(err <= tol, line)
    log("  " + line)
    res_d = {"max_abs_err": err, "path": roi_align_multilevel_cuda.last_path}
    if prev_ms is not None:
        check(res_d["path"] == "vector", f"{label}: took the {res_d['path']} path")
    if timing:
        res_d["ms"] = event_ms(lambda: roi_align_multilevel_cuda(*args), 3, 20)
        res_d["plain_ms"] = event_ms(lambda: roi_align_multilevel_plain(*args), 1, 3)
        nbytes, flops = roi_align_cost(feats, boxes, bidx, levels, scales, res, sr, aligned)
        res_d["bound_ms"], res_d["bound_by"] = bound(nbytes, flops)
        res_d["bytes"], res_d["flops"] = nbytes, flops
        log(
            f"    kernel {res_d['ms']:.4f} ms, plain {res_d['plain_ms']:.3f} ms, "
            f"bound {res_d['bound_ms']:.4f} ms by {res_d['bound_by']} "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP)"
            + (f"; {prev_ms:.4f} ms on {PREV_MS_FROM}: {prev_ms / res_d['ms']:.2f}x"
               if prev_ms is not None else "")
        )
    return res_d


def phase_kernel_vs_plain(device):
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    scales = tuple(1.0 / s for s in STRIDES)
    feats32 = [
        torch.randn(B, H // s, W // s, C, generator=gen, device=device) for s in STRIDES
    ]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    results = {}
    for res, n in ((BOX_RES, BOX_ROIS), (MASK_RES, MASK_ROIS)):
        boxes, bidx = synthetic_rois(gen, n, device)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        log(f"  shape: {boxes.shape[0]} rois at {res}x{res}, levels {[tuple(f.shape) for f in feats16]}, "
            f"rois per level {torch.bincount(levels, minlength=4).tolist()}")
        for dtype, feats in (("f32", feats32), ("bf16", feats16)):
            for aligned in (True, False):
                for sr in (0, 2):
                    timing = dtype == "bf16" and aligned and sr == 0
                    r = compare_kernel(
                        feats, boxes, bidx, levels, scales, res, sr, aligned,
                        f"R={boxes.shape[0]} {res}x{res} {dtype} aligned={aligned} sr={sr}", timing,
                    )
                    if timing:
                        results[res] = r
    return results


def phase_golden(device):
    import torch

    from detectron2_tpu_torch.checkpoint import load_state_dict_report
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.testing import compare_with_golden, golden_r18_config, golden_state_dict

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens", "e2e_maskrcnn_r18.npz"))
    model = build_model(golden_r18_config(), device=device)
    log("  " + load_state_dict_report(model, golden_state_dict(golden)).splitlines()[0])
    out = model({"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)})
    torch.cuda.synchronize()
    errs = compare_with_golden(out, golden)
    log(f"  R18-FPN fixture on the card, f32: reproduces the reference detections: {errs}")


def check_instances(inst, n, h, w) -> None:
    """One request's result: n boxes inside the h x w image, n full-size masks."""
    import torch

    boxes, masks = inst.pred_boxes.tensor, inst.pred_masks.tensor
    check(len(inst.pred_boxes) == n and masks.shape == (n, h, w) and masks.dtype == torch.bool)
    check(torch.isfinite(boxes).all() and (boxes[:, 0::2] <= w).all() and (boxes[:, 1::2] <= h).all())
    check((boxes >= 0).all() and torch.isfinite(inst.scores).all())


def phase_main_path(device):
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.model_zoo import mask_rcnn_R_50_FPN_3x_config
    from detectron2_tpu_torch.modeling import calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    cfg = mask_rcnn_R_50_FPN_3x_config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.PASTE_MASKS_IN_GRAPH = True
    predictor = DefaultPredictor(cfg, device=device)
    model = predictor.model
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    images = torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[H, W]] * B, dtype=torch.int32, device=device)}
    calibrate_frozen_bn(model, {k: v[:2] for k, v in batch.items()})
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  R50-FPN Mask R-CNN, {n_params} parameters, bf16 compute, in-graph paste")

    # (a) DefaultPredictor, 3 requests of different sizes
    rng = np.random.RandomState(0)
    roi_align_multilevel_cuda.launches = 0
    for h, w in ((480, 640), (600, 800), (427, 1000)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = len(inst)
        check(n > 0, "no detections")
        check_instances(inst, n, h, w)
        log(f"  request {h}x{w}: {n} instances, masks {tuple(inst.pred_masks.tensor.shape)}, {dt * 1e3:.1f} ms")
    predictor_launches = roi_align_multilevel_cuda.launches
    check(predictor_launches == 2 * 3, predictor_launches)

    # (b) batch forward, 16 x 800x1344; the first forward also records the
    # pooler inputs for the comparison below
    recorded = []
    kernel_entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        recorded.append((args, kwargs))
        return kernel_entry(*args, **kwargs)

    iters = 3
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    poolers.roi_align_multilevel = recording
    try:
        out = model(batch)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = model(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    batch_launches = roi_align_multilevel_cuda.launches
    check(batch_launches == 2 * (1 + iters), batch_launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  batch forward 16x800x1344: {dt * 1e3:.1f} ms/batch, {B / dt:.2f} img/s, peak memory {peak:.2f} GiB")
    log(f"  RoIAlign kernel launches: {predictor_launches} over 3 requests, {batch_launches} over {1 + iters} batch forwards")

    if "--profile" in sys.argv[1:]:
        profile_run(lambda: model(batch), "forward", "main_path_trace.json")

    D = cfg.TEST.DETECTIONS_PER_IMAGE
    check(out["pred_boxes"].shape == (B, D, 4) and out["pred_masks"].shape == (B, D, 28, 28))
    check(out["pred_masks_full"].shape == (B, D, H, W) and out["pred_masks_full"].dtype == torch.bool)
    check(torch.isfinite(out["pred_boxes"]).all() and torch.isfinite(out["pred_masks"]).all())
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    log(f"  detections per image: {n_valid}")

    # the kernel against the plain version on the main path's own inputs
    check(len(recorded) == 2, len(recorded))
    shapes = {}
    for (args, kwargs), res in zip(recorded, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        r = compare_kernel(
            feats, boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"],
            f"main-path pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["inference"][res],
        )
        shapes[res] = r
    return {
        "img_s": B / dt,
        "batch_ms": dt * 1e3,
        "peak_gib": peak,
        "launches": predictor_launches + batch_launches,
        "shapes": shapes,
        # phase 10's weights, on the host: the model is freed with this phase
        "state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
    }


# the RoIAlign backward's five kernels, summed in a profile
ROI_BWD_KERNELS = ("d2t_bwd_", "d2t_roi_align_bwd")


def profile_run(fn, label: str, trace_name: str, top: int = 25):
    """``--profile``: device time by kernel over one call of ``fn``
    (torch.profiler), the device's busy share of the wall time, and a Chrome
    trace in chiprun_out/ (none when ``trace_name`` is None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:  # kernels and copies on the card
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, count + 1)
    rows = [(ms, count, name) for name, (ms, count) in by_name.items()]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernels")
    for ms, count, key in rows[:top]:
        log(f"    {ms:9.3f} ms  {count:6d}x  {key[:110]}")
    bwd = [r for r in rows if any(k in r[2] for k in ROI_BWD_KERNELS)]
    if bwd:
        log(f"    RoIAlign backward (prep, count, scan, fill, accumulate): {sum(r[0] for r in bwd):.3f} ms "
            f"in {sum(r[1] for r in bwd)} launches of {len(bwd)} kernels")
    if trace_name is None:
        return
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, trace_name))


def compare_backward(g, shapes, boxes, bidx, levels, scales, res, sr, aligned, label, timing=False, prev_ms=None):
    """Backward kernel vs plain backward on identical inputs. Per element
    |kernel - plain(float32)| <= 1e-5 * A + 1e-7, A the plain backward of
    |g|: the kernel adds the same terms in another order (each bin's sample
    weights summed first, rois in tile-list order), and A bounds that sum's
    rounding; for a bfloat16 cotangent plus half a bf16 ulp of the float32
    result, 2^-8 * |ref|, the kernel's one rounding. The check fails too if
    the tolerance covers |ref| everywhere, where a kernel that wrote zeros
    would pass: scale a tiny ``g`` up first. A second launch must give the
    same bits. ``prev_ms``, the time on these inputs before the redesign,
    marks a main-path pool, which must take the 16-byte path."""
    import torch

    from detectron2_tpu_torch.ops.roi_align import (
        roi_align_multilevel_backward_cuda,
        roi_align_multilevel_backward_plain,
    )

    args = (shapes, boxes, bidx, levels, scales, (res, res), sr, aligned)
    out = roi_align_multilevel_backward_cuda(g, *args)
    path = roi_align_multilevel_backward_cuda.last_path
    again = roi_align_multilevel_backward_cuda(g, *args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)), f"{label}: two launches differ")
    del again
    ref = roi_align_multilevel_backward_plain(g.float(), *args)
    bound_a = roi_align_multilevel_backward_plain(g.float().abs(), *args)
    err, excess, margin, ref_max = 0.0, float("-inf"), float("-inf"), 0.0
    for o, r, a in zip(out, ref, bound_a):
        check(o.shape == r.shape and o.dtype == g.dtype, (o.shape, o.dtype, r.shape))
        check(torch.isfinite(o.float()).all(), label)
        diff = (o.float() - r).abs()
        tol = 1e-5 * a + 1e-7
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0**-8 * r.abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - tol).max().item())
        margin = max(margin, (r.abs() - tol).max().item())
        ref_max = max(ref_max, r.abs().max().item())
    del out, ref, bound_a
    line = (
        f"{label} [{path}]: max_abs_err vs f32 plain {err:.3e}, max|ref| {ref_max:.3e} "
        f"(tol 1e-5*A+1e-7{' + 2^-8*|ref|' if g.dtype == torch.bfloat16 else ''} per element); "
        f"two launches bitwise equal"
    )
    check(excess <= 0, line)
    check(margin > 0, f"{line}: the tolerance covers |ref| everywhere, a zero gradient would pass")
    log("  " + line)
    res_d = {"max_abs_err": err, "path": path}
    if prev_ms is not None:
        check(path == "vector", f"{label}: took the {path} path")
    if timing:
        res_d["ms"] = event_ms(lambda: roi_align_multilevel_backward_cuda(g, *args), 3, 10)
        res_d["plain_ms"] = event_ms(lambda: roi_align_multilevel_backward_plain(g, *args), 1, 2)
        nbytes, flops, design = roi_align_backward_cost(g, *args[:5], res, sr, aligned)
        res_d["bound_ms"], res_d["bound_by"] = bound(nbytes, flops)
        res_d["bytes"], res_d["flops"] = nbytes, flops
        log(
            f"    kernel {res_d['ms']:.4f} ms, plain {res_d['plain_ms']:.3f} ms, "
            f"bound {res_d['bound_ms']:.4f} ms by {res_d['bound_by']} "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP); the design adds >= {design / 1e9:.4f} GB"
            + (f"; {prev_ms:.4f} ms on {PREV_MS_FROM}: {prev_ms / res_d['ms']:.2f}x" if prev_ms is not None else "")
        )
        if "--profile" in sys.argv[1:]:
            profile_run(lambda: roi_align_multilevel_backward_cuda(g, *args), f"{label}, one call", None, top=8)
    return res_d


def phase_backward_vs_plain(device):
    import torch

    from detectron2_tpu_torch.modeling.poolers import assign_boxes_to_levels

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    scales = tuple(1.0 / s for s in STRIDES)
    shapes = [(TRAIN_B, H // s, W // s, C) for s in STRIDES]
    results = {}
    for res, n in ((BOX_RES, TRAIN_BOX_ROIS), (MASK_RES, TRAIN_MASK_ROIS)):
        boxes, bidx = synthetic_rois(gen, n, device, TRAIN_B)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        log(f"  shape: {boxes.shape[0]} rois at {res}x{res}, levels {shapes}, "
            f"rois per level {torch.bincount(levels, minlength=4).tolist()}")
        g32 = torch.randn((boxes.shape[0], res, res, C), generator=gen, device=device)
        for dtype, g in (("f32", g32), ("bf16", g32.bfloat16())):
            for aligned in (True, False):
                for sr in (0, 2):
                    timing = dtype == "bf16" and aligned and sr == 0
                    r = compare_backward(
                        g, shapes, boxes, bidx, levels, scales, res, sr, aligned,
                        f"bwd R={boxes.shape[0]} {res}x{res} {dtype} aligned={aligned} sr={sr}", timing,
                        prev_ms=PREV_ROI_BWD_MS["synthetic"][res] if timing else None,
                    )
                    check(r["path"] == "vector", f"C={C}: the backward took the {r['path']} path")
                    if timing:
                        results[res] = r
    return results


def synthetic_train_batch(device):
    """A padded batch as tools/_bench_train.py builds it: 8 x 800x1344
    uint8 images, 50 gt slots per image of which 5-50 are valid, boxes
    16-316 px with corners from 0-600 px (scaled by H/800 at other sizes),
    80 classes, 28x28 gt masks."""
    import torch

    rng = np.random.RandomState(0)
    Bt, G = TRAIN_B, TRAIN_G
    xy = rng.rand(Bt, G, 2) * 600 * (H / 800)
    wh = (rng.rand(Bt, G, 2) * 300 + 16) * (H / 800)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(G)[None, :] < rng.randint(5, G + 1, (Bt, 1))
    boxes[~valid] = 0
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "image": as_t(rng.randint(0, 256, (Bt, H, W, 3)).astype(np.uint8)),
        "image_sizes": as_t(np.tile(np.array([[H, W]], np.int32), (Bt, 1))),
        "gt_boxes": as_t(boxes),
        "gt_classes": as_t(rng.randint(0, 80, (Bt, G)).astype(np.int32)),
        "gt_valid": as_t(valid),
        "gt_masks": as_t((rng.rand(Bt, G, 28, 28) > 0.5).astype(np.float32)),
    }


def phase_train(device):
    import itertools

    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch.engine import SimpleTrainer, hooks
    from detectron2_tpu_torch.model_zoo import mask_rcnn_R_50_FPN_3x_config
    from detectron2_tpu_torch.modeling import build_model, calibrate_frozen_bn, init_weights
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
    from detectron2_tpu_torch.solver import build_lr_scheduler, build_optimizer

    cfg = mask_rcnn_R_50_FPN_3x_config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    # the 3x schedule warms up over 1000 iterations: its first steps' LR
    # (2e-5 and up) moves the mask head's weights by less than a float32 ulp,
    # so the smoke run ramps to BASE_LR over its own steps instead
    cfg.SOLVER.WARMUP_ITERS = 10 * TRAIN_STEPS
    torch.manual_seed(0)  # the samplers' draws
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    batch = synthetic_train_batch(device)
    calibrate_frozen_bn(model, {k: batch[k][:2] for k in ("image", "image_sizes")})
    optimizer = build_optimizer(cfg, model)
    scheduler = build_lr_scheduler(cfg, optimizer)
    params0 = {name: p.detach().clone() for name, p in model.named_parameters()}
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"  R50-FPN Mask R-CNN, {sum(v.numel() for v in params0.values())} parameters ({n_train} trainable), "
        f"bf16 compute, batch {TRAIN_B} x {H}x{W}, gt per image {batch['gt_valid'].sum(1).tolist()}")

    # the first step records the pooler inputs and the cotangents reaching them
    recorded = []
    kernel_entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        out = kernel_entry(*args, **kwargs)
        if len(recorded) < 2:
            rec = {"args": args, "kwargs": kwargs}
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone(memory_format=torch.contiguous_format)))
            recorded.append(rec)
        return out

    trainer = SimpleTrainer(model, itertools.repeat(batch), optimizer)
    trainer.register_hooks([hooks.IterationTimer(warmup_iter=2), hooks.LRScheduler(optimizer, scheduler)])
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_backward_cuda.launches = 0
    poolers.roi_align_multilevel = recording
    try:
        trainer.train(0, TRAIN_STEPS)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    torch.cuda.synchronize()
    fwd_launches = roi_align_multilevel_cuda.launches
    bwd_launches = roi_align_multilevel_backward_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(fwd_launches == 2 * TRAIN_STEPS, f"forward kernel launches {fwd_launches}")
    check(bwd_launches == 2 * TRAIN_STEPS, f"backward kernel launches {bwd_launches}")

    storage = trainer.storage
    for k in LOSSES:
        values = [v for v, _ in storage.history(k).values()]
        check(len(values) == TRAIN_STEPS and all(np.isfinite(values)), (k, values))
        log(f"  {k}: " + ", ".join(f"{v:.4f}" for v in values))
    step_times = [v for v, _ in storage.history("time").values()]
    step_ms = storage.history("time").median(TRAIN_STEPS) * 1e3
    mean_ms = sum(step_times) / len(step_times) * 1e3
    lrs = [v for v, _ in storage.history("lr").values()]
    log(f"  lr {lrs[0]:.3e} -> {lrs[-1]:.3e}; train step over steps 3-{TRAIN_STEPS}: median {step_ms:.1f} ms, "
        f"mean {mean_ms:.1f} ms ({TRAIN_B / step_ms * 1e3:.2f} and {TRAIN_B / mean_ms * 1e3:.2f} img/s), "
        f"peak memory {peak:.2f} GiB")
    log("  step times (ms): " + ", ".join(f"{v * 1e3:.1f}" for v in step_times))
    log(f"  RoIAlign launches over {TRAIN_STEPS} steps: forward {fwd_launches}, backward {bwd_launches}")

    unchanged, moved_frozen = [], []
    frozen_prefixes = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")
    for name, p in model.named_parameters():
        same = torch.equal(p.detach(), params0[name])
        if name.startswith(frozen_prefixes):
            check(not p.requires_grad, f"{name} should be frozen")
            if not same:
                moved_frozen.append(name)
        elif not p.requires_grad:
            raise RuntimeError(f"check failed: {name} is frozen but outside stem/res2")
        elif same:
            unchanged.append(name)
    check(not unchanged, f"trainable parameters that did not move: {unchanged}")
    check(not moved_frozen, f"frozen parameters that moved: {moved_frozen}")
    log(f"  every trainable parameter moved; the frozen stem and res2 did not")

    # both kernels against their plain versions on the first step's inputs
    check(len(recorded) == 2 and all("grad" in r for r in recorded), len(recorded))
    fwd, bwd = {}, {}
    with torch.no_grad():
        for rec, res in zip(recorded, (BOX_RES, MASK_RES)):
            feats, boxes, bidx, levels, scales, size = rec["args"]
            feats = [f.detach() for f in feats]
            sr, aligned = rec["kwargs"]["sampling_ratio"], rec["kwargs"]["aligned"]
            fwd[res] = compare_kernel(
                feats, boxes, bidx, levels, scales, res, sr, aligned,
                f"train-step pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["train"][res],
            )
            # the loss-normalized cotangents are tiny (max ~1e-8), under the
            # tolerance's 1e-7 floor; the backward is linear in them, so scale
            # them by a power of two, exactly, to a max in [1, 2)
            g = rec["grad"]
            g_max = g.float().abs().max().item()
            check(g_max > 0, f"pool {res}x{res}: the train step's cotangent is zero")
            g = g * 2.0 ** -math.floor(math.log2(g_max))
            shapes = [tuple(f.shape) for f in feats]
            scaled = f"cotangent x 2^{-math.floor(math.log2(g_max))}"
            bwd[res] = compare_backward(
                g, shapes, boxes, bidx, levels, scales, res, sr, aligned,
                f"train-step bwd R={boxes.shape[0]} {res}x{res} bf16 ({scaled})",
                timing=True, prev_ms=PREV_ROI_BWD_MS["train"][res],
            )
            # the same rois and cotangent in both dtypes, on both grids, at
            # both sampling ratios
            for dtype in (torch.float32, torch.bfloat16):
                for other_aligned in (True, False):
                    for other_sr in (0, 2):
                        if (dtype, other_aligned, other_sr) == (g.dtype, aligned, sr):
                            continue
                        compare_backward(
                            g.to(dtype), shapes, boxes, bidx, levels, scales, res, other_sr, other_aligned,
                            f"train-step bwd R={boxes.shape[0]} {res}x{res} {'f32' if dtype == torch.float32 else 'bf16'} aligned={other_aligned} "
                            f"sr={other_sr} ({scaled})",
                        )
    recorded.clear()

    if "--profile" in sys.argv[1:]:
        def one_step():
            losses = model(batch, train=True)
            optimizer.zero_grad(set_to_none=True)
            sum(losses.values()).backward()
            optimizer.step()

        profile_run(one_step, "train step", "train_step_trace.json")

    return {
        "train_ms_per_step": step_ms,
        "train_mean_ms_per_step": mean_ms,
        "train_img_s": TRAIN_B / step_ms * 1e3,
        "train_mean_img_s": TRAIN_B / mean_ms * 1e3,
        "train_peak_gib": peak,
        "fwd_launches": fwd_launches,
        "bwd_launches": bwd_launches,
        "fwd": fwd,
        "bwd": bwd,
    }

# ViTDet-B at 8 x 1024x1024: (batch-heads, tokens, head dim, Hk, Wk)
VIT_B, VIT_HW = 8, 1024
ATTN_SHAPES = {"global": (96, 4096, 64, 64, 64), "windowed": (2400, 196, 64, 14, 14)}
ATTN_PER_FORWARD = {"global": 4, "windowed": 8}
# the plain version stores [chunk, S, S] float32 scores
ATTN_CHUNK = {"global": 24, "windowed": 600}
# ViT-H's head dim, 1280 / 16 heads = 80 (no other main path has it): one
# 1024x1024 image's global block (16 heads x 64x64 tokens) and windowed block
# (16 heads x 25 windows of 14x14), and the kernel each must take
ATTN_D80_SHAPES = {"vith_global": (16, 4096, 80, 64, 64), "vith_windowed": (400, 196, 80, 14, 14)}
ATTN_D80_CHUNK = {"vith_global": 8, "vith_windowed": 400}
ATTN_D80_PATHS = {"float32": "simt_f32", "bfloat16": "mma_tiled"}


def attention_entry(transposed: bool):
    from detectron2_tpu_torch.ops import attention as A

    return (A.flash_attention_t_cuda, A.attention_plain_t) if transposed else (A.flash_attention_cuda, A.attention_plain)


def plain_in_chunks(plain, args, scale, chunk):
    """The plain version over slices of the batch-heads (each slice is the
    whole function for its batch-heads: the arithmetic is unchanged)."""
    import torch

    B = args[0].shape[0]
    return torch.cat(
        [plain(*(None if a is None else a[s : s + chunk] for a in args), scale) for s in range(0, B, chunk)]
    )


def compare_attention(args, scale, transposed, chunk, label, timing=False, entry=None):
    """Attention kernel vs plain on identical inputs. float32: 2e-5 * max|v|
    (sum order and the exponential; the JAX package's own test holds its TPU
    kernel to 2e-5; an output is a convex combination of v's rows). bfloat16:
    per element, the bounds of ``testing.attention_bf16_bounds``, which scale
    with A = softmax @ |v| and |ref|: 2^-9 A + 2^-8 |ref| + 2e-5 max|v|
    against the plain version run in float32 on the same inputs, and that
    plus 2^-9 (1 + 2 max|bias|) A + 2^-9 |ref| against the plain version in
    bfloat16, which also rounds the summed bias. A bound that a wrong kernel
    could pass fails the check too: |ref| must exceed the float32-reference
    bound at more than half of the elements. ``entry``: another (kernel,
    plain) pair than the layout's."""
    import torch
    import torch.nn.functional as F

    from detectron2_tpu_torch.testing import attention_bf16_bounds

    kernel, plain = entry or attention_entry(transposed)
    q, k, v, rel_h, rel_w = args
    out = kernel(*args, scale=scale)
    torch.cuda.synchronize()
    path = kernel.last_path
    label = f"{label} [{path}]"
    check(out.shape == q.shape and out.dtype == q.dtype, (out.shape, out.dtype))
    check(torch.isfinite(out.float()).all(), label)
    vmax = v.float().abs().max().item()
    # q scaled in its own dtype, as the kernel and the plain version scale it
    args32 = [(q * torch.tensor(scale, dtype=q.dtype, device=q.device)).float()] + [None if a is None else a.float() for a in args[1:]]
    ref32 = plain_in_chunks(plain, args32, 1.0, chunk)
    ref_max, ref_rms = ref32.abs().max().item(), ref32.square().mean().sqrt().item()
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    if q.dtype == torch.float32:
        tol = 2e-5 * vmax
        line = f"{label}: max_abs_err {err:.3e} (tol 2e-5*max|v| = {tol:.3e}), |ref| max {ref_max:.3f} rms {ref_rms:.3f}"
        check(err <= tol, line)
        check(ref_rms > tol, f"{line}: the tolerance covers a typical |ref|")
    else:
        args32[2] = args32[2].abs()
        weight = plain_in_chunks(plain, args32, 1.0, chunk)
        bias_max = 0.0 if rel_h is None else rel_h.float().abs().max().item() + rel_w.float().abs().max().item()
        tol32, tol16 = attention_bf16_bounds(ref32, weight, vmax, bias_max)
        del weight
        diff16 = (out.float() - plain_in_chunks(plain, args, scale, chunk).float()).abs()
        err16 = diff16.max().item()
        above = (ref32.abs() > tol32).float().mean().item()
        line = (
            f"{label}: max_abs_err vs f32 plain {err:.3e} (worst err/tol {(diff / tol32).max().item():.3f}, tol "
            f"2^-9*A+2^-8*|ref|+2e-5*max|v| per element, median {tol32.median().item():.3e}), vs bf16 plain {err16:.3e} "
            f"(worst err/tol {(diff16 / tol16).max().item():.3f}, tol median {tol16.median().item():.3e}), "
            f"|ref| max {ref_max:.3f} rms {ref_rms:.3f}, above the tolerance at {above:.1%} of the elements"
        )
        check((diff <= tol32).all(), line)
        check((diff16 <= tol16).all(), line)
        check(above > 0.5, f"{line}: the tolerance covers a typical |ref|, a wrong kernel would pass")
        del tol32, tol16, diff16
    del ref32, diff, args32
    log("  " + line)
    res = {"max_abs_err": err, "path": path}
    if timing:
        B, S, D = q.shape
        res["ms"] = event_ms(lambda: kernel(*args, scale=scale), 2, 10)
        res["plain_ms"] = event_ms(lambda: plain(*args, scale), 1, 2)
        flops = 4 * B * S * S * D
        nbytes = sum(a.numel() * a.element_size() for a in args if a is not None) + out.numel() * out.element_size()
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, H100_BF16_FLOPS)
        res["bytes"], res["flops"] = nbytes, flops
        line = (
            f"    kernel {res['ms']:.4f} ms ({flops / res['ms'] / 1e9:.1f} TFLOP/s), plain {res['plain_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.4f} ms by {res['bound_by']} against the bf16 tensor-core peak "
            f"({nbytes / 1e9:.4f} GB, {flops / 1e9:.1f} GFLOP)"
        )
        if rel_h is not None:
            # the yardstick: one library call on the same inputs, with the
            # [B, S, S] bias it needs materialised first (timed apart)
            def build_bias():
                h, w = (rel_h.transpose(1, 2), rel_w.transpose(1, 2)) if transposed else (rel_h, rel_w)
                return (h[:, :, :, None] + w[:, :, None, :]).contiguous().view(1, B, S, S)

            res["library_bias_ms"] = event_ms(build_bias, 1, 3)
            bias = build_bias()
            sdpa = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=bias, scale=scale)  # noqa: E731
            lib = sdpa()[0]
            res["library_max_abs_err"] = (lib.float() - out.float()).abs().max().item()
            check(res["library_max_abs_err"] <= 2.0**-5 * vmax, f"{label}: the library call disagrees: {res['library_max_abs_err']}")
            res["library_ms"] = event_ms(sdpa, 2, 10)
            del bias, lib
            line += f", library sdpa {res['library_ms']:.4f} ms + {res['library_bias_ms']:.4f} ms to build its bias"
        log(line)
    return res


def folded_bias_ms(args, scale, chunk, fetched_ms):
    """The other way to the bias at the global shape: the wgmma kernel with
    the bias folded into the first product, held to the plain version like
    the kernel the shape takes, and timed beside it."""
    from detectron2_tpu_torch.ops import attention as A

    folded = A.flash_attention_folded_cuda
    r = compare_attention(args, scale, False, chunk, "global standard bf16, bias folded into q.k^T", entry=(folded, A.attention_plain))
    check(r["path"] == "wgmma_folded", f"took the {r['path']} kernel")
    ms = event_ms(lambda: folded(*args, scale=scale), 2, 10)
    log(f"    bias folded into the first product {ms:.4f} ms, bias added to the scores (the kernel this shape takes) {fetched_ms:.4f} ms")
    return ms


def phase_attention_vs_plain(device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    results = {False: {}, True: {}}
    for name, (B, S, D, Hk, Wk) in ATTN_SHAPES.items():
        q, k, v = (torch.randn(B, S, D, generator=gen, device=device) for _ in range(3))
        rel_h = torch.randn(B, S, Hk, generator=gen, device=device) * 0.5
        rel_w = torch.randn(B, S, Wk, generator=gen, device=device) * 0.5
        log(f"  shape {name}: q, k, v {[B, S, D]}, factors {[B, S, Hk]} and {[B, S, Wk]}")
        for transposed in (False, True):
            h, w = (rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous()) if transposed else (rel_h, rel_w)
            for dtype in (torch.float32, torch.bfloat16):
                for bias in (True, False):
                    args = tuple(a.to(dtype) for a in (q, k, v)) + ((h.to(dtype), w.to(dtype)) if bias else (None, None))
                    timing = dtype == torch.bfloat16  # without the bias: the kernel and its plain version only
                    r = compare_attention(
                        args, D**-0.5, transposed, ATTN_CHUNK[name],
                        f"{name} {'transposed' if transposed else 'standard'} {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                        f"{'bias' if bias else 'no bias'}", timing,
                    )
                    want = "simt_f32" if dtype == torch.float32 else ATTN_MAIN_PATHS[name]
                    check(r["path"] == want, f"{name} {dtype}: took the {r['path']} kernel, expected {want}")
                    if timing and bias:
                        results[transposed][name] = r
                        if name == "global" and not transposed:
                            r["folded_bias_ms"] = folded_bias_ms(args, D**-0.5, ATTN_CHUNK[name], r["ms"])
                    elif timing:
                        results[transposed][name]["no_bias_ms"] = r["ms"]
        del q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    # head dim 80 (C1): with the bias, both layouts, float32 and bfloat16
    results["d80"] = {False: {}, True: {}}
    for name, (B, S, D, Hk, Wk) in ATTN_D80_SHAPES.items():
        q, k, v = (torch.randn(B, S, D, generator=gen, device=device) for _ in range(3))
        rel_h = torch.randn(B, S, Hk, generator=gen, device=device) * 0.5
        rel_w = torch.randn(B, S, Wk, generator=gen, device=device) * 0.5
        log(f"  shape {name}: q, k, v {[B, S, D]}, factors {[B, S, Hk]} and {[B, S, Wk]}")
        for transposed in (False, True):
            h, w = (rel_h.transpose(1, 2).contiguous(), rel_w.transpose(1, 2).contiguous()) if transposed else (rel_h, rel_w)
            for dtype in (torch.float32, torch.bfloat16):
                args = tuple(a.to(dtype) for a in (q, k, v, h, w))
                dname = str(dtype).split(".")[-1]
                r = compare_attention(
                    args, D**-0.5, transposed, ATTN_D80_CHUNK[name],
                    f"{name} {'transposed' if transposed else 'standard'} {dname} bias", dtype == torch.bfloat16,
                )
                want = ATTN_D80_PATHS[dname]
                check(r["path"] == want, f"{name} {dtype}: took the {r['path']} kernel, expected {want}")
                if dtype == torch.bfloat16:
                    results["d80"][transposed][name] = r
        del q, k, v, rel_h, rel_w
        torch.cuda.empty_cache()
    return results


def detections_agree(a, b, iou_thresh=0.9, score_tol=0.01):
    """Share of a's valid detections (over the batch) that b holds too: same
    class, IoU >= iou_thresh, score within score_tol."""
    import torch

    from detectron2_tpu_torch.ops.nms import pairwise_iou

    found = total = 0
    for i in range(a["valid"].shape[0]):
        va, vb = a["valid"][i], b["valid"][i]
        iou = pairwise_iou(a["pred_boxes"][i][va][None], b["pred_boxes"][i][vb][None])[0]
        same = a["pred_classes"][i][va][:, None] == b["pred_classes"][i][vb][None, :]
        close = (a["scores"][i][va][:, None] - b["scores"][i][vb][None, :]).abs() <= score_tol
        found += int(((iou >= iou_thresh) & same & close).any(dim=1).sum().item())
        total += int(va.sum().item())
    return found / max(total, 1)


def phase_vitdet(device):
    import torch

    import detectron2_tpu_torch.modeling.backbone.vit as vit
    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.engine import DefaultPredictor
    from detectron2_tpu_torch.modeling import init_weights
    from detectron2_tpu_torch.ops.attention import flash_attention_cuda, flash_attention_t_cuda
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda

    model = model_zoo.mask_rcnn_vitdet_b(device, compute_dtype="bfloat16", mask_paste_in_graph=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    init_weights(model, gen)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  Mask R-CNN ViTDet-B, {n_params} parameters, bf16 compute, in-graph paste")
    images = torch.randint(0, 256, (VIT_B, VIT_HW, VIT_HW, 3), generator=gen, device=device, dtype=torch.uint8)
    batch = {"image": images, "image_sizes": torch.tensor([[VIT_HW, VIT_HW]] * VIT_B, dtype=torch.int32, device=device)}
    counters = (flash_attention_cuda, flash_attention_t_cuda, roi_align_multilevel_cuda)

    def reset():
        for c in counters:
            c.launches = 0
        flash_attention_cuda.paths, flash_attention_t_cuda.paths = {}, {}

    def main_paths(forwards):
        """The kernels `forwards` ViTDet-B forwards must have taken."""
        return {ATTN_MAIN_PATHS[n]: ATTN_PER_FORWARD[n] * forwards for n in ATTN_SHAPES}

    def forward_recording():
        """One forward that keeps the attention inputs of the first windowed
        and the first global block and both pooler inputs."""
        attn_rec, pool_rec = {}, []
        attn_entry, pool_entry = vit.attention_with_rel_pos, poolers.roi_align_multilevel

        def rec_attn(q, k, v, rel_h, rel_w, *, scale, factors_transposed):
            name = "global" if q.shape[1] == ATTN_SHAPES["global"][1] else "windowed"
            attn_rec.setdefault(name, ((q, k, v, rel_h, rel_w), scale, factors_transposed))
            return attn_entry(q, k, v, rel_h, rel_w, scale=scale, factors_transposed=factors_transposed)

        def rec_pool(*args, **kwargs):
            pool_rec.append((args, kwargs))
            return pool_entry(*args, **kwargs)

        vit.attention_with_rel_pos, poolers.roi_align_multilevel = rec_attn, rec_pool
        try:
            out = model(batch)
        finally:
            vit.attention_with_rel_pos, poolers.roi_align_multilevel = attn_entry, pool_entry
        torch.cuda.synchronize()
        return out, attn_rec, pool_rec

    # (a) 4 batch forwards, the first one recorded
    os.environ.pop("D2T_FLASH_V2", None)
    iters = 3
    torch.cuda.reset_peak_memory_stats()
    reset()
    out, attn_rec, pool_rec = forward_recording()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = model(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch_launches = [c.launches for c in counters]
    check(batch_launches == [12 * (1 + iters), 0, 2 * (1 + iters)], f"launches over {1 + iters} forwards: {batch_launches}")
    batch_paths = dict(flash_attention_cuda.paths)
    check(batch_paths == main_paths(1 + iters), f"attention kernels taken over {1 + iters} forwards: {batch_paths}")
    log(f"  batch forward {VIT_B}x{VIT_HW}x{VIT_HW}: {dt * 1e3:.1f} ms/batch, {VIT_B / dt:.2f} img/s, peak memory {peak:.2f} GiB")
    log(f"  launches over {1 + iters} batch forwards: attention {batch_launches[0]} (12 per forward: {batch_paths}), "
        f"RoIAlign {batch_launches[2]} (2 per forward)")
    D = model.roi_heads.box_predictor.test_topk_per_image
    check(out["pred_boxes"].shape == (VIT_B, D, 4) and out["pred_masks"].shape == (VIT_B, D, 28, 28))
    check(out["pred_masks_full"].shape == (VIT_B, D, VIT_HW, VIT_HW) and out["pred_masks_full"].dtype == torch.bool)
    check(torch.isfinite(out["pred_boxes"]).all() and torch.isfinite(out["pred_masks"]).all())
    n_valid = out["valid"].sum(1).tolist()
    check(min(n_valid) > 0, n_valid)
    log(f"  detections per image: {n_valid}")

    if "--profile" in sys.argv[1:]:
        profile_run(lambda: model(batch), "ViTDet forward", "vitdet_forward_trace.json")

    # (b) 3 requests of differing sizes through the predictor
    predictor = DefaultPredictor(model=model, min_size_test=VIT_HW, max_size_test=VIT_HW)
    rng = np.random.RandomState(0)
    reset()
    for h, w in ((480, 640), (600, 800), (427, 1000)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        inst = predictor(img)["instances"]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(len(inst) > 0, "no detections")
        check_instances(inst, len(inst), h, w)
        log(f"  request {h}x{w}: {len(inst)} instances, masks {tuple(inst.pred_masks.tensor.shape)}, {ms:.1f} ms")
    request_launches = [c.launches for c in counters]
    check(request_launches == [12 * 3, 0, 2 * 3], f"launches over 3 requests: {request_launches}")
    request_paths = dict(flash_attention_cuda.paths)
    check(request_paths == main_paths(3), f"attention kernels taken over 3 requests: {request_paths}")

    # (c) one forward with the transposed factor layout
    os.environ["D2T_FLASH_V2"] = "1"
    try:
        reset()
        out_t, attn_rec_t, _ = forward_recording()
    finally:
        os.environ.pop("D2T_FLASH_V2", None)
    t_launches = [c.launches for c in counters]
    check(t_launches == [0, 12, 2], f"launches of the transposed-layout forward: {t_launches}")
    t_paths = dict(flash_attention_t_cuda.paths)
    check(t_paths == main_paths(1), f"attention kernels taken by the transposed-layout forward: {t_paths}")
    agree = detections_agree(out, out_t)
    log(f"  transposed layout: {t_launches[1]} launches of the transposed kernel; {agree:.1%} of the standard layout's "
        f"detections found again (same class, IoU >= 0.9, score within 0.01: both run in bf16)")
    check(agree >= 0.9, f"the two layouts' detections differ: {agree}")
    del out_t

    # (d) the kernels against their plain versions on the main path's inputs
    attn = {False: {}, True: {}}
    for rec in (attn_rec, attn_rec_t):
        check(sorted(rec) == ["global", "windowed"], sorted(rec))
        for name, (args, scale, transposed) in rec.items():
            check(tuple(args[0].shape) == ATTN_SHAPES[name][:3] and args[0].dtype == torch.bfloat16, args[0].shape)
            r = compare_attention(
                args, scale, transposed, ATTN_CHUNK[name],
                f"main-path {name} block {'transposed' if transposed else 'standard'} bf16", timing=True,
            )
            check(r["path"] == ATTN_MAIN_PATHS[name], f"main-path {name}: took the {r['path']} kernel")
            log(f"    {PREV_ATTN_MS[transposed][name]:.4f} ms on {PREV_MS_FROM}: "
                f"{PREV_ATTN_MS[transposed][name] / r['ms']:.2f}x")
            attn[transposed][name] = r
    check(len(pool_rec) == 2, len(pool_rec))
    pools = {}
    for (args, kwargs), res in zip(pool_rec, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        pools[res] = compare_kernel(
            feats, boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"],
            f"ViTDet pool R={boxes.shape[0]} {res}x{res} bf16", timing=True, prev_ms=PREV_ROI_FWD_MS["vitdet"][res],
        )
    return {
        "vitdet_img_s": VIT_B / dt,
        "vitdet_batch_ms": dt * 1e3,
        "vitdet_peak_gib": peak,
        "attn_launches": batch_launches[0] + request_launches[0],
        "attn_t_launches": t_launches[1],
        "attn_paths": {k: batch_paths[k] + request_paths[k] for k in batch_paths},
        "attn_t_paths": t_paths,
        "roi_launches": batch_launches[2] + request_launches[2] + t_launches[2],
        "attn": attn,
        "pools": pools,
    }


def instances_agree(a, b) -> dict:
    """One image's Instances from two paths: classes equal, boxes within
    1e-3 px, scores within 1e-4, masks equal on at least 99.9% of pixels."""
    import torch

    check(len(a) == len(b), f"{len(a)} vs {len(b)} instances")
    check(torch.equal(a.pred_classes, b.pred_classes), "classes differ")
    box_err = (a.pred_boxes.tensor - b.pred_boxes.tensor).abs().max().item() if len(a) else 0.0
    score_err = (a.scores - b.scores).abs().max().item() if len(a) else 0.0
    same = (a.pred_masks.tensor == b.pred_masks.tensor).float().mean().item() if len(a) else 1.0
    check(box_err <= 1e-3 and score_err <= 1e-4 and same >= 0.999, (box_err, score_err, same))
    return {"n": len(a), "box_err": box_err, "score_err": score_err, "mask_agree": same}


def phase_eval(device, state_dict, card: str):
    """``tools/train_net.py --eval-only`` on the port: a synthetic COCO json
    registered by name, the test loader, the R50-FPN 3x zoo config in bf16
    with phase 5's seeded weights and FrozenBN statistics,
    ``DefaultTrainer.test`` with COCOEvaluator."""
    import tempfile

    from detectron2_tpu_torch.testing import write_synthetic_coco

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coco_") as root:
        t0 = time.perf_counter()
        json_file, image_root = write_synthetic_coco(root, EVAL_IMAGES, seed=0)
        write_s = time.perf_counter() - t0
        res = _eval_on(device, state_dict, card, json_file, image_root, write_s)
    res["eval_phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 10 took {res['eval_phase_s']:.1f} s")
    return res


def _eval_on(device, state_dict, card, json_file, image_root, write_s):
    import torch

    import detectron2_tpu_torch.modeling.poolers as poolers
    from detectron2_tpu_torch import model_zoo
    from detectron2_tpu_torch.data import MetadataCatalog, build_detection_test_loader
    from detectron2_tpu_torch.data.datasets import register_coco_instances
    from detectron2_tpu_torch.data.detection_utils import read_image
    from detectron2_tpu_torch.engine import DefaultPredictor, DefaultTrainer
    from detectron2_tpu_torch.evaluation import COCOEvaluator
    from detectron2_tpu_torch.modeling import build_model
    from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
    from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_cuda
    from detectron2_tpu_torch.testing import COCO_SIZES, ground_truth_detections

    name = "chip_smoke_synthetic_coco"
    register_coco_instances(name, {}, json_file, image_root)
    cfg = model_zoo.get_config(EVAL_CONFIG)
    cfg.MODEL.WEIGHTS = ""  # phase 5's seeded weights instead
    cfg.DATASETS.TEST = (name,)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.OUTPUT_DIR = ""
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    n_gt = sum(1 for _ in ground_truth_detections(json_file))
    log(f"  {EVAL_IMAGES} images of {list(COCO_SIZES)} (h, w), "
        f"{n_gt} non-crowd objects over 80 categories, written in {write_s:.2f} s; config {EVAL_CONFIG}, "
        f"MIN_SIZE_TEST {cfg.INPUT.MIN_SIZE_TEST}, MAX_SIZE_TEST {cfg.INPUT.MAX_SIZE_TEST}, bf16")

    # the eval run: the kernel's counts from 0 just before, read just after;
    # the first batch's pooler inputs are recorded for the comparison below
    recorded = []
    kernel_entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        if len(recorded) < 2:
            recorded.append((args, kwargs))
        return kernel_entry(*args, **kwargs)

    evaluator = COCOEvaluator(name, distributed=False)
    evaluate = evaluator.evaluate
    evaluate_s = []

    def timed_evaluate(*args, **kwargs):
        t = time.perf_counter()
        out = evaluate(*args, **kwargs)
        evaluate_s.append(time.perf_counter() - t)
        return out

    evaluator.evaluate = timed_evaluate
    timing = {}
    torch.cuda.reset_peak_memory_stats()
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_cuda.paths = {}
    poolers.roi_align_multilevel = recording
    t0 = time.perf_counter()
    try:
        results = DefaultTrainer.test(cfg, model, evaluators=[evaluator], timing=timing)
    finally:
        poolers.roi_align_multilevel = kernel_entry
    test_s = time.perf_counter() - t0
    launches, paths = roi_align_multilevel_cuda.launches, dict(roi_align_multilevel_cuda.paths)
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = timing[name]

    # 1. every metric the csv table prints, finite, in [0, 100]
    check(set(results) == {"bbox", "segm"}, list(results))
    for task in ("bbox", "segm"):
        values = [results[task][k] for k in EVAL_KEYS]
        check(all(math.isfinite(v) and 0 <= v <= 100 for v in values), (task, values))
        log(f"  {task}: " + ", ".join(EVAL_KEYS))
        log(f"  {task}: " + ", ".join(f"{v:.4f}" for v in values))
    # 2. both pools of every batch through the kernel, on its 16-byte path
    check(launches == 2 * t["batches"], f"{launches} RoIAlign launches over {t['batches']} batches")
    check(paths == {"vector": launches}, paths)
    timed = t["timed_batches"]
    img_s = timed / t["total_s"]
    log(f"  {card}: {t['batches']} batches of 1 image, RoIAlign launches {launches} {paths}")
    log(f"  eval loop {img_s:.2f} img/s over the {timed} batches after the first 2: per image data "
        f"{t['data_s'] / timed:.4f} s, compute {t['compute_s'] / timed:.4f} s, evaluator.process "
        f"{t['eval_s'] / timed:.4f} s; evaluator.evaluate (COCOeval, bbox + segm) {evaluate_s[0]:.2f} s; "
        f"DefaultTrainer.test {test_s:.2f} s; peak memory {peak:.2f} GiB")

    # 3. the ground truth fed back as detections: AP 100 (the PIL-free PNG
    # codec and the cv2-free polygon fill on this machine)
    contiguous = MetadataCatalog.get(name).thing_dataset_id_to_contiguous_id
    perfect = COCOEvaluator(name, distributed=False)
    by_image = {}
    for det in ground_truth_detections(json_file):
        det["category_id"] = contiguous[det["category_id"]]
        by_image.setdefault(det["image_id"], []).append(det)
    perfect._predictions = [{"image_id": k, "instances": v} for k, v in by_image.items()]
    perfect_res = perfect.evaluate()
    for task in ("bbox", "segm"):
        check(perfect_res[task]["AP"] == 100.0, (task, perfect_res[task]))
    log(f"  ground truth as detections: bbox AP {perfect_res['bbox']['AP']}, segm AP {perfect_res['segm']['AP']}")

    # 4. the eval path and DefaultPredictor on the same four images
    predictor = DefaultPredictor(
        model=model, min_size_test=cfg.INPUT.MIN_SIZE_TEST, max_size_test=cfg.INPUT.MAX_SIZE_TEST,
        size_bucket=cfg.TPU.SIZE_BUCKET,
    )
    agree = []
    for i, batch in enumerate(build_detection_test_loader(cfg, name)):
        if i == 4:
            break
        meta = batch["metadata"][0]
        out = model({k: v for k, v in batch.items() if k != "metadata"})
        in_h, in_w = batch["image_sizes"][0].tolist()
        with torch.inference_mode():
            ours = detector_postprocess({k: v[0] for k, v in out.items()}, meta["height"], meta["width"], in_h, in_w)
        theirs = predictor(read_image(meta["file_name"], "BGR"))["instances"]
        agree.append(instances_agree(ours, theirs))
    log(f"  eval path vs DefaultPredictor on 4 images: {agree}")

    # 5. the kernel against the plain version on the eval path's own inputs
    # (the first batch's box and mask pools), in bf16 as run and in float32
    check(len(recorded) == 2, len(recorded))
    pools = {}
    for (args, kwargs), res in zip(recorded, (BOX_RES, MASK_RES)):
        feats, boxes, bidx, levels, scales, size = args
        sr, aligned = kwargs["sampling_ratio"], kwargs["aligned"]
        label = f"eval-path pool R={boxes.shape[0]} {res}x{res}"
        pools[res] = compare_kernel(feats, boxes, bidx, levels, scales, res, sr, aligned, label + " bf16", timing=True)
        f32 = compare_kernel([f.float() for f in feats], boxes, bidx, levels, scales, res, sr, aligned, label + " f32")
        pools[res]["max_abs_err_f32"] = f32["max_abs_err"]
    return {
        "eval_img_s": img_s,
        "eval_data_s_per_img": t["data_s"] / timed,
        "eval_compute_s_per_img": t["compute_s"] / timed,
        "eval_process_s_per_img": t["eval_s"] / timed,
        "eval_evaluate_s": evaluate_s[0],
        "eval_peak_gib": peak,
        "eval_bbox_AP": results["bbox"]["AP"],
        "eval_segm_AP": results["segm"]["AP"],
        "roi_launches": launches,
        "roi_paths": paths,
        "pools": pools,
    }


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import detectron2_tpu_torch
        from detectron2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 3
    if os.path.dirname(os.path.dirname(os.path.abspath(detectron2_tpu_torch.__file__))) != here:
        print("chip_smoke: detectron2_tpu_torch must come from this checkout", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    log("== phase 1: card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for convolutions and matmuls (comparison phases run in full float32)")

    log("== phase 2: build")
    if "--ptxas" in sys.argv[1:]:
        log(_build.ptxas_report())
    t0 = time.perf_counter()
    _build.build_kernels()
    log(f"built {list(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.2f} s")

    if "--kernels-only" in sys.argv[1:]:
        with torch.inference_mode():
            log("== phase 3: RoIAlign kernel vs plain at the main-path shapes")
            phase_kernel_vs_plain(device)
            log("== phase 8: attention kernels vs plain at the ViTDet-B shapes")
            phase_attention_vs_plain(device)
        log("== phase 6: RoIAlign backward kernel vs plain at the train shapes")
        phase_backward_vs_plain(device)
        log("kernels only: ok (no main path was driven, so no result line)")
        return 0

    with torch.inference_mode():
        log("== phase 3: RoIAlign kernel vs plain at the main-path shapes")
        synthetic = phase_kernel_vs_plain(device)

        log("== phase 4: golden fixture on the card")
        phase_golden(device)

        log("== phase 5: main path, full width")
        main_path = phase_main_path(device)

    log("== phase 6: RoIAlign backward kernel vs plain at the train shapes")
    synthetic_bwd = phase_backward_vs_plain(device)

    log("== phase 7: training, full width")
    train = phase_train(device)
    torch.cuda.empty_cache()

    with torch.inference_mode():
        log("== phase 8: attention kernels vs plain at the ViTDet-B shapes")
        synthetic_attn = phase_attention_vs_plain(device)

        log("== phase 9: ViTDet main path, full width")
        vitdet = phase_vitdet(device)

        log("== phase 10: COCO evaluation, full width")
        evaluation = phase_eval(device, main_path.pop("state_dict"), smi)

    pools = ((BOX_RES, "box pool"), (MASK_RES, "mask pool"))

    def per_pool(results, synthetic_results=None):
        """One entry per pool, with the synthetic-roi times where given."""
        out = []
        for res, name in pools:
            entry = {"pool": name, "res": res}
            entry.update({k: results[res][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "max_abs_err_f32", "path",
            ) if k in results[res]})
            if synthetic_results:
                entry.update(synthetic_ms=synthetic_results[res]["ms"], synthetic_plain_ms=synthetic_results[res]["plain_ms"])
            out.append(entry)
        return out

    def summed(results):
        """Both pools together: times add; the bound of the summed work."""
        b_ms, b_by = bound(sum(results[r]["bytes"] for r, _ in pools), sum(results[r]["flops"] for r, _ in pools))
        return {
            "max_abs_err": max(results[r]["max_abs_err"] for r, _ in pools),
            "ms": sum(results[r]["ms"] for r, _ in pools),
            "plain_ms": sum(results[r]["plain_ms"] for r, _ in pools),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }

    def attention_kernel(name, replaces, transposed, launches, paths):
        """One forward's 12 launches (4 global + 8 windowed) on the main
        path's inputs; per shape also the synthetic-input times."""
        main, synth = vitdet["attn"][transposed], synthetic_attn[transposed]
        per_forward = lambda key: sum(ATTN_PER_FORWARD[n] * main[n][key] for n in ATTN_SHAPES)  # noqa: E731
        b_ms, b_by = bound(
            sum(ATTN_PER_FORWARD[n] * main[n]["bytes"] for n in ATTN_SHAPES),
            sum(ATTN_PER_FORWARD[n] * main[n]["flops"] for n in ATTN_SHAPES), H100_BF16_FLOPS,
        )
        shape_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_bias_ms", "max_abs_err")
        return {
            "name": name,
            "route": "cuda",
            "source": "detectron2_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": launches,
            "paths": paths,
            "max_abs_err": max(main[n]["max_abs_err"] for n in ATTN_SHAPES),
            "ms": per_forward("ms"),
            "plain_ms": per_forward("plain_ms"),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": per_forward("library_ms"),
            "library_bias_ms": per_forward("library_bias_ms"),
            "bound_peak": "989 TFLOP/s dense bf16 tensor cores, 3.35 TB/s",
            "per_forward": "4 global + 8 windowed launches of one 8x1024x1024 ViTDet-B forward, bf16",
            "head_dim_80": [
                {
                    "shape": n, "qkv": list(ATTN_D80_SHAPES[n][:3]), "dtype": "bfloat16", "bias": True,
                    **{k: synthetic_attn["d80"][transposed][n][k] for k in shape_keys + ("path",)},
                }
                for n in ATTN_D80_SHAPES
            ],
            "shapes": [
                {
                    "shape": n, "qkv": list(ATTN_SHAPES[n][:3]), "launches_per_forward": ATTN_PER_FORWARD[n],
                    "path": main[n]["path"],
                    **{k: main[n][k] for k in shape_keys},
                    **{f"synthetic_{k}": synth[n][k] for k in (
                        "ms", "no_bias_ms", "folded_bias_ms", "plain_ms", "library_ms", "library_bias_ms",
                    ) if k in synth[n]},
                }
                for n in ATTN_SHAPES
            ],
        }

    kernels = {
        "kernels": [
            {
                "name": "roi_align_multilevel_fwd",
                "route": "cuda",
                "source": "detectron2_tpu_torch/csrc/roi_align.cu",
                "replaces": "detectron2_tpu/ops/pallas/roi_align_pallas.py:226",
                "launches": main_path["launches"] + train["fwd_launches"] + vitdet["roi_launches"] + evaluation["roi_launches"],
                "inference_launches": main_path["launches"],
                "train_launches": train["fwd_launches"],
                "vitdet_launches": vitdet["roi_launches"],
                "eval_launches": evaluation["roi_launches"],
                "paths": {"inference, train, vitdet": "vector (checked per pool)", "eval": evaluation["roi_paths"]},
                **summed(main_path["shapes"]),
                "max_abs_err": max(summed(r)["max_abs_err"] for r in (
                    main_path["shapes"], train["fwd"], vitdet["pools"], evaluation["pools"],
                )),
                "library_ms": None,
                "per_forward": "box pool + mask pool of one 16x800x1344 forward",
                "shapes": per_pool(main_path["shapes"], synthetic),
                "train": {**summed(train["fwd"]), "per_step": "box pool + mask pool of one 8x800x1344 train step",
                          "shapes": per_pool(train["fwd"])},
                "vitdet": {**summed(vitdet["pools"]), "per_forward": "box pool + mask pool of one 8x1024x1024 ViTDet-B forward",
                           "shapes": per_pool(vitdet["pools"])},
                "eval": {**summed(evaluation["pools"]), "per_batch": "box pool + mask pool of the eval loader's first 1-image batch",
                         "shapes": per_pool(evaluation["pools"])},
            },
            {
                "name": "roi_align_multilevel_bwd",
                "route": "cuda",
                "source": "detectron2_tpu_torch/csrc/roi_align.cu",
                "replaces": "detectron2_tpu/ops/pallas/roi_align_pallas.py:521",
                "launches": train["bwd_launches"],
                "path": train["bwd"][BOX_RES]["path"],
                **summed(train["bwd"]),
                "library_ms": None,
                "per_step": "box pool + mask pool backward of one 8x800x1344 train step",
                "shapes": per_pool(train["bwd"], synthetic_bwd),
            },
            attention_kernel(
                "flash_attention_fwd", "detectron2_tpu/ops/pallas/flash_attention.py:296", False,
                vitdet["attn_launches"], vitdet["attn_paths"],
            ),
            attention_kernel(
                "flash_attention_fwd_t", "detectron2_tpu/ops/pallas/flash_attention.py:189", True,
                vitdet["attn_t_launches"], vitdet["attn_t_paths"],
            ),
        ],
        "main_path": {
            **{k: main_path[k] for k in ("img_s", "batch_ms", "peak_gib")},
            **{k: train[k] for k in (
                "train_ms_per_step", "train_mean_ms_per_step", "train_img_s", "train_mean_img_s", "train_peak_gib",
            )},
            **{k: vitdet[k] for k in ("vitdet_img_s", "vitdet_batch_ms", "vitdet_peak_gib")},
            **{k: v for k, v in evaluation.items() if k.startswith("eval_")},
        },
        "card": smi,
    }
    print(json.dumps(kernels), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
