"""Deformable convolution and DensePose on the card against the CPU, float32
with TF32 off:

- ``deform_conv2d`` (fractional offsets a few pixels long, samples outside
  the map; groups, deformable groups, modulation) on the card against the
  same op in float64 on the CPU, within 1e-5 of the largest |value|, and
  its gradients (x, offset, mask, weight) within 1e-4 of each one's largest;
- ``roi_align_separable_chan`` on the card against
  ``roi_align_multilevel_plain`` on the one level, within 1e-5 of the
  largest |value| (at least 1e-5), on both grids;
- the two DensePose goldens' tiny models (``tests/goldens/
  e2e_densepose{,_dl}_r18.npz``, their synthetic weights) on the card
  against the CPU: the RoIAlign kernel launches once a forward (the box
  pool; the DensePose pool is the decoder's), the detections pair as in
  ``tests/test_torch_rcnn_heads_cuda.py`` and their raw DensePose maps agree
  within 1e-3 of the CPU's largest; the ``_legacy`` form (no decoder)
  launches it twice, its 14x14 FPN pool the second;
- the CSE losses (embedding, soft embedding, shape-to-shape and
  pixel-to-shape) and their gradients on the card against the CPU, within
  1e-5 of the largest value.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_densepose_cuda.py -q

Without a card every test skips.
"""

import os

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.ops.deform_conv import deform_conv2d
from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_plain, roi_align_separable_chan
from detectron2_tpu_torch.testing import golden_densepose_config, golden_state_dict

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RoIAlign kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dg, groups, stride, modulated", [(1, 1, 1, False), (2, 4, 2, True), (1, 2, 1, True)])
def test_deform_conv2d_on_the_card_matches_float64(cuda, dg, groups, stride, modulated):
    rng = np.random.RandomState(0)
    B, H, W, C, Cout = 2, 23, 31, 32, 24
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    host = {
        "x": rng.standard_normal((B, H, W, C)),
        "offset": rng.uniform(-3, 3, (B, Ho, Wo, 2 * dg * 9)),
        "weight": rng.standard_normal((3, 3, C // groups, Cout)) * 0.1,
        "mask": rng.uniform(0, 1, (B, Ho, Wo, dg * 9)) if modulated else None,
    }
    kw = dict(stride=stride, padding=1, groups=groups, deformable_groups=dg)
    cot = rng.standard_normal((B, Ho, Wo, Cout))
    results = []
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        t = {k: None if v is None else torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for k, v in host.items()}
        out = deform_conv2d(t["x"], t["offset"], t["weight"], mask=t["mask"], **kw)
        out.backward(torch.tensor(cot, dtype=dtype, device=device))
        results.append({"out": out.detach(), **{k: v.grad for k, v in t.items() if v is not None}})
    for k, ref in results[1].items():
        got = results[0][k].double().cpu()
        tol = (1e-5 if k == "out" else 1e-4) * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align_separable_chan_on_the_card_matches_the_plain_roi_align(cuda, aligned):
    g = torch.Generator(device="cpu").manual_seed(0)
    feats = torch.randn(2, 50, 84, 64, generator=g)
    xy = torch.rand(2, 24, 2, generator=g) * 300 - 20
    boxes = torch.cat([xy, xy + torch.rand(2, 24, 2, generator=g) * 200 + 1], -1)
    out = roi_align_separable_chan(feats.to(cuda), boxes.to(cuda), 28, spatial_scale=0.25, sampling_ratio=2, aligned=aligned)
    bidx = torch.arange(2, dtype=torch.int32).repeat_interleave(24)
    ref = roi_align_multilevel_plain(
        [feats], boxes.reshape(-1, 4), bidx, torch.zeros_like(bidx), (0.25,), (28, 28), 2, aligned
    )
    err = (out.reshape(-1, 28, 28, 64).cpu() - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err


def _run(deeplab, legacy, device):
    golden = np.load(os.path.join(GOLDENS, "e2e_densepose_dl_r18.npz" if deeplab else "e2e_densepose_r18.npz"))
    cfg = golden_densepose_config(deeplab)
    cfg.MODEL.ROI_DENSEPOSE_HEAD.DECODER_ON = not legacy
    model = build_model(cfg, device=device)
    sd = golden_state_dict(golden)
    if legacy:  # the FPN pool: the head reads the 64 FPN channels, as it read the decoder's 64
        sd = {k: v for k, v in sd.items() if ".decoder." not in k}
    assert load_state_dict_report(model, sd).startswith(f"Loaded {len(sd)}/{len(sd)} tensors")
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    return {k: (v[0].cpu() if torch.is_tensor(v) else {kk: vv[0].cpu() for kk, vv in v.items()}) for k, v in model(batch).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("deeplab, legacy", [(False, False), (True, False), (False, True)], ids=["decoder", "dl_wc1", "legacy"])
def test_densepose_model_on_the_card_matches_the_cpu(cuda, deeplab, legacy):
    from detectron2_tpu_torch.ops import roi_align as port_ra

    before = port_ra.roi_align_multilevel_cuda.launches
    gpu = _run(deeplab, legacy, cuda)
    assert port_ra.roi_align_multilevel_cuda.launches - before == (2 if legacy else 1)
    cpu = _run(deeplab, legacy, torch.device("cpu"))
    g_idx, c_idx = torch.nonzero(gpu["valid"])[:, 0], torch.nonzero(cpu["valid"])[:, 0]
    assert abs(len(g_idx) - len(c_idx)) <= 1 and len(c_idx) > 0
    taken = torch.zeros(len(g_idx), dtype=torch.bool)
    pairs = []
    for j in c_idx.tolist():
        cand = (
            ~taken
            & ((gpu["scores"][g_idx] - cpu["scores"][j]).abs() <= 1e-4)
            & ((gpu["pred_boxes"][g_idx] - cpu["pred_boxes"][j]).abs().amax(dim=1) <= 1e-2)
        )
        hit = torch.nonzero(cand)[:, 0]
        if len(hit):
            taken[hit[0]] = True
            pairs.append((j, int(g_idx[hit[0]])))
    assert len(pairs) >= 0.8 * len(c_idx), (len(pairs), len(c_idx))
    for key, ref in cpu["pred_densepose_raw"].items():
        got = gpu["pred_densepose_raw"][key]
        err = max((got[i] - ref[j]).abs().max().item() for j, i in pairs)
        assert err <= 1e-3 * ref.abs().max().item(), (key, err)


def _cse_inputs(seed, P=300, K=500, D=16):
    from detectron2_tpu_torch.projects.densepose.cse import normalize_embeddings

    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(P, D, generator=g)
    mesh = normalize_embeddings(torch.randn(K, D, generator=g))
    ids = torch.randint(0, K, (P,), generator=g)
    pts = normalize_embeddings(torch.randn(K, 3, generator=g))
    geo = torch.arccos((pts @ pts.T).clamp(-1, 1))
    return emb, mesh, ids, ids >= 0, geo


def _on(device, *xs):
    return [x.to(device).requires_grad_(x.is_floating_point()) for x in xs]


def _grads_close(gpu, cpu, tol=1e-5):
    for g, c in zip(gpu, cpu):
        if c.grad is not None:
            err = (g.grad.cpu() - c.grad).abs().max().item()
            assert err <= tol * max(1.0, c.grad.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [False, True], ids=["embed", "soft"])
def test_cse_embedding_losses_on_the_card_match_the_cpu(cuda, soft):
    from detectron2_tpu_torch.projects.densepose.cse import cse_embedding_loss, cse_soft_embedding_loss

    inputs = _cse_inputs(0)
    outs = []
    for device in (cuda, torch.device("cpu")):
        emb, mesh, ids, valid, geo = _on(device, *inputs)
        if soft:
            loss = cse_soft_embedding_loss(emb, ids, valid, mesh, geo.detach(), 0.1, 0.1)
        else:
            loss = cse_embedding_loss(emb, ids, valid, mesh, 0.1)
        loss.backward()
        outs.append((loss.item(), (emb, mesh)))
    (lg, tg), (lc, tc) = outs
    assert abs(lg - lc) <= 1e-5 * max(1.0, abs(lc))
    _grads_close(tg, tc)


@pytest.mark.cuda
def test_cse_cycle_losses_on_the_card_match_the_cpu(cuda):
    """Shape-to-shape, and pixel-to-shape on masks with exactly the sample's
    count of foreground pixels (the card's generator draws other pixels, the
    same set)."""
    from detectron2_tpu_torch.projects.densepose.cse import pix_to_shape_cycle_loss, shape_to_shape_cycle_loss

    emb, mesh, _, _, geo = _cse_inputs(1, P=500)
    g = torch.Generator().manual_seed(2)
    pix = torch.randn(3, 24, 24, 16, generator=g)
    masks = torch.zeros(3, 576, dtype=torch.bool)
    for r in range(3):
        masks[r, torch.randperm(576, generator=g)[:40]] = True
    masks = masks.reshape(3, 24, 24)
    res = []
    for device in (cuda, torch.device("cpu")):
        e1, e2, p = _on(device, emb[:300], mesh[:300], pix)
        s2s = shape_to_shape_cycle_loss(e1, geo[:300, :300].to(device), e2, geo[200:500, 200:500].to(device))
        gen = torch.Generator(device=device).manual_seed(3)
        p2s = pix_to_shape_cycle_loss(p, masks.to(device), mesh.to(device), gen, 40)
        (s2s + p2s.sum()).backward()
        res.append((s2s.item(), p2s.detach().cpu(), (e1, e2, p)))
    (sg, pg, tg), (sc, pc, tc) = res
    assert abs(sg - sc) <= 1e-5 * max(1.0, abs(sc))
    assert (pg - pc).abs().max().item() <= 1e-5 * max(1.0, pc.abs().max().item())
    _grads_close(tg, tc)
