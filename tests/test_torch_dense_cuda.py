"""The tiny RetinaNet and FCOS R18 models of the goldens
(``tests/goldens/e2e_{retinanet,fcos}_r18.npz``, their synthetic weights) on
the card against the same models on the CPU, in float32 with TF32 off. This
catches anchors, point anchors, the EMA buffer or a decode temporary left on
the wrong device, and a card-only difference in the decode.

This file imports neither jax nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_cuda.py -q

Without a card every test skips. Tolerances: the raw per-level outputs
within 1e-4 of the CPU's max|x| (cuDNN's and the CPU's convolutions sum in
other orders); the detections paired by class, score (1e-4) and box (1e-2
px), at least 95% of the CPU's, since scores that tie to the ulp may swap
places in the top-k; one train step's losses within rtol 1e-4 and
``loss_normalizer`` equal (it counts foreground anchors). None of the
RoIAlign and attention kernels launches: these models have neither.
"""

import os

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.testing import golden_dense_config, golden_state_dict, synthetic_train_batch

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
MODELS = {"RetinaNet": "e2e_retinanet_r18", "FCOS": "e2e_fcos_r18"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's card path")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _model(meta, device):
    golden = np.load(os.path.join(GOLDENS, MODELS[meta] + ".npz"))
    model = build_model(golden_dense_config(meta), device=device)
    sd = golden_state_dict(golden)
    report = load_state_dict_report(model, sd)
    assert report.splitlines()[0] == f"Loaded {len(sd)}/{len(sd) + 1} tensors from the checkpoint.", report
    model.test_score_thresh = 0.0  # detections from FCOS's synthetic weights too
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    return model, batch


def _launches():
    from detectron2_tpu_torch.ops import attention, roi_align

    return [k.launches for k in (roi_align.roi_align_multilevel_cuda, roi_align.roi_align_multilevel_backward_cuda,
                                 attention.flash_attention_cuda, attention.flash_attention_t_cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("meta", list(MODELS))
def test_forward_and_decode_on_the_card_match_the_cpu(cuda, meta):
    before = _launches()
    outs = {}
    for name, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        model, batch = _model(meta, device)
        raw = model(batch, raw=True)
        det = model(batch)
        assert all(v.device.type == device.type for v in det.values())
        outs[name] = ({k: [x.cpu() for x in v] for k, v in raw.items()}, {k: v[0].cpu() for k, v in det.items()})
    assert _launches() == before
    (raw_g, det_g), (raw_c, det_c) = outs["card"], outs["cpu"]
    for key in raw_c:
        for i, (g, c) in enumerate(zip(raw_g[key], raw_c[key])):
            assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item() + 1e-6, (key, i)
    vg, vc = det_g["valid"], det_c["valid"]
    assert vc.sum() > 20 and abs(int(vg.sum()) - int(vc.sum())) <= 1
    sg, bg, cg = det_g["scores"][vg], det_g["pred_boxes"][vg], det_g["pred_classes"][vg]
    paired, taken = 0, torch.zeros(len(sg), dtype=torch.bool)
    for s, b, c in zip(det_c["scores"][vc], det_c["pred_boxes"][vc], det_c["pred_classes"][vc]):
        cand = (cg == c) & ~taken & ((sg - s).abs() <= 1e-4) & ((bg - b).abs().amax(1) <= 1e-2)
        idx = torch.nonzero(cand)
        if len(idx):
            taken[idx[0, 0]] = True
            paired += 1
    assert paired >= 0.95 * int(vc.sum()), (paired, int(vc.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("meta", list(MODELS))
def test_train_step_on_the_card_matches_the_cpu(cuda, meta):
    batch = synthetic_train_batch(H=128, W=128, num_classes=7, seed=3)
    results = {}
    for name, device in (("card", cuda), ("cpu", torch.device("cpu"))):
        model, _ = _model(meta, device)
        losses = model(batch, train=True)
        sum(losses.values()).backward()
        assert model.loss_normalizer.device.type == device.type
        results[name] = ({k: v.item() for k, v in losses.items()}, model.loss_normalizer.item())
    (lg, ng), (lc, nc) = results["card"], results["cpu"]
    assert set(lg) == set(lc) and ng == nc != 100.0
    for k in lc:
        assert abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) + 1e-6, (k, lg[k], lc[k])
