"""The tiny Keypoint R-CNN, Mask R-CNN C4 and Cascade R-CNN R18 models of the
goldens (``tests/goldens/e2e_{keypointrcnn,maskrcnn_c4,cascadercnn}_r18.npz``,
their synthetic weights) on the card against the same models on the CPU, in
float32 with TF32 off: the RoIAlign kernel and cuDNN on one side, the plain
version and the CPU's convolutions on the other.

This file imports neither jax nor the JAX package, so it runs on a machine
with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rcnn_heads_cuda.py -q

Without a card every test skips. The detections are paired by class, score
(1e-4) and box (1e-2 px), because the goldens' scores tie to 1e-7 in places
(the C4 fixture: every detection ~0.2008) and the two devices order such
ties differently: at least 80% of the CPU detections must pair, as the
parity tests require of the reference's. Each pair's masks agree within
1e-3 and its keypoints within one bin of the 4x-upsampled heatmap in x, y
(two bins may tie to the float32 ulp) and 1e-3 in probability.

The PanopticFPN and SemanticSegmentor of the goldens
(``e2e_{panoptic,semseg}_r18.npz``) on the card against the CPU: the
PanopticFPN forward launches the RoIAlign kernel twice (box and mask
pools) and none of the others, the SemanticSegmentor none of the four;
the sem-seg logits agree within 1e-4 of the CPU's largest.

One train step of each model (the cascade with its mask head) on a
synthetic padded batch (``testing.synthetic_train_batch``) with the same
sampler draws on both devices: the card launches the RoIAlign forward and
backward kernels once per pool (keypoint 2, C4 1, cascade 4), every loss
agrees with the CPU's within rtol 1e-3 and every parameter's gradient
within 5e-3 of the CPU's largest (cuDNN's and the CPU's sums in other
orders, through a random network).
"""

import os

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.modeling import sampling
from detectron2_tpu_torch.testing import (
    golden_c4_config,
    golden_cascade_config,
    golden_keypoint_config,
    golden_panoptic_config,
    golden_semseg_config,
    golden_state_dict,
    synth_weight_value,
    synthetic_train_batch,
)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
MODELS = {
    "keypoint": ("e2e_keypointrcnn_r18", golden_keypoint_config, ("box", "keypoint")),
    "c4": ("e2e_maskrcnn_c4_r18", golden_c4_config, ("box", "mask")),
    "cascade": ("e2e_cascadercnn_r18", golden_cascade_config, ("stage 1", "stage 2", "stage 3")),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RoIAlign kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _run(name, device):
    golden_name, config, _ = MODELS[name]
    golden = np.load(os.path.join(GOLDENS, golden_name + ".npz"))
    model = build_model(config(), device=device)
    sd = golden_state_dict(golden)
    assert load_state_dict_report(model, sd) == f"Loaded {len(sd)}/{len(sd)} tensors from the checkpoint."
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    return {k: v[0].cpu() for k, v in model(batch).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_model_on_the_card_matches_the_cpu(cuda, name):
    from detectron2_tpu_torch.ops import roi_align as port_ra

    before = port_ra.roi_align_multilevel_cuda.launches
    gpu = _run(name, cuda)
    assert port_ra.roi_align_multilevel_cuda.launches - before == len(MODELS[name][2])
    cpu = _run(name, torch.device("cpu"))
    assert set(gpu) == set(cpu)
    gv, cv = gpu["valid"], cpu["valid"]
    g_idx, c_idx = torch.nonzero(gv)[:, 0], torch.nonzero(cv)[:, 0]
    assert abs(len(g_idx) - len(c_idx)) <= 1 and len(c_idx) > 0
    taken = torch.zeros(len(g_idx), dtype=torch.bool)
    pairs = []
    for j in c_idx.tolist():
        cand = (
            ~taken
            & (gpu["pred_classes"][g_idx] == cpu["pred_classes"][j])
            & ((gpu["scores"][g_idx] - cpu["scores"][j]).abs() <= 1e-4)
            & ((gpu["pred_boxes"][g_idx] - cpu["pred_boxes"][j]).abs().amax(dim=1) <= 1e-2)
        )
        hit = torch.nonzero(cand)[:, 0]
        if len(hit):
            taken[hit[0]] = True
            pairs.append((j, int(g_idx[hit[0]])))
    assert len(pairs) >= 0.8 * len(c_idx), (len(pairs), len(c_idx))
    for j, i in pairs:
        if "pred_masks" in cpu:
            assert (gpu["pred_masks"][i] - cpu["pred_masks"][j]).abs().max() <= 1e-3
        if "pred_keypoints" in cpu:
            g, c, box = gpu["pred_keypoints"][i], cpu["pred_keypoints"][j], cpu["pred_boxes"][j]
            bin_w = max(float(box[2] - box[0]), 1.0) / 224 + 1e-3
            bin_h = max(float(box[3] - box[1]), 1.0) / 224 + 1e-3
            assert (g[:, 0] - c[:, 0]).abs().max() <= bin_w and (g[:, 1] - c[:, 1]).abs().max() <= bin_h
            assert (g[:, 3] - c[:, 3]).abs().max() <= 1e-3


def _train_cfg(name):
    cfg = MODELS[name][1]()
    cfg.MODEL.MASK_ON = name != "keypoint"
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 200
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    return cfg


def _same_draws(shape, generator, device):
    """The sampler's uniform draws from a seeded host generator, one row
    length at a time, so that both devices sample the same slots."""
    rng = np.random.RandomState(shape[-1])
    return tuple(torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device) for _ in range(2))


def _train_step(name, device, monkeypatch):
    """One forward and backward of the model with the golden generator's
    weights for every tensor (the cascade's mask head included)."""
    monkeypatch.setattr(sampling, "uniform_draws", _same_draws)
    model = build_model(_train_cfg(name), device=device)
    sd = {k: synth_weight_value(k, tuple(v.shape)) for k, v in model.state_dict().items()}
    assert load_state_dict_report(model, sd) == f"Loaded {len(sd)}/{len(sd)} tensors from the checkpoint."
    batch = synthetic_train_batch(num_classes=7, num_keypoints=17 if name == "keypoint" else 0, seed=5)
    losses = model(batch, train=True)
    sum(losses.values()).backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None}
    return {k: v.item() for k, v in losses.items()}, grads


TRAIN_POOLS = {"keypoint": 2, "c4": 1, "cascade": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    from detectron2_tpu_torch.ops import roi_align as port_ra

    fwd0 = port_ra.roi_align_multilevel_cuda.launches
    bwd0 = port_ra.roi_align_multilevel_backward_cuda.launches
    gpu_losses, gpu_grads = _train_step(name, cuda, monkeypatch)
    torch.cuda.synchronize()
    assert port_ra.roi_align_multilevel_cuda.launches - fwd0 == TRAIN_POOLS[name]
    assert port_ra.roi_align_multilevel_backward_cuda.launches - bwd0 == TRAIN_POOLS[name]
    cpu_losses, cpu_grads = _train_step(name, torch.device("cpu"), monkeypatch)
    assert set(gpu_losses) == set(cpu_losses) and set(gpu_grads) == set(cpu_grads)
    for k, v in cpu_losses.items():
        assert np.isfinite(v) and abs(gpu_losses[k] - v) <= 1e-3 * abs(v) + 1e-6, (k, gpu_losses[k], v)
    for k, g in cpu_grads.items():
        assert (gpu_grads[k] - g).abs().max() <= 5e-3 * g.abs().max() + 1e-6, k


SEG_MODELS = {"panoptic": ("e2e_panoptic_r18", golden_panoptic_config), "semantic": ("e2e_semseg_r18", golden_semseg_config)}


def _run_seg(name, device):
    golden_name, config = SEG_MODELS[name]
    golden = np.load(os.path.join(GOLDENS, golden_name + ".npz"))
    model = build_model(config(), device=device)
    sd = golden_state_dict(golden)
    assert load_state_dict_report(model, sd) == f"Loaded {len(sd)}/{len(sd)} tensors from the checkpoint."
    batch = {"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)}
    return {k: v[0].cpu() for k, v in model(batch).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SEG_MODELS))
def test_segmentation_model_on_the_card_launches_its_kernels(cuda, name):
    from detectron2_tpu_torch.ops import attention as port_attn
    from detectron2_tpu_torch.ops import roi_align as port_ra

    counters = (
        port_ra.roi_align_multilevel_cuda,
        port_ra.roi_align_multilevel_backward_cuda,
        port_attn.flash_attention_cuda,
        port_attn.flash_attention_t_cuda,
    )
    before = [c.launches for c in counters]
    out = _run_seg(name, cuda)
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([2, 0, 0, 0] if name == "panoptic" else [0, 0, 0, 0]), launched
    ref = _run_seg(name, "cpu")
    assert set(out) == set(ref)
    sem, ref_sem = out["sem_seg"].numpy(), ref["sem_seg"].numpy()
    assert np.abs(sem - ref_sem).max() <= 1e-4 * np.abs(ref_sem).max()
    if name == "panoptic":
        assert int(out["valid"].sum()) > 0
