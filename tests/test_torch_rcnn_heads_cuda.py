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
"""

import os

import numpy as np
import pytest
import torch

from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.testing import golden_c4_config, golden_cascade_config, golden_keypoint_config, golden_state_dict

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
