"""PointRend and PointSup on the card, float32 with TF32 off:

- the PointRend golden's tiny model (``tests/goldens/e2e_pointrend_r18.npz``,
  its synthetic weights by d2 name) on the card reproduces the golden at
  its parity test's bounds; the RoIAlign kernel launches once a forward
  (the box pool: the mask branch samples points);
- the RoIAlign forward and backward kernels on that model's recorded box
  pool against their plain versions: the forward within 1e-5 of the
  largest |value|, the backward of a seeded cotangent within 1e-5 of the
  largest |gradient|;
- one train step of a tiny PointSup model on the card: the kernels launch
  twice (box and 14x14 mask pools), once each way, and its losses match
  the CPU's within 1e-4.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_point_rend_cuda.py -q

Without a card every test skips.
"""

import os

import numpy as np
import pytest
import torch

import detectron2_tpu_torch.modeling.poolers as poolers
from detectron2_tpu_torch.checkpoint import load_state_dict_report
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.ops import roi_align as R
from detectron2_tpu_torch.testing import (
    add_synthetic_points,
    compare_with_pointrend_golden,
    golden_pointrend_config,
    golden_r18_config,
    golden_state_dict,
    synthetic_train_batch,
)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RoIAlign kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _golden_run(device, recorded):
    golden = np.load(os.path.join(GOLDENS, "e2e_pointrend_r18.npz"))
    model = build_model(golden_pointrend_config(), device=device)
    sd = golden_state_dict(golden)
    assert load_state_dict_report(model, sd) == f"Loaded {len(sd)}/{len(sd)} tensors from the checkpoint."
    entry = poolers.roi_align_multilevel

    def recording(*args, **kwargs):
        recorded.append((args, kwargs))
        return entry(*args, **kwargs)

    poolers.roi_align_multilevel = recording
    try:
        out = model({"image": golden["image"][None], "image_sizes": np.array([[320, 320]], np.int32)})
    finally:
        poolers.roi_align_multilevel = entry
    return golden, out


@pytest.mark.cuda
def test_golden_on_the_card_with_one_kernel_launch_a_forward(cuda):
    R.roi_align_multilevel_cuda.launches = 0
    recorded = []
    golden, out = _golden_run(cuda, recorded)
    assert R.roi_align_multilevel_cuda.launches == 1 and len(recorded) == 1
    errs = compare_with_pointrend_golden(out, golden)
    assert errs["mask_probs10"] < 5e-4


@pytest.mark.cuda
def test_kernels_on_the_pointrend_box_pool_match_their_plain_versions(cuda):
    recorded = []
    _golden_run(cuda, recorded)
    (feats, boxes, bidx, levels, scales, res), kwargs = recorded[0]
    feats = [f.detach() for f in feats]
    args = (boxes, bidx, levels, scales, res, kwargs["sampling_ratio"], kwargs["aligned"])
    got = R.roi_align_multilevel_cuda(feats, *args)
    ref = R.roi_align_multilevel_plain(feats, *args)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    g = torch.randn(got.shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    shapes = [tuple(f.shape) for f in feats]
    got_b = R.roi_align_multilevel_backward_cuda(g, shapes, *args)
    ref_b = R.roi_align_multilevel_backward_plain(g, shapes, *args)
    for a, b in zip(got_b, ref_b):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-7


@pytest.mark.cuda
def test_point_sup_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The samplers' draws are made on the CPU and moved, so that both
    devices take the same slots."""
    from detectron2_tpu_torch.modeling import sampling
    from detectron2_tpu_torch.projects.point_sup import add_point_sup_config

    cfg = golden_r18_config()
    add_point_sup_config(cfg)
    batch = add_synthetic_points(synthetic_train_batch(num_classes=7), 5, seed=0)
    monkeypatch.setattr(sampling, "uniform_draws", lambda shape, generator, device: tuple(
        torch.rand(shape, generator=torch.Generator().manual_seed(s)).to(device) for s in (1, 2)))
    state = build_model(cfg, device="cpu").state_dict()
    losses = {}
    for device in (torch.device("cpu"), cuda):
        model = build_model(cfg, device=device)
        model.load_state_dict(state)
        R.roi_align_multilevel_cuda.launches = R.roi_align_multilevel_backward_cuda.launches = 0
        out = model(batch, train=True)
        sum(out.values()).backward()
        losses[device.type] = {k: v.item() for k, v in out.items()}
    assert (R.roi_align_multilevel_cuda.launches, R.roi_align_multilevel_backward_cuda.launches) == (2, 2)
    assert "loss_mask" in losses["cpu"]
    for k, v in losses["cpu"].items():
        assert abs(losses["cuda"][k] - v) <= 1e-4 * max(abs(v), 1.0), (k, losses["cuda"][k], v)
