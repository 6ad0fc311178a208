"""The port's mask paste and detector_postprocess against the reference
golden and the JAX package's (float32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import load_golden, n, t

from detectron2_tpu.modeling.postprocessing import detector_postprocess as jax_postprocess
from detectron2_tpu.ops.paste_masks import paste_masks_in_image as jax_paste
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess
from detectron2_tpu_torch.ops.paste_masks import paste_masks_in_image

torch.set_num_threads(1)


def test_paste_matches_reference_golden():
    g = load_golden("paste_masks")
    H, W = (int(v) for v in g["image_hw"])
    out = n(paste_masks_in_image(t(g["masks"]), t(g["boxes"]), (H, W)))
    # binarized masks agree except possibly on the 0.5 contour (the golden
    # test's own bound)
    assert (out != g["pasted_binary"].astype(bool)).mean() < 5e-3


@pytest.mark.parametrize("fast", [False, True])
def test_paste_matches_jax(fast):
    rng = np.random.RandomState(int(fast))
    N = 13
    masks = rng.uniform(size=(N, 28, 28)).astype(np.float32)
    xy = rng.uniform(-20, 90, (N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 70, (N, 2))], 1).astype(np.float32)
    ref = np.asarray(jax_paste(jnp.asarray(masks), jnp.asarray(boxes), (96, 112), chunk=5, fast=fast))
    out = n(paste_masks_in_image(t(masks), t(boxes), (96, 112), chunk=5, fast=fast))
    # the same float32 (or bf16-operand) arithmetic; a pixel may flip only
    # where the probability sits within float rounding of 0.5
    assert out.shape == ref.shape and out.dtype == bool
    assert (out != ref).sum() <= 2


def test_detector_postprocess_matches_jax():
    rng = np.random.RandomState(2)
    D = 20
    xy = rng.uniform(-10, 150, (D, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (D, 2))], 1).astype(np.float32)
    boxes[3] = [170, 10, 180, 20]  # empty after clipping to the 160-wide frame
    det = {
        "pred_boxes": boxes,
        "scores": rng.uniform(size=D).astype(np.float32),
        "pred_classes": rng.randint(0, 7, D).astype(np.int32),
        "valid": rng.uniform(size=D) > 0.2,
        "pred_masks": rng.uniform(size=(D, 28, 28)).astype(np.float32),
    }
    det["valid"][3] = True
    ref = jax_postprocess(det, 240, 300, 128, 160)
    out = detector_postprocess({k: t(v) for k, v in det.items()}, 240, 300, 128, 160)
    assert out.image_size == (240, 300) and len(out) == len(ref.scores)
    np.testing.assert_allclose(n(out.pred_boxes.tensor), np.asarray(ref.pred_boxes.tensor), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(n(out.scores), ref.scores)
    np.testing.assert_array_equal(n(out.pred_classes), ref.pred_classes)
    ref_masks = np.asarray(ref.pred_masks.tensor)
    assert out.pred_masks.tensor.shape == ref_masks.shape
    assert (n(out.pred_masks.tensor) != ref_masks).mean() < 1e-4
