"""The port's semantic segmentation against the JAX package's, on the CPU.

- ``upsample_bilinear`` (``F.interpolate`` one axis at a time, half-pixel
  centres) against ``jax.image.resize(..., "bilinear")`` at 2x and 4x on
  odd sizes: float32 to 1e-6, bfloat16 ``==``;
- ``SemSegFPNHead`` alone on the same NHWC features, float32 (2e-5 of
  max|x|) at odd level sizes, with p2-p5 and with the stride-4 level alone
  (one conv, no upsample), and in bfloat16 against the JAX head's bfloat16
  run within a stated bound (the bf16 convolutions' sums differ in order
  between the CPU's backends: ROADMAP C);
- the tiny R18-FPN ``SemanticSegmentor`` (FPN width 32, head 32 wide, 9
  classes) with the JAX model's variables carried across by
  ``convert_jax_params``: the forward logits (2e-5 of max|x|), one training
  step's loss (rtol 1e-4) and every gradient (1e-3 of max|g| + 1e-6, the
  head's included), with ignored pixels in the targets;
- ``tests/goldens/e2e_semseg_r18.npz`` through the port's d2 ``.pkl``
  loader (``sem_seg_head.{p}.{2k}``), at the JAX golden test's bounds
  (2e-3, argmax agreement above 0.999);
- ``sem_seg_postprocess`` against the JAX function (``cv2.resize``,
  ``INTER_LINEAR``) up and down to 1e-5, the labels ``==`` except where the
  top two logits are within 1e-5;
- the ``SemanticSegmentor`` yamls build with the JAX model's parameter
  names and sizes.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    load_golden,
    n,
    port_model,
    t,
)

from detectron2_tpu.modeling.postprocessing import sem_seg_postprocess as jax_sem_seg_postprocess
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_d2_checkpoint
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.layers import ShapeSpec
from detectron2_tpu_torch.modeling import SemanticSegmentor, build_model
from detectron2_tpu_torch.modeling.meta_arch.semantic_seg import SemSegFPNHead, upsample_bilinear
from detectron2_tpu_torch.modeling.postprocessing import sem_seg_postprocess
from detectron2_tpu_torch.testing import golden_semseg_config, golden_state_dict

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}


def close(ours, ref, rel=2e-5):
    ours, ref = n(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours.astype(np.float64) - ref.astype(np.float64)).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (err, np.abs(ref).max())
    return err


def tiny_cfg(in_features=("p2", "p3", "p4", "p5")):
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "SemanticSegmentor"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.SEM_SEG_HEAD.IN_FEATURES = list(in_features)
    m.SEM_SEG_HEAD.NUM_CLASSES = 9
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    m.DEVICE = "cpu"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def eval_batch(seed=0):
    """Two images in a 96x160 batch: p5 is 3x5, every level odd in a side."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (2, 96, 160, 3)).astype(np.uint8)
    return {"image": img, "image_sizes": np.array([[96, 160], [80, 130]], np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("hw", [(3, 5), (7, 11), (24, 40)])
def test_upsample_matches_jax_image_resize(factor, hw, dtype):
    """float32 within 1e-6 of max|x|; bfloat16 ``==`` (both round the
    width's pass to bf16, then the height's)."""
    x = np.random.RandomState(hw[0] * factor).standard_normal((2,) + hw + (6,)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x, dtype), (2, hw[0] * factor, hw[1] * factor, 6), method="bilinear")
    ours = upsample_bilinear(t(x).to(getattr(torch, dtype)), factor)
    if dtype == "float32":
        close(ours, ref, rel=1e-6)
    else:
        np.testing.assert_array_equal(n(ours.float()), np.asarray(ref.astype(jnp.float32)))


def _heads(in_features, dtype):
    """The JAX head and the port's with the same seeded weights, and
    features of ``dtype`` at the 96x160 batch's level sizes."""
    from detectron2_tpu.layers.shape_spec import ShapeSpec as JaxShapeSpec
    from detectron2_tpu.modeling.meta_arch.semantic_seg import SemSegFPNHead as JaxHead

    cfg = tiny_cfg(in_features)
    rng = np.random.RandomState(1)
    feats = {
        f: rng.standard_normal((2, 96 // s, 160 // s, 32)).astype(np.float32) for f, s in STRIDES.items() if f in in_features
    }
    jax_head = JaxHead.from_config(jax_cfg_from_port(cfg), {f: JaxShapeSpec(channels=32, stride=STRIDES[f]) for f in feats})
    jfeats = {f: jnp.asarray(v, dtype) for f, v in feats.items()}
    shapes = jax.eval_shape(lambda: jax_head.init(jax.random.PRNGKey(0), jfeats))
    variables = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.2), shapes)
    head = SemSegFPNHead.from_config(cfg, {f: ShapeSpec(channels=32, stride=STRIDES[f]) for f in feats})
    state = convert_jax_params({"params": {"sem_seg_head": variables["params"]}})
    head.load_state_dict({k[len("sem_seg_head."):]: v for k, v in state.items()})
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jax_head, variables, jfeats, head.eval(), {f: t(v).to(tdtype) for f, v in feats.items()}


@pytest.mark.parametrize("in_features", [("p2", "p3", "p4", "p5"), ("p2",)])
def test_sem_seg_head_matches_jax(in_features):
    jax_head, variables, jfeats, head, feats = _heads(in_features, jnp.float32)
    with torch.no_grad():
        logits = head.layers(feats, False)
        up, losses = head(feats)
    close(logits, jax_head.apply(variables, jfeats, method=jax_head.layers))
    ref_up, _ = jax_head.apply(variables, jfeats)
    close(up, ref_up)
    assert losses == {} and up.dtype == torch.float32 and up.shape == (2, 96, 160, 9)
    assert [k for k, _ in head.named_parameters()][:3] == ["p2.0.weight", "p2.0.norm.weight", "p2.0.norm.bias"]


def test_sem_seg_head_bf16_against_jax_bf16():
    """bfloat16 features through both heads: the logits differ by the bf16
    convolutions' sums (the resizes round as the JAX ones). Bound: 4 bf16
    ulps of max|logit| (2^-6)."""
    jax_head, variables, jfeats, head, feats = _heads(("p2", "p3", "p4", "p5"), jnp.bfloat16)
    with torch.no_grad():
        logits = head.layers(feats, False)
    ref = np.asarray(jax_head.apply(variables, jfeats, method=jax_head.layers))
    assert logits.dtype == torch.float32 and ref.dtype == np.float32
    err = np.abs(n(logits) - ref).max()
    assert err <= 2.0**-6 * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.1)
    return cfg, jm, variables


def test_semantic_segmentor_forward_matches_jax(tiny):
    cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    assert isinstance(model, SemanticSegmentor)
    batch = eval_batch()
    ref = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    out = model(batch)
    assert set(out) == {"sem_seg"} and out["sem_seg"].shape == (2, 96, 160, 9)
    close(out["sem_seg"], ref["sem_seg"])


def train_batch(seed=0):
    batch = eval_batch(seed)
    rng = np.random.RandomState(seed + 1)
    sem = rng.randint(0, 9, (2, 96, 160)).astype(np.int32)
    sem[:, :10] = 255  # ignored rows
    sem[1, 80:] = 255  # the second image's padding
    sem[1, :, 130:] = 255
    batch["gt_sem_seg"] = sem
    return batch


def test_semantic_segmentor_train_step_matches_jax(tiny):
    cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    batch = train_batch()
    ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    assert set(ref_losses) == {"loss_sem_seg"}
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert np.isfinite(losses["loss_sem_seg"])
    head = [k for k, p in model.named_parameters() if k.startswith("sem_seg_head.") and p.grad is not None]
    assert len(head) == 7 * 3 + 2  # p2-p5 take 1, 1, 2 and 3 convs with GN; the predictor
    assert all(model.get_parameter(k).grad.abs().sum() > 0 for k in head)


def test_all_targets_ignored_gives_zero_loss_as_jax(tiny):
    cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    batch = train_batch()
    batch["gt_sem_seg"][:] = 255
    ref_losses, _ = jax_losses_and_grads(cfg, variables, batch)
    losses = model(batch, train=True)
    assert ref_losses["loss_sem_seg"] == 0.0 and losses["loss_sem_seg"].item() == 0.0


def test_golden_through_the_d2_loader(tmp_path):
    g = load_golden("e2e_semseg_r18")
    pkl = tmp_path / "semseg.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"model": golden_state_dict(g), "__author__": "reference-oracle"}, f)
    model = build_model(golden_semseg_config(), device="cpu")
    report = load_d2_checkpoint(model, str(pkl))
    assert report.splitlines() == [f"Loaded {len(model.state_dict())}/{len(model.state_dict())} tensors from the checkpoint."]
    out = model({"image": g["image"][None], "image_sizes": np.array([[320, 320]], np.int32)})
    ours = n(out["sem_seg"][0])
    ref = g["sem_seg"].transpose(1, 2, 0)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 2e-3
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize(
    "hw, img_size, out_hw",
    [((96, 160), (80, 130), (160, 260)), ((96, 160), (96, 150), (61, 97)), ((64, 64), (64, 64), (64, 64)), ((32, 48), (30, 41), (480, 640))],
)
def test_sem_seg_postprocess_matches_cv2(hw, img_size, out_hw):
    rng = np.random.RandomState(sum(out_hw))
    logits = rng.standard_normal(hw + (9,)).astype(np.float32)
    ref = jax_sem_seg_postprocess(logits, img_size, *out_hw)
    ours = sem_seg_postprocess(t(logits), img_size, *out_hw)
    assert ours.dtype == torch.float32
    close(ours, ref, rel=1e-5)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-5
    assert (n(ours.argmax(-1)) == ref.argmax(-1))[decided].all()


SEMANTIC_YAMLS = [
    "Misc/semantic_R_50_FPN_1x.yaml",
    "quick_schedules/semantic_R_50_FPN_inference_acc_test.yaml",
    "quick_schedules/semantic_R_50_FPN_instant_test.yaml",
    "quick_schedules/semantic_R_50_FPN_training_acc_test.yaml",
]


@pytest.mark.parametrize("config", SEMANTIC_YAMLS)
def test_semantic_yamls_build_with_the_jax_names(config):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", config))
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    assert type(model).__name__ == "SemanticSegmentor"
    assert model.sem_seg_head.predictor.out_channels == cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES == 54
    assert model.train_target_sizes()["with_sem_seg"]
    jm = jax_model(cfg)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, {"image": jnp.zeros((1, 64, 64, 3)), "image_sizes": jnp.asarray([[64, 64]])})
    )
    names = {k: v.numel() for k, v in convert_jax_params(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    assert names == {k: v.numel() for k, v in model.state_dict().items()}
