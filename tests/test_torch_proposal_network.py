"""The port's RPN-only model (``ProposalNetwork``) against the JAX package's,
on the CPU in float32: a tiny R18-FPN (width 32) with the JAX variables
carried across by ``convert_jax_params``.

- inference: validity equal, proposal logits within 2e-5 of max|x| of the
  JAX ones, and boxes within 2e-2 px: a proposal is decoded with exp(dw)
  up to 62 times its anchor (up to 512 px wide) before it is clipped to the
  64-px image, so a float32 rounding of its delta moves a coordinate inside
  the image by up to ~1e-2 px (measured 9.4e-3, the next largest 6e-4);
- training: the RPN losses rtol 1e-4 and every gradient within 1e-3 of
  max|g| + 1e-6, as the R-CNN train-step tests, both samplers on the same
  draws (``SameDraws``); no proposal is decoded in training;
- ``DefaultTrainer.test`` with ``COCOEvaluator`` on an 8-image synthetic
  COCO: the box-proposal AR dict within 1e-3 of the JAX ``DefaultTrainer.
  test``'s (the same proposals up to float32 rounding);
- ``DefaultPredictor`` on a ``ProposalNetwork`` raises ``KeyError:
  'pred_boxes'`` in both packages: the JAX predictor hands the proposal
  dict to ``detector_postprocess``, which reads detections.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import SameDraws, assert_train_step_matches, jax_cfg_from_port, jax_losses_and_grads, jax_model, jax_random_variables, n, port_model
from test_torch_eval import _jax_train_net, coco_tiny  # noqa: F401  (the fixture)
from test_torch_retinanet import close

from detectron2_tpu.engine.defaults import DefaultPredictor as JaxDefaultPredictor
from detectron2_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.engine import DefaultPredictor, DefaultTrainer
from detectron2_tpu_torch.evaluation import COCOEvaluator
from detectron2_tpu_torch.testing import synthetic_train_batch

torch.set_num_threads(1)


def tiny_cfg():
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "ProposalNetwork"
    m.DEVICE = "cpu"
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.OUT_CHANNELS = 32
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TEST = 200
    m.RPN.POST_NMS_TOPK_TEST = 100
    m.RPN.PRE_NMS_TOPK_TRAIN = 200
    m.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def make_batch():
    return synthetic_train_batch(H=64, W=64, num_classes=8, seed=1)


@pytest.fixture(scope="module")
def draws():
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        yield


@pytest.fixture(scope="module")
def jax_run(draws):
    cfg = tiny_cfg()
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=2, scale=0.1)
    b = make_batch()
    out = jm.apply(variables, {k: jnp.asarray(b[k]) for k in ("image", "image_sizes")}, train=False)
    losses, grads = jax_losses_and_grads(cfg, variables, b)
    return {"cfg": cfg, "jm": jm, "variables": variables, "out": jax.tree_util.tree_map(np.asarray, out),
            "losses": losses, "grads": grads}


def test_inference_outputs_match_jax(jax_run):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    b = make_batch()
    out, ref = model({"image": b["image"], "image_sizes": b["image_sizes"]}), jax_run["out"]
    assert set(out) == set(ref) == {"proposal_boxes", "proposal_logits", "valid"}
    np.testing.assert_array_equal(n(out["valid"]), ref["valid"])
    assert n(out["valid"]).sum() > 50
    np.testing.assert_allclose(n(out["proposal_boxes"]), ref["proposal_boxes"], rtol=0, atol=2e-2)
    v = ref["valid"]
    close(n(out["proposal_logits"])[v], ref["proposal_logits"][v], name="logits")  # padding is -inf on both sides


def test_training_losses_and_gradients_match_jax(jax_run, monkeypatch):
    model = port_model(jax_run["cfg"], jax_run["variables"])
    calls = []
    rpn = model.proposal_generator
    monkeypatch.setattr(rpn, "_proposals", lambda *a, **k: calls.append(1))
    losses = assert_train_step_matches(model, make_batch(), jax_run["losses"], jax_run["grads"])
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_loc"} and not calls  # no proposal decoded in training


def test_default_trainer_test_gives_the_jax_box_proposal_ar(jax_run, coco_tiny):
    cfg = jax_run["cfg"].clone()
    cfg.DATASETS.TEST = ("tiny_synth",)
    cfg.INPUT.MIN_SIZE_TEST = cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.OUTPUT_DIR = ""
    jax_cfg = jax_cfg_from_port(cfg)
    ref_ev = _jax_train_net().build_evaluator(jax_cfg, "tiny_synth", output_folder="")
    ref = JaxDefaultTrainer.test(jax_cfg, jax_run["jm"], evaluators=[ref_ev], params=jax_run["variables"])
    ev = COCOEvaluator("tiny_synth", distributed=False)
    ours = DefaultTrainer.test(cfg, port_model(cfg, jax_run["variables"]), evaluators=[ev])
    assert set(ours) == set(ref) == {"box_proposals"}
    assert list(ours["box_proposals"]) == list(ref["box_proposals"])
    assert {"AR@100", "AR@1000"} <= set(ours["box_proposals"]) and ours["box_proposals"]["AR@1000"] > 0
    for key, value in ref["box_proposals"].items():
        assert ours["box_proposals"][key] == pytest.approx(value, abs=1e-3, nan_ok=True), key


def test_predictor_on_a_proposal_network_raises_as_the_jax_one(jax_run, tmp_path):
    """The JAX ``DefaultPredictor`` passes the model's outputs to
    ``detector_postprocess``, which reads ``pred_boxes``: a proposal dict
    has none. The port's predictor does the same."""
    img = np.random.RandomState(0).randint(0, 256, (60, 80, 3)).astype(np.uint8)
    cfg = jax_run["cfg"].clone()
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 64, 96
    with pytest.raises(KeyError, match="pred_boxes"):
        JaxDefaultPredictor(jax_cfg_from_port(cfg))(img)
    with pytest.raises(KeyError, match="pred_boxes"):
        DefaultPredictor(cfg)(img)
