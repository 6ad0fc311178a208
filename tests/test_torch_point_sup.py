"""The port's PointSup against the JAX package's, in float32 on the CPU.

- ``PointSupROIHeads`` (the standard mask head, its loss the binary cross
  entropy at the matched gt's annotated points) and
  ``ImplicitPointRendPointSupROIHeads`` on tiny R18-FPN models (64x64
  images, 5 points an instance inside its gt box, padded gt slots labelled
  -1): the losses (rtol 1e-4) and every gradient
  (``assert_train_step_matches``), the samplers on the same draws.
- ROADMAP C, correction 19: d2's ``MaskRCNNConvUpsamplePointSupHead`` under
  ``StandardROIHeads`` (``configs/PointSup/mask_rcnn_*``) is refused by the
  JAX package (no registry holds the name) and is ``PointSupROIHeads`` in
  the port, with the JAX ``PointSupROIHeads``' losses and gradients.
- The 3 PointSup yamls merge after ``add_point_sup_config`` (and
  ``add_pointrend_config``) and build on the meta device; they name a train
  set that neither package registers (d2's point-annotation data, which
  neither package has).
"""

import os

import numpy as np
import pytest
import torch

from _torch_port import (
    SameDraws,
    PointDraws,
    assert_train_step_matches,
    jax_cfg_from_port,
    jax_losses_and_grads,
    jax_model,
    jax_random_variables,
    jax_train_step,
    port_model,
)
from test_torch_point_rend import rcnn_cfg
from test_torch_train_step import make_batch, tiny_cfg

from detectron2_tpu.modeling import build_model as jax_build_model
from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.modeling import build_model
from detectron2_tpu_torch.projects.point_rend import add_pointrend_config
from detectron2_tpu_torch.projects.point_sup import ImplicitPointRendPointSupROIHeads, PointSupROIHeads, add_point_sup_config
from detectron2_tpu_torch.testing import add_synthetic_points

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def point_batch():
    return add_synthetic_points(make_batch(), num_points=5, seed=1)


@pytest.fixture(scope="module")
def draws():
    with pytest.MonkeyPatch.context() as mp:
        SameDraws(seed=9).patch(mp)
        PointDraws(seed=10).patch(mp)
        yield


def d2_named_cfg():
    """``configs/PointSup/mask_rcnn_*``'s naming on the tiny model."""
    cfg = tiny_cfg()
    add_point_sup_config(cfg)
    cfg.MODEL.ROI_HEADS.NAME = "StandardROIHeads"
    cfg.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsamplePointSupHead"
    return cfg


def test_point_sup_losses_and_gradients_match_jax_under_d2s_names(draws):
    """Correction 19 both ways: the JAX package refuses the pair, the port
    builds PointSupROIHeads and matches the JAX PointSupROIHeads."""
    cfg = d2_named_cfg()
    with pytest.raises(KeyError, match="MaskRCNNConvUpsamplePointSupHead"):
        jax_build_model(jax_cfg_from_port(cfg))
    jcfg = jax_cfg_from_port(cfg)
    jcfg.MODEL.ROI_HEADS.NAME, jcfg.MODEL.ROI_MASK_HEAD.NAME = "PointSupROIHeads", "MaskRCNNConvUpsampleHead"
    jm = jax_build_model(jcfg)
    variables = jax_random_variables(jm, seed=3, scale=0.1)
    batch = point_batch()
    ref_losses, ref_grads = jax_train_step(jm, variables, batch)
    model = port_model(cfg, variables)
    assert type(model.roi_heads) is PointSupROIHeads
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert "loss_mask" in losses and np.isfinite(losses["loss_mask"]) and losses["loss_mask"] > 0
    assert all(p.grad.abs().sum() > 0 for k, p in model.named_parameters() if k.startswith("roi_heads.mask_head."))


def test_implicit_point_sup_losses_and_gradients_match_jax(draws):
    cfg = rcnn_cfg(implicit=True)
    add_point_sup_config(cfg)
    cfg.MODEL.ROI_HEADS.NAME = "ImplicitPointRendPointSupROIHeads"
    cfg.MODEL.ROI_MASK_HEAD.NAME = "ImplicitPointRendPointSupHead"
    variables = jax_random_variables(jax_model(cfg), seed=3, scale=0.1)
    batch = point_batch()
    ref_losses, ref_grads = jax_losses_and_grads(cfg, variables, batch)
    model = port_model(cfg, variables)
    assert type(model.roi_heads) is ImplicitPointRendPointSupROIHeads
    losses = assert_train_step_matches(model, batch, ref_losses, ref_grads)
    assert {"loss_mask_point", "loss_l2"} <= set(losses) and "loss_mask" not in losses


def test_point_loss_weighs_only_annotated_points_inside_the_box():
    """No annotated point (every label -1): the mask loss is 0 and the
    heads get no gradient from it, in both packages' formula."""
    cfg = tiny_cfg()
    add_point_sup_config(cfg)
    cfg.MODEL.DEVICE = "cpu"
    model = build_model(cfg)
    batch = point_batch()
    batch["gt_point_labels"][:] = -1
    losses = model(batch, train=True)
    assert losses["loss_mask"].item() == 0.0


POINT_SUP_YAMLS = {
    "PointSup/implicit_pointrend_R_50_FPN_3x_point_sup_point_aug_coco.yaml": ImplicitPointRendPointSupROIHeads,
    "PointSup/mask_rcnn_R_50_FPN_3x_point_sup_coco.yaml": PointSupROIHeads,
    "PointSup/mask_rcnn_R_50_FPN_3x_point_sup_point_aug_coco.yaml": PointSupROIHeads,
}


@pytest.mark.parametrize("yaml", sorted(POINT_SUP_YAMLS))
def test_point_sup_yamls_build(yaml):
    cfg = get_cfg()
    add_pointrend_config(cfg)
    add_point_sup_config(cfg)
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml))
    assert cfg.INPUT.POINT_SUP and cfg.INPUT.SAMPLE_POINTS == 5
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    assert type(model.roi_heads) is POINT_SUP_YAMLS[yaml]
    assert cfg.DATASETS.TRAIN == ("coco_2017_train_points_n10_v1_without_masks",)
    assert cfg.DATASETS.TRAIN[0] not in DatasetCatalog.list() and cfg.DATASETS.TEST[0] in DatasetCatalog.list()
