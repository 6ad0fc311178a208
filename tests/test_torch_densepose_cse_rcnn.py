"""The CSE DensePose R-CNN (the embedding predictor and ``DensePoseROIHeads``'
CSE branch) on a tiny R18-FPN against the JAX package, float32, weights
carried across by ``convert_jax_params`` (the embedders' parameters and
their feature buffers too), on meshes of 30-60 vertices staged by
``testing.write_synthetic_cse_meshes``:

- ``embed``: one mesh, a direct embedder, ``EmbeddingLoss``: inference
  (``pred_densepose_embedding`` and ``pred_densepose_fg``) and the train
  losses and every gradient;
- ``soft_cycles``: three meshes with feature embedders, ``SoftEmbeddingLoss``
  (each instance's points routed to its mesh by ``gt_dp_mesh_id``),
  ``COARSE_SEGM_TRAINED_BY_MASKS``, the shape-to-shape loss on a vertex
  subsample (``MAX_NUM_VERTICES``) and the pixel-to-shape loss: the losses
  and every gradient, with the mesh pair fixed in both packages and the
  pixel sample a fixed function of the mask in both (their samplers draw
  from different generators).

Tolerances as ``tests/test_torch_densepose_rcnn.py``.
"""

import numpy as np
import pytest
import torch

from _torch_port import (
    SameDraws,
    assert_train_step_matches,
    jax_inference,
    jax_model,
    jax_random_variables,
    jax_train_step,
    n,
    port_model,
)

from detectron2_tpu_torch.config.cfg_node import CfgNode as CN
from detectron2_tpu_torch.projects.densepose import DensePoseROIHeads
from detectron2_tpu_torch.projects.densepose.meshes import MeshCatalog
from detectron2_tpu_torch.testing import synthetic_train_batch, write_synthetic_cse_meshes
from test_torch_densepose_rcnn import eval_batch, tiny_cfg

torch.set_num_threads(1)

MESHES = {"cat_5001": 40, "dog_5002": 50, "sheep_5004": 60}
PAIR = 2  # the shape-to-shape pair both packages take: (dog, sheep)


def cse_cfg(variant: str):
    cfg = tiny_cfg("decoder")
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    h.PREDICTOR_NAME = "DensePoseEmbeddingPredictor"
    h.RAW_OUTPUTS = False
    h.CSE.EMBED_SIZE = 8
    if variant == "embed":
        h.CSE.EMBEDDERS["smpl_27554"] = CN({"TYPE": "vertex_direct", "NUM_VERTICES": 30})
        cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING = CN({"0": "smpl_27554"})
        return cfg
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 48  # 12 foreground slots an image: every mesh's instances in the branch
    h.COARSE_SEGM_TRAINED_BY_MASKS = True
    h.CSE.EMBED_LOSS_NAME = "SoftEmbeddingLoss"
    h.CSE.EMBEDDING_DIST_GAUSS_SIGMA = h.CSE.GEODESIC_DIST_GAUSS_SIGMA = 0.1
    h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.ENABLED = True
    h.CSE.SHAPE_TO_SHAPE_CYCLE_LOSS.MAX_NUM_VERTICES = 45
    h.CSE.PIX_TO_SHAPE_CYCLE_LOSS.ENABLED = True
    h.CSE.PIX_TO_SHAPE_CYCLE_LOSS.NUM_PIXELS_TO_SAMPLE = 20
    for name, v in MESHES.items():
        h.CSE.EMBEDDERS[name] = CN({"TYPE": "vertex_feature", "NUM_VERTICES": v, "FEATURE_DIM": 12})
    cfg.DATASETS.CLASS_TO_MESH_NAME_MAPPING = CN({str(i): name for i, name in enumerate(MESHES)})
    return cfg


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    write_synthetic_cse_meshes(root, list(MESHES), seed=3, num_vertices=MESHES, feature_dim=12)
    return root


@pytest.fixture(scope="module", params=["embed", "soft_cycles"])
def tiny(request, staged):
    mp = pytest.MonkeyPatch()
    mp.setenv("DETECTRON2_DATASETS", staged)
    cfg = cse_cfg(request.param)
    jm = jax_model(cfg)
    variables = jax_random_variables(jm, seed=0, scale=0.05)
    yield request.param, cfg, jm, variables
    mp.undo()


# inference is the predictor's, the same whatever the losses: one variant
@pytest.mark.parametrize("tiny", ["embed"], indirect=True)
def test_cse_inference_matches_jax(tiny):
    variant, cfg, jm, variables = tiny
    model = port_model(cfg, variables)
    assert isinstance(model.roi_heads, DensePoseROIHeads) and model.roi_heads.cse_mesh_names == ("smpl_27554",)
    batch = eval_batch()
    ref = jax_inference(jm, variables, batch)
    out = model(batch)
    assert set(out) == set(ref) == {"pred_boxes", "scores", "pred_classes", "box_idx", "valid",
                                    "pred_densepose_embedding", "pred_densepose_fg"}
    assert ref["valid"].sum() >= 10
    for k in ("valid", "pred_classes", "box_idx"):
        np.testing.assert_array_equal(n(out[k]), ref[k], err_msg=k)
    np.testing.assert_allclose(n(out["pred_boxes"]), ref["pred_boxes"], rtol=0, atol=1e-3)
    emb, remb = n(out["pred_densepose_embedding"]), ref["pred_densepose_embedding"]
    assert emb.shape == remb.shape == (2, 8, 56, 56, 8) and not emb[:, 5:].any()
    np.testing.assert_allclose(emb, remb, rtol=0, atol=1e-4 * np.abs(remb).max())
    fg, rfg = n(out["pred_densepose_fg"]), ref["pred_densepose_fg"]
    assert fg.dtype == rfg.dtype == bool and (fg == rfg).mean() > 0.999 and rfg[:, :5].any()
    # the class's mesh: each pixel's nearest vertex of the embedder's table
    verts = model.roi_heads.closest_vertices(out["pred_densepose_embedding"][0, 0], 0)
    assert verts.shape == (56, 56) and 0 <= int(verts.min()) and int(verts.max()) < 30


def cse_train_batch(variant: str, seed=0, P=12):
    """``synthetic_train_batch`` with CSE points inside each gt box: vertex
    ids below the instance's mesh size, the last two slots padding, one gt
    of image 0 without points; the instances' meshes in turn."""
    names = ["smpl_27554"] if variant == "embed" else list(MESHES)
    batch = synthetic_train_batch(B=2, H=64, W=96, G=5, num_classes=len(names), seed=seed, mask_size=28)
    if variant == "embed":
        del batch["gt_masks"]
    rng = np.random.RandomState(seed + 1)
    boxes = batch["gt_boxes"]
    frac = rng.rand(2, 5, P, 2).astype(np.float32)
    batch["gt_dp_points"] = (boxes[..., None, :2] + frac * (boxes[..., None, 2:] - boxes[..., None, :2])).astype(np.float32)
    batch["gt_dp_part"] = np.full((2, 5, P), -1, np.int64)
    batch["gt_dp_u"] = np.zeros((2, 5, P), np.float32)
    batch["gt_dp_v"] = np.zeros((2, 5, P), np.float32)
    cls = (np.arange(5)[None] + np.arange(2)[:, None]) % len(names)
    sizes = np.array([30 if variant == "embed" else MESHES[m] for m in names])
    vert = (rng.rand(2, 5, P) * sizes[cls][..., None]).astype(np.int64)
    vert[..., -2:] = -1
    vert[0, 1] = -1
    batch["gt_dp_vertex"] = vert
    batch["gt_dp_mesh_id"] = np.array([[MeshCatalog.get_mesh_id(names[c]) for c in row] for row in cls], np.int64)
    return batch


def _order(N: int) -> np.ndarray:
    """A fixed permutation of N positions as distinct weights in [0, 1)."""
    return ((np.arange(N) * 7919) % N / N).astype(np.float32)


def patch_cycle_draws(monkeypatch):
    """Both packages' pixel samplers -> a fixed draw (the foreground first,
    each group in :func:`_order`); the mesh pair -> PAIR."""
    import jax
    import jax.numpy as jnp

    import detectron2_tpu.projects.densepose.cse as jax_cse
    import detectron2_tpu_torch.projects.densepose.cse as cse
    import detectron2_tpu_torch.projects.densepose.roi_heads as roi_heads

    def port_sample(mask, num, generator=None):
        flat = mask.flatten(-2).float()
        idx = torch.topk(flat * 2.0 + torch.from_numpy(_order(flat.shape[-1])), num).indices
        return idx, torch.gather(flat, -1, idx) > 0

    def jax_sample(rng, mask, num):
        flat = mask.reshape(-1).astype(jnp.float32)
        idx = jax.lax.top_k(flat * 2.0 + jnp.asarray(_order(flat.shape[-1])), num)[1]
        return idx.astype(jnp.int32), flat[idx] > 0

    monkeypatch.setattr(cse, "sample_fg_pixels", port_sample)
    monkeypatch.setattr(jax_cse, "sample_fg_pixels", jax_sample)
    monkeypatch.setattr(roi_heads, "draw_pair", lambda n_pairs, generator, device: PAIR)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **k: jnp.asarray(PAIR, jnp.int32))


def test_cse_train_step_matches_jax(tiny, monkeypatch):
    variant, cfg, jm, variables = tiny
    SameDraws(0).patch(monkeypatch)
    patch_cycle_draws(monkeypatch)
    model = port_model(cfg, variables)
    batch = cse_train_batch(variant)
    ref_losses, ref_grads = jax_train_step(jm, variables, batch)
    names = ["smpl_27554"] if variant == "embed" else list(MESHES)
    dp_losses = {"loss_densepose_S"} | {f"loss_densepose_E_{m}" for m in names}
    if variant != "embed":
        dp_losses |= {"loss_shape2shape", "loss_pix2shape"}
    assert dp_losses <= set(ref_losses) and all(ref_losses[k] > 0 for k in dp_losses), {k: ref_losses[k] for k in dp_losses}
    assert_train_step_matches(model, batch, ref_losses, ref_grads)
    heads = [k for k, p in model.named_parameters() if k.startswith(("roi_heads.densepose", "roi_heads.embedder"))]
    unmoved = {k for k in heads if model.get_parameter(k).grad.abs().sum() == 0}
    assert len(heads) > 8 and not unmoved, unmoved
