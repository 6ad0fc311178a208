"""The CSE functions of ``detectron2_tpu_torch/projects/densepose/cse.py``
against the JAX package's ``cse.py``, float32, at 1e-5 (relative to the
largest value where stated), on meshes of at most 200 vertices: the specs
in both config layouts, the embedders, the embedding and soft embedding
losses and their gradients, the nearest vertices, the shape-to-shape loss
pair by pair on the shared vertex subsample, and the pixel-to-shape loss on
masks with exactly ``NUM_PIXELS_TO_SAMPLE`` foreground pixels (both
samplers then take the same set, and the loss does not change under a
joint permutation of it, so the two generators need not agree).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import detectron2_tpu.projects.densepose.cse as jcse
from detectron2_tpu.config import get_cfg as jax_get_cfg
from detectron2_tpu.projects.densepose import add_densepose_config as jax_add_densepose_config

from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.config.cfg_node import CfgNode as CN
from detectron2_tpu_torch.projects.densepose import add_densepose_config
from detectron2_tpu_torch.projects.densepose import cse

torch.set_num_threads(1)
TOL = 1e-5
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs", "DensePose")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol * max(1.0, np.abs(b).max()), (err, np.abs(b).max())


def _cfgs(embedders):
    """(port cfg, JAX cfg) with CSE.EMBEDDERS = ``embedders`` (a dict of
    spec dicts, or the list layout)."""
    out = []
    for get, add in ((get_cfg, add_densepose_config), (jax_get_cfg, jax_add_densepose_config)):
        cfg = get()
        add(cfg)
        cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBED_SIZE = 8
        if embedders is None:
            pass
        elif isinstance(embedders, dict):
            node = type(cfg)(new_allowed=True)
            node.update({k: type(cfg)(v) for k, v in embedders.items()})
            cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS = node
        else:
            cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS = embedders
        out.append(cfg)
    return out


SPECS = {
    "dog_32": {"TYPE": "vertex_direct", "NUM_VERTICES": 32},
    "cat_64": {"TYPE": "vertex_feature", "NUM_VERTICES": 64, "FEATURE_DIM": 16, "FEATURES_TRAINABLE": False,
               "IS_TRAINABLE": True, "INIT_FILE": "https://example.invalid/phi_cat.pkl"},
    "cow_48": {"TYPE": "vertex_feature", "NUM_VERTICES": 48, "FEATURE_DIM": 16, "FEATURES_TRAINABLE": True,
               "IS_TRAINABLE": False},
}


@pytest.mark.parametrize("layout", ["dict", "list", "empty", "animals_yaml", "human_yaml"])
def test_specs_match_jax(layout):
    if layout.endswith("yaml"):
        name = "densepose_rcnn_R_50_FPN_soft_animals_finetune_4k.yaml" if layout == "animals_yaml" else \
            "densepose_rcnn_R_50_FPN_s1x.yaml"
        port, jaxc = _cfgs(None)
        port.merge_from_file(os.path.join(CONFIGS, "cse", name))
        jaxc.merge_from_file(os.path.join(CONFIGS, "cse", name))
    else:
        port, jaxc = _cfgs({"dict": SPECS, "list": [["smpl_27554", 27554], ["cat_5001", 5001]], "empty": []}[layout])
    specs = cse.embedder_specs_from_cfg(port)
    assert specs == jcse.embedder_specs_from_cfg(jaxc)
    assert cse.embedder_init_files_from_cfg(port) == jcse.embedder_init_files_from_cfg(jaxc)
    if layout == "dict":
        assert [s[0] for s in specs] == ["cat_64", "cow_48", "dog_32"]
    if layout == "animals_yaml":
        assert len(specs) == 9 and all(s[1] == "vertex_feature" and s[3] == 256 for s in specs)


def _jax_embedder(specs, seed=0, scale=0.3):
    """The JAX Embedder with seeded random variables (params and buffers)."""
    module = jcse.Embedder(mesh_specs=specs)

    def call_all(m):
        return [m(s[0]) for s in specs]

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), method=call_all))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * scale), shapes)
    return module, variables


def _port_embedder(specs, variables):
    from detectron2_tpu_torch.checkpoint import convert_jax_params

    emb = cse.Embedder(specs)
    # the embedder as the ROI heads hold it: the JAX scope cse_embedder, d2's embedder
    scoped = {coll: {"cse_embedder": tree} for coll, tree in jax.tree_util.tree_map(np.asarray, variables).items()}
    state = {k[len("embedder."):]: v for k, v in convert_jax_params(scoped).items()}
    missing, unexpected = emb.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    return emb


def test_embedders_match_jax():
    port, jaxc = _cfgs(SPECS)
    specs = cse.embedder_specs_from_cfg(port)
    module, variables = _jax_embedder(specs)
    emb = _port_embedder(specs, variables)
    names = [s[0] for s in specs]
    assert isinstance(emb.cat_64, cse.VertexFeatureEmbedder) and isinstance(emb.dog_32, cse.VertexDirectEmbedder)
    assert "features" in dict(emb.cat_64.named_buffers()) and "features" in dict(emb.cow_48.named_parameters())
    for name in names:
        ref = module.apply(variables, name)
        out = emb(name)
        close(out.detach(), ref)
        np.testing.assert_allclose(np.linalg.norm(np.asarray(ref), axis=1), 1.0, rtol=1e-5)
    # IS_TRAINABLE False: no gradient in either package
    grads = jax.grad(lambda v: sum((module.apply(v, n) ** 2 * (i + 1)).sum() for i, n in enumerate(names)))(variables)
    sum((emb(n) ** 2 * (i + 1)).sum() for i, n in enumerate(names)).backward()
    assert emb.cow_48.embeddings.grad is None and emb.cow_48.features.grad is None
    assert not np.asarray(grads["params"]["embedder_cow_48"]["embeddings"]).any()
    for name in ("cat_64", "dog_32"):
        close(getattr(emb, name).embeddings.grad, grads["params"][f"embedder_{name}"]["embeddings"], 1e-4)


def test_load_embedder_features(tmp_path):
    """A local INIT_FILE fills the feature buffer; a URL is skipped, as in
    the JAX package."""
    port, _ = _cfgs(SPECS)
    specs = cse.embedder_specs_from_cfg(port)
    emb = cse.Embedder(specs)
    feats = np.random.RandomState(0).rand(64, 16).astype(np.float32)
    path = tmp_path / "phi_cat.pkl"
    with open(path, "wb") as f:
        pickle.dump({"features": feats}, f)
    assert cse.load_embedder_features(emb, cse.embedder_init_files_from_cfg(port)) == ()
    assert not emb.cat_64.features.any()
    assert cse.load_embedder_features(emb, {"cat_64": str(path)}) == ("cat_64",)
    np.testing.assert_array_equal(emb.cat_64.features.numpy(), feats)
    # the JAX package's loader on its variables, the same array
    module, variables = _jax_embedder(specs)
    out = jcse.load_embedder_features(jax.tree_util.tree_map(np.asarray, variables), specs, {"cat_64": str(path)})
    np.testing.assert_array_equal(np.asarray(out["buffers"]["embedder_cat_64"]["features"]), feats)


def _loss_inputs(seed, P=150, K=120, D=8):
    rng = np.random.RandomState(seed)
    emb = rng.standard_normal((P, D)).astype(np.float32)
    mesh = rng.standard_normal((K, D)).astype(np.float32)
    mesh /= np.linalg.norm(mesh, axis=1, keepdims=True)
    ids = rng.randint(0, K, P)
    ids[-5:] = -1
    valid = ids >= 0
    pts = rng.standard_normal((K, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    geo = np.arccos(np.clip(pts @ pts.T, -1, 1)).astype(np.float32)
    return emb, mesh, ids, valid, geo


@pytest.mark.parametrize("soft", [False, True], ids=["embed", "soft"])
@pytest.mark.parametrize("sigma", [0.01, 0.1])
def test_embedding_losses_match_jax(soft, sigma):
    emb, mesh, ids, valid, geo = _loss_inputs(1)

    def jax_loss(e, m):
        if soft:
            return jcse.cse_soft_embedding_loss(e, jnp.asarray(ids), jnp.asarray(valid), m, jnp.asarray(geo), sigma, sigma)
        return jcse.cse_embedding_loss(e, jnp.asarray(ids), jnp.asarray(valid), m, sigma)

    ref, (ge, gm) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(mesh))
    e, m = t(emb).requires_grad_(), t(mesh).requires_grad_()
    if soft:
        out = cse.cse_soft_embedding_loss(e, t(ids), t(valid), m, t(geo), sigma, sigma)
    else:
        out = cse.cse_embedding_loss(e, t(ids), t(valid), m, sigma)
    out.backward()
    close(out.detach(), ref)
    close(e.grad, ge)
    close(m.grad, gm)


def test_closest_vertices_match_jax():
    emb, mesh, _, _, _ = _loss_inputs(2, P=1000)
    pix = emb.reshape(10, 100, 8)
    ref = np.asarray(jcse.closest_vertices_from_embedding(jnp.asarray(pix), jnp.asarray(mesh), chunk=256))
    out = cse.closest_vertices_from_embedding(t(pix), t(mesh), chunk=256)
    assert out.shape == (10, 100)
    np.testing.assert_array_equal(out.numpy(), ref)
    close(cse.normalize_embeddings(t(emb)), jcse.normalize_embeddings(jnp.asarray(emb)))


MESH_SIZES = {"cat_5001": 120, "dog_5002": 90, "sheep_5004": 200}


@pytest.fixture(scope="module")
def cycle_meshes():
    rng = np.random.RandomState(3)
    specs = tuple((name, "vertex_direct", n, 0, 8, False, True) for name, n in MESH_SIZES.items())
    geodists = {}
    for name, n in MESH_SIZES.items():
        pts = rng.standard_normal((n, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        geodists[name] = np.arccos(np.clip(pts @ pts.T, -1, 1)).astype(np.float32)
    data = cse.build_cycle_mesh_data(specs, 100, seed=0, geodists=geodists)
    jdata = jcse.build_cycle_mesh_data(specs, 100, seed=0, geodists=geodists)
    for (n1, i1, g1), (n2, i2, g2) in zip(data, jdata):
        assert n1 == n2 and (i1 is None) == (i2 is None)
        if i1 is not None:
            np.testing.assert_array_equal(i1, np.asarray(i2))
        np.testing.assert_array_equal(g1, np.asarray(g2))
    embs = {name: rng.standard_normal((n, 8)).astype(np.float32) for name, n in MESH_SIZES.items()}
    return data, embs


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("norm_p", [2, 1])
def test_shape_to_shape_matches_jax(cycle_meshes, pair, norm_p):
    data, embs = cycle_meshes
    (n1, i1, g1), (n2, i2, g2) = data[pair[0]], data[pair[1]]
    assert [d[1] is None for d in data] == [False, True, False]  # the meshes over 100 vertices are subsampled
    e1 = embs[n1] if i1 is None else embs[n1][i1]
    e2 = embs[n2] if i2 is None else embs[n2][i2]

    def jloss(a, b):
        return jcse.shape_to_shape_cycle_loss(
            jcse.normalize_embeddings(a), jnp.asarray(g1), jcse.normalize_embeddings(b), jnp.asarray(g2), 0.05, norm_p
        )

    ref, (ga, gb) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(e1), jnp.asarray(e2))
    a, b = t(e1).requires_grad_(), t(e2).requires_grad_()
    out = cse.shape_to_shape_cycle_loss(cse.normalize_embeddings(a), t(g1), cse.normalize_embeddings(b), t(g2), 0.05, norm_p)
    out.backward()
    close(out.detach(), ref)
    close(a.grad, ga)
    close(b.grad, gb)


def _exact_masks(R, S, num, seed):
    """Masks with exactly ``num`` foreground pixels each (one with none)."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((R, S * S), bool)
    for r in range(R - 1):
        masks[r, rng.choice(S * S, num, replace=False)] = True
    return masks.reshape(R, S, S)


@pytest.mark.parametrize("norm_p", [2, 1])
def test_pix_to_shape_matches_jax(norm_p):
    R, S, D, num = 4, 24, 8, 30
    rng = np.random.RandomState(4)
    emb = rng.standard_normal((R, S, S, D)).astype(np.float32)
    masks = _exact_masks(R, S, num, 5)
    mesh = rng.standard_normal((150, D)).astype(np.float32)
    mesh_n = np.asarray(jcse.normalize_embeddings(jnp.asarray(mesh)))
    keys = jax.random.split(jax.random.PRNGKey(0), R)

    def jloss(e):
        return jax.vmap(lambda ei, mi, ki: jcse.pix_to_shape_cycle_loss(ei, mi, jnp.asarray(mesh_n), ki, num, 0.05, 0.05, norm_p))(
            e, jnp.asarray(masks), keys
        )

    ref = jloss(jnp.asarray(emb))
    gref = jax.grad(lambda e: (jloss(e) * jnp.arange(1, R + 1)).sum())(jnp.asarray(emb))
    e = t(emb).requires_grad_()
    gen = torch.Generator().manual_seed(7)
    out = cse.pix_to_shape_cycle_loss(e, t(masks), t(mesh_n), gen, num, 0.05, 0.05, norm_p)
    (out * torch.arange(1, R + 1)).sum().backward()
    # no foreground: every pixel distance masked, the norm 0 (at its floor 1e-6 for p 2)
    assert out.shape == (R,) and out[-1].item() == pytest.approx(float(ref[-1]), abs=1e-12) and float(ref[-1]) <= 1e-6
    close(out.detach(), ref)
    close(e.grad, gref)


def test_sample_fg_pixels_support_and_shortfall():
    masks = torch.from_numpy(_exact_masks(3, 10, 7, 6))
    idx, valid = cse.sample_fg_pixels(masks, 9, torch.Generator().manual_seed(0))
    assert idx.shape == valid.shape == (3, 9)
    for r in range(2):
        assert valid[r].sum() == 7 and set(idx[r][valid[r]].tolist()) == set(np.flatnonzero(masks[r].numpy()).tolist())
    assert not valid[2].any()
    # uniform without replacement: a large mask's draws differ by generator and never repeat
    big = torch.ones(1, 16, 16, dtype=torch.bool)
    a, _ = cse.sample_fg_pixels(big, 50, torch.Generator().manual_seed(1))
    b, _ = cse.sample_fg_pixels(big, 50, torch.Generator().manual_seed(2))
    assert len(set(a[0].tolist())) == 50 and set(a[0].tolist()) != set(b[0].tolist())


def test_mesh_alignment_evaluator_matches_jax(tmp_path, monkeypatch):
    """GE and GPS of learned vertex embeddings between meshes staged by
    ``testing.write_synthetic_cse_meshes``, each package reading the
    geodesics through its own ``create_mesh``."""
    from detectron2_tpu.projects.densepose.evaluation import MeshAlignmentEvaluator as JaxMeshAlignment
    from detectron2_tpu_torch.projects.densepose import MeshAlignmentEvaluator, create_mesh
    from detectron2_tpu_torch.testing import write_synthetic_cse_meshes

    sizes = {"cat_5001": 60, "dog_5002": 80, "sheep_5004": 70}
    write_synthetic_cse_meshes(str(tmp_path), list(sizes), seed=5, num_vertices=sizes, feature_dim=8)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    mesh = create_mesh("dog_5002")
    assert mesh.geodists.shape == (80, 80) and (np.diag(mesh.geodists) == 0).all()
    np.testing.assert_allclose(mesh.geodists, mesh.geodists.T, atol=1e-6)
    sym = mesh.symmetry["vertex_transforms"]
    assert (sym[sym] == np.arange(80)).all()  # an involution
    rng = np.random.RandomState(6)
    tables = {m: rng.standard_normal((n, 8)).astype(np.float32) for m, n in sizes.items()}
    keyvertices = {m: {f"k{i}": int(v) for i, v in enumerate(rng.choice(n, 5, replace=False))} for m, n in sizes.items()}
    ours = MeshAlignmentEvaluator(lambda m: torch.from_numpy(tables[m]), list(sizes), keyvertices).evaluate()
    ref = JaxMeshAlignment(lambda m: tables[m], list(sizes), keyvertices).evaluate()
    assert ours[0] == pytest.approx(ref[0], abs=1e-6) and ours[1] == pytest.approx(ref[1], abs=1e-6)
    for kind in ("GE", "GPS"):
        assert ours[2][kind] == pytest.approx(ref[2][kind], abs=1e-6)
    assert 0 < ours[1] < 1 and ours[0] > 0
