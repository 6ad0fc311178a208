"""Continuous surface embeddings (counterpart of
``detectron2_tpu/projects/densepose/cse.py``; d2's ``modeling/cse/`` and
``losses/{embed,soft_embed,cycle_pix2shape,cycle_shape2shape}.py``).

Each mesh vertex has a D-dim embedding, a learned table
(:class:`VertexDirectEmbedder`) or fixed per-vertex features projected by a
learned matrix (:class:`VertexFeatureEmbedder`); the head predicts a D-dim
embedding per pixel. The losses:

- :func:`cse_embedding_loss`: cross entropy over the vertices of the scores
  ``-||e_pixel - e_vertex||^2 / sigma`` against each annotated point's
  vertex;
- :func:`cse_soft_embedding_loss`: the same against a softmax of the
  geodesic distances from that vertex;
- :func:`pix_to_shape_cycle_loss`: pixel -> vertex -> pixel soft
  correspondences should come back to the pixel (the pixel distances
  weighted by the cycle, a p-norm);
- :func:`shape_to_shape_cycle_loss`: mesh -> mesh -> mesh should stay
  geodesically close to the identity, for one pair of meshes.

Fixed shapes as in the JAX package: the annotated points come padded with a
validity mask, the pixel sample is a Gumbel top-k of fixed size
(:func:`sample_fg_pixels`) and the shape-to-shape vertex subsample is drawn
once (:func:`build_cycle_mesh_data`). The ``[P, K]`` products are
``torch.matmul`` (the JAX package's are ``jnp`` outside Pallas: no kernel).

Parameter names are d2's: ``roi_heads.embedder.<mesh>.embeddings`` and, for
a feature embedder, the ``features`` buffer (a parameter with
``FEATURES_TRAINABLE``).
"""

import logging
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "normalize_embeddings",
    "squared_euclidean_distance_matrix",
    "VertexDirectEmbedder",
    "VertexFeatureEmbedder",
    "Embedder",
    "EmbedderSpec",
    "embedder_specs_from_cfg",
    "embedder_init_files_from_cfg",
    "load_embedder_features",
    "cse_embedding_loss",
    "cse_soft_embedding_loss",
    "closest_vertices_from_embedding",
    "sample_fg_pixels",
    "pix_to_shape_cycle_loss",
    "shape_to_shape_cycle_loss",
    "build_cycle_mesh_data",
]

logger = logging.getLogger(__name__)


def normalize_embeddings(embeddings: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Rows ``[..., D]`` divided by their L2 norm, at least ``epsilon``."""
    return embeddings / torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True).clamp_min(epsilon)


def squared_euclidean_distance_matrix(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """``[..., M, D]`` x ``[..., N, D]`` -> ``[..., M, N]``: -2 a.b + |a|^2 +
    |b|^2, the JAX package's (and d2's) order of terms."""
    cross = -2.0 * (pts1 @ pts2.transpose(-1, -2))
    return cross + (pts1 * pts1).sum(-1, keepdim=True) + (pts2 * pts2).sum(-1).unsqueeze(-2)


class VertexDirectEmbedder(nn.Module):
    """A learned ``[num_vertices, embed_dim]`` table (zeros at first, as in
    d2), L2-normalised on read."""

    def __init__(self, num_vertices: int, embed_dim: int):
        super().__init__()
        self.embeddings = nn.Parameter(torch.zeros(num_vertices, embed_dim))

    def forward(self) -> torch.Tensor:
        return normalize_embeddings(self.embeddings)


class VertexFeatureEmbedder(nn.Module):
    """Per-vertex features ``[num_vertices, feature_dim]`` (a buffer, or a
    parameter with ``train_features``) projected by a learned ``[F, D]``
    matrix, L2-normalised; both zeros at first, as in d2 (the features come
    from ``INIT_FILE``: :func:`load_embedder_features`)."""

    def __init__(self, num_vertices: int, feature_dim: int, embed_dim: int, train_features: bool = False):
        super().__init__()
        features = torch.zeros(num_vertices, feature_dim)
        if train_features:
            self.features = nn.Parameter(features)
        else:
            self.register_buffer("features", features)
        self.embeddings = nn.Parameter(torch.zeros(feature_dim, embed_dim))

    def forward(self) -> torch.Tensor:
        return normalize_embeddings(self.features @ self.embeddings)


#: a mesh's embedder: (mesh_name, type, num_vertices, feature_dim,
#: embed_dim, features_trainable, is_trainable); type "vertex_direct" or
#: "vertex_feature"
EmbedderSpec = Tuple[str, str, int, int, int, bool, bool]


def _spec_get(s, key, default):
    return s.get(key, default) if hasattr(s, "get") else getattr(s, key, default)


def embedder_specs_from_cfg(cfg) -> Tuple[EmbedderSpec, ...]:
    """``MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS`` as specs, in sorted mesh
    name order: d2's dict layout (``TYPE``, ``NUM_VERTICES``,
    ``FEATURE_DIM``, ``FEATURES_TRAINABLE``, ``IS_TRAINABLE``,
    ``INIT_FILE``), or the list of ``[name, num_vertices]`` pairs (a
    trainable direct embedder each). Empty: no embedder (the CSE base
    config)."""
    h = cfg.MODEL.ROI_DENSEPOSE_HEAD
    embed_dim = int(h.CSE.EMBED_SIZE)
    raw = h.CSE.EMBEDDERS
    if not raw:
        return ()
    if isinstance(raw, (list, tuple)):
        return tuple((str(name), "vertex_direct", int(n), 0, embed_dim, False, True) for name, n in raw)
    return tuple(
        (
            str(name),
            str(_spec_get(raw[name], "TYPE", "vertex_direct")),
            int(_spec_get(raw[name], "NUM_VERTICES", 0)),
            int(_spec_get(raw[name], "FEATURE_DIM", 0)),
            embed_dim,
            bool(_spec_get(raw[name], "FEATURES_TRAINABLE", False)),
            bool(_spec_get(raw[name], "IS_TRAINABLE", True)),
        )
        for name in sorted(raw.keys())
    )


def embedder_init_files_from_cfg(cfg) -> Dict[str, str]:
    """mesh name -> ``INIT_FILE`` of the dict layout's specs that name one."""
    raw = cfg.MODEL.ROI_DENSEPOSE_HEAD.CSE.EMBEDDERS
    if isinstance(raw, (list, tuple)):
        return {}
    files = {str(name): str(_spec_get(raw[name], "INIT_FILE", "")) for name in raw.keys()}
    return {name: f for name, f in files.items() if f}


class Embedder(nn.Module):
    """One embedder a mesh, a child named by the mesh (d2's
    ``roi_heads.embedder.<mesh>``); ``embedder(name)`` -> the ``[K, D]``
    vertex embeddings. An embedder with ``is_trainable`` False has no
    gradient (``requires_grad`` off, d2's ``requires_grad_(False)``)."""

    def __init__(self, specs: Sequence[EmbedderSpec]):
        super().__init__()
        self.specs = tuple(specs)
        self.mesh_names = tuple(s[0] for s in self.specs)
        for name, etype, n, f, d, feats_train, trainable in self.specs:
            if etype == "vertex_feature":
                module = VertexFeatureEmbedder(n, f, d, feats_train)
            elif etype == "vertex_direct":
                module = VertexDirectEmbedder(n, d)
            else:
                raise ValueError(f"Unexpected embedder type {etype!r} for mesh {name!r}")
            module.requires_grad_(trainable)
            self.add_module(name, module)

    def has_embeddings(self, mesh_name: str) -> bool:
        return mesh_name in self.mesh_names

    def forward(self, mesh_name: str) -> torch.Tensor:
        return getattr(self, mesh_name)()


def load_embedder_features(embedder: Embedder, init_files: Dict[str, str]) -> Tuple[str, ...]:
    """Fill the feature embedders' ``features`` from their ``INIT_FILE``
    pickles (``{"features": [K, F]}`` or the array; d2's
    ``VertexFeatureEmbedder.load``). A file that is not local (a URL) is
    skipped with a log line, as the JAX package skips it. Returns the meshes
    filled."""
    done = []
    for name, etype, n, f, _, _, _ in embedder.specs:
        fpath = init_files.get(name, "")
        if etype != "vertex_feature" or not fpath:
            continue
        if not os.path.isfile(fpath):
            logger.info("Embedder %s: INIT_FILE %s not a local file, skipping", name, fpath)
            continue
        with open(fpath, "rb") as fh:
            data = pickle.load(fh, encoding="latin1")
        feats = np.asarray(data["features"] if isinstance(data, dict) else data, np.float32)
        assert feats.shape == (n, f), (name, feats.shape, (n, f))
        with torch.no_grad():
            getattr(embedder, name).features.copy_(torch.from_numpy(feats))
        done.append(name)
    return tuple(done)


def _masked_mean(per_point: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = valid.float()
    return (per_point * w).sum() / w.sum().clamp_min(1.0)


def _vertex_log_probs(pixel_embeddings, mesh_vertex_embeddings, sigma) -> torch.Tensor:
    emb = normalize_embeddings(pixel_embeddings)
    return F.log_softmax(squared_euclidean_distance_matrix(emb, mesh_vertex_embeddings) / (-sigma), dim=-1)


def cse_embedding_loss(
    pixel_embeddings: torch.Tensor,
    gt_vertex_ids: torch.Tensor,
    valid: torch.Tensor,
    mesh_vertex_embeddings: torch.Tensor,
    embdist_gauss_sigma: float = 0.01,
) -> torch.Tensor:
    """``[P, D]`` pixel embeddings at the annotated points, their ``[P]``
    vertex ids and validity, the mesh's ``[K, D]``: the masked mean of the
    cross entropy of the normalised pixel embeddings' scores
    ``-||e - e_k||^2 / sigma`` (d2's ``EmbeddingLoss``)."""
    logp = _vertex_log_probs(pixel_embeddings, mesh_vertex_embeddings, embdist_gauss_sigma)
    ids = gt_vertex_ids.long().clamp(0, logp.shape[-1] - 1)
    return _masked_mean(-torch.gather(logp, -1, ids[:, None])[:, 0], valid)


def cse_soft_embedding_loss(
    pixel_embeddings: torch.Tensor,
    gt_vertex_ids: torch.Tensor,
    valid: torch.Tensor,
    mesh_vertex_embeddings: torch.Tensor,
    geodists: torch.Tensor,
    embdist_gauss_sigma: float = 0.01,
    geodist_gauss_sigma: float = 0.01,
) -> torch.Tensor:
    """:func:`cse_embedding_loss` against soft targets, the softmax of
    ``-geodesic / geodist_sigma`` from each point's vertex (``geodists``
    ``[K, K]``; d2's ``SoftEmbeddingLoss``)."""
    logp = _vertex_log_probs(pixel_embeddings, mesh_vertex_embeddings, embdist_gauss_sigma)
    ids = gt_vertex_ids.long().clamp(0, logp.shape[-1] - 1)
    target = F.softmax(geodists[ids] / (-geodist_gauss_sigma), dim=-1)
    return _masked_mean(-(target * logp).sum(-1), valid)


def closest_vertices_from_embedding(
    pixel_embeddings: torch.Tensor, mesh_vertex_embeddings: torch.Tensor, chunk: int = 8192
) -> torch.Tensor:
    """argmin_k ||normalise(e) - e_k||^2 for every pixel ``[..., D]`` ->
    int64 ``[...]``, ``chunk`` pixels at a time."""
    shape = pixel_embeddings.shape[:-1]
    flat = normalize_embeddings(pixel_embeddings.reshape(-1, pixel_embeddings.shape[-1]))
    out = [
        squared_euclidean_distance_matrix(flat[i : i + chunk], mesh_vertex_embeddings).argmin(dim=-1)
        for i in range(0, flat.shape[0], chunk)
    ]
    return (torch.cat(out) if out else flat.new_zeros(0, dtype=torch.long)).reshape(shape)


def _matrix_norm(x: torch.Tensor, p: int) -> torch.Tensor:
    """The entrywise p-norm of the last two axes (p 2: Frobenius, kept off
    zero as the JAX package keeps it)."""
    if p == 2:
        return (x * x).sum((-2, -1)).clamp_min(1e-12).sqrt()
    return (x.abs() ** p).sum((-2, -1)) ** (1.0 / p)


def sample_fg_pixels(fg_mask: torch.Tensor, num: int, generator: Optional[torch.Generator] = None):
    """``num`` foreground pixels of each ``[..., S, S]`` mask, uniform and
    without replacement: the top ``num`` of Gumbel noise on the foreground
    (-inf elsewhere), as the JAX package draws them (d2 takes ``randperm``
    of the foreground). Returns flat indices ``[..., num]`` and their
    validity (False where the mask has fewer than ``num`` pixels)."""
    flat = fg_mask.flatten(-2).float()
    u = torch.rand(flat.shape, generator=generator, device=flat.device).clamp_min(torch.finfo(torch.float32).tiny)
    g = torch.where(flat > 0, torch.zeros_like(flat), torch.full_like(flat, -float("inf"))) - torch.log(-torch.log(u))
    idx = g.topk(num, dim=-1).indices
    return idx, torch.gather(flat, -1, idx) > 0


def pix_to_shape_cycle_loss(
    pixel_embeddings: torch.Tensor,
    fg_mask: torch.Tensor,
    mesh_vertex_embeddings: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_pixels: int = 100,
    temperature_pix_to_vertex: float = 0.05,
    temperature_vertex_to_pix: float = 0.05,
    norm_p: int = 2,
) -> torch.Tensor:
    """Pixel -> vertex -> pixel cycle consistency of each instance
    ``[R, S, S, D]`` with its ``[R, S, S]`` foreground against one mesh's
    ``[K, D]`` (d2's ``PixToShapeCycleLoss``): ``num_pixels`` foreground
    pixels sampled, the soft correspondences C = softmax(sim / t1) @
    softmax(sim^T / t2), the loss ||pixel_dists * C||_p with the squared
    pixel-grid distances of the sample (zero on slots past a small mask's
    foreground). Returns ``[R]``. d2's ``PIXEL_SIGMA`` is read nowhere, in
    d2 too."""
    R, S = fg_mask.shape[0], fg_mask.shape[-1]
    idx, valid = sample_fg_pixels(fg_mask, num_pixels, generator)
    coords = torch.stack([torch.div(idx, S, rounding_mode="floor"), idx % S], -1).float()  # [R, M, 2]
    v = valid.float()
    pixel_dists = squared_euclidean_distance_matrix(coords, coords) * v[:, :, None] * v[:, None, :]
    D = pixel_embeddings.shape[-1]
    emb = torch.gather(pixel_embeddings.reshape(R, -1, D), 1, idx[..., None].expand(-1, -1, D))
    sim = normalize_embeddings(emb) @ mesh_vertex_embeddings.T  # [R, M, K]
    c_pix_vertex = F.softmax(sim / temperature_pix_to_vertex, dim=-1)
    c_vertex_pix = F.softmax(sim.transpose(1, 2) / temperature_vertex_to_pix, dim=-1)
    return _matrix_norm(pixel_dists * (c_pix_vertex @ c_vertex_pix), norm_p)


def shape_to_shape_cycle_loss(
    embeddings_1: torch.Tensor,
    geodists_1: torch.Tensor,
    embeddings_2: torch.Tensor,
    geodists_2: torch.Tensor,
    temperature: float = 0.05,
    norm_p: int = 2,
) -> torch.Tensor:
    """Mesh 1 -> 2 -> 1 and 2 -> 1 -> 2 cycle consistency of one pair
    (d2's ``ShapeToShapeCycleLoss``): ||G_1 * C_11||_p + ||G_2 * C_22||_p
    with C_12 = softmax(E_1 E_2^T / t) and C_21 its transpose's; the vertex
    subsample is the caller's (:func:`build_cycle_mesh_data`)."""
    sim_12 = embeddings_1 @ embeddings_2.T
    c_12 = F.softmax(sim_12 / temperature, dim=1)
    c_21 = F.softmax(sim_12.T / temperature, dim=1)
    return _matrix_norm(geodists_1 * (c_12 @ c_21), norm_p) + _matrix_norm(geodists_2 * (c_21 @ c_12), norm_p)


def build_cycle_mesh_data(
    specs: Sequence[EmbedderSpec], max_num_vertices: int, seed: int = 0, geodists: Optional[Dict[str, np.ndarray]] = None
):
    """Per mesh ``(name, vertex_idx or None, geodists [N, N] float32)`` for
    the shape-to-shape loss: meshes over ``max_num_vertices`` keep a sorted
    subsample drawn once, by ``RandomState(seed + i)`` as the JAX package
    draws it (d2 draws one every step). ``geodists`` maps a mesh to its
    ``[K, K]`` matrix; the others are read by ``meshes.load_mesh_geodists``."""
    out = []
    for li, (name, _, n, _, _, _, _) in enumerate(specs):
        if geodists is not None and name in geodists:
            geo = np.asarray(geodists[name], np.float32)
        else:
            from detectron2_tpu_torch.projects.densepose.meshes import load_mesh_geodists

            geo = load_mesh_geodists(name)
        idx = None
        if 0 < max_num_vertices < n:
            idx = np.sort(np.random.RandomState(seed + li).choice(n, max_num_vertices, replace=False))
            geo = geo[np.ix_(idx, idx)]
        out.append((name, idx, np.ascontiguousarray(geo, np.float32)))
    return tuple(out)
