"""The CSE mesh catalog (counterpart of
``detectron2_tpu/projects/densepose/meshes.py``; d2's ``data/meshes/
{catalog,builtin}.py`` and ``structures/mesh.py``): the 13 DensePose meshes
(SMPL and 12 animals) with their data, geodesics, symmetry and texture
coordinate files, and ``create_mesh``, which loads a mesh's pickles as numpy
arrays on the host. The files are downloads in d2; a file named by URL is
read from ``$DETECTRON2_DATASETS/densepose_meshes/<basename>``
(``testing.write_synthetic_cse_meshes`` writes files of their layout).
``load_mesh_geodists`` reads a mesh's geodesics alone (the losses), and
``load_mesh_symmetry`` its symmetry table alone (the mapper's flips, once a
process).
"""

import logging
import os
import pickle
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = [
    "MeshInfo",
    "MeshCatalog",
    "register_mesh",
    "register_meshes",
    "Mesh",
    "create_mesh",
    "DENSEPOSE_MESHES_DIR",
    "load_mesh_geodists",
    "load_mesh_symmetry",
    "mesh_file_path",
]

logger = logging.getLogger(__name__)


def _maybe_prepend_base_path(base_path: Optional[str], path: str) -> str:
    if base_path is None or ("://" in path) or os.path.isabs(path):
        return path
    return os.path.join(base_path, path)


@dataclass
class MeshInfo:
    """(reference meshes/catalog.py:13-19)."""

    name: str
    data: str
    geodists: Optional[str] = None
    symmetry: Optional[str] = None
    texcoords: Optional[str] = None


class _MeshCatalog(dict):
    """name -> MeshInfo with stable integer mesh ids
    (reference meshes/catalog.py:22-49)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh_ids: Dict[str, int] = {}
        self.mesh_names: Dict[int, str] = {}
        self.max_mesh_id = -1

    def __setitem__(self, key, value):
        if key in self:
            logger.warning(
                f"Overwriting mesh catalog entry '{key}': old value {self[key]}, new value {value}"
            )
            mesh_id = self.mesh_ids[key]
        else:
            self.max_mesh_id += 1
            mesh_id = self.max_mesh_id
        super().__setitem__(key, value)
        self.mesh_ids[key] = mesh_id
        self.mesh_names[mesh_id] = key

    def get_mesh_id(self, shape_name: str) -> int:
        return self.mesh_ids[shape_name]

    def get_mesh_name(self, mesh_id: int) -> str:
        return self.mesh_names[mesh_id]


MeshCatalog = _MeshCatalog()


def register_mesh(mesh_info: MeshInfo, base_path: Optional[str]) -> None:
    """(reference meshes/catalog.py:54-69)."""
    geodists, symmetry, texcoords = mesh_info.geodists, mesh_info.symmetry, mesh_info.texcoords
    if geodists:
        geodists = _maybe_prepend_base_path(base_path, geodists)
    if symmetry:
        symmetry = _maybe_prepend_base_path(base_path, symmetry)
    if texcoords:
        texcoords = _maybe_prepend_base_path(base_path, texcoords)
    MeshCatalog[mesh_info.name] = MeshInfo(
        name=mesh_info.name,
        data=_maybe_prepend_base_path(base_path, mesh_info.data),
        geodists=geodists,
        symmetry=symmetry,
        texcoords=texcoords,
    )


def register_meshes(mesh_infos: Iterable[MeshInfo], base_path: Optional[str]) -> None:
    """(reference meshes/catalog.py:72-74)."""
    for mesh_info in mesh_infos:
        register_mesh(mesh_info, base_path)


@dataclass
class Mesh:
    """Loaded mesh arrays (reference structures/mesh.py:23-133, as numpy)."""

    name: str
    vertices: Optional[np.ndarray] = None  # [V, 3] float32
    faces: Optional[np.ndarray] = None  # [F, 3] int
    geodists: Optional[np.ndarray] = None  # [V, V] float32
    symmetry: Optional[Dict[str, np.ndarray]] = None
    texcoords: Optional[np.ndarray] = None

    def get_geodists(self) -> np.ndarray:
        assert self.geodists is not None, f"mesh {self.name} registered without geodists"
        return self.geodists


def _load_pickle(fpath: str):
    with open(fpath, "rb") as f:
        return pickle.load(f)


def mesh_file_path(path: Optional[str], base_dir: Optional[str] = None) -> Optional[str]:
    """A catalog path as a local file: a URL is looked up by its basename
    under ``base_dir`` (default ``$DETECTRON2_DATASETS/densepose_meshes``)."""
    if path is None or "://" not in path:
        return path
    root = base_dir or os.path.join(os.environ.get("DETECTRON2_DATASETS", "datasets"), "densepose_meshes")
    local = os.path.join(root, os.path.basename(path))
    if not os.path.exists(local):
        raise FileNotFoundError(f"mesh file {path} not staged locally at {local}; download it there")
    return local


def create_mesh(mesh_name: str, base_dir: Optional[str] = None) -> Mesh:
    """A registered mesh's arrays (d2's ``create_mesh``), loaded on the host
    from the catalog's files (see :func:`mesh_file_path`)."""
    info = MeshCatalog[mesh_name]
    data = _load_pickle(mesh_file_path(info.data, base_dir))
    mesh = Mesh(
        name=mesh_name,
        vertices=np.asarray(data["vertices"], np.float32) if "vertices" in data else None,
        faces=np.asarray(data["faces"]) if "faces" in data else None,
    )
    if info.geodists:
        geo = _load_pickle(mesh_file_path(info.geodists, base_dir))
        mesh.geodists = np.asarray(geo["geodists"] if isinstance(geo, dict) else geo, np.float32)
    if info.symmetry:
        sym = _load_pickle(mesh_file_path(info.symmetry, base_dir))
        mesh.symmetry = {k: np.asarray(v) for k, v in sym.items()}
    if info.texcoords:
        tex = _load_pickle(mesh_file_path(info.texcoords, base_dir))
        mesh.texcoords = np.asarray(tex["texcoords"] if isinstance(tex, dict) else tex)
    return mesh


def load_mesh_geodists(mesh_name: str) -> np.ndarray:
    """The ``[V, V]`` float32 geodesic distances of a registered mesh, read
    from its geodists file alone (the losses need no other array)."""
    info = MeshCatalog[mesh_name]
    assert info.geodists, f"mesh {mesh_name} registered without geodists"
    geo = _load_pickle(mesh_file_path(info.geodists))
    return np.asarray(geo["geodists"] if isinstance(geo, dict) else geo, np.float32)


_SYMMETRY_CACHE: Dict[str, Dict[str, np.ndarray]] = {}


def load_mesh_symmetry(mesh_name: str) -> Optional[Dict[str, np.ndarray]]:
    """The symmetry table of a registered mesh (``{"vertex_transforms":
    [V]}``), read once a process and file; None when the mesh is not
    registered or its file is not staged."""
    info = MeshCatalog.get(mesh_name)
    if info is None or not info.symmetry:
        return None
    try:
        path = mesh_file_path(info.symmetry)
    except FileNotFoundError:
        return None
    if path not in _SYMMETRY_CACHE:
        _SYMMETRY_CACHE[path] = {k: np.asarray(v) for k, v in _load_pickle(path).items()}
    return _SYMMETRY_CACHE[path]


DENSEPOSE_MESHES_DIR = "https://dl.fbaipublicfiles.com/densepose/meshes/"

# (reference meshes/builtin.py:9-103)
MESHES = [
    MeshInfo(
        name=name,
        data=f"{stem}.pkl",
        geodists=f"geodists/geodists_{stem}.pkl",
        symmetry=f"symmetry/symmetry_{stem}.pkl",
        texcoords=f"texcoords/texcoords_{tex_stem}.pkl",
    )
    for name, stem, tex_stem in [
        ("smpl_27554", "smpl_27554", "smpl_27554"),
        ("chimp_5029", "chimp_5029", "chimp_5029"),
        ("cat_5001", "cat_5001", "cat_5001"),
        ("cat_7466", "cat_7466", "cat_7466"),
        ("sheep_5004", "sheep_5004", "sheep_5004"),
        ("zebra_5002", "zebra_5002", "zebra_5002"),
        # the reference maps horse texcoords to the zebra file
        # (meshes/builtin.py:60-66)
        ("horse_5004", "horse_5004", "zebra_5002"),
        ("giraffe_5002", "giraffe_5002", "giraffe_5002"),
        ("elephant_5002", "elephant_5002", "elephant_5002"),
        ("dog_5002", "dog_5002", "dog_5002"),
        ("dog_7466", "dog_7466", "dog_7466"),
        ("cow_5002", "cow_5002", "cow_5002"),
        ("bear_4936", "bear_4936", "bear_4936"),
    ]
]

register_meshes(MESHES, DENSEPOSE_MESHES_DIR)
