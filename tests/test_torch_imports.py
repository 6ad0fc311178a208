"""Import guard of the PyTorch/CUDA port: no module of ``detectron2_tpu_torch``,
not ``chip_smoke.py`` and not the card's own tests
(``test_torch_roi_align_cuda.py``, ``test_torch_attention_cuda.py``,
``test_torch_trainer_cuda.py``, ``test_torch_rcnn_heads_cuda.py``,
``test_torch_batch_norm_cuda.py``, ``test_torch_densepose_cuda.py`` and
``test_torch_point_rend_cuda.py``, run where jax is not installed) import
jax, flax, optax or the JAX package (the DensePose evaluator's, CSE, HRNet /
HRFPN and bootstrap modules among them, named in ``DENSEPOSE_MODULES``, and
PointRend's and PointSup's, named in ``POINT_MODULES``, DeepLab's and
Panoptic-DeepLab's, named in ``DEEPLAB_MODULES``, and TridentNet's and
TensorMask's, named in ``TRIDENT_TENSORMASK_MODULES``);
importing the package and its kernel wrapper builds nothing and touches no
GPU. The card's machine has no OpenCV, no PIL and no PyAV: no module of the
port imports ``cv2``, ``PIL`` only inside
``data/detection_utils.py::read_image``, which reads PNGs without it, and
``av`` only inside ``projects/densepose/video.py::_open_av``, whose callers
return no frames without it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "detectron2_tpu")
# the DensePose modules that keep their own copies of the JAX package's
# numpy code (the evaluator's protocol, the spool, the mesh catalog)
DENSEPOSE_MODULES = ("dp_coco_eval", "tensor_storage", "evaluation", "meshes", "cse", "datasets", "trainer",
                     "hrnet", "hrfpn", "converters", "bootstrap", "video", "build")
# DeepLab and Panoptic-DeepLab, with the layers, dataset and augmentation they brought
DEEPLAB_MODULES = ("layers/aspp", "layers/blocks", "projects/deeplab/config", "projects/deeplab/resnet",
                   "projects/deeplab/loss", "projects/deeplab/semantic_seg", "projects/panoptic_deeplab/config",
                   "projects/panoptic_deeplab/panoptic_seg", "projects/panoptic_deeplab/post_processing",
                   "projects/panoptic_deeplab/target_generator", "data/datasets/cityscapes_panoptic",
                   "data/transforms/augmentation_impl", "solver/lr_scheduler")
# TridentNet and TensorMask
TRIDENT_TENSORMASK_MODULES = ("tridentnet/config", "tridentnet/trident_conv", "tridentnet/trident_backbone",
                              "tridentnet/trident_rpn", "tensormask/config", "tensormask/layers", "tensormask/arch")
POINT_MODULES = ("point_rend/config", "point_rend/point_features", "point_rend/point_head", "point_rend/coarse_mask_head",
                 "point_rend/roi_heads", "point_rend/semantic_seg", "point_sup/config", "point_sup/roi_heads")


def _sources():
    files = sorted((ROOT / "detectron2_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "tests" / "test_torch_roi_align_cuda.py",
        ROOT / "tests" / "test_torch_attention_cuda.py",
        ROOT / "tests" / "test_torch_trainer_cuda.py",
        ROOT / "tests" / "test_torch_rcnn_heads_cuda.py",
        ROOT / "tests" / "test_torch_batch_norm_cuda.py",
        ROOT / "tests" / "test_torch_densepose_cuda.py",
        ROOT / "tests" / "test_torch_point_rend_cuda.py",
    ]
    assert len(files) > 30
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_names_are_detected():
    assert _forbidden("jax.numpy") and _forbidden("flax") and _forbidden("detectron2_tpu.ops") and _forbidden("optax")
    assert not _forbidden("detectron2_tpu_torch.ops") and not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("module", DENSEPOSE_MODULES)
def test_densepose_modules_are_guarded(module):
    path = ROOT / "detectron2_tpu_torch" / "projects" / "densepose" / f"{module}.py"
    assert path in _sources() and (ROOT / "chip_smoke.py") in _sources()


@pytest.mark.parametrize("module", POINT_MODULES)
def test_point_rend_and_point_sup_modules_are_guarded(module):
    assert ROOT / "detectron2_tpu_torch" / "projects" / f"{module}.py" in _sources()


@pytest.mark.parametrize("module", TRIDENT_TENSORMASK_MODULES)
def test_tridentnet_and_tensormask_modules_are_guarded(module):
    assert ROOT / "detectron2_tpu_torch" / "projects" / f"{module}.py" in _sources()


@pytest.mark.parametrize("module", DEEPLAB_MODULES)
def test_deeplab_modules_are_guarded(module):
    assert ROOT / "detectron2_tpu_torch" / f"{module}.py" in _sources()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_touches_neither_nvcc_nor_cuda():
    """In a fresh interpreter with no nvcc on PATH: importing every module
    builds no kernel, loads no library and initialises no CUDA context."""
    code = (
        "import pkgutil, importlib, torch, detectron2_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'detectron2_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "from detectron2_tpu_torch.ops import _build, attention, roi_align\n"
        "assert not _build._loaded and roi_align._fn is None and roi_align._bwd_fn is None, 'a kernel library was loaded'\n"
        "assert not attention._fns, 'a kernel library was loaded'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA was initialised'\n"
        "import sys; assert not any(m == 'jax' or m.startswith(('jax.', 'flax')) for m in sys.modules)\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(ROOT), CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20


def _imports_with_scope(tree):
    """(module, enclosing function name or None) of every import."""
    out = []

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            if isinstance(child, ast.Import):
                out.extend((alias.name, scope) for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                out.append((child.module, scope))
            visit(child, inner)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_cv2_and_pil_only_in_read_image(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    imports = _imports_with_scope(tree)
    assert not [m for m, _ in imports if m == "cv2" or m.startswith("cv2.")]
    pil = [(m, scope) for m, scope in imports if m == "PIL" or m.startswith("PIL.")]
    av = [(m, scope) for m, scope in imports if m == "av" or m.startswith("av.")]
    rel = str(path.relative_to(ROOT))
    if rel == "detectron2_tpu_torch/data/detection_utils.py":
        assert pil and all(scope == "read_image" for _, scope in pil), pil
    else:
        assert not pil, pil
    if rel == "detectron2_tpu_torch/projects/densepose/video.py":
        assert av == [("av", "_open_av")], av
    else:
        assert not av, av


def test_import_pulls_in_neither_cv2_nor_pil():
    code = (
        "import pkgutil, importlib, sys, detectron2_tpu_torch as p\n"
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(p.__path__, 'detectron2_tpu_torch.')]\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'av')], 'cv2, PIL or av was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
