"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. The library goes
to ``build/kernels/`` at the root of the checkout, named by a hash of its
source and its flags (the common ones and the source's own), so an edited
source builds anew and an unchanged one is reused. Nothing here runs when a module is imported: the first kernel call
builds, or :func:`build_kernels` builds every source at once, one ``nvcc``
process per source, all started together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_SOURCES", "SOURCE_FLAGS", "build_kernels", "load_kernel", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
KERNEL_SOURCES = ("roi_align", "flash_attention")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# RoIAlign's tap selection needs its coordinate arithmetic rounded op by op;
# the attention kernels want their multiply-adds fused
SOURCE_FLAGS = {"roi_align": ("-fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _flags(name: str):
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()))


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, cmd


def build_kernels(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Build every named source in parallel; raise with nvcc's output on failure."""
    pending = [(n, _start_build(n)) for n in names]
    errors = []
    for name, job in pending:
        if job is None:
            continue
        proc, tmp, lib, cmd = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    if name not in _loaded:
        build_kernels([name])
        _loaded[name] = ctypes.CDLL(str(_library_path(name)))
    return _loaded[name]
