"""A spool for the DensePose evaluator's per-detection IUV stacks
(counterpart of ``detectron2_tpu/projects/densepose/tensor_storage.py``; d2's
``evaluation/tensor_storage.py`` has the same role), in one process.

The evaluator's ``process`` writes each box-sized ``[3, h, w]`` uint8 stack
to an append-only byte stream and keeps only a :class:`BlobRef`; the engine
reads each back through a :class:`LazyBlob` when it uses it, so the
evaluator holds one stack at a time, not the dataset's. The stacks differ
in shape, so each ref carries its offset, shape and dtype.

Backends, as ``DENSEPOSE_EVALUATION.STORAGE`` names them: "none" (no
spool), "ram" (an ``io.BytesIO``) and "file"
(``<OUTPUT_DIR>/densepose_eval/densepose_eval_spool.bin``). The port
evaluates in one process (ROADMAP A6): the one writer is the one reader, so
a ref holds no rank and nothing is gathered.
"""

import io
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

__all__ = ["BlobRef", "BlobSpool", "LazyBlob", "build_densepose_evaluator_storage"]


@dataclass(frozen=True)
class BlobRef:
    """Where one stored array lies and how to decode it."""

    offset: int
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.dtype(self.dtype).itemsize * int(np.prod(self.shape, dtype=np.int64)))


class BlobSpool:
    """An append-only array store: ``put`` while the evaluator processes,
    ``finalize_for_read`` once, then ``get``."""

    def __init__(self, kind: str, directory: Optional[str] = None):
        assert kind in ("ram", "file"), kind
        self.kind = kind
        if kind == "ram":
            self._buf: Any = io.BytesIO()
        else:
            assert directory, "a file spool needs a directory"
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(directory, "densepose_eval_spool.bin")
            self._buf = open(self._path, "wb")
        self._finalized = False

    def put(self, arr: np.ndarray) -> BlobRef:
        assert not self._finalized, "spool already finalized for reading"
        arr = np.ascontiguousarray(arr)
        offset = self._buf.tell()
        self._buf.write(arr.tobytes())
        return BlobRef(offset, tuple(arr.shape), str(arr.dtype))

    def finalize_for_read(self) -> None:
        """Switch to reading: the file is flushed, closed and opened for
        reading; the ram buffer is read in place."""
        if self._finalized:
            return
        self._finalized = True
        if self.kind == "file":
            self._buf.flush()
            os.fsync(self._buf.fileno())
            self._buf.close()
            self._buf = open(self._path, "rb")

    def get(self, ref: BlobRef) -> np.ndarray:
        assert self._finalized, "call finalize_for_read() first"
        self._buf.seek(ref.offset)
        data = self._buf.read(ref.nbytes)
        assert len(data) == ref.nbytes, (len(data), ref)
        return np.frombuffer(data, ref.dtype).reshape(ref.shape)

    def close(self) -> None:
        self._buf.close()


class LazyBlob:
    """An array handle over a spooled stack: ``np.asarray`` reads it from
    the spool when the engine uses it."""

    __slots__ = ("_spool", "_ref")

    def __init__(self, spool: BlobSpool, ref: BlobRef):
        self._spool = spool
        self._ref = ref

    def __array__(self, dtype=None, copy=None):
        arr = self._spool.get(self._ref)
        return arr if dtype is None else arr.astype(dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._ref.shape

    def __getitem__(self, idx):
        return self._spool.get(self._ref)[idx]


def build_densepose_evaluator_storage(storage_spec: str, output_dir: Optional[str] = None):
    """``DENSEPOSE_EVALUATION.STORAGE`` -> a spool, None for "none"; the
    file backend spools to ``<output_dir>/densepose_eval/
    densepose_eval_spool.bin``."""
    if storage_spec in (None, "", "none"):
        return None
    if storage_spec == "ram":
        return BlobSpool("ram")
    if storage_spec == "file":
        assert output_dir, "STORAGE 'file' needs cfg.OUTPUT_DIR"
        return BlobSpool("file", os.path.join(output_dir, "densepose_eval"))
    raise ValueError(f"unknown DENSEPOSE_EVALUATION.STORAGE: {storage_spec!r}")
