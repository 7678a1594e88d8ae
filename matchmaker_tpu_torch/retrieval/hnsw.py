"""HNSW graph index on the host: counterpart of
``matchmaker_tpu/retrieval/hnsw.py``, the port's own ctypes binding to the
repository's C++ graph (``native/hnsw.cpp``; inner product,
``faiss_hnsw_graph_neighbors`` M, ``hnsw_ef_construction``,
``hnsw_ef_search``).

At first use the source is compiled with the Makefile's flags (``g++ -O3
-march=native -fPIC -std=c++17 -fopenmp -shared``) into
``build/native/libmmhnsw_<digest>.so`` at the root of the checkout, the
digest taken over the flags, the source and the host's CPU model, so a
changed source, or a checkout copied to another CPU, builds anew; the
prebuilt ``native/libmmhnsw.so`` is never loaded. If the build
fails, :func:`load_hnsw_library` and :class:`HNSWIndex` raise (the JAX
factory builds an IVF index instead; the port does not). The graph files
are the JAX index's: ``hnsw_graph.bin`` and ``hnsw_ids.npy``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from matchmaker_tpu_torch.retrieval.indexes import BaseNNIndexer, gather_ids

SOURCE = Path(__file__).resolve().parents[2] / "native" / "hnsw.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code built on one CPU
    may not run on another, so a checkout copied to another machine builds
    anew."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_model().encode())
    return BUILD_DIR / f"libmmhnsw_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/hnsw.cpp`` unless the library for its digest exists
    (written under a temporary name, then renamed: concurrent builders never
    load a half-written file). Raises RuntimeError with the compiler's output
    when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native HNSW library could not be built ({' '.join(cmd)}): {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native HNSW library could not be built ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_hnsw_library() -> ctypes.CDLL:
    """The built library, loaded once, its entry points typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mm_hnsw_new.restype = ctypes.c_void_p
            lib.mm_hnsw_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
            lib.mm_hnsw_add_batch.restype = None
            lib.mm_hnsw_add_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.mm_hnsw_size.restype = ctypes.c_int
            lib.mm_hnsw_size.argtypes = [ctypes.c_void_p]
            lib.mm_hnsw_search_batch.restype = None
            lib.mm_hnsw_search_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)]
            lib.mm_hnsw_save.restype = ctypes.c_int
            lib.mm_hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.mm_hnsw_load.restype = ctypes.c_void_p
            lib.mm_hnsw_load.argtypes = [ctypes.c_char_p]
            lib.mm_hnsw_free.restype = None
            lib.mm_hnsw_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class HNSWIndex(BaseNNIndexer):
    """Native HNSW over the corpus vectors (f32, on the host); ids resolved
    on the host. ``device`` and ``mesh`` are accepted for the factory's
    signature: the graph has no device part."""

    def __init__(self, config=None, device="cuda", mesh=None):
        super().__init__(config, device)
        config = config or {}
        self.m = config.get("faiss_hnsw_graph_neighbors", 16)
        self.ef_construction = config.get("hnsw_ef_construction", 80)
        self.ef_search = config.get("hnsw_ef_search", 128)
        self.seed = config.get("random_seed", 42)
        self._lib = load_hnsw_library()
        self._handle = None
        self._ids: Optional[np.ndarray] = None

    def _free(self) -> None:
        if self._handle:
            self._lib.mm_hnsw_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self._free()

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._ids = np.asarray(ids)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self._free()
        self.dim = vectors.shape[1]
        self._handle = self._lib.mm_hnsw_new(self.dim, self.m, self.ef_construction, self.seed)
        self._lib.mm_hnsw_add_batch(self._handle, vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    vectors.shape[0])

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        scores = np.empty((nq, top_n), np.float32)
        idx = np.empty((nq, top_n), np.int64)
        self._lib.mm_hnsw_search_batch(self._handle, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq,
                                       top_n, max(self.ef_search, top_n),
                                       scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                       idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return gather_ids(self._ids, idx, len(self._ids), scores)

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        if self._lib.mm_hnsw_save(self._handle, os.path.join(folder, "hnsw_graph.bin").encode()) != 0:
            raise IOError(f"hnsw save failed in {folder}")
        np.save(os.path.join(folder, "hnsw_ids.npy"), self._ids)

    def load(self, folder: str) -> None:
        self._free()
        self._handle = self._lib.mm_hnsw_load(os.path.join(folder, "hnsw_graph.bin").encode())
        if not self._handle:
            raise IOError(f"hnsw load failed in {folder}")
        self._ids = np.load(os.path.join(folder, "hnsw_ids.npy"), allow_pickle=True)
        self.dim = None
