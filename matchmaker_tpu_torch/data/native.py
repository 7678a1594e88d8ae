"""ctypes bindings for the native host text pipeline (``native/fast_text.cpp``):
counterpart of ``matchmaker_tpu/data/native.py``.

Accelerated variants of the Python tokenizers: vocabulary tokenization runs
in C++ with no per-token Python objects, and a streaming triple reader fills
whole batches a call.

At first use the source is compiled with the Makefile's flags (``g++ -O3
-march=native -fPIC -std=c++17 -Wall -shared``) into
``build/native/libmmfast_<digest>.so`` at the root of the checkout, the
digest taken over the flags, the source and the host's CPU model (as
``retrieval/hnsw.py`` builds its graph library), so a changed source, or a
checkout copied to another CPU, builds anew; the prebuilt
``native/libmmfast.so`` is never loaded. If the build fails,
:func:`load_library`, :class:`NativeVocabTokenizer` and
:class:`NativeTripleReader` raise with the compiler's output, and
:func:`native_available` says False.

    python -m matchmaker_tpu_torch.data.native --build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fast_text.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code built on one CPU
    may not run on another."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    digest.update(_cpu_model().encode())
    return BUILD_DIR / f"libmmfast_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/fast_text.cpp`` unless the library for its digest
    exists (written under a temporary name, then renamed: concurrent
    builders never load a half-written file). Raises RuntimeError with the
    compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native text library could not be built ({' '.join(cmd)}): {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native text library could not be built ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_native(force: bool = False) -> bool:
    """Build the library (anew with ``force``); True on success."""
    if force:
        library_path().unlink(missing_ok=True)
    try:
        build()
    except RuntimeError:
        return False
    return True


def load_library() -> ctypes.CDLL:
    """The built library, loaded once, its entry points typed; raises
    RuntimeError when it cannot be built."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.mm_vocab_load.restype = ctypes.c_void_p
            lib.mm_vocab_load.argtypes = [ctypes.c_char_p]
            lib.mm_vocab_size.restype = ctypes.c_int32
            lib.mm_vocab_size.argtypes = [ctypes.c_void_p]
            lib.mm_vocab_free.argtypes = [ctypes.c_void_p]
            lib.mm_tokenize_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ]
            lib.mm_hash_tokenize_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ]
            lib.mm_triples_open.restype = ctypes.c_void_p
            lib.mm_triples_open.argtypes = [ctypes.c_char_p]
            lib.mm_triples_next_batch.restype = ctypes.c_int32
            lib.mm_triples_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int32,
            ]
            lib.mm_triples_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        load_library()
    except RuntimeError:
        return False
    return True


class NativeVocabTokenizer:
    """C++-backed batch tokenizer with the VocabTokenizer contract."""

    def __init__(self, vocab_path: str, mask_oov: bool = False):
        lib = load_library()
        self._lib = lib
        self._handle = lib.mm_vocab_load(vocab_path.encode())
        if not self._handle:
            raise FileNotFoundError(vocab_path)
        self.mask_oov = mask_oov

    @property
    def vocab_size(self) -> int:
        return self._lib.mm_vocab_size(self._handle)

    @property
    def pad_id(self) -> int:
        return 0

    def encode_batch(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        joined = "\n".join(t.replace("\n", " ") for t in texts).encode("utf-8")
        ids = np.zeros((n, max_length), dtype=np.int32)
        mask = np.zeros((n, max_length), dtype=np.float32)
        self._lib.mm_tokenize_batch(
            self._handle, joined, n, max_length, int(self.mask_oov),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return ids, mask

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids, mask = self.encode_batch([text], max_length)
        return ids[0], mask[0]

    def encode_pair(self, query: str, doc: str, max_q: int, max_d: int):
        raise NotImplementedError("embedding-based models use independent inputs")

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.mm_vocab_free(self._handle)


class NativeTripleReader:
    """Streaming batch reader over a 3-col triple file."""

    _BUF_CAP = 1 << 22  # 4 MB per column per batch

    def __init__(self, path: str):
        lib = load_library()
        self._lib = lib
        self._handle = lib.mm_triples_open(path.encode())
        if not self._handle:
            raise FileNotFoundError(path)

    def next_batch(self, batch_size: int):
        q = ctypes.create_string_buffer(self._BUF_CAP)
        p = ctypes.create_string_buffer(self._BUF_CAP)
        n = ctypes.create_string_buffer(self._BUF_CAP)
        rows = self._lib.mm_triples_next_batch(self._handle, batch_size, q, p, n, self._BUF_CAP)
        if rows == 0:
            return None
        split = lambda buf: buf.value.decode("utf-8").split("\n")[:rows]
        return split(q), split(p), split(n)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mm_triples_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--build":
        ok = build_native(force=True)
        print("built" if ok else "build FAILED")
        sys.exit(0 if ok else 1)
