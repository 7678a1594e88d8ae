"""Build and bind the port's CUDA kernels (``matchmaker_tpu_torch/csrc``).

At first use the ``.cu`` sources are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, under ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags (a
changed source builds anew; an unchanged one loads the cached library). The
library is loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, and every entry point returns ``cudaGetLastError()``, which
:func:`call` turns into an exception.

``LAUNCHES`` counts, per ported TPU kernel, the calls of its wrapper that
launched the CUDA kernels (a wrapper given CPU tensors runs its plain version
and counts nothing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# one counter per ported TPU kernel (see PERF.md for the table)
LAUNCHES = {
    "fused_attention_block": 0,  # K1
    "fused_mlp_block": 0,  # K2
    "binmax_candidates": 0,  # K3, with K5's transpose folded into its store
    "level2_reduce": 0,  # K4
    "unpack_candidates": 0,  # K6
}

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "mm_gemm": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
    "mm_attention_core": [_p, _p, _p, _i, _i, _i, _f, _p],
    "mm_layernorm": [_p, _p, _p, _p, _i, _i, _f, _p],
    "mm_binmax_scan": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i64, _p],
    "mm_level2": [_p, _p, _i, _i, _i, _i64, _i64, _p],
    "mm_unpack": [_p, _p, _p, _p, _i64, _i, _i, _i, _p],
}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmm_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mm_error_string.argtypes = [ctypes.c_int]
            lib.mm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def call(name: str, *args) -> None:
    """Run one C entry point; raise on a launch or configuration error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.mm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """What every kernel takes: a contiguous tensor of ``dtype`` on the card,
    its first element 16-byte aligned (the kernels move 16-byte chunks)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
