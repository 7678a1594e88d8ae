"""Build and bind the port's CUDA kernels (``matchmaker_tpu_torch/csrc``).

At first use each ``.cu`` source is compiled with ``nvcc`` for ``sm_90a`` to
an object, all sources at once in parallel processes, and the objects are
linked into one shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags (a changed source builds anew; an unchanged one loads the
cached library). The
library is loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, and every entry point returns ``cudaGetLastError()``, which
:func:`call` turns into an exception (the ``_bytes`` ones return the bytes
of workspace their launch needs, :func:`workspace_bytes`).

``LAUNCHES`` counts, per ported TPU kernel, the calls of its wrapper that
launched the CUDA kernels (a wrapper given CPU tensors runs its plain version
and counts nothing).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# one counter per ported TPU kernel (see PERF.md for the table)
LAUNCHES = {
    "fused_attention_block": 0,  # K1
    "fused_mlp_block": 0,  # K2
    "binmax_candidates": 0,  # K3, with K5's transpose folded into its store
    "level2_reduce": 0,  # K4
    "unpack_candidates": 0,  # K6
    "fused_mlp_block_bwd": 0,  # K11
    "fused_attention_block_bwd": 0,  # K12
    "fused_mlp_int8_block": 0,  # K9
    "fused_attention_int8_block": 0,  # K10
    "binmax_candidates_int8f": 0,  # K8: int8 corpus, bf16 queries
    "binmax_candidates_int8": 0,  # K7: int8 corpus, int8 queries
    "maxsim_all_pairs": 0,  # K14
    "maxsim_all_pairs_argmax": 0,  # K14's training form (all pairs + each row max's doc token)
    "maxsim_all_pairs_bwd": 0,  # the backward of K14's all-pairs form
    "fused_mha": 0,  # K13
    "attn_inner": 0,  # K15 (probes/attn_inner.py)
    "int8_matmul": 0,  # K16 (probes/int8_matmul.py)
    "mlp_rows2d": 0,  # K17 (probes/mlp_rows.py)
    "mlp_rowsblk": 0,  # K18 (probes/mlp_rows.py)
}

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "mm_attention_core": [_p, _p, _p, _i, _i, _i, _i, _f, _p],
    "mm_attention_core_f32": [_p, _p, _p, _i, _i, _i, _i, _f, _p],
    "mm_fused_mha": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _p],
    "mm_maxsim": [_p] * 7 + [_i] * 6 + [_f, _p],
    "mm_maxsim_train": [_p] * 7 + [_i] * 9 + [_f, _p],
    "mm_maxsim_bwd": [_p] * 10 + [_i] * 6 + [_p],
    "mm_quant_groups": [_p, _p, _p, _i, _i, _i, _i, _i, _p],
    "mm_wg_gemm_s8": [_p] * 7 + [_i] * 5 + [_p],
    "mm_wg_gemm_s8_gelu_quant": [_p] * 7 + [_i] * 4 + [_p],
    "mm_layernorm": [_p, _p, _p, _p, _i, _i, _f, _p],
    "mm_layernorm_ld": [_p, _p, _p, _p, _i, _i, _i, _i, _f, _p],
    "mm_binmax_scan": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i64, _p],
    "mm_binmax_scan_int8": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i64, _i, _p],
    "mm_level2": [_p, _p, _i, _i, _i, _i64, _i64, _p],
    "mm_unpack": [_p, _p, _p, _p, _i64, _i, _i, _i, _p],
    "mm_unpack_floor": [_i64, _p],
    "mm_wg_gemm": [_p, _p, _p, _p, _i, _i, _i, _i, _p],
    "mm_wg_gemm_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
    "mm_wg_gemm_dz": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "mm_wg_wgrad": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
    "mm_attention_bwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _f, _p],
    "mm_attention_block_bwd": [_p] * 14 + [_i, _i, _i, _i, _i, _i, _f, _f, _i, _i, _i, _i, _p],
    "mm_mlp_block_bwd": [_p] * 13 + [_i, _i, _i, _i, _f, _i, _i, _i, _i, _p],
    "mm_probe_attn_inner": [_p, _p, _p, _p, _p, _i, _i, _i, _f, _i, _p],
    "mm_probe_int8_matmul": [_p, _p, _p, _i, _i, _i, _p],
    "mm_probe_mlp_rows": [_p] * 8 + [_i, _i, _f, _p],
}
# entry points that return the bytes of workspace a launch above needs
_SIZE_SIGNATURES = {
    "mm_attention_block_bwd_bytes": [_i] * 7,
    "mm_mlp_block_bwd_bytes": [_i] * 5,
    "mm_maxsim_bwd_ws_bytes": [_i] * 2,
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


def _run_all(cmds) -> None:
    """Run the commands in parallel processes; raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = []
    compiles = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        compiles.append([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    try:
        _run_all(compiles)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for o in objects]])
        os.replace(tmp, out)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for signatures, restype in ((_SIGNATURES, ctypes.c_int), (_SIZE_SIGNATURES, ctypes.c_longlong)):
                for name, argtypes in signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            lib.mm_error_string.argtypes = [ctypes.c_int]
            lib.mm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as the int a ``c_void_p``
    argument takes: PyTorch's raw-stream query, without the
    ``torch.cuda.Stream`` object ``current_stream`` builds on every call."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if device.index is None else device.index)


def on(device: torch.device):
    """The device context a launch on ``device`` needs: none when it is the
    current device already (entering ``torch.cuda.device`` switches the
    device twice, which costs host time on every call)."""
    return contextlib.nullcontext() if device.index == torch.cuda.current_device() else torch.cuda.device(device)


def call(name: str, *args) -> None:
    """Run one C entry point; raise on a launch or configuration error."""
    lib = _lib if _lib is not None else library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.mm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def workspace_bytes(name: str, *args) -> int:
    """The bytes of workspace one of the ``_SIZE_SIGNATURES`` entry points
    reports for these sizes."""
    return int(getattr(library(), name)(*args))


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
