"""The int8 product probe: counterpart of ``benchmarks/int8_matmul_probe.py``
and of its TPU kernel K16 (``pk`` inside ``mm_int8_pallas``).

:func:`int8_matmul` computes xq (M, K) int8 · wq (K, N) int8 → (M, N)
int32, exactly. The weight codes are passed K-major, as ``wq_t`` = wqᵀ
(N, K), the way a serving path stores them once; CUDA tensors launch the
tensor-core kernel of ``csrc/probe_int8_matmul.cu`` (K % 32 == 0,
N % 8 == 0, any M), CPU tensors run :func:`reference_int8_matmul`.
:func:`int8_chain` is the int8 MLP product a serving path pays for:
per-row activation quantization, the product, dequantization.

    python -m matchmaker_tpu_torch.probes.int8_matmul [--iters 30] [--device cpu]

times a bf16 ``torch.matmul``, ``torch._int_mm`` (the library's int8
product, a yardstick the port never calls; with wq_t as the kernel takes
it, and with wq row-major), the kernel and the chain at
the probe's shape (16,384 × 768 × 3,072) and prints one JSON line: the
JAX probe's keys (``bf16_tflops``, ``int8_tops`` for ``torch._int_mm``,
``int8_chain_efftops``, ``int8_vs_bf16``, ``chain_vs_bf16``, the last two
of the kernel), ``kernel_int8_tops`` for the kernel (the JAX probe's
``pallas_int8_tops``), each row's ms and share of the H100's 1,979 TOP/s.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from matchmaker_tpu_torch.ops import _build, over_127
from matchmaker_tpu_torch.probes import PEAK, card, device_of, median_ms


def reference_int8_matmul(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """Plain version of K16: xq · wq_tᵀ as int32. An int64 product on the
    CPU; on the card (no integer matmul there) a float64 one, exact while
    K · 127² < 2⁵³."""
    if xq.is_cuda:
        return torch.matmul(xq.double(), wq_t.double().T).to(torch.int32)
    return torch.matmul(xq.long(), wq_t.long().T).to(torch.int32)


def _check(xq: torch.Tensor, wq_t: torch.Tensor) -> None:
    if xq.dim() != 2 or wq_t.dim() != 2 or xq.shape[1] != wq_t.shape[1]:
        raise ValueError(f"int8_matmul: xq (M, K) and wq_t (N, K) expected, got {tuple(xq.shape)} and "
                         f"{tuple(wq_t.shape)}")
    k, n = xq.shape[1], wq_t.shape[0]
    if k % 32 or n % 8 or not k or not n:
        raise ValueError(f"int8_matmul: the CUDA kernel takes K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")


def int8_matmul(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """(M, N) int32 = xq (M, K) int8 · wq_t (N, K) int8 transposed."""
    if not xq.is_cuda:
        return reference_int8_matmul(xq, wq_t)
    _check(xq, wq_t)
    for name, t in (("xq", xq), ("wq_t", wq_t)):
        _build.check_cuda(t, f"int8_matmul.{name}", torch.int8)
    m, k = xq.shape
    n = wq_t.shape[0]
    with torch.cuda.device(xq.device):
        out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
        _build.call("mm_probe_int8_matmul", _build.ptr(xq), _build.ptr(wq_t), _build.ptr(out), m, n, k,
                    _build.stream(xq.device))
    _build.LAUNCHES["int8_matmul"] += 1
    return out


def quantize_rows(x: torch.Tensor):
    """Per-row int8 codes of x and their f32 scales amax/127, as the JAX
    probe's chain: clip(round(x / s), −127, 127)."""
    s = over_127(x.abs().amax(dim=1, keepdim=True).float())
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8), s


def int8_chain(x: torch.Tensor, wq_t: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 → per-row codes → K16 → dequantized (M, N) f32."""
    xq, s = quantize_rows(x)
    return int8_matmul(xq, wq_t).float() * (s * wscale[None, :])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--k", type=int, default=768)
    ap.add_argument("--n", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    m, k, n = args.m, args.k, args.n
    ops = 2 * m * k * n
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(device, torch.bfloat16)
    xq = torch.from_numpy(rng.integers(-127, 127, size=(m, k), dtype=np.int8)).to(device)
    wq = torch.from_numpy(rng.integers(-127, 127, size=(k, n), dtype=np.int8)).to(device)
    wq_t = wq.T.contiguous()  # K-major weight codes, stored once
    wscale = torch.ones(n, device=device)

    exact = bool(torch.equal(int8_matmul(xq, wq_t), reference_int8_matmul(xq, wq_t)))
    t_bf16 = median_ms(lambda: torch.matmul(x, w), device, args.iters)
    t_kernel = median_ms(lambda: int8_matmul(xq, wq_t), device, args.iters)
    t_chain = median_ms(lambda: int8_chain(x, wq_t, wscale), device, args.iters)
    on_card = device.type == "cuda"
    # the library's int8 product with the kernel's own operands (B K-major),
    # and with B row-major (K, N) as the JAX probe stores it
    t_int_mm = median_ms(lambda: torch._int_mm(xq, wq_t.T), device, args.iters) if on_card else None
    t_int_mm_kn = median_ms(lambda: torch._int_mm(xq, wq), device, args.iters) if on_card else None

    def per_s(ms):  # operations per second in units of 1e12, a card's time only
        return ops / ms / 1e9 if on_card and ms else None

    result = {
        "bf16_tflops": per_s(t_bf16), "int8_tops": per_s(t_int_mm), "int8_chain_efftops": per_s(t_chain),
        "kernel_int8_tops": per_s(t_kernel), "int8_vs_bf16": t_bf16 / t_kernel, "chain_vs_bf16": t_bf16 / t_chain,
        "int_mm_vs_bf16": t_bf16 / t_int_mm if t_int_mm else None,
        "kernel_eff_vs_int8_peak": ops / t_kernel / 1e-3 / PEAK["int8"] if on_card else None,
        "ms": {"bf16_matmul": t_bf16, "int_mm": t_int_mm, "int_mm_row_major_b": t_int_mm_kn, "kernel": t_kernel,
               "chain": t_chain},
        "shape": [m, k, n], "exact": exact, "device": card(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
