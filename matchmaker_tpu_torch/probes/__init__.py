"""Hopper probes: the port's counterparts of the TPU measurement probes in
``benchmarks/`` (each module keeps its probe's name).

- :mod:`.attn_inner`: the attention inner loop alone (TPU kernel K15,
  ``benchmarks/attn_inner_probe.py``);
- :mod:`.int8_matmul`: an int8 x int8 -> int32 product at the MLP shape
  (K16, ``benchmarks/int8_matmul_probe.py``);
- :mod:`.mlp_rows`: the fused MLP half over row-packed tiles (K17 and K18,
  ``benchmarks/mlp_rows_probe.py``).

Each module has a plain PyTorch version of its kernel's function, a
wrapper (a CPU tensor runs the plain version; a CUDA tensor launches the
hand-written kernel of ``csrc/probe_*.cu`` or raises, and counts the launch
in ``ops/_build.py:LAUNCHES``), and ``main()``: run as
``python -m matchmaker_tpu_torch.probes.<name>``, on the card unless
``--device cpu`` is given, it times its rows with CUDA events after a
warm-up (medians) and prints one JSON line. Rates are against the H100
SXM's data-sheet peaks; a ``--device cpu`` run reports its host times and
no rate.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# H100 SXM data-sheet peaks (dense), the denominators of every rate here
PEAK = {"bf16": 989e12, "int8": 1979e12}


def device_of(name: str) -> torch.device:
    """The probe's device: "cuda" needs a card (no silent CPU run)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probe times the card's kernels (pass --device cpu for the plain "
                         "versions on the host)")
    return device


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


def median_ms(fn, device: torch.device, iters: int, warmup: int = 3) -> float:
    """Median ms of one call of ``fn`` after ``warmup`` calls: CUDA events
    around each call on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for begin, end in events:
            begin.record()
            fn()
            end.record()
        torch.cuda.synchronize(device)
        times = [begin.elapsed_time(end) for begin, end in events]
    else:
        for _ in range(iters):
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def rate(ops: float, ms: float, kind: str, device: torch.device) -> dict:
    """{"ms", "tflops", "eff_vs_peak"}: the rate only for a card's time."""
    on_card = device.type == "cuda"
    return {"ms": ms, "tflops": ops / ms / 1e9 if on_card else None,
            "eff_vs_peak": ops / ms / 1e-3 / PEAK[kind] if on_card else None}
