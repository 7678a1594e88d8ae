#!/usr/bin/env python3
"""Time the probes' K15-K18 of two checkouts on one card, in turns.

    python3 tools/probe_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout (``tools/ab_turns.py``), so its kernels build from that checkout's
sources, and times, on inputs made from seeds as ``chip_smoke.py`` phase 3
makes them:

- K15 (``probes.attn_inner.attn_inner``), each variant (batched, f32_p,
  softmax_stub) at (B, L) = (256, 200) and (16, 77) with masked keys,
  12 heads of 64; beside it K13's ``fused_mha`` and one
  ``scaled_dot_product_attention`` call with the same additive mask;
- K16 (``probes.int8_matmul.int8_matmul``) at 16,384 x 768 x 3,072 and
  1,000 x 768 x 3,072; beside it ``torch._int_mm`` on the same operands;
- K17 (``probes.mlp_rows.mlp_rows2d``) and K18 (``mlp_rowsblk``, block_r
  1024) at (B, L) = (256, 200) and (16, 77), 768 wide, FF 3,072, with the
  weights ``chip_smoke._probe_mlp_weights`` draws, each wrapper called with
  its defaults; beside them K2's ``fused_mlp_block`` and the chain of bf16
  PyTorch calls (``probes.mlp_rows.matmul_chain``).

Each row gets its device time (``chip_smoke._device_ms``: the kernels'
durations from torch.profiler, a CUDA graph replay as its fallback) under
"device_ms" and its CUDA-event time over back-to-back calls
(``chip_smoke._time_ms``) under "ms"; each kernel its byte or operation
bound under "bound_ms". A turn fails if a kernel misses its bar against its
plain version (K15: row cosine >= 0.999 and max |d| <= 0.1 for each
variant against its own; K16: bit-identical, and equal to ``torch._int_mm``
on the card; K17/K18: K2's bar, row cosine >= 0.999 and max |d| <= 0.1,
against ``reference_mlp_rows``); "checks" holds the agreements, among them
each checkout's mean |d| of batched and f32_p to the f32-P plain version
at (256, 200).
``--device cpu --tiny`` rehearses the script on a CPU at a small size (the
plain versions; no device time).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import ab_turns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = dict(heads=12, attn=[(256, 200, False), (16, 77, True)], int8=[(16384, 768, 3072), (1000, 768, 3072)],
            hid=768, ff=3072, mlp=[(256, 200), (16, 77)])
TINY = dict(heads=2, attn=[(2, 9, False), (2, 7, True)], int8=[(40, 64, 24), (9, 32, 8)],
            hid=128, ff=256, mlp=[(2, 9), (2, 7)])


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timers, bounds and checks."""
    spec = importlib.util.spec_from_file_location("_probe_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def attn_inputs(b, l, hid, masked, device, seed):
    """q, k, v (B, L, hid) bf16 and a mask, as chip_smoke.py phase 3 draws
    them: N(0, 0.3); a masked shape keeps a random length >= L/4 a row."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = ((torch.randn(b, l, hid, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, l, device=device)
    if masked:
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    return q, k, v, mask


def int8_inputs(m, k, n, device, seed):
    """xq (M, K) and wq_t (N, K) int8 codes in [-127, 127]."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    wq_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    return xq, wq_t


def mlp_inputs(b, l, hid, device, seed):
    """x (B, L, hid) bf16, N(0, 1), as chip_smoke.py phase 3 draws it."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)


def run_turn(checkout: str, reps: int, device_name: str, tiny: bool) -> dict:
    """Time K15, K16, K17 and K18 of the port in ``checkout`` (this process)."""
    ab_turns.import_port(checkout)
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import attn_inner as ai
    from matchmaker_tpu_torch.probes import int8_matmul as im
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = TINY if tiny else FULL
    on_card = device.type == "cuda"
    if on_card:
        _build.library()
    torch.set_float32_matmul_precision("highest")
    heads = sz["heads"]
    hid = heads * ai.HEAD_DIM
    ms, dev, bounds, checks = {}, {}, {}, {}

    def timed(name, fn):
        ms[name] = cs._time_ms(fn, device, reps)
        dev[name] = cs._device_ms(fn, device)

    for i, (b, l, masked) in enumerate(sz["attn"]):
        q, k, v, mask = attn_inputs(b, l, hid, masked, device, seed=600 + i)
        tag = f"({b}, {l}{', masked' if masked else ''})"
        ops = 4 * hid * l * int(mask.sum())  # QK^T and PV over the live keys, every head
        for variant in ai.VARIANTS:
            got = ai.attn_inner(q, k, v, mask, variant, heads)
            cos, err = cs._rows_close(got, ai.reference_attn_inner(q, k, v, mask, variant, heads))
            if not (got.shape == q.shape and cos >= 0.999 and err <= 0.1):
                raise RuntimeError(f"K15 {variant} {tag}: row cosine {cos}, max |d| {err}")
            name = f"K15 {variant} {tag}"
            checks[name] = {"min_row_cosine": cos, "max_abs_err": err}
            timed(name, lambda vr=variant: ai.attn_inner(q, k, v, mask, vr, heads))
            bounds[name] = cs.bound(cs.nbytes(q, k, v, mask, got), bf16=ops)[0]
        if i == 0:
            want = ai.reference_attn_inner(q, k, v, mask, "f32_p", heads)
            for vr in ("batched", "f32_p"):
                checks[f"K15 {vr} {tag} vs f32-P plain, mean |d|"] = cs._mean_abs(
                    ai.attn_inner(q, k, v, mask, vr, heads), want)
        timed(f"K13 fused_mha {tag}", lambda: fa.fused_mha(q, k, v, mask, heads))
        if on_card:
            timed(f"sdpa {tag}", lambda: ai.sdpa(q, k, v, mask, heads))
        del q, k, v, mask

    for i, (m, k, n) in enumerate(sz["int8"]):
        xq, wq_t = int8_inputs(m, k, n, device, seed=700 + i)
        name = f"K16 ({m}, {k}, {n})"
        got = im.int8_matmul(xq, wq_t)
        exact = bool(torch.equal(got, im.reference_int8_matmul(xq, wq_t)))
        if on_card:
            exact = exact and bool(torch.equal(got, torch._int_mm(xq, wq_t.T)))
        if not exact:
            raise RuntimeError(f"{name}: not bit-identical to its plain version or torch._int_mm")
        checks[name] = {"exact": exact}
        timed(name, lambda: im.int8_matmul(xq, wq_t))
        bounds[name] = cs.bound(cs.nbytes(xq, wq_t, got), int8=2 * m * k * n)[0]
        if on_card:
            timed(f"torch._int_mm ({m}, {k}, {n})", lambda: torch._int_mm(xq, wq_t.T))
        del xq, wq_t, got

    weights = cs._probe_mlp_weights(sz, device, 800)
    for i, (b, l) in enumerate(sz["mlp"]):
        x = mlp_inputs(b, l, sz["hid"], device, seed=810 + i)
        tag = f"({b}, {l})"
        want = mr.reference_mlp_rows(x, *weights)
        ops = 4 * b * l * sz["hid"] * sz["ff"]  # two products over the live rows
        for kernel, fn in (("K17 mlp_rows2d", mr.mlp_rows2d), ("K18 mlp_rowsblk", mr.mlp_rowsblk)):
            got = fn(x, *weights)
            cos, err = cs._rows_close(got, want)
            if not (got.shape == x.shape and cos >= 0.999 and err <= 0.1):
                raise RuntimeError(f"{kernel} {tag}: row cosine {cos}, max |d| {err}")
            name = f"{kernel} {tag}"
            checks[name] = {"min_row_cosine": cos, "max_abs_err": err}
            timed(name, lambda f=fn: f(x, *weights))
            bounds[name] = cs.bound(cs.nbytes(x, weights, got), bf16=ops)[0]
        timed(f"K2 fused_mlp_block {tag}", lambda: fa.fused_mlp_block(x, *weights))
        timed(f"chain {tag}", lambda: mr.matmul_chain(x, *weights))
        del x, want, got
    return {"checkout": checkout, "ms": ms, "device_ms": dev, "bound_ms": bounds, "checks": checks}


if __name__ == "__main__":
    sys.exit(ab_turns.main(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]), run_turn,
                           kinds=("device_ms",)))
