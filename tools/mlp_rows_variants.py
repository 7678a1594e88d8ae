#!/usr/bin/env python3
"""Time K17 (the probes' row-packed MLP) of one or more checkouts on one card, each in its own process.

    python3 tools/mlp_rows_variants.py DIR [DIR ...] [--reps 20]

Each DIR is the root of a checkout, or of a copy of the port under
``build/`` (``matchmaker_tpu_torch`` and ``chip_smoke.py``) with an edited
kernel. Each runs in a fresh process that imports the port from there, so
its kernels build into its own ``build/`` and the variants meet the same
card in one call. For each DIR, one JSON line: at (B, L) = (256, 200) and
(16, 77), on the inputs of ``chip_smoke.py`` phase 3
(``_probe_mlp_weights``), ``mlp_rows2d``'s device time
(``chip_smoke._device_ms``), its min row cosine and max |d| against
``reference_mlp_rows`` and whether a rerun gave the same bits; K2's
``fused_mlp_block`` device time at (256, 200) beside it; and, where the
variant's library exports ``mm_probe_mlp_clusters`` (a query a variant adds
for itself), the clusters the card runs at once
(``cudaOccupancyMaxActiveClusters``). A variant with parts of the kernel
stubbed out, to attribute its time, is timed the same way; its agreement
reads as whatever the stub computes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

TAG = "VARIANT "
SHAPES = [(256, 200), (16, 77)]


def one(checkout: str, reps: int) -> dict:
    """Time this process's import of the port from ``checkout``."""
    root = os.path.abspath(checkout)
    sys.path.insert(0, root)
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    spec = importlib.util.spec_from_file_location("_variant_chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    device = torch.device("cuda")
    lib = _build.library()
    weights = cs._probe_mlp_weights(dict(hid=768, ff=3072), device, 800)
    out = {"checkout": checkout}
    if hasattr(lib, "mm_probe_mlp_clusters"):
        out["max_active_clusters"] = lib.mm_probe_mlp_clusters()
    for i, (b, l) in enumerate(SHAPES):
        g = torch.Generator(device=device).manual_seed(810 + i)
        x = torch.randn(b, l, 768, generator=g, device=device).to(torch.bfloat16)
        got = mr.mlp_rows2d(x, *weights)
        cos, err = cs._rows_close(got, mr.reference_mlp_rows(x, *weights))
        out[f"({b}, {l})"] = {"min_row_cosine": cos, "max_abs_err": err,
                              "rerun_identical": bool(torch.equal(got, mr.mlp_rows2d(x, *weights))),
                              "device_ms": cs._device_ms(lambda: mr.mlp_rows2d(x, *weights), device, reps)}
        if i == 0:
            out[f"K2 ({b}, {l}) device_ms"] = cs._device_ms(lambda: fa.fused_mlp_block(x, *weights), device, reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+", help="roots of the checkouts or variant copies")
    ap.add_argument("--reps", type=int, default=20, help="timed calls a row (device time)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)  # one checkout in this process
    args = ap.parse_args()
    if args.one:
        print(TAG + json.dumps(one(args.checkouts[0], args.reps)), flush=True)
        return 0
    failed = 0
    for checkout in args.checkouts:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), checkout, "--one", "--reps", str(args.reps)],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
        if proc.returncode != 0 or not lines:
            failed += 1
            print(json.dumps({"checkout": checkout, "failed": proc.returncode}), flush=True)
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        else:
            print(lines[-1][len(TAG):], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
