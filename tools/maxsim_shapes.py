#!/usr/bin/env python3
"""Time ColBERT's MaxSim (K14) of this checkout at every shape of ``chip_smoke.py`` phase 3.

    python3 tools/maxsim_shapes.py [--reps 20]

Runs from a checkout's root (``.`` first on ``sys.path``), so a copy of the
port under ``build/`` with an edited kernel is timed by running the script
from that copy (``cd build/var_x && python3 ../../tools/maxsim_shapes.py``),
its kernels built into its own ``build/``: kernel variants meet the same
card in one call, in turns. For each all-pairs shape of
``chip_smoke.FULL["maxsim_shapes"]`` (inputs from ``chip_smoke._maxsim_inputs``)
and for the gathered batched rescore (``chip_smoke._gathered_inputs``, float16
tokens and the same spans as f32), one JSON line: the mean ms a call with
CUDA events after two warm-up calls, and whether the kernel met rtol = atol
= 1e-4 against the plain version with equal non-finite entries.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="timed calls of each shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from matchmaker_tpu_torch.ops import maxsim as ms

    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")
    out = {}
    for i, (bq, lq, bd, ld, dim, fill, below) in enumerate(cs.FULL["maxsim_shapes"]):
        q, d, qm, dm = cs._maxsim_inputs(bq, lq, bd, ld, dim, below, dev, seed=400 + i)
        got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
        want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
        fin = torch.isfinite(want)
        ok = bool(((got - want).abs()[fin] <= 1e-4 + 1e-4 * want.abs()[fin]).all()) and torch.equal(
            fin, torch.isfinite(got))
        out[str((bq, lq, bd, ld, dim))] = (cs._time_ms(lambda: ms.maxsim_all_pairs(q, d, qm, dm, fill=fill), dev,
                                                       args.reps), ok)
    q, qm, tokens, first, count, pad = cs._gathered_inputs(cs.FULL, dev, seed=409)
    inf = float("-inf")
    out["gathered"] = cs._time_ms(lambda: ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=inf), dev,
                                  args.reps)
    tf = tokens.float()
    out["gathered f32 tokens"] = cs._time_ms(lambda: ms.maxsim_gathered(q, qm, tf, first, count, pad, fill=inf),
                                             dev, args.reps)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
