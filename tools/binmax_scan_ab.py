#!/usr/bin/env python3
"""Time the binmax scans (bf16 K3, int8 K7, mixed K8) and the 1M-row searches of two checkouts on one card, in turns.

    python3 tools/binmax_scan_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout, so its kernels build from that checkout's sources into that
checkout's ``build/``, and times, with CUDA events after two warm-up calls
and on data made from seeds as ``chip_smoke.py`` makes it (its
``_clustered`` rows, of this checkout):

- ``binmax_candidates`` over 262,144 x 768 rows and 256 queries: K3 (bf16
  rows and queries), K7 (int8 codes with bin scales, int8 query codes) and
  K8 (the same codes, bf16 queries) at per_bin 2 and 8, the shapes of
  ``chip_smoke.py`` phase 3;
- ``FlatIndex`` device searches (scan, level 2, top-k, unpack) of 256
  queries at k 1000 over 1,048,576 x 768 rows, the rows of phase 5: the
  bf16 route (K3), the default int8 route (int8 queries, K7 alone) and the
  mixed route (``mips_int8_queries: float``, K8).

The turns run in the order of ``--turns`` (A = BASE_DIR, B = NEW_DIR), so
both checkouts meet the same card. One JSON line per turn, then the card's
name and power limit, then a JSON line with each checkout's mean of each
time. ``--device cpu --tiny`` rehearses the script on a CPU at a small size
(the plain versions).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN_TAG = "TURN "


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timer and its seeded rows."""
    spec = importlib.util.spec_from_file_location("_binmax_scan_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_turn(checkout: str, reps: int, device_name: str, tiny: bool) -> dict:
    """Time the scans and searches of the port in ``checkout`` (this process)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    import matchmaker_tpu_torch
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb
    from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus_binwise, quantize_queries
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = dict(cs.FULL)
    if tiny:
        sz.update(hid=64, scan_rows=8192, scan_queries=16, scale_rows=32_768, scale_k=10, scale_clusters=64)
    if device.type == "cuda":
        _build.library()
    torch.set_float32_matmul_precision("highest")

    n, hid = sz["scan_rows"], sz["hid"]
    rows, q = cs._clustered(n, hid, 256, device, seed=5, n_queries=sz["scan_queries"])
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    codes, scales = (torch.from_numpy(a).to(device) for a in quantize_corpus_binwise(rows.cpu().numpy()))
    q8, qs = quantize_queries(q)
    del rows
    scans = {}
    for per_bin in (2, 8):
        scans[f"K3 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(qb, c, n_valid=n, per_bin=pb), device, reps)
        scans[f"K7 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(q8, codes, n_valid=n, per_bin=pb, corpus_scales=scales,
                                                    query_scales=qs), device, reps)
        scans[f"K8 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(qb, codes, n_valid=n, per_bin=pb, corpus_scales=scales),
            device, reps)
    del c, codes

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = cs._clustered(n, hid, sz["scale_clusters"], device, seed=9, n_queries=256)
    vectors = rows.cpu().numpy()
    del rows
    searches = {}
    for name, quant in (("bf16", {"mips_quantization": "float16"}),
                        ("int8", {"mips_quantization": "int8", "mips_int8_queries": "int8"}),
                        ("mixed", {"mips_quantization": "int8", "mips_int8_queries": "float"})):
        index = FlatIndex({"token_dtype": "float16", "mips_kernel": "binmax", **quant}, device)
        index.prepare(hid)
        index.index(np.arange(n), vectors)
        index._ensure_device()
        searches[f"{name} search"] = cs._time_ms(lambda ix=index: ix._search_device(q, k), device, reps)
        del index
    return {"checkout": checkout, "scan_shape": [sz["scan_rows"], hid, sz["scan_queries"]],
            "search_shape": [n, hid, 256, k], "ms": {**scans, **searches}}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", help="root of the checkout measured as A")
    ap.add_argument("new", nargs="?", help="root of the checkout measured as B")
    ap.add_argument("--turns", default="ABBA", help="order of the turns (letters A and B)")
    ap.add_argument("--reps", type=int, default=10, help="timed calls of each scan and search a turn")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal with --tiny")
    ap.add_argument("--tiny", action="store_true", help="a 64-wide corpus of a few thousand rows")
    ap.add_argument("--out", help="write the turns and the means to this JSON file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn in this process: the checkout's root
    args = ap.parse_args()

    if args.turn:
        print(TURN_TAG + json.dumps(run_turn(args.turn, args.reps, args.device, args.tiny)), flush=True)
        return 0
    if not (args.base and args.new) or set(args.turns) - set("AB"):
        ap.error("give BASE_DIR, NEW_DIR and turns of A and B")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
    checkouts = {"A": args.base, "B": args.new}
    turns = []
    for letter in args.turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", checkouts[letter], "--reps", str(args.reps),
               "--device", args.device] + (["--tiny"] if args.tiny else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TURN_TAG)]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"turn {letter} ({checkouts[letter]}) failed with exit code {proc.returncode}")
        turn = dict(json.loads(lines[-1][len(TURN_TAG):]), turn=letter)
        turns.append(turn)
        print(json.dumps(turn), flush=True)

    means = {}
    for letter in sorted(set(args.turns)):
        mine = [t for t in turns if t["turn"] == letter]
        means[letter] = {"checkout": checkouts[letter],
                         **{name: sum(t["ms"][name] for t in mine) / len(mine) for name in mine[0]["ms"]}}
    card = _card_line() if args.device == "cuda" else "cpu"
    print(card)
    summary = {"card": card, "reps": args.reps, "turns": args.turns, "means": means}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
