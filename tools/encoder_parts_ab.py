#!/usr/bin/env python3
"""Time the encoder halves' launches (bf16 K1, K2; int8 K10, K9) of two checkouts on one card, in turns.

    python3 tools/encoder_parts_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout, so its kernels build from that checkout's sources into that
checkout's ``build/``, and runs ``chip_smoke.py``'s ``bf16_half_parts`` and
``int8_half_parts`` (of this checkout) on it: the four halves at DistilBERT
width at the headline (B, L) = (256, 128) of phase 3, random weights from a
seed, each C launch timed alone with CUDA events (each product with its
TFLOP/s or TOP/s and one ``torch.addmm`` or ``torch._int_mm`` call of the
same shapes beside it, the attention core beside one
``scaled_dot_product_attention`` call, the quantizations, the LayerNorm)
and the whole call.

The turns run in the order of ``--turns`` (A = BASE_DIR, B = NEW_DIR), so
both checkouts meet the same card. One JSON line per turn, then the card's
name and power limit, then a JSON line with each checkout's mean time of
each half and of each of its launches. ``--device cpu --tiny`` rehearses
the script on a CPU at a small size (the plain versions: whole calls only,
no launches).
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
    """This checkout's chip_smoke.py, for its phase 3 timing of the halves."""
    spec = importlib.util.spec_from_file_location("_encoder_parts_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_turn(checkout: str, reps: int, device_name: str, tiny: bool) -> dict:
    """Time the encoder halves of the port in ``checkout`` (this process)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import matchmaker_tpu_torch
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_int8 as fi

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = dict(cs.FULL)
    b, l = sz["layer_shapes"][0]
    if tiny:
        sz.update(hid=128, heads=2, ff=256)
        b, l = 2, 16
    if device.type == "cuda":
        _build.library()
    torch.set_float32_matmul_precision("highest")
    halves = {**cs.bf16_half_parts(fa, sz, b, l, device, reps), **cs.int8_half_parts(fi, sz, b, l, device, reps)}
    return {"checkout": checkout, "shape": [b, l, sz["hid"]], "halves": halves}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", help="root of the checkout measured as A")
    ap.add_argument("new", nargs="?", help="root of the checkout measured as B")
    ap.add_argument("--turns", default="ABBA", help="order of the turns (letters A and B)")
    ap.add_argument("--reps", type=int, default=10, help="timed calls of each half a turn")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal with --tiny")
    ap.add_argument("--tiny", action="store_true", help="a 128-wide layer (two heads) and a small batch")
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
        means[letter] = {"checkout": checkouts[letter]}
        for half in mine[0]["halves"]:
            runs = [t["halves"][half] for t in mine]
            means[letter][half] = {
                "ms": sum(r["parts_total_ms"] for r in runs) / len(runs),
                "parts": [dict(part, ms=sum(r["parts"][j]["ms"] for r in runs) / len(runs))
                          for j, part in enumerate(runs[0]["parts"])]}
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
