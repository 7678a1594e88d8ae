"""The turn loop of the A/B tools: two checkouts timed on one card, in turns.

A tool built on it defines ``run_turn(checkout, reps, device, tiny) -> dict``
(one turn in this process: import the port from ``checkout``, time it, and
return its times under "ms" and under each extra kind, such as
"device_ms", as {name: ms}) and calls :func:`main` with its own argument
parser. :func:`main` adds the common arguments, runs each turn of
``--turns`` (A = BASE_DIR, B = NEW_DIR) as a fresh process of the tool with
``--turn CHECKOUT``, so each checkout's kernels build from its own sources
into its own ``build/``, prints one JSON line per turn, then the card's
name and power limit, then a JSON line with each checkout's mean of each
time (None where no turn measured it), and writes both to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN_TAG = "TURN "


def import_port(checkout: str):
    """``matchmaker_tpu_torch`` imported from ``checkout`` (first on the
    path); raises if another copy was found."""
    sys.path.insert(0, os.path.abspath(checkout))
    import matchmaker_tpu_torch

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    return matchmaker_tpu_torch


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def means(turns: list, checkouts: dict, kinds=()) -> dict:
    """Each checkout's mean of each "ms" time (at the top level) and of
    each time under each of ``kinds``."""
    out = {}
    for letter in sorted({t["turn"] for t in turns}):
        mine = [t for t in turns if t["turn"] == letter]
        out[letter] = {"checkout": checkouts[letter], **{name: _mean(t["ms"][name] for t in mine)
                                                         for name in mine[0]["ms"]},
                       **{kind: {name: _mean(t[kind].get(name) for t in mine) for name in mine[0][kind]}
                          for kind in kinds}}
    return out


def main(ap, run_turn, kinds=()) -> int:
    """Parse the common arguments on ``ap`` and run the turns (or, given
    ``--turn``, one turn in this process)."""
    ap.add_argument("base", nargs="?", help="root of the checkout measured as A")
    ap.add_argument("new", nargs="?", help="root of the checkout measured as B")
    ap.add_argument("--turns", default="ABBA", help="order of the turns (letters A and B)")
    ap.add_argument("--reps", type=int, default=10, help="timed calls of each row a turn")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal with --tiny")
    ap.add_argument("--tiny", action="store_true", help="small shapes, for a rehearsal on the CPU")
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
    script = os.path.abspath(sys.argv[0])
    turns = []
    for letter in args.turns:
        cmd = [sys.executable, script, "--turn", checkouts[letter], "--reps", str(args.reps),
               "--device", args.device] + (["--tiny"] if args.tiny else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TURN_TAG)]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"turn {letter} ({checkouts[letter]}) failed with exit code {proc.returncode}")
        turn = dict(json.loads(lines[-1][len(TURN_TAG):]), turn=letter)
        turns.append(turn)
        print(json.dumps(turn), flush=True)

    card = card_line() if args.device == "cuda" else "cpu"
    print(card)
    summary = {"card": card, "reps": args.reps, "turns": args.turns, "means": means(turns, checkouts, kinds)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    return 0
