#!/usr/bin/env python3
"""Time the encoder halves' launches (bf16 K1, K2; int8 K10, K9) of two checkouts on one card, in turns.

    python3 tools/encoder_parts_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--shapes 256x128,...]
        [--out FILE]

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
and the whole call. At each (B, L) of ``--shapes`` (the first one's halves
are the ones above) the attention kernels whose core is shared, each call
by device time (torch.profiler, ``chip_smoke._device_ms``) and a SHA-256 of
its output's bytes: K1 (the packed entry), K10 (the K-major entry where the
checkout has one), K13, K12 (the attention half's backward after its
training forward) and K12's attention core alone, on inputs from seeds
with ragged masks and one example without a live key. The summary says,
for each shape and kernel, whether every turn gave the same bits, and B's
device time over A's.

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


def _digest(t) -> str:
    import hashlib

    import torch

    if isinstance(t, (tuple, list)):
        return hashlib.sha256("".join(_digest(x) for x in t).encode()).hexdigest()
    t = t.detach().contiguous()
    return hashlib.sha256(t.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def attention_kernels(cs, fa, fb, fi, sz, b, l, device, reps) -> dict:
    """K1, K10, K13, K12 and K12's core alone at (b, l): {kernel: {"device_ms",
    "digest"}} (device_ms None off the card)."""
    import torch

    attn, ln1, _, _ = cs._layer_params(sz, device, 21)
    x, mask, g = cs._half_inputs(sz, b, l, device, 22)
    if b > 1:
        mask[1] = 0.0  # an example without a live key: every key tile runs
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    heads, hid = sz["heads"], sz["hid"]
    q, k, v, dy = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(4))
    qkv = torch.randn(b, l, 3 * hid, generator=g, device=device).to(torch.bfloat16)
    a8, _, l8, _ = cs._int8_layer_params(sz, device, 23)
    if hasattr(fi, "fused_attention_int8_block_qkv_kmajor"):
        a8_t = fi.kmajor_attention_weights(*a8)
        int8 = lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *a8_t, mask, heads, *l8)  # noqa: E731
    else:
        int8 = lambda: fi.fused_attention_int8_block(x, *a8, mask, heads, *l8)  # noqa: E731
    _, saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, heads, *ln1)
    kernels = {"K1": lambda: fa.fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, heads, *ln1),
               "K10": int8,
               "K13": lambda: fa.fused_mha(q, k, v, mask, heads),
               "K12": lambda: fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, heads, ln1[0], dy, saved),
               "K12 core": lambda: fb.attention_core_bwd(qkv, mask, dy, heads)}
    out = {}
    for name, fn in kernels.items():
        out[name] = {"digest": _digest(fn()), "device_ms": cs._device_ms(fn, device, reps)}
        ms = out[name]["device_ms"]
        print(f"[ab] {name} at {(b, l)}: device {'-' if ms is None else f'{ms:.4f}'} ms, "
              f"bits {out[name]['digest'][:12]}", file=sys.stderr)
    return out


def run_turn(checkout: str, reps: int, device_name: str, tiny: bool, shapes=None) -> dict:
    """Time the encoder halves of the port in ``checkout`` (this process),
    and the attention kernels at each (B, L) of ``shapes``."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import matchmaker_tpu_torch
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb
    from matchmaker_tpu_torch.ops import fused_int8 as fi

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = dict(cs.FULL)
    shapes = shapes or [tuple(sz["layer_shapes"][0])]
    if tiny:
        sz.update(hid=128, heads=2, ff=256)
        shapes = [(2, 16)]
    b, l = shapes[0]
    if device.type == "cuda":
        _build.library()
    torch.set_float32_matmul_precision("highest")
    halves = {**cs.bf16_half_parts(fa, sz, b, l, device, reps), **cs.int8_half_parts(fi, sz, b, l, device, reps)}
    attention = {f"{b}x{l}": attention_kernels(cs, fa, fb, fi, sz, b, l, device, reps) for b, l in shapes}
    return {"checkout": checkout, "shape": [b, l, sz["hid"]], "halves": halves, "attention": attention}


def _mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


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
    ap.add_argument("--shapes", default="", help="(B, L) of the attention kernels, as 256x128,32x200 (default: "
                    "phase 3's headline)")
    ap.add_argument("--out", help="write the turns and the means to this JSON file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn in this process: the checkout's root
    args = ap.parse_args()
    shapes = [tuple(int(n) for n in s.split("x")) for s in args.shapes.split(",") if s]

    if args.turn:
        print(TURN_TAG + json.dumps(run_turn(args.turn, args.reps, args.device, args.tiny, shapes)), flush=True)
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
               "--device", args.device, "--shapes", args.shapes] + (["--tiny"] if args.tiny else [])
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
        means[letter]["attention"] = {
            shape: {name: _mean([t["attention"][shape][name]["device_ms"] for t in mine]) for name in kernels}
            for shape, kernels in mine[0]["attention"].items()}
    if set(means) == {"A", "B"}:
        means["B/A"] = {shape: {name: (ms / means["A"]["attention"][shape][name]
                                       if ms is not None and means["A"]["attention"][shape][name] else None)
                                for name, ms in kernels.items()}
                        for shape, kernels in means["B"]["attention"].items()}
    bits = {shape: {name: len({t["attention"][shape][name]["digest"] for t in turns}) == 1 for name in kernels}
            for shape, kernels in turns[0]["attention"].items()}
    card = _card_line() if args.device == "cuda" else "cpu"
    print(card)
    summary = {"card": card, "reps": args.reps, "turns": args.turns, "means": means, "bits_identical": bits}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
