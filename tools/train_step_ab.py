#!/usr/bin/env python3
"""Time the PyTorch port's training step of two checkouts on one card, in turns.

    python3 tools/train_step_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--steps 20] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout, so its kernels build from that checkout's sources into that
checkout's ``build/``, and times the training step of ``chip_smoke.py``'s
phase 6 configuration: a DistilBERT-width BERT_DOT (bf16, fused layers,
random weights from a seed), one seeded batch of 32 triples (query 30, doc
200), Margin-MSE with in-batch negatives, AdamW with clipping at 1.0.

Each turn reports, over ``--steps`` steps after three warm-up steps:

- ``step_ms``: ms a step on the card's clock (CUDA events around all steps);
- ``host_ms``: the host's ms a step to issue each part of the step
  (forward and loss, backward, gradient norm and update), by
  ``time.perf_counter`` with no synchronisation inside a step: where the sum
  is close to ``step_ms``, the host sets the step;
- ``host_ms_inside``: of that host time, the ms a step inside the C entry
  points (``_build.call``: argument conversion, tensor maps, launches) by
  part, and inside the K11/K12 wrappers (``fused_backward.attention_block_bwd``
  and ``mlp_block_bwd``, their C calls included); the timers around them
  cost about a microsecond a call, in both checkouts alike;
- ``kernel_ms``: the card's kernel time a step over three profiled steps
  (torch.profiler), and ``busy``, its share of ``step_ms``.

The turns run in the order of ``--turns`` (A = BASE_DIR, B = NEW_DIR), so
both checkouts meet the same host and card. One JSON line per turn, then the
card's name and power limit, then a JSON line with each checkout's means.
``--device cpu --tiny`` rehearses the script on a CPU at a small size.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN_TAG = "TURN "


def _chip_smoke():
    """This checkout's chip_smoke.py, for its phase 6 data and configuration."""
    spec = importlib.util.spec_from_file_location("_train_step_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_turn(checkout: str, steps: int, device_name: str, tiny: bool) -> dict:
    """Time the training step of the port in ``checkout`` (this process)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import matchmaker_tpu_torch
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_backward as fb
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = dict(cs.FULL, train_batches=1, dr_passages=64, dr_queries=8)
    if tiny:
        sz.update(model_name="bert-tiny", train_doc_len=64, train_query_len=16, train_batch=4)
    t_build = time.perf_counter()
    if device.type == "cuda":
        _build.library()
    build_s = time.perf_counter() - t_build

    with tempfile.TemporaryDirectory(prefix="train_step_ab_") as root:
        paths = cs._write_train_data(root, sz)
        config = cs._train_config(paths, sz, device)
        tokenizer = build_tokenizer(config)
        model = get_model(config, tokenizer)
        init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
        model.to(device)
        model.train()
        optimizer = build_optimizer(config, model)
        loss_fn = make_loss_fn(model, get_loss(config), config)
        batch = cs._device_batch(config, tokenizer, paths["train"], device)

    parts = ("forward_and_loss", "backward", "norm_and_update")
    host = dict.fromkeys(parts, 0.0)
    # host time inside the C entry points (_build.call) by part, and inside
    # the K11/K12 wrappers (their C calls included), over the timed steps
    inside = {"c_calls": dict.fromkeys(parts, 0.0), "fused_backward_halves": {"backward": 0.0}}
    now = [None]  # the part of a timed step that runs, else None

    def on_host(fn, key):
        def timed_call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if now[0] in inside[key]:
                    inside[key][now[0]] += (time.perf_counter() - t) * 1e3 / steps
        return timed_call

    _build.call = on_host(_build.call, "c_calls")
    fb.attention_block_bwd = on_host(fb.attention_block_bwd, "fused_backward_halves")
    fb.mlp_block_bwd = on_host(fb.mlp_block_bwd, "fused_backward_halves")

    def step(timed: bool):
        optimizer.zero_grad()
        t0 = time.perf_counter()
        now[0] = parts[0] if timed else None
        loss, _ = loss_fn(batch)
        t1 = time.perf_counter()
        now[0] = parts[1] if timed else None
        loss.backward()
        t2 = time.perf_counter()
        now[0] = parts[2] if timed else None
        optimizer.step(optimizer.global_norm())
        t3 = time.perf_counter()
        now[0] = None
        if timed:
            for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                host[name] += dt * 1e3 / steps
        return loss

    for _ in range(3):
        step(False)
    _build.reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(True)
    if device.type == "cuda":
        end.record()
        torch.cuda.synchronize()
        step_ms = begin.elapsed_time(end) / steps
    else:
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: v for k, v in _build.LAUNCHES.items() if k.startswith("fused_")}
    if device.type == "cuda" and not (launches["fused_attention_block_bwd"] == launches["fused_mlp_block_bwd"]
                                      == 2 * steps * sz["n_layers"]):
        raise RuntimeError(f"the fused halves' kernels did not run once per layer and encode: {launches}")
    if not bool(torch.isfinite(loss).all()):
        raise RuntimeError("a non-finite training loss")

    kernel_ms = None
    if device.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        n = 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(False)
            torch.cuda.synchronize()
        # kernels only, as chip_smoke.py's profile counts them
        kernel_ms = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)) / 1e3 / n
    return {"checkout": checkout, "build_s": build_s, "step_ms": step_ms, "host_ms": host,
            "host_ms_total": sum(host.values()), "host_ms_inside": inside, "kernel_ms": kernel_ms,
            "busy": kernel_ms / step_ms if kernel_ms is not None else None,
            "triples_per_s": sz["train_batch"] / step_ms * 1e3, "launches": launches}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", help="root of the checkout measured as A")
    ap.add_argument("new", nargs="?", help="root of the checkout measured as B")
    ap.add_argument("--turns", default="ABBA", help="order of the turns (letters A and B)")
    ap.add_argument("--steps", type=int, default=20, help="timed steps a turn")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal with --tiny")
    ap.add_argument("--tiny", action="store_true", help="a 2-layer, 64-wide encoder and a small batch")
    ap.add_argument("--out", help="write the turns and the means to this JSON file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn in this process: the checkout's root
    args = ap.parse_args()

    if args.turn:
        print(TURN_TAG + json.dumps(run_turn(args.turn, args.steps, args.device, args.tiny)), flush=True)
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
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", checkouts[letter], "--steps", str(args.steps),
               "--device", args.device] + (["--tiny"] if args.tiny else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TURN_TAG)]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise RuntimeError(f"turn {letter} ({checkouts[letter]}) failed with exit code {proc.returncode}")
        turn = dict(json.loads(lines[-1][len(TURN_TAG):]), turn=letter)
        turns.append(turn)
        print(json.dumps(turn), flush=True)

    def mean(letter, key):
        vals = [t[key] for t in turns if t["turn"] == letter and t[key] is not None]
        return sum(vals) / len(vals) if vals else None

    means = {}
    for letter in sorted(set(args.turns)):
        means[letter] = {key: mean(letter, key) for key in ("step_ms", "host_ms_total", "kernel_ms", "busy",
                                                             "triples_per_s")}
        means[letter]["host_ms"] = {part: sum(t["host_ms"][part] for t in turns if t["turn"] == letter)
                                    / sum(t["turn"] == letter for t in turns) for part in turns[0]["host_ms"]}
        means[letter]["host_ms_inside"] = {
            key: {part: sum(t["host_ms_inside"][key][part] for t in turns if t["turn"] == letter)
                  / sum(t["turn"] == letter for t in turns) for part in by_part}
            for key, by_part in turns[0]["host_ms_inside"].items()}
        means[letter]["checkout"] = checkouts[letter]
    card = _card_line() if args.device == "cuda" else "cpu"
    print(card)
    summary = {"card": card, "steps": args.steps, "turns": args.turns, "means": means}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
