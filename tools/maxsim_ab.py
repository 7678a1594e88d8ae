#!/usr/bin/env python3
"""Time ColBERT's MaxSim (K14), its training kernels and the exact rescore of two checkouts on one card, in turns.

    python3 tools/maxsim_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout, so its kernels build from that checkout's sources into that
checkout's ``build/``, and times on data made from seeds:

- ``maxsim_all_pairs`` (K14) with CUDA events after two warm-up calls, at
  its headline (Bq, Lq, Bd, Ld, D) = (128, 32, 256, 200, 128) with fill
  -1000 and at one query's rescore, (1, 32, 64, 128, 128) with fill -inf
  (f32 tokens and masks as ``chip_smoke.py`` phase 3 makes them);
- the training form (``maxsim_all_pairs_argmax``) and the backward
  (``maxsim_all_pairs_bwd``) by device time (the durations of the kernels
  they launch, from torch.profiler, after two warm-up calls; each kernel's
  under ``kernel_ms``) at the ColBERT training step's in-batch shape (32,
  30, 64, 200, 128), a batch of 128 against its 256 in-batch docs and the
  public checkpoint's width 768, on chip_smoke.py's phase-3 data (random
  f32 vectors, a fifth of the slots masked);
- the same two by a SHA-256 of their outputs' bytes (out and argmax; dq
  and dd) at each of those shapes and at the first with exact ties (token
  5 of every doc a copy of token 3), the summary saying whether every turn
  gave the same bits; K14 all pairs at the first of them by device time;
- K14's serving launches at every shape of ``chip_smoke.py``'s
  ``maxsim_shapes`` and the gathered form at the ColBERT run's batched
  rescore: a SHA-256 of each output's bytes (the summary says whether every
  turn gave the same bits) and, for the headline all-pairs shape and the
  gathered form, the device time;
- the exact rescore of 256 queries of 32 tokens against 64 candidates each,
  from a token store of 16,384 documents of 1-128 float16 vectors of width
  128 written once to a temporary folder (the ColBERT run's shapes), on the
  host clock to a synchronised end: the checkout's batched rescore
  (``exact_rescore_batch``, one launch, the store's rows uploaded once
  before the timing) where it has one, else its per-query
  ``exact_rescore`` loop (a gather from the memmapped store, an upload and
  a launch a query).

The turns run in the order of ``--turns`` (A = BASE_DIR, B = NEW_DIR), so
both checkouts meet the same card. One JSON line per turn, then the card's
name and power limit, then a JSON line with each checkout's mean of each
time. ``--device cpu --tiny`` rehearses the script on a CPU at a small size
(the plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

TURN_TAG = "TURN "
FULL = dict(all_pairs=(128, 32, 256, 200, 128), rescore_shape=(1, 32, 64, 128, 128), queries=256, query_len=32,
            candidates=64, docs=16_384, max_tokens=128, dim=128,
            # chip_smoke.py's FULL["maxsim_shapes"] (Bq, Lq, Bd, Ld, D, fill, live dots below -1000)
            serving=[(128, 32, 256, 200, 128, -1000.0, False), (32, 32, 64, 200, 128, -1000.0, False),
                     (1, 32, 64, 128, 128, float("-inf"), False), (7, 30, 21, 77, 128, -1000.0, True),
                     (1, 32, 64, 128, 768, float("-inf"), False), (8, 200, 64, 200, 128, -1000.0, False)],
            train=[(32, 30, 64, 200, 128), (128, 30, 256, 200, 128), (32, 30, 64, 200, 768)])
TINY = dict(all_pairs=(4, 8, 16, 24, 64), rescore_shape=(1, 8, 16, 24, 64), queries=16, query_len=8, candidates=16,
            docs=256, max_tokens=24, dim=64,
            serving=[(4, 8, 16, 24, 64, -1000.0, False), (3, 5, 7, 13, 64, -1000.0, True)],
            train=[(4, 6, 8, 24, 64), (8, 6, 16, 24, 64)])


def write_store(folder: str, sz: dict, seed: int = 3) -> None:
    """A token store as retrieval/encode.py writes it: one float16 block,
    doc_infos spans and encode_meta."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = rng.integers(1, sz["max_tokens"] + 1, size=sz["docs"])
    starts = np.cumsum(counts) - counts
    rows = (rng.normal(size=(int(counts.sum()), sz["dim"])) * 0.1).astype(np.float16)
    np.save(os.path.join(folder, "token_reps_0.npy"), rows)
    spans = np.stack([np.zeros_like(starts), starts, starts + counts], axis=1).astype(np.int64)
    np.savez_compressed(os.path.join(folder, "doc_infos.npz"), ids=np.array([f"p{i}" for i in range(sz["docs"])]),
                        spans=spans)
    with open(os.path.join(folder, "encode_meta.json"), "w") as f:
        json.dump({"dim": sz["dim"], "dtype": "float16", "blocks": 1, "sequences": sz["docs"]}, f)


def _time_ms(fn, device, reps: int) -> float:
    """Mean ms a call after two warm-up calls: CUDA events on a card, the
    host clock on a CPU."""
    import torch

    for _ in range(2):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) * 1e3 / reps
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def _kernel_ms(fn, device, reps: int) -> dict:
    """Device time a call of each kernel ``fn`` launches, by name: the
    kernels' durations from torch.profiler over ``reps`` calls after two
    warm-up calls (the host's time between launches does not count); on a
    CPU the host clock of the whole call under the name "cpu"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"cpu": _time_ms(fn, device, reps)}
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then a window comes back without its kernels
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {ev.key[:80]: getattr(ev, "self_device_time_total", 0) / 1e3 / reps for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)
                 and getattr(ev, "self_device_time_total", 0) > 0}
        if parts:
            return parts
    raise RuntimeError("torch.profiler recorded no kernel in three windows")


def _device_ms(fn, device, reps: int) -> float:
    """Device time a call: the sum of _kernel_ms."""
    return sum(_kernel_ms(fn, device, reps).values())


def _all_pairs_inputs(shape, device, seed, below_fill=False):
    """chip_smoke.py's _maxsim_inputs without its padded rows when not
    ``below_fill``; with it, its every-third doc of live dots below -1000,
    a half-masked last query and an all-padding last doc."""
    import torch

    bq, lq, bd, ld, dim = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bq, lq, dim, generator=g, device=device)
    d = torch.randn(bd, ld, dim, generator=g, device=device)
    if below_fill:
        q, d[::3] = q.abs() * 5, -d[::3].abs() * 40
    q_mask = (torch.rand(bq, lq, generator=g, device=device) > 0.2).float()
    d_mask = (torch.rand(bd, ld, generator=g, device=device) > 0.2).float()
    q_mask[:, 0] = d_mask[:, 0] = 1.0
    if below_fill:
        q_mask[-1, lq // 2:] = 0.0
        d_mask[-1] = 0.0
    return q, d, q_mask, d_mask


def _gathered_inputs(sz, device, seed):
    """The batched rescore's launch: ``queries`` x ``query_len`` queries (8
    padded tokens in every fourth), float16 token rows of ``docs`` documents
    of 1..``max_tokens`` rows, ``candidates`` spans a query drawn with
    replacement, on the CPU."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    b, lq, c, dim, pad = sz["queries"], sz["query_len"], sz["candidates"], sz["dim"], sz["max_tokens"]
    counts = torch.randint(1, pad + 1, (sz["docs"],), generator=g, device=device)
    starts = torch.cumsum(counts, 0) - counts
    tokens = (torch.randn(int(counts.sum()), dim, generator=g, device=device) * 2).half()
    pick = torch.randint(0, sz["docs"], (b, c), generator=g, device=device)
    q = torch.randn(b, lq, dim, generator=g, device=device) * 2
    qm = torch.ones(b, lq, device=device)
    qm[::4, lq - 8:] = 0.0
    return q, qm, tokens, starts[pick].cpu(), counts[pick].int().cpu(), pad


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def run_turn(checkout: str, store_dir: str, reps: int, device_name: str, tiny: bool) -> dict:
    """Time K14 and the rescore of the port in ``checkout`` (this process)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import numpy as np
    import torch

    import matchmaker_tpu_torch
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import maxsim as ms
    from matchmaker_tpu_torch.retrieval import colbert_search as cs

    where = os.path.dirname(os.path.dirname(os.path.abspath(matchmaker_tpu_torch.__file__)))
    if where != os.path.abspath(checkout):
        raise RuntimeError(f"imported matchmaker_tpu_torch from {where}, not from {checkout}")
    sz = TINY if tiny else FULL
    device = torch.device(device_name)
    if device.type == "cuda":
        _build.library()
    torch.set_float32_matmul_precision("highest")

    times = {}
    for name, shape, fill, seed in (("K14 all pairs", sz["all_pairs"], ms.NEG_FILL, 1),
                                    ("K14 one query's rescore", sz["rescore_shape"], float("-inf"), 2)):
        args = _all_pairs_inputs(shape, device, seed)
        times[name] = _time_ms(lambda a=args, f=fill: ms.maxsim_all_pairs(*a, fill=f), device, reps)
        if name == "K14 all pairs":
            times["K14 all pairs, device"] = _device_ms(lambda a=args: ms.maxsim_all_pairs(*a), device, reps)

    # the training kernels, by device time, and each of their kernels'; their outputs' bits
    parts, train_digests = {}, {}
    first = sz["train"][0]
    times[f"K14 all pairs {list(first)}, device"] = _device_ms(
        lambda a=_all_pairs_inputs(first, device, 3): ms.maxsim_all_pairs(*a), device, reps)
    for i, shape in enumerate(sz["train"]):
        q, d, qm, dm = _all_pairs_inputs(shape, device, 10 + i)
        g = torch.randn(shape[0], shape[2], generator=torch.Generator(device=device).manual_seed(20 + i),
                        device=device)
        out, idx = ms.maxsim_all_pairs_argmax(q, d, qm, dm)
        train_digests[f"training form {list(shape)}"] = _digest(torch.cat([out.flatten(), idx.flatten().float()]))
        dq, dd = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
        train_digests[f"backward {list(shape)}"] = _digest(torch.cat([dq.flatten(), dd.flatten()]))
        for name, fn in (("training form", lambda a=(q, d, qm, dm): ms.maxsim_all_pairs_argmax(*a)),
                         ("backward", lambda a=(q, d, qm, dm, idx, g): ms.maxsim_all_pairs_bwd(*a))):
            parts[f"{name} {list(shape)}"] = _kernel_ms(fn, device, reps)
            times[f"{name} {list(shape)}"] = sum(parts[f"{name} {list(shape)}"].values())
        if i == 0:  # exact ties: every doc's token 5 a copy of token 3
            d[:, 3] = q.sum(dim=(0, 1))
            d[:, 5], dm[:, 3], dm[:, 5] = d[:, 3], 1.0, 1.0
            out, idx = ms.maxsim_all_pairs_argmax(q, d, qm, dm)
            dq, dd = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
            train_digests[f"ties {list(shape)}"] = _digest(torch.cat([out.flatten(), idx.flatten().float(),
                                                                      dq.flatten(), dd.flatten()]))

    # K14's serving launches: their output bits, and the gathered form's device time
    digests = {}
    with torch.no_grad():
        for i, (*shape, fill, below) in enumerate(sz["serving"]):
            args = _all_pairs_inputs(tuple(shape), device, 400 + i, below_fill=below)
            digests[f"all pairs {shape} fill {fill}"] = _digest(ms.maxsim_all_pairs(*args, fill=fill))
        q, qm, tokens, first, count, pad = _gathered_inputs(sz, device, 409)
        gathered = lambda: ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=float("-inf"))  # noqa: E731
        digests["gathered"] = _digest(gathered())
        times["K14 gathered, device"] = _device_ms(gathered, device, reps)

    store = cs.TokenVectorStore(store_dir)
    rng = np.random.default_rng(4)
    ids = [f"p{i}" for i in range(sz["docs"])]
    q = rng.normal(size=(sz["queries"], sz["query_len"], sz["dim"])).astype(np.float32)
    q_mask = np.ones((sz["queries"], sz["query_len"]), np.float32)
    q_mask[::4, -4:] = 0.0
    cands = [[(ids[i], 0.0) for i in rng.choice(sz["docs"], sz["candidates"], replace=False)]
             for _ in range(sz["queries"])]
    pad_t = -(-store.max_tokens // 8) * 8
    batched = hasattr(cs, "exact_rescore_batch")
    if batched:
        rows = store.device_rows(device)
        q_dev = torch.from_numpy(q).to(device)

        def rescore():
            return cs.exact_rescore_batch(q_dev, q_mask, cands, store, 10, sz["candidates"], pad_t, rows)
    else:
        def rescore():
            return [cs.exact_rescore(q[i], q_mask[i], cands[i], store, 10, sz["candidates"], pad_t, device)
                    for i in range(sz["queries"])]
    rescore()  # warm-up (builds nothing new: the kernels are loaded)
    if device.type == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(max(1, reps // 5)):
        result = rescore()
    if device.type == "cuda":
        torch.cuda.synchronize()
    times[f"rescore of {sz['queries']} queries"] = (time.perf_counter() - start) * 1e3 / max(1, reps // 5)
    return {"checkout": checkout, "rescore_form": "batched" if batched else "per-query loop", "sizes": sz,
            "ms": times, "kernel_ms": parts, "serving_digests": digests, "training_digests": train_digests,
            "top_score": result[0][0][1]}


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", help="root of the checkout measured as A")
    ap.add_argument("new", nargs="?", help="root of the checkout measured as B")
    ap.add_argument("--turns", default="ABBA", help="order of the turns (letters A and B)")
    ap.add_argument("--reps", type=int, default=10, help="timed calls of each kernel a turn (rescore: reps / 5)")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal with --tiny")
    ap.add_argument("--tiny", action="store_true", help="small shapes and a store of a few hundred documents")
    ap.add_argument("--out", help="write the turns and the means to this JSON file")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one turn in this process: the checkout's root
    ap.add_argument("--store", help=argparse.SUPPRESS)  # the token store the turns share
    args = ap.parse_args()

    if args.turn:
        print(TURN_TAG + json.dumps(run_turn(args.turn, args.store, args.reps, args.device, args.tiny)), flush=True)
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
    with tempfile.TemporaryDirectory() as store_dir:
        write_store(store_dir, TINY if args.tiny else FULL)
        for letter in args.turns:
            cmd = [sys.executable, os.path.abspath(__file__), "--turn", checkouts[letter], "--store", store_dir,
                   "--reps", str(args.reps), "--device", args.device] + (["--tiny"] if args.tiny else [])
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
        means[letter] = {"checkout": checkouts[letter], "rescore_form": mine[0]["rescore_form"],
                         **{name: sum(t["ms"][name] for t in mine) / len(mine) for name in mine[0]["ms"]}}
    if len(means) == 2:
        means["B/A"] = {name: means["B"][name] / means["A"][name] for name in turns[0]["ms"]
                        if name in means["B"] and means["A"][name] > 0}
    digests = [t["serving_digests"] for t in turns]
    card = _card_line() if args.device == "cuda" else "cpu"
    print(card)
    trained = [t["training_digests"] for t in turns]
    summary = {"card": card, "reps": args.reps, "turns": args.turns, "means": means,
               "serving_bits_identical": all(d == digests[0] for d in digests),
               "training_bits_identical": all(d == trained[0] for d in trained)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
