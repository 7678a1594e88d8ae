#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``matchmaker_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
1. the card's name and power limit; no CUDA device → exit 1;
2. build the CUDA kernels from ``matchmaker_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes: the encoder halves (bf16 K1/K2 and int8 K10/K9) at
   DistilBERT width for (B, L) = (256, 128), (256, 200), (64, 30); their
   backward kernels (K11, K12) at the training shapes (64, 200) and
   (32, 30), at (256, 200) and at an odd L = 77 with padded keys, every
   gradient compared; at the training rows, each backward product of the
   Hopper GEMM beside torch.matmul of the same shapes, and the attention-core
   backward alone against its plain version and bound; the binmax scan (bf16
   K3, mixed K8, int8 K7), level 2 and unpack on 262,144 x 768 rows and 256
   queries (K7 bit-identical; K3 and K7 beside one torch.matmul /
   torch._int_mm of the product alone; K3 also at ColBERT's token scan,
   8,192 query rows of width 128, per_bin 1, 4096-row tiles; K8 beside
   torch.matmul of the bf16-converted codes); level 2 (K4) bit for bit at
   widths 32 and 128 over the per_bin-8 candidates (256 x 16,384), at
   width 128 over ColBERT's per-token scan of 1.35M token rows (8,192 x
   11,264) and, in phase 5, at width 32 over the 1M-row search's own
   candidates; unpack (K6) exact at (256, 1000), (256, 4000) and (8,192,
   48); each with its device time (kernel durations from torch.profiler),
   its CUDA-event and host time a call, beside K4 torch.topk of the groups
   and beside K6 an empty kernel at its grid; ColBERT's MaxSim (K14), all
   pairs at (Bq, Lq, Bd, Ld, D) = (128, 32, 256, 200, 128), (32, 32, 64,
   200, 128), the single-query rescore shape (1, 32, 64, 128, 128) with
   fill -inf, an odd (7, 30, 21, 77, 128) with dots below -1000, the
   public checkpoint's width (1, 32, 64, 128, 768) and 200 query tokens
   (8, 200, 64, 200, 128), and its gathered form at the ColBERT run's
   batched rescore (256 queries x 32 tokens against their own 64 candidates
   of float16 token rows, 128 slots) (rtol = atol = 1e-4, reruns
   bit-identical); K14's training form (all pairs, each max's doc token
   saved) and the MaxSim backward kernel against plain autograd at the
   ColBERT training shape (32, 30, 64, 200, 128), an odd (7, 30, 21, 77,
   128) with dots below -1000 and a shape with exact ties (the forward at
   rtol = atol = 1e-4, the saved tokens equal to the plain argmax on >=
   99.99 % of (b, l, k) and near ties elsewhere, dq and dd at rtol = atol =
   1e-4 where the tokens agree, ties split evenly, reruns bit-identical);
   the standalone
   attention K13 at (B, L) = (256, 128) and (64, 30), 12 heads x 64, beside
   one scaled_dot_product_attention call; the probes' kernels: the
   attention inner loop K15 (three variants) at (256, 200) and (16, 77) with
   padded keys beside K13 and scaled_dot_product_attention, the int8 product
   K16 (bit-identical) at 16,384 x 768 x 3,072 and M = 1,000 beside
   torch._int_mm, the row-packed MLP K17/K18 (one cluster kernel) at
   (256, 200) and (16, 77) by device time beside K2 and the bf16
   torch.matmul chain; with CUDA-event timings of both and each kernel's
   bound (bytes or operations at the H100's data-sheet rates); at the
   encoder halves' headline
   (256, 128) each launch of K1, K2, K10 and K9 alone (each bf16 product
   with its TFLOP/s beside one torch.addmm call of the same shapes, each
   int8 product with its TOP/s beside one torch._int_mm call on codes of
   the same K-major shapes, the attention core beside one
   scaled_dot_product_attention call, the quantizations, the LayerNorm) and
   K1 and K2 beside their chains of PyTorch calls;
4. the main path, ``cli.dense_retrieval.run("encode+index+search")``, on a
   seeded 16,384-passage collection with a DistilBERT-width BERT_DOT
   (random weights from a seed), searching one query set at top-100 and one
   at top-10 (the latter takes the level-2 tournament): output files, the
   launch count of every kernel in that run, recall against an exact search
   of the same bf16 rows, and a re-encode with the plain versions;
   4b. the int8 serving path through the same CLI: ``encoder_int8`` with an
   int8 index, searched with ``mips_int8_queries: float`` (K8) and with int8
   queries plus ``mips_twostage`` (K7 + rescore): launch counts of K9/K10
   (6 x encode batches) and of the scan kernels, recall against an exact
   search of the int8-encoded rows, their cosine to phase 4's bf16 encode,
   device-only encode psg/s with the int8 halves;
   4c. ColBERT serving through the same CLI on the same collection and
   queries: a DistilBERT-width ``ColBert`` (bf16, compression 128, 8 query
   [MASK]s, random weights from a seed) encodes per-token vectors into a
   binmax token index (per_bin 1, 4096-row tiles), every query token
   searches 48 candidates, the device merges them by MaxSim and K14 rescores
   64 of them exactly: files, token rows and index bytes, launch counts
   against the prediction (K13: none), per-token recall@48 against an exact
   search (>= 0.95) with the misses' causes counted (token_recall_causes),
   the device merge against the host merge, the run's
   scores against the plain exact MaxSim, recall@10 against an exhaustive
   exact MaxSim over all passages (reported), encode psg/s, search QPS and
   device-only per-token search QPS;
5. ``FlatIndex`` search at 1,048,576 x 768 rows, Q = 256, k = 1000 (the
   keep-8/32 level-2 path): recall@1000 against an exact search and QPS;
   5b. the same rows in an int8 ``FlatIndex``, searched by the mixed, the
   int8 + two-stage and the default int8 (K7 alone; recall reported, not
   gated) routes: recall@1000 and QPS;
6. the training path, ``cli.train``'s ``Trainer``: a DistilBERT-width
   BERT_DOT (bf16, fused layers, random weights from a seed) takes 100
   Margin-MSE + in-batch-negative steps of 32 seeded synthetic triples with
   teacher scores (query 30, doc 200 tokens), validates by re-ranking at
   steps 50 and 100, keeps the best checkpoint, runs the test pass and hands
   ``best-model.npz`` to the dense-retrieval CLI; checked: the launch count of
   K1, K2, K11 and K12 against the prediction, a finite loss every step, the
   run-folder files; then one step with the kernels against one with the
   plain versions (loss and every parameter's gradient), a one-batch overfit
   (30 steps halve Margin-MSE), device-only triples/s and a profile of three
   steps;
   6b. ColBERT training through the same Trainer: a DistilBERT-width
   ``ColBert`` (configs/train/defaults.yaml + models/colbert.yaml:
   compression 128, 8 query [MASK]s, in-batch margin-mse over the
   all-pairs MaxSim; bf16, fused layers) takes 30 steps of phase 6's
   triples, validates once and runs the test pass: launch counts against
   the prediction (K14's training form and the backward kernel once a
   step), a finite loss every step, the run-folder files, triples/s through
   the Trainer and device-only, one step with the kernels against one with
   the plain versions (loss within 1e-2; every gradient's cosine >= 0.99
   under Margin-MSE + in-batch KLDivTeacherList), a one-batch overfit (30
   steps halve Margin-MSE);
7. the probes' own path: ``python -m matchmaker_tpu_torch.probes.<name>``'s
   main() for attn_inner (K15), int8_matmul (K16) and mlp_rows (K17/K18) at
   the JAX probes' shapes, the launch counts set to 0 before each and read
   after (every probe kernel launched), their JSON lines in the report;
8. the TAS-Balanced recipe, ``cli/tasb_recipe.py``'s run_recipe with the JAX
   recipe's configuration (mini-lm) cut in scale (``recipe_args``): every
   stage's wall time, the teacher's pairwise accuracy, the cluster count,
   MRR@10 >= 0.2 and Recall@100 >= 0.6 (tests/test_tasb_recipe.py:31-32),
   K14's training form, backward and plain launch and the search's scan
   launched; then the effectiveness check at 1,500 docs, MRR@10 >= 0.5
   (tests/test_effectiveness.py:45).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    layer_shapes=[(256, 128), (256, 200), (64, 30)],  # (B, L) of the encoder halves
    hid=768, heads=12, ff=3072, n_layers=6, vocab=30522, model_name="distilbert-base-uncased",
    scan_rows=262_144, scan_queries=256, scan_k=1000,
    passages=16_384, queries=256, doc_len=128, top_n=100, top_n_small=10, batch=256,
    scale_rows=1_048_576, scale_k=1000, scale_clusters=1024,
    reps=10,
    bwd_shapes=[(64, 200), (32, 30), (256, 200), (16, 77)],  # (B, L) of the backward kernels
    bwd_reps=5,
    train_batches=100, train_batch=32, train_query_len=30, train_doc_len=200, validate_every=50,
    val_queries=32, val_docs=10, eval_batch=256, dr_passages=2048, dr_queries=64, dr_top_n=10, dr_batch=256,
    overfit_steps=30,
    # K14 all pairs (Bq, Lq, Bd, Ld, D, fill, live dots below -1000): the
    # headline of matchmaker_tpu/ops/pallas_kernels.py:17, the teacher
    # shape, one query's rescore (colbert_rescore_n docs, the store's padded
    # tokens: the gathered form's slots), an odd padded shape, one query's
    # rescore at the public checkpoint's width 768, 200 query tokens (two
    # row tiles)
    maxsim_shapes=[(128, 32, 256, 200, 128, -1000.0, False), (32, 32, 64, 200, 128, -1000.0, False),
                   (1, 32, 64, 128, 128, float("-inf"), False), (7, 30, 21, 77, 128, -1000.0, True),
                   (1, 32, 64, 128, 768, float("-inf"), False), (8, 200, 64, 200, 128, -1000.0, False)],
    # K14's training form and the backward kernel (Bq, Lq, Bd, Ld, D, fill,
    # live dots below -1000, exact ties): the ColBERT training phase's
    # in-batch shape (the headline), an odd padded shape, exact ties
    maxsim_train_shapes=[(32, 30, 64, 200, 128, -1000.0, False, False), (7, 30, 21, 77, 128, -1000.0, True, False),
                         (4, 30, 16, 200, 128, -1000.0, False, True)],
    colbert_train_batches=30,
    # phase 8: cli/tasb_recipe.py's run_recipe (the JAX recipe's own
    # configuration, mini-lm) cut in scale to fit the time limit, and the
    # effectiveness check at tests/test_effectiveness.py:38-45's scale
    recipe_args=dict(n_docs=20_000, n_train_queries=400, n_eval_queries=100, mlm_steps=300, teacher_epochs=6,
                     tas_batches_per_epoch=100, student_epochs=3),
    effectiveness_args=dict(n_docs=1500, n_train_queries=150, n_eval_queries=20, epochs=6),
    mha_shapes=[(256, 128), (64, 30)],  # (B, L) of K13 at 12 heads x 64
    colbert_token_rows=1_350_000,  # phase 4c's token rows, the per-token search's K4/K6 shapes in phase 3
    colbert_dim=128, colbert_query_len=32, colbert_query_batch=256, colbert_candidates=48, colbert_rescore_n=64,
    colbert_top_n=10, colbert_checked_queries=32,
    # the probes' kernels (K15-K18) at each probe's headline shape and an odd
    # one: K15 (B, L, masked keys), K16 (M, K, N), K17/K18 (B, L)
    probe_attn_shapes=[(256, 200, False), (16, 77, True)],
    probe_int8_shapes=[(16384, 768, 3072), (1000, 768, 3072)],
    probe_mlp_shapes=[(256, 200), (16, 77)],
    # phase 7: each probe's main() with these arguments (the defaults: the
    # JAX probes' own shapes)
    probe_args={"attn_inner": [], "int8_matmul": [], "mlp_rows": []},
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, device, reps: int) -> float:
    """Mean ms per call after two warm-up calls (CUDA events on a card)."""
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


def _kernel_times(prof):
    """(name, device us, launches) of each kernel a torch.profiler window
    recorded. Kernels only: a kernel launched through ctypes is also counted
    as self device time of the CPU range around it (the autograd Function),
    and a GPU user annotation (Optimizer.step) spans kernels of its own."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    return rows


def _device_ms(fn, device, reps: int = 100):
    """Device time per call of ``fn``: the durations of the kernels it
    launches, from torch.profiler over ``reps`` calls after two warm-up
    calls. Unlike ``_time_ms`` the host's time between launches does not
    count, so a launch of a few us is measured, not its wrapper. Now and
    then the profiler hands back a window without its kernels: after three
    such windows, ``_graph_ms``. None off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(us for _, us, _ in _kernel_times(prof))
        if total_us > 0:
            return total_us / 1e3 / reps
    return _graph_ms(fn, reps)


def _graph_ms(fn, reps: int = 100):
    """Device time per call of ``fn`` without the profiler: ``reps`` calls
    captured in one CUDA graph on a side stream, one replay timed with CUDA
    events (a replay launches them back to back, with no host in between)."""
    import torch

    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / reps


def _host_ms(fn, device, reps: int = 100):
    """Host time per call of ``fn`` (the wrapper's checks, allocation and
    launch, not the kernel): the host clock around ``reps`` calls queued
    behind a sleeping kernel, so that no call waits for the card."""
    import torch

    for _ in range(2):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - start) * 1e3 / reps
    if device.type == "cuda":
        torch.cuda.synchronize()
    return host


def _pair_ms(kernel, plain, device, reps):
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain, device, reps)
    k1 = _time_ms(kernel, device, reps)
    k2 = _time_ms(kernel, device, reps)
    p2 = _time_ms(plain, device, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


# H100 SXM data-sheet peaks (dense): the card's memory rate and each input
# type's tensor-core rate, for the least time a kernel's work could take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}


def bound(n_bytes, **ops):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over the memory rate and its operations, by input type, over that
    type's peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    """Bytes of tensors (each read or written once); nested tuples and
    lists count their tensors, anything else counts nothing."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def _record(entry, shape, kernel, plain, device, reps, headline, bound_of=None):
    """Time kernel and plain at one shape into entry["timings"]; the
    headline shape also gives the entry's "ms" / "plain_ms" and, from
    ``bound_of`` = (bound_ms, bound_by), its bound."""
    ms, plain_ms = _pair_ms(kernel, plain, device, reps)
    timing = {"shape": shape, "ms": ms, "plain_ms": plain_ms}
    if bound_of:
        timing.update(bound_ms=bound_of[0], bound_by=bound_of[1])
    entry.setdefault("timings", []).append(timing)
    print(f"[kernels]   timed {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
          + (f", bound {bound_of[0]:.4f} ms ({bound_of[1]})" if bound_of else ""))
    if headline:
        entry.update(ms=ms, plain_ms=plain_ms, timed_shape=shape)
        if bound_of:
            entry.update(bound_ms=bound_of[0], bound_by=bound_of[1])


def _device_beside(entry, kernel, device, headline):
    """The device time of ``kernel`` (``_device_ms``) and its multiple of
    the bound, into the timing _record just wrote and, at the headline,
    into the entry."""
    timing = entry["timings"][-1]
    dev = _device_ms(kernel, device)
    timing.update(device_ms=dev, x_bound=dev / timing["bound_ms"] if dev is not None else None)
    print(f"[kernels]   device {_fmt(dev)}" + (f", {timing['x_bound']:.2f}x bound" if dev is not None else ""))
    if headline:
        entry.update(device_ms=dev, x_bound=timing["x_bound"])


def _library_level2(x, width):
    """The nearest library call to K4: each group's 8 largest values and
    their offsets, ``torch.topk(x.view(Q, G, w), 8)``, with ties in no set
    order and nothing packed (a yardstick; the port never calls it)."""
    import torch

    return torch.topk(x.view(x.shape[0], -1, width), 8, dim=-1)


def level2_timings(mb, packed, width, device, reps):
    """K4 (``mb._level2_reduce``, ``mb`` a checkout's ops.mips_binmax) at one
    shape: its share of output elements bit-identical (int32 view) to
    ``_level2_plain``, its device time (``_device_ms``), the CUDA-event time
    over back-to-back calls (``_time_ms``: the wrapper's per-call time when
    the host is the slower), its host time a call, its byte bound, and the
    ``torch.topk`` yardstick's device and event times."""
    import torch
    import torch.nn.functional as F

    x = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))  # _level2_reduce's own padding
    got = mb._level2_reduce(packed, width)
    want = mb._level2_plain(x, width)
    fin = torch.isfinite(want)
    rec = {"shape": [*packed.shape, width],
           "identical": float((got.view(torch.int32) == want.view(torch.int32)).float().mean()),
           "max_abs_err": float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0}
    del want, fin

    def kernel():
        return mb._level2_reduce(packed, width)

    rec.update(device_ms=_device_ms(kernel, device), ms=_time_ms(kernel, device, reps),
               host_ms=_host_ms(kernel, device),
               library_device_ms=_device_ms(lambda: _library_level2(x, width), device),
               library_ms=_time_ms(lambda: _library_level2(x, width), device, reps))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(packed, got))
    return rec


def unpack_timings(mb, build, top, pos, tile, per_bin, level2, device, reps):
    """K6 (``mb.unpack_candidates``; ``build`` the checkout's ops._build) on
    selected candidates at one shape: ids equal to ``_unpack_plain``'s and
    values bit for bit, its device, event and host times, its byte bound,
    and, where the checkout has ``mm_unpack_floor``, the device time of an
    empty kernel at K6's grid: the floor the card gives a launch there."""
    import torch

    gv, gi = mb.unpack_candidates(top, pos, tile, per_bin, level2)
    wv, wi = mb._unpack_plain(top, pos, tile, per_bin, level2)
    rec = {"shape": list(top.shape), "per_bin": per_bin, "level2": level2,
           "exact": bool(torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32)))}

    def kernel():
        return mb.unpack_candidates(top, pos, tile, per_bin, level2)

    rec.update(device_ms=_device_ms(kernel, device), ms=_time_ms(kernel, device, reps),
               host_ms=_host_ms(kernel, device), floor_device_ms=None)
    if device.type == "cuda" and "mm_unpack_floor" in build._SIGNATURES:
        rec["floor_device_ms"] = _device_ms(
            lambda: build.call("mm_unpack_floor", top.numel(), build.stream(device)), device)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes(top, pos, gv, gi))
    return rec


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def time_level2(entry, mb, packed, width, device, reps, headline):
    """level2_timings, held bit for bit and recorded beside the plain
    version's time (_record) into ``entry``."""
    import torch.nn.functional as F

    rec = level2_timings(mb, packed, width, device, reps)
    print(f"[kernels] level 2 width={width} over {list(packed.shape)}: identical {rec['identical']:.6f}; device "
          f"{_fmt(rec['device_ms'])}, events {_fmt(rec['ms'])}, host {_fmt(rec['host_ms'])} a call, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); torch.topk yardstick device "
          f"{_fmt(rec['library_device_ms'])}, events {_fmt(rec['library_ms'])}")
    check(rec["identical"] == 1.0, f"level 2 width {width} over {list(packed.shape)}: {rec['identical']} identical")
    entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])
    x = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))
    _record(entry, rec["shape"], lambda: mb._level2_reduce(packed, width), lambda: mb._level2_plain(x, width),
            device, reps, headline, bound_of=(rec["bound_ms"], rec["bound_by"]))
    extra = {key: rec[key] for key in ("device_ms", "host_ms", "library_device_ms", "library_ms")}
    entry["timings"][-1].update(extra)
    if headline:
        entry.update(extra, library_call="torch.topk(x.view(Q, C/w, w), 8, dim=-1): values and int64 offsets, "
                                         "ties unordered, nothing packed")


def time_unpack(entry, mb, build, packed, k, tile, per_bin, level2, device, reps, headline):
    """unpack_timings on the top k of ``packed`` (level-1 or level-2
    candidates), held exact and recorded beside the plain version's time."""
    import torch

    top, pos = torch.topk(packed, k, dim=1)
    rec = unpack_timings(mb, build, top, pos, tile, per_bin, level2, device, reps)
    print(f"[kernels] unpack {list(top.shape)} (per_bin {per_bin}, level 2 {level2}): exact {rec['exact']}; device "
          f"{_fmt(rec['device_ms'])}, events {_fmt(rec['ms'])}, host {_fmt(rec['host_ms'])} a call, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), empty kernel at its grid {_fmt(rec['floor_device_ms'])}")
    check(rec["exact"], f"unpack at {list(top.shape)}: ids or values differ from the plain version")
    _record(entry, rec["shape"] + [per_bin, level2], lambda: mb.unpack_candidates(top, pos, tile, per_bin, level2),
            lambda: mb._unpack_plain(top, pos, tile, per_bin, level2), device, reps, headline,
            bound_of=(rec["bound_ms"], rec["bound_by"]))
    extra = {key: rec[key] for key in ("device_ms", "host_ms", "floor_device_ms")}
    entry["timings"][-1].update(extra)
    if headline:
        entry.update(extra)


def _attention_ops(b, l, hid, heads):
    """(projection, attention-core) operations of an attention half."""
    m = b * l
    return 2 * m * hid * 3 * hid + 2 * m * hid * hid, 4 * b * heads * l * l * (hid // heads)


def _rows_close(a, b):
    import torch

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    return float(cos.min()), float((a - b).abs().max())


# The int8 halves' plain versions repeat the kernels' rounding step by step,
# so kernel and plain differ only where a rounding flips on a few elements
# (mean |d| <= 3e-6 on an H100). A wrong scale granularity (gelu codes per
# row instead of per row and FF chunk, attention codes per row instead of
# per head group) moves most elements and the mean |d| to >= 1e-3 at this
# width, while the row cosine stays above 0.99998: the mean is the tight bar.
INT8_HALF_MEAN_ABS = 5e-5


def _mean_abs(a, b):
    return float((a.float() - b.float()).abs().mean())


def fresh_perf_monitor() -> None:
    """The CLIs and the Trainer record into a process-wide PerformanceMonitor
    whose blocks add up over every run in the process; each run here starts
    a fresh one, so its efficiency-metrics.json holds its own blocks alone."""
    from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor

    PerformanceMonitor._instance = None


# ---- phase 3: kernels against their plain versions ------------------------

def _layer_params(sz, device, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]

    def w(rows, cols):
        return (torch.randn(rows, cols, generator=g, device=device) * rows ** -0.5).to(torch.bfloat16)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = (w(hid, hid), w(hid, hid), w(hid, hid), w(hid, hid), v(hid, 0.02), v(hid, 0.02), v(hid, 0.02),
            v(hid, 0.02))
    ln1 = (v(hid, 0.1, 1.0), v(hid, 0.1))
    mlp = (w(hid, ff), v(ff, 0.02), w(ff, hid), v(hid, 0.02))
    ln2 = (v(hid, 0.1, 1.0), v(hid, 0.1))
    return attn, ln1, mlp, ln2


def phase_encoder_kernels(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed=11)
    out = {"fused_attention_block": {"max_abs_err": 0.0}, "fused_mlp_block": {"max_abs_err": 0.0}}
    for i, (b, l) in enumerate(sz["layer_shapes"]):
        x, mask, _ = _half_inputs(sz, b, l, device, 100 + i)
        a_args = (*attn, mask, sz["heads"], *ln1)
        m_args = (*mlp, *ln2)
        proj, core = _attention_ops(b, l, sz["hid"], sz["heads"])
        cases = (("fused_attention_block", fa.fused_attention_block, fa.reference_attention_block, a_args,
                  dict(bf16=proj + core)),
                 ("fused_mlp_block", fa.fused_mlp_block, fa.reference_mlp_block, m_args,
                  dict(bf16=4 * b * l * sz["hid"] * sz["ff"])))
        for name, kernel, plain, args, ops in cases:
            got, want = kernel(x, *args), plain(x, *args)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], lambda k=kernel, a=args: k(x, *a),
                    lambda p=plain, a=args: p(x, *a), device, sz["reps"], headline=i == 0,
                    bound_of=bound(nbytes(x, args, got), **ops))
        if i == 0:
            for name, rec in bf16_half_parts(fa, sz, b, l, device, sz["reps"]).items():
                out[name].update(rec)
    return out


def _half_inputs(sz, b, l, device, seed):
    """x (B, L, HID) bf16 and a ragged key mask (B, L), from a seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
    lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
    mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    return x, mask, g


# the products of each encoder half (bf16 and int8) in launch order: (name,
# K, N) in units of (hid, ff); the other launches by entry point
_ATTENTION_PRODUCTS = (("QKV", "hid", "3hid"), ("Wo", "hid", "hid"))
_MLP_PRODUCTS = (("W1", "hid", "ff"), ("W2", "ff", "hid"))
HALF_PRODUCTS = {"fused_attention_block": _ATTENTION_PRODUCTS, "fused_mlp_block": _MLP_PRODUCTS,
                 "fused_attention_int8_block": _ATTENTION_PRODUCTS, "fused_mlp_int8_block": _MLP_PRODUCTS}
HALF_OTHER_PARTS = {"mm_attention_core": "attention core", "mm_attention_core_f32": "attention core",
                    "mm_layernorm": "LayerNorm"}


def _core_part(rec, sz, b, l, mask, g, device, reps):
    """The attention core's TFLOP/s (QK^T and P.V over all L keys) and one
    scaled_dot_product_attention call on inputs of its shape beside it."""
    import torch

    from matchmaker_tpu_torch.probes import attn_inner as ai

    heads, hid = sz["heads"], sz["hid"]
    ops = 4 * b * heads * l * l * (hid // heads)
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    lib = _time_ms(lambda: ai.sdpa(q, k, v, mask, heads), device, reps)
    rec.update(tflops=ops / rec["ms"] / 1e9, sdpa_ms=lib, sdpa_tflops=ops / lib / 1e9,
               peak_share=ops / rec["ms"] / 1e9 / (PEAK_OPS_PER_S["bf16"] / 1e12))
    return (f", {rec['tflops']:.1f} TFLOP/s ({100 * rec['peak_share']:.1f} % of 989); "
            f"scaled_dot_product_attention {lib:.4f} ms ({rec['sdpa_tflops']:.1f} TFLOP/s)")


def _library_chains(sz, b, l, x, mask, attn, ln1, mlp, ln2, device, reps):
    """Each bf16 half as a chain of PyTorch calls in bf16 (a yardstick the
    port never calls): K1 addmm (QKV), scaled_dot_product_attention, the
    residual add, addmm (Wo), layer_norm; K2 addmm (W1), gelu, the residual
    add, addmm (W2), layer_norm. Returns {half: ms}."""
    import torch
    import torch.nn.functional as F

    from matchmaker_tpu_torch.probes import attn_inner as ai

    bf, hid, heads, m = torch.bfloat16, sz["hid"], sz["heads"], b * l
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]).to(bf)
    w1, b1, w2, b2 = mlp
    x2 = x.reshape(m, hid)
    g1, be1, g2, be2 = (t.to(bf) for t in (*ln1, *ln2))
    bo, b1, b2 = bo.to(bf), b1.to(bf), b2.to(bf)

    def attention():
        q, k, v = torch.addmm(bqkv, x2, wqkv).view(b, l, 3 * hid).chunk(3, dim=-1)
        a = ai.sdpa(q, k, v, mask, heads).reshape(m, hid)
        return F.layer_norm(torch.addmm(x2 + bo, a, wo), (hid,), g1, be1)

    def mlp_half():
        h = F.gelu(torch.addmm(b1, x2, w1))
        return F.layer_norm(torch.addmm(x2 + b2, h, w2), (hid,), g2, be2)

    return {"fused_attention_block": _time_ms(attention, device, reps),
            "fused_mlp_block": _time_ms(mlp_half, device, reps)}


def bf16_half_parts(fa, sz, b, l, device, reps, seed=11):
    """Where K1's and K2's time goes at (B, L): each launch alone (see
    _launch_parts_ms), each product's TFLOP/s against the card's 989 with
    one torch.addmm call of the same shapes beside it, the attention core
    beside one scaled_dot_product_attention call, and the whole half beside
    its chain of PyTorch calls (library_chain_ms); yardsticks the port never
    calls. ``fa`` is a checkout's ``ops.fused_attention``; K1 runs through
    the encoder's packed entry."""
    import torch

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed)
    x, mask, g = _half_inputs(sz, b, l, device, 200)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    heads, m = sz["heads"], b * l
    halves = {"fused_attention_block": lambda: fa.fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, heads,
                                                                            *ln1),
              "fused_mlp_block": lambda: fa.fused_mlp_block(x, *mlp, *ln2)}
    chains = _library_chains(sz, b, l, x, mask, attn, ln1, mlp, ln2, device, reps) if device.type == "cuda" else {}
    dims = {"hid": sz["hid"], "3hid": 3 * sz["hid"], "ff": sz["ff"]}
    out = {}
    for name, fn in halves.items():
        launches, total = _launch_parts_ms(fn, device, reps)
        products, parts = list(HALF_PRODUCTS[name]), []
        for entry, ms in launches:
            rec, note = {"entry": entry, "ms": ms}, ""
            if "gemm" in entry:
                label, k, n = products.pop(0)
                k, n = dims[k], dims[n]
                a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
                w = (torch.randn(k, n, generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
                bias = torch.zeros(n, device=device, dtype=torch.bfloat16)
                lib = _time_ms(lambda: torch.addmm(bias, a, w), device, reps)
                ops = 2 * m * k * n
                rec.update(part=f"{label} product ({m} x {k} x {n})", tflops=ops / ms / 1e9, addmm_ms=lib,
                           addmm_tflops=ops / lib / 1e9, peak_share=ops / ms / 1e9 / (PEAK_OPS_PER_S["bf16"] / 1e12))
                note = (f", {rec['tflops']:.1f} TFLOP/s ({100 * rec['peak_share']:.1f} % of 989); torch.addmm "
                        f"{lib:.4f} ms ({rec['addmm_tflops']:.1f} TFLOP/s)")
            else:
                rec["part"] = HALF_OTHER_PARTS.get(entry, entry)
                if rec["part"] == "attention core":
                    note = _core_part(rec, sz, b, l, mask, g, device, reps)
            parts.append(rec)
            print(f"[kernels]   {name} part {rec['part']} ({entry}): {ms:.4f} ms{note}")
        out[name] = {"parts": parts, "parts_total_ms": total}
        if name in chains:
            out[name]["library_chain_ms"] = chains[name]
        print(f"[kernels]   {name} at {(b, l)}: {total:.4f} ms a call, {sum(r['ms'] for r in parts):.4f} ms in "
              f"its {len(parts)} launches" + (f"; PyTorch chain {chains[name]:.4f} ms" if name in chains else ""))
    return out


def grads_close(got, want, scale_of=None):
    """Per-tensor check of a backward kernel's gradients against the plain
    version's: cosine >= 0.999 and max |d| <= 2e-2 * max |plain| (f32 sums
    over up to 51,200 rows in another order, bf16 rounding of dz/dq/dk/dv at
    the same points). A gradient that is zero in exact arithmetic holds only
    rounding noise; ``scale_of`` names the gradient whose size bounds it.
    Returns the largest max |d| over the tensors."""
    import torch

    worst = 0.0
    for name, g in got.items():
        a, b = g.float().reshape(-1), want[name].float().reshape(-1)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if scale_of and name in scale_of:
            ref = float(want[scale_of[name]].float().abs().max())
            check(err <= 2e-2 * ref, f"{name}: max |d| {err} vs {ref} (a zero gradient's noise)")
            continue
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        check(cos >= 0.999 and err <= 2e-2 * float(b.abs().max()),
              f"{name}: cosine {cos}, max |d| {err}, max |plain| {float(b.abs().max())}")
    return worst


_ATTN_GRADS = ("dx", "dwq", "dwk", "dwv", "dwo", "dbq", "dbk", "dbv", "dbo", "dg", "dbe")
_MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")


def _zero_attention_grads(l):
    """The attention gradients that are zero in exact arithmetic, each with
    the gradient whose size bounds its rounding noise: the key bias always
    (each softmax row's gradient sums to zero); with one key (L = 1) the
    softmax is constant, so all of dq and dk."""
    if l == 1:
        return {"dwq": "dwv", "dwk": "dwv", "dbq": "dbv", "dbk": "dbv"}
    return {"dbk": "dbq"}


def _named_attention_grads(dx, dwqkv, dbqkv, dwo, dbo, dg, dbe):
    out = dict(dx=dx, dwo=dwo, dbo=dbo, dg=dg, dbe=dbe)
    for i, n in enumerate("qkv"):
        out[f"dw{n}"] = dwqkv.chunk(3, dim=1)[i]
        out[f"db{n}"] = dbqkv.chunk(3)[i]
    return out


def phase_backward_kernels(sz, device):
    """K12 and K11 against their plain versions on the same inputs: the
    kernels after the K1/K2 training forward, the plain backward after the
    plain forward."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.ops import fused_backward as fb

    attn, ln1, mlp, ln2 = _layer_params(sz, device, seed=13)
    wq, wk, wv, wo, bq, bk, bv, bo = attn
    wqkv, bqkv = torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv])
    heads = sz["heads"]
    out = {"fused_attention_block_bwd": {"max_abs_err": 0.0}, "fused_mlp_block_bwd": {"max_abs_err": 0.0}}
    for i, (b, l) in enumerate(sz["bwd_shapes"]):
        g = torch.Generator(device=device).manual_seed(200 + i)
        x = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
        dy = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        _, a_saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, heads, *ln1)
        _, a_acc = fa.reference_attention_block(x, *attn, mask, heads, *ln1, save_acc=True)
        _, m_saved = fb.mlp_block_fwd(x, *mlp, *ln2)
        _, m_acc = fa.reference_mlp_block(x, *mlp, *ln2, save_acc=True)
        w1, b1, w2, _ = mlp
        cases = (
            ("fused_attention_block_bwd",
             lambda: fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, heads, ln1[0], dy, a_saved),
             lambda: fb.reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, heads, ln1[0], dy, a_acc),
             lambda r: _named_attention_grads(*r), lambda r: dict(zip(_ATTN_GRADS, r)), _zero_attention_grads(l)),
            ("fused_mlp_block_bwd",
             lambda: fb.mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_saved),
             lambda: fb.reference_mlp_block_bwd(x, w1, b1, w2, ln2[0], dy, m_acc),
             lambda r: dict(zip(_MLP_GRADS, r)), lambda r: dict(zip(_MLP_GRADS, r)), None),
        )
        m, hid, ff = b * l, sz["hid"], sz["ff"]
        proj, core = _attention_ops(b, l, hid, heads)
        # weight and input gradients of every projection (2x the forward's
        # projections), and the attention core's S recompute, dP, dV, dQ, dK
        ops = {"fused_attention_block_bwd": dict(bf16=2 * proj + 5 * core // 2),
               # dW2, the gelu' recompute, dz, dW1, dx: five M x HID x FF products
               "fused_mlp_block_bwd": dict(bf16=10 * m * hid * ff)}
        inputs = {"fused_attention_block_bwd": (x, wqkv, bqkv, wo, mask, ln1[0], dy, a_saved),
                  "fused_mlp_block_bwd": (x, w1, b1, w2, ln2[0], dy, m_saved)}
        for name, kernel, plain, name_k, name_p, scale_of in cases:
            got, want = name_k(kernel()), name_p(plain())
            check(got["dx"].shape == x.shape and all(bool(torch.isfinite(t).all()) for t in got.values()),
                  f"{name} gradients at {(b, l)}")
            err = grads_close(got, want, scale_of)
            print(f"[kernels] {name} B={b} L={l}: {len(got)} gradients within cosine 0.999, "
                  f"max |d| <= 2e-2 max |plain| (largest |d| {err:.4g})")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], kernel, plain, device, sz["bwd_reps"], headline=i == 0,
                    bound_of=bound(nbytes(inputs[name], list(got.values())), **ops[name]))
    return out


def phase_backward_parts(sz, device):
    """K11's and K12's parts alone at the main path's rows (docs (64, 200),
    queries (32, 30)): every product of the Hopper GEMM beside one
    torch.matmul of each of its products (a yardstick; the port never calls
    it), and the attention-core backward against its plain version and its
    bound."""
    import torch

    from matchmaker_tpu_torch.ops import fused_backward as fb

    hid, ff, heads = sz["hid"], sz["ff"], sz["heads"]
    out = {"products": [], "attention_core": []}
    for b, l in sz["bwd_shapes"][:2]:
        m = b * l
        g = torch.Generator(device=device).manual_seed(300 + m)

        def rand(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device=device) * std).to(torch.bfloat16)

        x, dacc, a = rand(m, hid), rand(m, hid), rand(m, hid)
        dqkv, dz, h = rand(m, 3 * hid), rand(m, ff), rand(m, ff)
        wo, wqkv = rand(hid, hid, std=hid ** -0.5), rand(hid, 3 * hid, std=hid ** -0.5)
        w1, w2 = rand(hid, ff, std=hid ** -0.5), rand(ff, hid, std=ff ** -0.5)
        b1 = torch.randn(ff, generator=g, device=device) * 0.05
        aux = torch.randn(m, hid, generator=g, device=device)
        y = torch.empty((m, hid), dtype=torch.bfloat16, device=device)
        # (name, flops, kernel, the same products through torch.matmul)
        cases = [
            ("K12 da = dacc.Wo^T", 2 * m * hid * hid, lambda: fb._bwd_gemm(dacc, wo, y, fb._EPI_BF16),
             lambda: torch.matmul(dacc, wo.t())),
            ("K12 dx = dqkv.Wqkv^T + dacc", 2 * m * hid * 3 * hid,
             lambda: fb._bwd_gemm(dqkv, wqkv, y, fb._EPI_RESID_BF16, aux=aux), lambda: torch.matmul(dqkv, wqkv.t())),
            ("K12 dWo = a^T.dacc", 2 * m * hid * hid, lambda: fb._wgrad(a, dacc), lambda: torch.matmul(a.t(), dacc)),
            ("K12 dWqkv = x^T.dqkv", 2 * m * hid * 3 * hid, lambda: fb._wgrad(x, dqkv),
             lambda: torch.matmul(x.t(), dqkv)),
            ("K11 dz = (dacc.W2^T) * gelu'(x.W1 + b1)", 4 * m * hid * ff, lambda: fb._gelu_dz(x, w1, b1, dacc, w2),
             lambda: (torch.matmul(dacc, w2.t()), torch.matmul(x, w1))),
            ("K11 dx = dz.W1^T + dacc", 2 * m * hid * ff, lambda: fb._bwd_gemm(dz, w1, y, fb._EPI_RESID_BF16, aux=aux),
             lambda: torch.matmul(dz, w1.t())),
            ("K11 dW2 = h^T.dacc", 2 * m * hid * ff, lambda: fb._wgrad(h, dacc), lambda: torch.matmul(h.t(), dacc)),
            ("K11 dW1 = x^T.dz", 2 * m * hid * ff, lambda: fb._wgrad(x, dz), lambda: torch.matmul(x.t(), dz)),
        ]
        for name, flops, kernel, library in cases if device.type == "cuda" else ():  # card-only wrappers
            ms, lib_ms = _pair_ms(kernel, library, device, sz["reps"])
            rec = {"product": name, "rows": m, "ms": ms, "tflops": flops / ms / 1e9, "matmul_ms": lib_ms,
                   "matmul_tflops": flops / lib_ms / 1e9}
            out["products"].append(rec)
            print(f"[kernels] backward product {name}, M={m}: {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s); "
                  f"torch.matmul {lib_ms:.4f} ms ({rec['matmul_tflops']:.1f} TFLOP/s)")

        # the attention core alone, at the half's shapes
        d = hid // heads
        qkv, da = rand(b, l, 3 * hid), rand(b, l, hid)
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        q, k, v = (t.reshape(b, l, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        dah = da.reshape(b, l, heads, d).transpose(1, 2)
        got = fb.attention_core_bwd(qkv, mask, da, heads)
        want = torch.cat([t.transpose(1, 2).reshape(b, l, hid)
                          for t in fb._attention_core_plain(q, k, v, dah, mask, d ** -0.5)[1:]], dim=-1)
        err = grads_close(dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1))),
                          dict(zip(("dq", "dk", "dv"), want.chunk(3, dim=-1))))
        ms, plain_ms = _pair_ms(lambda: fb.attention_core_bwd(qkv, mask, da, heads),
                                lambda: fb._attention_core_plain(q, k, v, dah, mask, d ** -0.5), device, sz["reps"])
        flops = 10 * b * heads * l * l * d  # S, dP, dV, dQ, dK
        bound_ms, bound_by = bound(nbytes(qkv, mask, da, got), bf16=flops)
        rec = {"shape": [b, l, hid], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / ms / 1e9, "max_abs_err": err}
        out["attention_core"].append(rec)
        print(f"[kernels] attention-core backward B={b} L={l}: {ms:.4f} ms ({rec['tflops']:.1f} TFLOP/s of its five "
              f"products), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); dq/dk/dv within cosine "
              f"0.999 of plain (largest |d| {err:.4g})")
    return out


def _clustered(n, d, n_clusters, device, seed, n_queries):
    """Normalised clustered rows in contiguous clusters and queries near
    random rows (the recipe of tests/test_binmax_recall.py)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn(n_clusters, d, generator=g, device=device)
    centers = centers / centers.norm(dim=1, keepdim=True)
    assign = torch.sort(torch.randint(0, n_clusters, (n,), generator=g, device=device)).values
    rows = centers[assign] + 0.35 * torch.randn(n, d, generator=g, device=device)
    rows = rows / rows.norm(dim=1, keepdim=True)
    q = rows[torch.randint(0, n, (n_queries,), generator=g, device=device)]
    q = q + 0.05 * torch.randn(n_queries, d, generator=g, device=device)
    return rows, q / q.norm(dim=1, keepdim=True)


def _overlap(a, b):
    k = a.shape[1]
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a.tolist(), b.tolist())]))


def colbert_scan_check(out, sz, device):
    """K3 at ColBERT's token scan: 8,192 query rows (256 queries x 32
    tokens) of width colbert_dim over the phase's rows, per_bin 1,
    4096-row tiles, n_valid mid-bin: >= 99.9 % identical candidates against
    the plain version (run in 1,024-row query chunks), and both timed. Then
    K4 (width 128) and K6 (the top colbert_candidates) at ColBERT's
    per-token search over colbert_token_rows rows (the phase 4c index's
    1.35M): on the scan's own output, bit for bit against their plain
    versions, timed on the card (time_level2, time_unpack)."""
    import torch
    import torch.nn.functional as F

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    entry = out["binmax_candidates"]
    n, tile, dim = sz["scan_rows"], 4096, sz["colbert_dim"]
    n_q = sz["colbert_query_batch"] * sz["colbert_query_len"]
    rows, q = _clustered(n, dim, 256, device, seed=7, n_queries=n_q)
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    del rows
    n_valid = n - 1000

    def plain():
        return torch.cat([mb._scan_plain(qb[i:i + 1024], c, n_valid, 1, tile) for i in range(0, n_q, 1024)])

    got, want = mb.binmax_candidates(qb, c, n_valid=n_valid, per_bin=1, tile_rows=tile), plain()
    pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
    _, gi = mb._unpack_plain(got, pos, tile, 1)
    _, wi = mb._unpack_plain(want, pos, tile, 1)
    share = float((gi == wi).float().mean())
    del pos, gi, wi, want
    print(f"[kernels] binmax scan at ColBERT's token scan ({n_q} query rows x {dim}, per_bin 1, tiles of {tile}): "
          f"identical candidates {share:.6f}")
    check(share >= 0.999, f"binmax scan at ColBERT's shape: {share} identical")
    entry["colbert_shape_identical"] = share
    _record(entry, [n, dim, n_q, 1, tile],
            lambda: mb.binmax_candidates(qb, c, n_valid=n_valid, per_bin=1, tile_rows=tile), plain, device,
            max(2, sz["reps"] // 5), headline=False, bound_of=bound(nbytes(qb, c, got), bf16=2 * n_q * n * dim))
    del c, got

    # the per-token search's level 2 and unpack: the scan writes its
    # candidates -inf-padded to a multiple of 1,024 columns (binmax_candidates
    # with level2), so K4 takes them without a copy
    n_tok = sz["colbert_token_rows"]
    rows, _ = _clustered(n_tok, dim, 1024, device, seed=8, n_queries=1)
    tokens = rows.to(torch.bfloat16)
    del rows
    tokens = F.pad(tokens, (0, 0, 0, -n_tok % mb.padding_grain(tile, 1)))
    packed = mb.binmax_candidates(qb, tokens, n_valid=n_tok, per_bin=1, tile_rows=tile)
    packed = F.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf"))
    del tokens
    reps = max(2, sz["reps"] // 5)
    time_level2(out["level2_reduce"], mb, packed, mb.L2_WIDE, device, reps, headline=False)
    time_unpack(out["unpack_candidates"], mb, _build, mb._level2_reduce(packed, mb.L2_WIDE),
                sz["colbert_candidates"], tile, 1, mb.L2_WIDE, device, reps, headline=False)


def phase_binmax_kernels(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    n, tile = sz["scan_rows"], 2048
    rows, q = _clustered(n, sz["hid"], 256, device, seed=5, n_queries=sz["scan_queries"])
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    out = {"binmax_candidates": {"max_abs_err": 0.0}, "level2_reduce": {"max_abs_err": 0.0},
           "unpack_candidates": {"max_abs_err": 0.0}}
    packed = {}
    for per_bin in (2, 4, 8):
        got = mb.binmax_candidates(qb, c, n_valid=n, per_bin=per_bin)
        want = mb._scan_plain(qb, c, n, per_bin, tile)
        pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
        gv, gi = mb._unpack_plain(got, pos, tile, per_bin)
        wv, wi = mb._unpack_plain(want, pos, tile, per_bin)
        same = gi == wi
        err = float((gv - wv).abs()[same & torch.isfinite(wv)].max())
        share = float(same.float().mean())
        print(f"[kernels] binmax scan per_bin={per_bin}: identical candidates {share:.6f}, max |d| {err:.3g}")
        check(share >= 0.999, f"binmax scan per_bin {per_bin}: {share} identical")
        out["binmax_candidates"]["max_abs_err"] = max(out["binmax_candidates"]["max_abs_err"], err)
        _record(out["binmax_candidates"], [n, sz["hid"], sz["scan_queries"], per_bin],
                lambda pb=per_bin: mb.binmax_candidates(qb, c, n_valid=n, per_bin=pb),
                lambda pb=per_bin: mb._scan_plain(qb, c, n, pb, tile), device, sz["reps"], headline=per_bin == 8,
                bound_of=bound(nbytes(qb, c, got), bf16=2 * qb.shape[0] * n * sz["hid"]))
        packed[per_bin] = got
    # the product alone, a yardstick for the scan's tensor-core work, not a
    # bound: it writes the (Q, N) scores and selects nothing
    product_ms = _time_ms(lambda: torch.matmul(qb, c.T), device, sz["reps"])
    out["binmax_candidates"].update(product_library_ms=product_ms,
                                    product_library_call="torch.matmul(queries, corpus.T), bf16 (the product alone)")
    print(f"[kernels]   product alone: torch.matmul {product_ms:.4f} ms "
          f"({2 * qb.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TFLOP/s)")
    colbert_scan_check(out, sz, device)
    # K4 at both widths over the per_bin-8 candidates; K6 on the top k of the
    # width-32 reduction, and on the top 4k of the per_bin-4 candidates (the
    # two-stage route's fetch, no level 2)
    for width in (mb.L2_MID, mb.L2_WIDE):
        time_level2(out["level2_reduce"], mb, packed[8], width, device, sz["reps"], headline=width == mb.L2_MID)
    k = sz["scan_k"]
    time_unpack(out["unpack_candidates"], mb, _build, mb._level2_reduce(packed[8], mb.L2_MID), k, tile, 8, mb.L2_MID,
                device, sz["reps"], headline=True)
    time_unpack(out["unpack_candidates"], mb, _build, packed[4], 4 * k, tile, 4, None, device, sz["reps"],
                headline=False)
    # the whole scan through the kernels against the plain pipeline
    for per_bin, kk in ((2, k), (4, k), (8, k), (8, k // 10)):
        _, ids = mb.binmax_scan_topk(qb, c, kk, n_valid=n, per_bin=per_bin)
        n_cands = n // 128 * per_bin
        level2 = mb.L2_WIDE if n_cands >= 128 * kk else (mb.L2_MID if n_cands >= 16 * kk else None)
        plain = mb._scan_plain(qb, c, n, per_bin, tile)
        if level2:
            plain = mb._level2_plain(plain, level2)
        ptop, ppos = torch.topk(plain, kk, dim=1)
        _, pids = mb._unpack_plain(ptop, ppos, tile, per_bin, level2)
        ov = _overlap(ids.cpu().numpy(), pids.cpu().numpy())
        print(f"[kernels] binmax_scan_topk per_bin={per_bin} k={kk} level2={level2}: id overlap {ov:.6f}")
        check(ov >= 0.999, f"binmax top-{kk} overlap {ov} at per_bin {per_bin}")
    return out


def _int8_layer_params(sz, device, seed):
    """Per-column int8 codes and f32 scales of random f32 weights (the
    encoder quantizes its f32 parameters the same way), f32 biases and LN."""
    import torch

    from matchmaker_tpu_torch.ops.fused_int8 import quantize_weights_per_col

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]

    def q(rows, cols):
        return quantize_weights_per_col(torch.randn(rows, cols, generator=g, device=device) * rows ** -0.5)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = (*q(hid, hid), *q(hid, hid), *q(hid, hid), *q(hid, hid), v(hid, 0.02), v(hid, 0.02), v(hid, 0.02),
            v(hid, 0.02))
    mlp = (*q(hid, ff), v(ff, 0.02), *q(ff, hid), v(hid, 0.02))
    return attn, mlp, (v(hid, 0.1, 1.0), v(hid, 0.1)), (v(hid, 0.1, 1.0), v(hid, 0.1))


def _int8_kmajor(fi, attn, mlp):
    """The halves' weights as the encoder holds them: K-major codes, Q/K/V
    packed (attention: wqkv_t, sqkv, bqkv, wo_t, so, bo; MLP: w1_t, s1, b1,
    w2_t, s2, b2)."""
    w1q, s1, b1, w2q, s2, b2 = mlp
    return fi.kmajor_attention_weights(*attn), (fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q), s2, b2)


def _launch_parts_ms(fn, device, reps):
    """Each C launch of one call of ``fn`` alone: CUDA events around every
    ``_build.call`` over ``reps`` calls, queued behind a sleeping kernel so
    that the host's launch gaps do not reach the card's clock. Returns
    ([(entry point, mean ms)] in call order, mean ms of a whole call)."""
    import torch

    from matchmaker_tpu_torch.ops import _build

    if device.type != "cuda":  # the plain versions: no launches to time
        return [], _time_ms(fn, device, reps)
    real_call, events = _build.call, []

    def timed_call(entry, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real_call(entry, *args)
        end.record()
        events.append((entry, start, end))

    fn()
    torch.cuda.synchronize()
    begin, finish = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _build.call = timed_call
    try:
        torch.cuda._sleep(50_000_000)
        begin.record()
        for _ in range(reps):
            fn()
        finish.record()
    finally:
        _build.call = real_call
    torch.cuda.synchronize()
    n = len(events) // reps
    parts = [(events[j][0], sum(events[r * n + j][1].elapsed_time(events[r * n + j][2]) for r in range(reps)) / reps)
             for j in range(n)]
    return parts, begin.elapsed_time(finish) / reps


# the quantizations of each int8 half in launch order
INT8_QUANTS = {"fused_attention_int8_block": ("x quantization", "attention-output quantization (row, head group)"),
               "fused_mlp_int8_block": ("x quantization", "gelu-output quantization (row, FF chunk)")}


def int8_half_parts(fi, sz, b, l, device, reps, seed=12):
    """Where K10's and K9's time goes at (B, L): each launch alone (see
    _launch_parts_ms), each int8 product's TOP/s against the card's 1,979,
    and beside it one torch._int_mm call on codes of the same K-major shapes
    (a yardstick; the port never calls it). ``fi`` is a checkout's
    ``ops.fused_int8``; one without the K-major entry points (an earlier
    tree) runs its public functions."""
    import torch

    attn, mlp, ln1, ln2 = _int8_layer_params(sz, device, seed)
    x, mask, g = _half_inputs(sz, b, l, device, 300)
    heads, m = sz["heads"], b * l
    if hasattr(fi, "fused_mlp_int8_block_kmajor"):
        attn_t, mlp_t = _int8_kmajor(fi, attn, mlp)
        halves = {"fused_attention_int8_block":
                  lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, heads, *ln1),
                  "fused_mlp_int8_block": lambda: fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln2)}
    else:
        halves = {"fused_attention_int8_block": lambda: fi.fused_attention_int8_block(x, *attn, mask, heads, *ln1),
                  "fused_mlp_int8_block": lambda: fi.fused_mlp_int8_block(x, *mlp, *ln2)}
    dims = {"hid": sz["hid"], "3hid": 3 * sz["hid"], "ff": sz["ff"]}
    out = {}
    for name, fn in halves.items():
        launches, total = _launch_parts_ms(fn, device, reps)
        products, quants = list(HALF_PRODUCTS[name]), list(INT8_QUANTS[name])
        parts = []
        for entry, ms in launches:
            rec, note = {"entry": entry, "ms": ms}, ""
            if "gemm" in entry:
                label, k, n = products.pop(0)
                k, n = dims[k], dims[n]
                a = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
                w_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
                lib = _time_ms(lambda: torch._int_mm(a, w_t.t()), device, reps)
                ops = 2 * m * k * n
                rec.update(part=f"{label} product ({m} x {k} x {n})", tops=ops / ms / 1e9, int_mm_ms=lib,
                           int_mm_tops=ops / lib / 1e9, peak_share=ops / ms / 1e9 / (PEAK_OPS_PER_S["int8"] / 1e12))
                note = (f", {rec['tops']:.1f} TOP/s ({100 * rec['peak_share']:.1f} % of 1,979); torch._int_mm "
                        f"{rec['int_mm_ms']:.4f} ms ({rec['int_mm_tops']:.1f} TOP/s)")
            elif entry == "mm_quant_groups":
                rec["part"] = quants.pop(0)
            else:
                rec["part"] = HALF_OTHER_PARTS.get(entry, entry)
                if rec["part"] == "attention core":
                    note = _core_part(rec, sz, b, l, mask, g, device, reps)
            parts.append(rec)
            print(f"[kernels]   {name} part {rec['part']} ({entry}): {ms:.4f} ms{note}")
        print(f"[kernels]   {name} at {(b, l)}: {total:.4f} ms a call, {sum(r['ms'] for r in parts):.4f} ms in "
              f"its {len(parts)} launches")
        out[name] = {"parts": parts, "parts_total_ms": total}
    return out


def phase_int8_encoder_kernels(sz, device):
    """K10 and K9 against their plain versions at the encoder halves' shapes,
    held to K1/K2's bar (row cosine >= 0.999, max |d| <= 0.1) and to a mean
    |d| <= INT8_HALF_MEAN_ABS. The kernels run as the encoder runs them
    (K-major codes, Q/K/V packed); at the headline shape each launch is
    also timed alone (int8_half_parts)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_int8 as fi

    attn, mlp, ln1, ln2 = _int8_layer_params(sz, device, seed=12)
    attn_t, mlp_t = _int8_kmajor(fi, attn, mlp)
    out = {name: {"max_abs_err": 0.0, "mean_abs_err": 0.0}
           for name in ("fused_attention_int8_block", "fused_mlp_int8_block")}
    for i, (b, l) in enumerate(sz["layer_shapes"]):
        x, mask, _ = _half_inputs(sz, b, l, device, 300 + i)
        proj, core = _attention_ops(b, l, sz["hid"], sz["heads"])
        heads = sz["heads"]
        cases = (("fused_attention_int8_block",
                  lambda: fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, heads, *ln1),
                  lambda: fi.reference_attention_int8_block(x, *attn, mask, heads, *ln1),
                  (x, attn_t, mask, ln1), dict(int8=proj, bf16=core)),
                 ("fused_mlp_int8_block", lambda: fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln2),
                  lambda: fi.reference_mlp_int8_block(x, *mlp, *ln2), (x, mlp_t, ln2),
                  dict(int8=4 * b * l * sz["hid"] * sz["ff"])))
        for name, kernel, plain, inputs, ops in cases:
            got, want = kernel(), plain()
            cos, err = _rows_close(got, want)
            mean = _mean_abs(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}, mean |d| {mean:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            check(mean <= INT8_HALF_MEAN_ABS, f"{name} vs plain at {(b, l)}: mean |d| {mean} > {INT8_HALF_MEAN_ABS}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            out[name]["mean_abs_err"] = max(out[name]["mean_abs_err"], mean)
            _record(out[name], [b, l, sz["hid"]], kernel, plain, device, sz["reps"], headline=i == 0,
                    bound_of=bound(nbytes(inputs, got), **ops))
        if i == 0:
            for name, rec in int8_half_parts(fi, sz, b, l, device, sz["reps"]).items():
                out[name].update(rec)
    return out


def phase_int8_binmax_kernels(sz, device):
    """K8 (bf16 queries) and K7 (int8 query codes) against their plain
    versions over an int8 corpus: >= 99.9 % identical candidates."""
    import torch

    from matchmaker_tpu_torch.ops import mips_binmax as mb
    from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus_binwise, quantize_queries

    n, tile = sz["scan_rows"], 2048
    rows, q = _clustered(n, sz["hid"], 256, device, seed=6, n_queries=sz["scan_queries"])
    codes, scales = (torch.from_numpy(a).to(device) for a in quantize_corpus_binwise(rows.cpu().numpy()))
    del rows
    qb = q.to(torch.bfloat16)
    q8, qs = quantize_queries(q)
    out = {"binmax_candidates_int8f": {"max_abs_err": 0.0}, "binmax_candidates_int8": {"max_abs_err": 0.0}}
    cases = (("binmax_candidates_int8f", qb, None, "bf16",
              lambda pb: mb._scan_int8f_plain(qb, codes, scales, n, pb, tile)),
             ("binmax_candidates_int8", q8, qs, "int8",
              lambda pb: mb._scan_int8_plain(q8, codes, scales, qs, n, pb, tile)))
    for name, queries, q_scales, kind, plain in cases:
        for per_bin in (2, 4, 8):
            def kernel(pb=per_bin, qq=queries, qsc=q_scales):
                return mb.binmax_candidates(qq, codes, n_valid=n, per_bin=pb, corpus_scales=scales,
                                            query_scales=qsc)

            got, want = kernel(), plain(per_bin)
            pos = torch.arange(got.shape[1], device=device).expand_as(got).contiguous()
            gv, gi = mb._unpack_plain(got, pos, tile, per_bin)
            wv, wi = mb._unpack_plain(want, pos, tile, per_bin)
            same = gi == wi
            err = float((gv - wv).abs()[same & torch.isfinite(wv)].max())
            share = float(same.float().mean())
            bits = float((got.view(torch.int32) == want.view(torch.int32)).float().mean())
            print(f"[kernels] {name} per_bin={per_bin}: identical candidates {share:.6f}, max |d| {err:.3g}, "
                  f"bit-identical packed values {bits:.6f}")
            check(share >= 0.999, f"{name} per_bin {per_bin}: {share} identical")
            if q_scales is not None:  # K7: exact sums, the plain version's rounding and tie rule
                check(bits == 1.0, f"{name} per_bin {per_bin}: {bits} of the packed values bit-identical")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [n, sz["hid"], sz["scan_queries"], per_bin], kernel,
                    lambda pb=per_bin: plain(pb), device, sz["reps"], headline=per_bin == 8,
                    bound_of=bound(nbytes(queries, q_scales, codes, scales, got),
                                   **{kind: 2 * queries.shape[0] * n * sz["hid"]}))
    # the products alone, yardsticks for the scans' tensor-core work, not
    # bounds: they write the (Q, N) scores and select nothing
    c16 = codes.to(torch.bfloat16)
    product_ms = _time_ms(lambda: torch.matmul(qb, c16.T), device, sz["reps"])
    del c16
    out["binmax_candidates_int8f"].update(
        product_library_ms=product_ms, product_library_call="torch.matmul(queries, codes.to(bf16).T) (the product "
                                                            "alone)")
    print(f"[kernels]   product alone: torch.matmul of the bf16 codes {product_ms:.4f} ms "
          f"({2 * qb.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TFLOP/s)")
    if device.type == "cuda":  # torch._int_mm needs the card
        product_ms = _time_ms(lambda: torch._int_mm(q8, codes.T), device, sz["reps"])
        out["binmax_candidates_int8"].update(
            product_library_ms=product_ms, product_library_call="torch._int_mm(query codes, corpus codes.T) "
                                                                "(the product alone)")
        print(f"[kernels]   product alone: torch._int_mm {product_ms:.4f} ms "
              f"({2 * q8.shape[0] * n * sz['hid'] / product_ms / 1e9:.1f} TOP/s)")
    return out


def _maxsim_inputs(bq, lq, bd, ld, dim, below_fill, device, seed):
    """Random f32 token vectors and masks with zeros (one all-padding query
    row, one all-padding doc); ``below_fill``: every third doc's live dots
    below -1000 (raw ColBERT dots reach |s| ~ 7000)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bq, lq, dim, generator=g, device=device)
    d = torch.randn(bd, ld, dim, generator=g, device=device)
    if below_fill:
        q, d[::3] = q.abs() * 5, -d[::3].abs() * 40
    q_mask = (torch.rand(bq, lq, generator=g, device=device) > 0.2).float()
    d_mask = (torch.rand(bd, ld, generator=g, device=device) > 0.2).float()
    q_mask[:, 0] = d_mask[:, 0] = 1.0
    q_mask[-1, lq // 2:] = 0.0
    d_mask[-1] = 0.0
    return q, d, q_mask, d_mask


def _gathered_inputs(sz, device, seed):
    """The batched rescore's launch at the ColBERT run's shapes: a query
    batch (colbert_query_batch x colbert_query_len, width colbert_dim, 8
    padded query tokens in every fourth query), a float16 token matrix of
    ``passages`` documents of 1..T tokens (T the store's padded tokens,
    maxsim_shapes[2][3]) and each query's colbert_rescore_n candidate spans,
    drawn with replacement, on the CPU as maxsim_gathered takes them."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    b, lq, c, dim, pad = (sz["colbert_query_batch"], sz["colbert_query_len"], sz["colbert_rescore_n"],
                          sz["colbert_dim"], sz["maxsim_shapes"][2][3])
    counts = torch.randint(1, pad + 1, (sz["passages"],), generator=g, device=device)
    starts = torch.cumsum(counts, 0) - counts
    tokens = (torch.randn(int(counts.sum()), dim, generator=g, device=device) * 2).half()
    pick = torch.randint(0, sz["passages"], (b, c), generator=g, device=device)
    q = torch.randn(b, lq, dim, generator=g, device=device) * 2
    qm = torch.ones(b, lq, device=device)
    qm[::4, lq - 8:] = 0.0
    return q, qm, tokens, starts[pick].cpu(), counts[pick].int().cpu(), pad


def _k14_check(out, got, want, shape, fill):
    """K14 against its plain version: non-finite entries identical, the rest
    within rtol = atol = 1e-4 (the bar of tests/test_perf_ops.py:91)."""
    import torch

    fin = torch.isfinite(want)
    check(got.shape == want.shape and torch.equal(fin, torch.isfinite(got))
          and torch.equal(got[~fin], want[~fin]), f"K14 non-finite entries at {shape}")
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    rel_ok = bool(((got - want).abs()[fin] <= 1e-4 + 1e-4 * want.abs()[fin]).all())
    print(f"[kernels] maxsim {shape} fill {fill}: max |d| {err:.4g}, "
          f"max |plain| {float(want[fin].abs().max()) if bool(fin.any()) else 0.0:.4g}")
    check(rel_ok, f"K14 vs plain at {shape}: max |d| {err}")
    out["max_abs_err"] = max(out["max_abs_err"], err)


def phase_maxsim_kernel(sz, device):
    """K14 against its plain version, rtol = atol = 1e-4 (the bar of
    tests/test_perf_ops.py:91): the all-pairs form at the ColBERT shapes
    with fill -1000 and -inf (f32 docs), and the gathered form at the
    ColBERT run's batched rescore (its launch on the main path: 256 queries
    against their own 64 candidates of float16 token rows, fill -inf), the
    headline. Bound: the bytes, or the TF32 products the split issues (3 for
    f32 docs, 2 for float16) over the live (query token, doc token) pairs
    at the TF32 rate."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    out = {"maxsim_all_pairs": {"max_abs_err": 0.0}}
    entry = out["maxsim_all_pairs"]
    for i, (bq, lq, bd, ld, dim, fill, below) in enumerate(sz["maxsim_shapes"]):
        q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, below, device, seed=400 + i)
        got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
        want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
        _k14_check(entry, got, want, (bq, lq, bd, ld, dim), fill)
        check(torch.equal(got, ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)), f"K14 reruns differ at {(bq, lq)}")
        ops = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
        _record(entry, [bq, lq, bd, ld, dim], lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs(*a, fill=f),
                lambda a=(q, d, qm, dm), f=fill: ms.reference_maxsim_all_pairs(*a, f), device, sz["reps"],
                headline=False, bound_of=bound(nbytes(q, d, qm, dm, got), tf32=3 * ops))
    q, qm, tokens, first, count, pad = _gathered_inputs(sz, device, seed=409)
    fill = float("-inf")

    def plain():
        slots = torch.arange(pad, device=device)
        rows = first.to(device)[..., None] + slots
        live = (slots < count.to(device)[..., None]).float()
        return torch.stack([ms.reference_maxsim_all_pairs(q[i:i + 1], tokens[rows[i].clamp(max=len(tokens) - 1)]
                                                          .float(), qm[i:i + 1], live[i], fill)[0]
                            for i in range(q.shape[0])])

    got = ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill)
    shape = [q.shape[0], q.shape[1], first.shape[1], pad, q.shape[2]]
    _k14_check(entry, got, plain(), ("gathered", *shape), fill)
    check(torch.equal(got, ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill)),
          "K14's gathered form: reruns differ")
    live_q = (qm > 0).sum(1).double().cpu()
    ops = int(2 * q.shape[2] * float((live_q * count.double().sum(1)).sum()))
    # the token rows of the distinct spans, once each (a document drawn twice
    # is read from device memory once; its second use can come from L2)
    distinct = torch.unique(torch.stack([first.flatten(), count.flatten().long()], 1), dim=0)
    read = int(distinct[:, 1].sum()) * q.shape[2] * tokens.element_size()
    _record(entry, ["gathered", *shape], lambda: ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill),
            plain, device, sz["reps"], headline=True,
            bound_of=bound(read + nbytes(q, qm, first, count, got), tf32=2 * ops))
    entry["headline"] = ("the ColBERT run's batched rescore: one launch for a query batch against each query's own "
                         "candidates (float16 token spans)")
    return out


def _maxsim_training_inputs(bq, lq, bd, ld, dim, below_fill, ties, device, seed):
    """_maxsim_inputs' tensors; ``ties``: in every doc token 5 repeats token
    3, the sum of the batch's query rows, so the two tie exactly, for the
    kernel and the plain dots alike, at the max of many (query token, doc)
    pairs."""
    q, d, qm, dm = _maxsim_inputs(bq, lq, bd, ld, dim, below_fill, device, seed)
    if ties:
        d[:, 3] = q.sum(dim=(0, 1))
        d[:, 5] = d[:, 3]
        dm[:, 3] = dm[:, 5] = 1.0
    return q, d, qm, dm


def phase_maxsim_training(sz, device):
    """K14's training form (the all-pairs launch that also saves each (query
    token, doc)'s max doc token) and the backward kernel against plain
    autograd through reference_maxsim_all_pairs, at the ColBERT training
    phase's shape (the headline), an odd shape with live dots below -1000
    and a shape with exact ties. Gates: the forward at K14's bar (rtol =
    atol = 1e-4); the saved tokens equal to the plain argmax on >= 99.99 %
    of (b, l, k), every other one a near tie (|top1 - top2| <= 1e-5 |top1|);
    dq and dd within rtol = atol = 1e-4 on the query rows and docs whose
    tokens all agree; the tie's two rows equal dd; reruns bit-identical.
    Bounds: the training form as K14 (its TF32 products over the live
    pairs), plus its int32 tokens; the backward by its bytes (q, docs, the
    tokens and g read once, dq and dd written once) against its f32 FMAs
    over the (b, l, k) whose max is a live token. No single library call
    computes either."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    out = {name: {"max_abs_err": 0.0, "library_ms": None} for name in ("maxsim_all_pairs_argmax",
                                                                        "maxsim_all_pairs_bwd")}
    fwd, bwd = out["maxsim_all_pairs_argmax"], out["maxsim_all_pairs_bwd"]
    agreement = []
    for i, (bq, lq, bd, ld, dim, fill, below, ties) in enumerate(sz["maxsim_train_shapes"]):
        shape = [bq, lq, bd, ld, dim]
        q, d, qm, dm = _maxsim_training_inputs(bq, lq, bd, ld, dim, below, ties, device, seed=500 + i)
        g = torch.randn(bq, bd, generator=torch.Generator(device=device).manual_seed(7 + i), device=device)
        got, idx = ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill)
        want, want_idx, top1, top2 = ms.reference_maxsim_argmax(q, d, qm, dm, fill, with_top2=True)
        _k14_check(fwd, got, want, shape, fill)
        agree = idx == want_idx
        share = float(agree.float().mean())
        near = bool(((top1 - top2).abs() <= 1e-5 * top1.abs())[~agree].all())
        print(f"[kernels] maxsim training form {shape}: tokens agree on {share:.6f} of (b, l, k), "
              f"{int((~agree).sum())} differ, all near ties: {near}")
        check(share >= 0.9999 and near, f"K14's training form at {shape}: tokens agree on {share}, near ties {near}")
        dq, dd = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
        qg, dg = q.clone().requires_grad_(), d.clone().requires_grad_()
        ref = ms.reference_maxsim_all_pairs(qg, dg, qm, dm, fill)
        pq, pd = torch.autograd.grad(ref, (qg, dg), g, retain_graph=True)
        rows, docs = agree.all(dim=2), agree.all(dim=(0, 1))
        err = 0.0
        for name, a, b in (("dq", dq[rows], pq[rows]), ("dd", dd[docs], pd[docs])):
            close = bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all())
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
            check(close, f"the MaxSim backward's {name} at {shape}: max |d| {err}")
        check(bool((dd[dm <= 0] == 0).all()), f"a gradient reached a masked doc token at {shape}")
        if ties:
            check(bool(docs.all()) and bool((idx == 3).any()) and torch.equal(dd[:, 3], dd[:, 5])
                  and bool(dd[:, 3].abs().max() > 0), f"the exact ties did not split evenly at {shape}")
        again = ms.maxsim_all_pairs_argmax(q, d, qm, dm, fill)
        check(torch.equal(again[0], got) and torch.equal(again[1], idx), f"the training form's reruns differ at {shape}")
        again = ms.maxsim_all_pairs_bwd(q, d, qm, dm, idx, g)
        check(torch.equal(again[0], dq) and torch.equal(again[1], dd), f"the backward's reruns differ at {shape}")
        bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
        print(f"[kernels] maxsim backward {shape}: dq on {int(rows.sum())} of {rows.numel()} query rows, dd on "
              f"{int(docs.sum())} of {bd} docs, max |d| {err:.4g}; max |plain| dq "
              f"{float(pq.abs().max()):.4g}, dd {float(pd.abs().max()):.4g}")
        agreement.append({"shape": shape, "tokens_agree": share, "differ": int((~agree).sum()), "ties": ties})
        headline = i == 0
        live = 2 * dim * int((qm > 0).sum()) * int((dm > 0).sum())
        _record(fwd, shape, lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs_argmax(*a, f),
                lambda a=(q, d, qm, dm), f=fill: ms.reference_maxsim_argmax(*a, f), device, sz["reps"], headline,
                bound_of=bound(nbytes(q, d, qm, dm, got, idx), tf32=3 * live))
        _device_beside(fwd, lambda a=(q, d, qm, dm), f=fill: ms.maxsim_all_pairs_argmax(*a, f), device, headline)
        used = int(((g[:, None, :] * qm[:, :, None] != 0) & (idx >= 0)).sum())
        _record(bwd, shape, lambda a=(q, d, qm, dm, idx, g): ms.maxsim_all_pairs_bwd(*a),
                lambda a=(q, d, qm, dm, idx, g): ms.reference_maxsim_bwd(*a), device, sz["reps"], headline,
                bound_of=bound(nbytes(q, d, qm, dm, idx, g, dq, dd), f32=4 * dim * used))
        _device_beside(bwd, lambda a=(q, d, qm, dm, idx, g): ms.maxsim_all_pairs_bwd(*a), device, headline)
    fwd["headline"] = ("the ColBERT training phase's in-batch all-pairs MaxSim (32 queries x 30 tokens against "
                       "64 docs x 200), forward with each max's doc token saved")
    bwd["headline"] = "its backward at the same shape"
    fwd["token_agreement"] = agreement
    return out


def phase_mha_kernel(sz, device):
    """K13 (no caller on any path) against its plain version at 12 heads x
    64, held to the encoder halves' bar; library_ms: one
    scaled_dot_product_attention call with the same additive mask at the
    headline shape (a yardstick the port never calls)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import attn_inner as ai

    out = {"fused_mha": {"max_abs_err": 0.0}}
    heads, hid = sz["heads"], sz["hid"]
    for i, (b, l) in enumerate(sz["mha_shapes"]):
        g = torch.Generator(device=device).manual_seed(500 + i)
        q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        got, want = fa.fused_mha(q, k, v, mask, heads), fa.mha_reference(q, k, v, mask, heads)
        cos, err = _rows_close(got, want)
        print(f"[kernels] fused_mha B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
        check(got.shape == q.shape and bool(torch.isfinite(got.float()).all()), f"fused_mha output at {(b, l)}")
        check(cos >= 0.999 and err <= 0.1, f"fused_mha vs plain at {(b, l)}: cos {cos}, max |d| {err}")
        out["fused_mha"]["max_abs_err"] = max(out["fused_mha"]["max_abs_err"], err)
        ops = 4 * heads * (hid // heads) * l * int(mask.sum())  # QK^T and PV over the live keys
        _record(out["fused_mha"], [b, l, hid], lambda a=(q, k, v, mask): fa.fused_mha(*a, heads),
                lambda a=(q, k, v, mask): fa.mha_reference(*a, heads), device, sz["reps"], headline=i == 0,
                bound_of=bound(nbytes(q, k, v, mask, got), bf16=ops))
        if i == 0 and device.type == "cuda":
            lcos, _ = _rows_close(ai.sdpa(q, k, v, mask, heads), want)
            out["fused_mha"]["library_ms"] = _time_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device,
                                                      sz["reps"])
            print(f"[kernels]   library scaled_dot_product_attention {out['fused_mha']['library_ms']:.4f} ms "
                  f"(min row cosine to plain {lcos:.6f})")
    return out


# ---- phase 3, the probes' kernels (K15-K18) ---------------------------------

def _probe_mlp_weights(sz, device, seed):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    hid, ff = sz["hid"], sz["ff"]
    w1 = (torch.randn(hid, ff, generator=g, device=device) * hid ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn(ff, hid, generator=g, device=device) * ff ** -0.5).to(torch.bfloat16)
    b1, b2 = (torch.randn(n, generator=g, device=device) * 0.02 for n in (ff, hid))
    ln_scale = torch.randn(hid, generator=g, device=device) * 0.1 + 1.0
    ln_bias = torch.randn(hid, generator=g, device=device) * 0.1
    return w1, b1, w2, b2, ln_scale, ln_bias


def phase_probe_kernels(sz, device):
    """The probes' kernels against their plain versions at each probe's
    headline shape and an odd one. K15: each variant against its own plain
    version (f32_p against the f32-P one, the stub against the stub) at
    K13's bar; beside it K13's fused_mha and, as library_ms, one
    scaled_dot_product_attention call. K16: bit-identical, and equal to
    one torch._int_mm call on the same operands, its library_ms. K15, K16
    and their library calls also by device time (_device_ms) at both
    shapes, each kernel's with its multiple of the bound. K17/K18 at K2's
    bar, by device time at both shapes; no single library call computes the
    MLP half, so library_ms is None, and beside each wrapper's row stand the
    chain of bf16 torch.matmul calls (chain_ms, chain_device_ms) and K2
    (fused_mlp_block_ms, fused_mlp_block_device_ms). Bounds: the live keys'
    products (K15), the int8 products or the bytes (K16), the live rows'
    products (K17/K18)."""
    import torch

    from matchmaker_tpu_torch.ops import fused_attention as fa
    from matchmaker_tpu_torch.probes import attn_inner as ai
    from matchmaker_tpu_torch.probes import int8_matmul as im
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    out = {name: {"max_abs_err": 0.0} for name in ("attn_inner", "int8_matmul", "mlp_rows2d", "mlp_rowsblk")}
    hid, heads = sz["hid"], sz["heads"]
    on_card = device.type == "cuda"

    entry = out["attn_inner"]
    for i, (b, l, masked) in enumerate(sz["probe_attn_shapes"]):
        g = torch.Generator(device=device).manual_seed(600 + i)
        q, k, v = ((torch.randn(b, l, hid, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
        mask = torch.ones(b, l, device=device)
        if masked:
            lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
            mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        ops = 4 * hid * l * int(mask.sum())  # QK^T and PV over the live keys, every head
        for variant in ai.VARIANTS:
            got, want = ai.attn_inner(q, k, v, mask, variant, heads), ai.reference_attn_inner(q, k, v, mask, variant,
                                                                                              heads)
            cos, err = _rows_close(got, want)
            print(f"[kernels] attn_inner {variant} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == q.shape and bool(torch.isfinite(got.float()).all()), f"attn_inner {variant} output")
            check(cos >= 0.999 and err <= 0.1, f"attn_inner {variant} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            _record(entry, [b, l, hid, variant], lambda a=(q, k, v, mask), vr=variant: ai.attn_inner(*a, vr, heads),
                    lambda a=(q, k, v, mask), vr=variant: ai.reference_attn_inner(*a, vr, heads), device, sz["reps"],
                    headline=i == 0 and variant == "batched", bound_of=bound(nbytes(q, k, v, mask, got), bf16=ops))
            _device_beside(entry, lambda a=(q, k, v, mask), vr=variant: ai.attn_inner(*a, vr, heads), device,
                           headline=i == 0 and variant == "batched")
        # the yardsticks at this shape, beside each variant's row
        lib = {"fused_mha_ms": _time_ms(lambda a=(q, k, v, mask): fa.fused_mha(*a, heads), device, sz["reps"]),
               "fused_mha_device_ms": _device_ms(lambda a=(q, k, v, mask): fa.fused_mha(*a, heads), device),
               "library_ms": None, "library_device_ms": None}
        if on_card:
            lib.update(library_ms=_time_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device, sz["reps"]),
                       library_device_ms=_device_ms(lambda a=(q, k, v, mask): ai.sdpa(*a, heads), device))
        for timing in entry["timings"][-len(ai.VARIANTS):]:
            timing.update(lib)
        print(f"[kernels]   B={b} L={l}: K13 fused_mha device {_fmt(lib['fused_mha_device_ms'])}, events "
              f"{_fmt(lib['fused_mha_ms'])}; library scaled_dot_product_attention device "
              f"{_fmt(lib['library_device_ms'])}, events {_fmt(lib['library_ms'])}")
        if i == 0:
            entry.update(lib, library_call="torch.nn.functional.scaled_dot_product_attention, the same additive "
                                           "mask in bf16")
            # P kept f32 (hi + lo) against rounded to bf16, both against the f32-P plain version
            want = ai.reference_attn_inner(q, k, v, mask, "f32_p", heads)
            entry.update({f"{vr}_vs_f32_plain_mean_abs": _mean_abs(ai.attn_inner(q, k, v, mask, vr, heads), want)
                          for vr in ("f32_p", "batched")})
            print(f"[kernels]   mean |d| to the f32-P plain version: f32_p {entry['f32_p_vs_f32_plain_mean_abs']:.4g}, "
                  f"batched {entry['batched_vs_f32_plain_mean_abs']:.4g}")

    entry = out["int8_matmul"]
    for i, (m, k, n) in enumerate(sz["probe_int8_shapes"]):
        g = torch.Generator(device=device).manual_seed(700 + i)
        xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
        wq_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
        got = im.int8_matmul(xq, wq_t)
        check(torch.equal(got, im.reference_int8_matmul(xq, wq_t)), f"int8_matmul not bit-identical at {(m, k, n)}")
        print(f"[kernels] int8_matmul {(m, k, n)}: bit-identical to the plain version")
        _record(entry, [m, k, n], lambda a=(xq, wq_t): im.int8_matmul(*a),
                lambda a=(xq, wq_t): im.reference_int8_matmul(*a), device, sz["reps"], headline=i == 0,
                bound_of=bound(nbytes(xq, wq_t, got), int8=2 * m * k * n))
        _device_beside(entry, lambda a=(xq, wq_t): im.int8_matmul(*a), device, headline=i == 0)
        if on_card:
            check(torch.equal(torch._int_mm(xq, wq_t.T), got),
                  f"torch._int_mm disagrees with the kernel at {(m, k, n)}")
            lib = {"library_ms": _time_ms(lambda a=(xq, wq_t): torch._int_mm(a[0], a[1].T), device, sz["reps"]),
                   "library_device_ms": _device_ms(lambda a=(xq, wq_t): torch._int_mm(a[0], a[1].T), device)}
            entry["timings"][-1].update(lib)
            if i == 0:
                entry.update(lib, library_call="torch._int_mm(xq, wq_t.T): the same operands, B K-major")
            print(f"[kernels]   library torch._int_mm device {_fmt(lib['library_device_ms'])}, events "
                  f"{_fmt(lib['library_ms'])}")
        del xq, wq_t, got

    weights = _probe_mlp_weights(sz, device, 800)
    for i, (b, l) in enumerate(sz["probe_mlp_shapes"]):
        g = torch.Generator(device=device).manual_seed(810 + i)
        x = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
        want = mr.reference_mlp_rows(x, *weights)
        ops = 4 * b * l * hid * sz["ff"]
        for name, fn in (("mlp_rows2d", mr.mlp_rows2d), ("mlp_rowsblk", mr.mlp_rowsblk)):
            got = fn(x, *weights)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, hid], lambda f=fn: f(x, *weights), lambda: mr.reference_mlp_rows(x, *weights),
                    device, sz["reps"], headline=i == 0, bound_of=bound(nbytes(x, weights, got), bf16=ops))
            _device_beside(out[name], lambda f=fn: f(x, *weights), device, headline=i == 0)
        # the yardsticks at this shape, beside each wrapper's row
        lib = {"chain_ms": _time_ms(lambda: mr.matmul_chain(x, *weights), device, sz["reps"]),
               "chain_device_ms": _device_ms(lambda: mr.matmul_chain(x, *weights), device),
               "fused_mlp_block_ms": _time_ms(lambda: fa.fused_mlp_block(x, *weights), device, sz["reps"]),
               "fused_mlp_block_device_ms": _device_ms(lambda: fa.fused_mlp_block(x, *weights), device),
               "library_ms": None}
        for name in ("mlp_rows2d", "mlp_rowsblk"):
            out[name]["timings"][-1].update(lib)
            if i == 0:
                out[name].update(lib)
        print(f"[kernels]   B={b} L={l}: bf16 torch.matmul chain device {_fmt(lib['chain_device_ms'])}, events "
              f"{_fmt(lib['chain_ms'])}; K2 fused_mlp_block device {_fmt(lib['fused_mlp_block_device_ms'])}, events "
              f"{_fmt(lib['fused_mlp_block_ms'])}")
    return out


# ---- phase 4: the main path through the CLI --------------------------------

def _write_collection(root, sz, seed=1):
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(20_000)])
    lens = rng.integers(40, 121, size=sz["passages"])
    passages = [" ".join(words[rng.integers(0, len(words), size=n)]) for n in lens]
    with open(os.path.join(root, "collection.tsv"), "w") as f:
        for i, p in enumerate(passages):
            f.write(f"{i}\t{p}\n")
    targets = rng.choice(sz["passages"], size=sz["queries"], replace=False)
    with open(os.path.join(root, "queries.tsv"), "w") as fq, open(os.path.join(root, "qrels.txt"), "w") as fr:
        for qi, t in enumerate(targets):
            toks = passages[t].split()
            fq.write(f"{qi}\t{' '.join(rng.choice(toks, size=int(rng.integers(3, 7))))}\n")
            fr.write(f"{qi} 0 {t} 1\n")


def _main_config(root, sz, device):
    return {
        "model": "bert_dot", "bert_pretrained_model": sz["model_name"], "random_seed": 1234,
        "use_fp16": True, "encoder_fused_attention": True,
        "faiss_index_type": "flat", "mips_quantization": "float16", "mips_kernel": "binmax",
        "token_dtype": "float16", "collection_tsv": os.path.join(root, "collection.tsv"),
        "collection_batch_size": sz["batch"], "max_doc_length": sz["doc_len"], "max_query_length": 30,
        "device": str(device),
        "query_sets": {name: {"queries_tsv": os.path.join(root, "queries.tsv"),
                              "qrels": os.path.join(root, "qrels.txt"), "top_n": sz[key],
                              "binarization_point": 1} for name, key, _ in QUERY_SETS},
    }


# run-file name, its top_n, its recall floor against an exact search: the
# top-100 set takes level 1 only (floor of tests/test_binmax_recall.py:62),
# the top-10 set the keep-8/32 level 2 (floor of tests/test_binmax_recall.py:99)
QUERY_SETS = (("dev", "top_n", 0.97), ("dev_top10", "top_n_small", 0.95))


@contextlib.contextmanager
def plain_encoder_blocks():
    """Route the encoder's fused halves to their plain versions: the plain
    forwards, and under autograd the plain forwards differentiated by
    PyTorch (in place of K1/K2 with K12/K11)."""
    import matchmaker_tpu_torch.models.encoder as enc
    from matchmaker_tpu_torch.ops import fused_attention as fa

    def plain_attention(x, wqkv, bqkv, wo, bo, *rest):
        wq, wk, wv = wqkv.chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return fa.reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, *rest)

    names = ("fused_attention_block_qkv", "fused_mlp_block", "fused_attention_block_qkv_train",
             "fused_mlp_block_train")
    saved = {n: getattr(enc, n) for n in names}
    for n, fn in zip(names, (plain_attention, fa.reference_mlp_block) * 2):
        setattr(enc, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(enc, n, fn)


def _encode_file(model, config, tokenizer, path, seq_type, batch, device, limit=None):
    import torch

    from matchmaker_tpu_torch.data.loaders import single_sequence_loader

    cfg = dict(config, batch_size_inference=batch)
    vecs, ids = [], []
    for b, sids in single_sequence_loader(cfg, tokenizer, path, seq_type):
        with torch.inference_mode():
            v = model.encode(torch.from_numpy(b["seq_ids"]).to(device), torch.from_numpy(b["seq_mask"]).to(device),
                             seq_type + "_encode")
        vecs.append(v[:len(sids)].float())
        ids += sids
        if limit and len(ids) >= limit:
            break
    return torch.cat(vecs), ids


def phase_main_path(sz, device, root):
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    _write_collection(root, sz)
    config = _main_config(root, sz, device)
    run_folder = os.path.join(root, "run")
    os.makedirs(run_folder)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), run_folder) == 0, "run() returned non-zero")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    result = {"wall_s": wall, "launches": launches}
    print(f"[main] launches in the CLI run: {launches}")

    for rel in ("efficiency-metrics.json", "encoded/encode_meta.json", "index/flat_vectors.npy",
                "index/flat_ids.npy") + tuple(f"{name}-{kind}" for name, _, _ in QUERY_SETS
                                              for kind in ("output.txt", "metrics.csv")):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel}")
    rankings = {}
    for name, key, _ in QUERY_SETS:
        ranking = rankings[name] = {}
        with open(os.path.join(run_folder, f"{name}-output.txt")) as f:
            for line in f:
                qid, did, _, score = line.split()
                ranking.setdefault(qid, []).append(did)
        check(len(ranking) == sz["queries"] and all(len(v) == sz[key] for v in ranking.values()),
              f"every query of {name} must have {sz[key]} hits")
    if device.type == "cuda":
        for name in SERVING:  # every kernel of the path, level 2 through the top-10 set
            check(launches[name] > 0, f"the main path launched no {name} kernel")
    with open(os.path.join(run_folder, "efficiency-metrics.json")) as f:
        perf = json.load(f)[-1]["blocks"]
    result["encode_psg_per_s"] = perf["encode"]["items_per_second"]
    result["search_qps"] = perf["search_total"]["items_per_second"]
    result["metrics"] = {}
    for name, _, _ in QUERY_SETS:
        with open(os.path.join(run_folder, f"{name}-metrics.csv")) as f:
            head, vals = [line.strip().split(",") for line in f][:2]
        result["metrics"][name] = dict(zip(head, map(float, vals)))

    # exact search over the same bf16-rounded rows and queries
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    q_vecs, qids = _encode_file(model, config, tokenizer, os.path.join(root, "queries.tsv"), "query", 32, device)
    check(bool(torch.isfinite(q_vecs).all()), "query vectors not finite")
    vectors, row_ids = load_encoded(os.path.join(run_folder, "encoded"))
    check(vectors.shape == (sz["passages"], sz["hid"]) and bool(np.isfinite(vectors).all()), "encoded vectors")
    rows = torch.from_numpy(vectors).to(device).to(torch.bfloat16).float()
    with torch.inference_mode():
        scores = q_vecs.to(torch.bfloat16).float() @ rows.T
    col_std = scores.std(dim=1).mean().item()
    for name, key, floor in QUERY_SETS:
        k = sz[key]
        top = torch.topk(scores, k, dim=1)
        exact = {qid: [str(row_ids[i]) for i in idx] for qid, idx in zip(qids, top.indices.cpu().tolist())}
        recall = float(np.mean([len(set(exact[q]) & set(rankings[name][q])) / k for q in exact]))
        spread = (top.values[:, 0] - top.values[:, -1]).mean().item()
        print(f"[main] {name}: recall@{k} vs exact bf16 search {recall:.4f}; mean top-1 score "
              f"{top.values[:, 0].mean().item():.4f}, mean top-1 - top-{k} score spread {spread:.4f}, "
              f"mean per-query score std {col_std:.4f}")
        result[f"recall@{k}"] = recall
        result[f"top_spread@{k}"] = spread
        check(recall >= floor, f"{name}: recall@{k} {recall} < {floor}")
    result["score_std"] = col_std

    # re-encode passages with the plain versions on the same device
    coll = os.path.join(root, "collection.tsv")
    k_vecs, _ = _encode_file(model, config, tokenizer, coll, "doc", sz["batch"], device, limit=sz["batch"])
    with plain_encoder_blocks():
        p_vecs, _ = _encode_file(model, config, tokenizer, coll, "doc", sz["batch"], device, limit=sz["batch"])
    cos, err = _rows_close(k_vecs, p_vecs)
    print(f"[main] re-encode of {len(k_vecs)} passages, kernels vs plain: min cosine {cos:.6f}, max |d| {err:.4g}")
    result.update(reencode_min_cos=cos, reencode_max_abs=err)
    check(cos >= 0.999, f"re-encode cosine {cos}")

    # encoder throughput at the main path's batch, device time only
    batch_ids = torch.randint(104, sz["vocab"], (sz["batch"], sz["doc_len"]), device=device)
    batch_mask = torch.ones(sz["batch"], sz["doc_len"], device=device)

    def encode_once():
        with torch.inference_mode():
            model.encode(batch_ids, batch_mask, "doc_encode")

    ms = _time_ms(encode_once, device, sz["reps"])
    result["encode_device_psg_per_s"] = sz["batch"] / ms * 1e3
    return result


# the int8 serving runs: encoder_int8 with an int8 index, searched with bf16
# queries against the codes (K8), then with int8 queries and the exact
# rescore (K7 + rescore)
INT8_RUNS = (("mixed", {"mips_int8_queries": "float"}, "binmax_candidates_int8f"),
             ("int8_twostage", {"mips_int8_queries": "int8", "mips_twostage": True}, "binmax_candidates_int8"))
# phase 5b also searches the default int8 route (int8 queries, K7 alone);
# its recall is reported, not gated: K7 is bit-identical to its plain version
SCALE_INT8_RUNS = INT8_RUNS + (("int8", {"mips_int8_queries": "int8"}, "binmax_candidates_int8"),)
GATED_INT8_RUNS = {name for name, _, _ in INT8_RUNS}


def predicted_int8_serving_launches(sz):
    """K9/K10 launch once per layer and encode batch: the collection's
    batches and each query set's batches of 32 (the CLI's query_batch_size)."""
    batches = -(-sz["passages"] // sz["batch"]) + len(QUERY_SETS) * -(-sz["queries"] // 32)
    return sz["n_layers"] * batches


def phase_main_path_int8(sz, device, root, bf16_run):
    """The int8 serving path through cli.dense_retrieval.run on phase 4's
    collection: launch counts; recall against an exact search of the
    unquantized encoded rows and against one of the rows the int8 index
    holds (the encoded rows' codes times their bin scales, which both
    routes' final scores are exact products of), each held to the bf16
    route's floors; the cosine of the int8-encoded vectors to phase 4's bf16
    encode; device-only encode psg/s with the int8 halves."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.encode import load_encoded
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    base = dict(_main_config(root, sz, device), encoder_int8=True, mips_quantization="int8")
    result = {}
    vectors = row_ids = None
    for name, extra, scan in INT8_RUNS:
        config = dict(base, **extra)
        folder = os.path.join(root, f"run_{name}")
        os.makedirs(folder)
        fresh_perf_monitor()
        _build.reset_launches()
        t0 = time.perf_counter()
        check(run("encode+index+search", dict(config), folder) == 0, f"int8 run {name} returned non-zero")
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        out = result[name] = {"wall_s": time.perf_counter() - t0, "launches": launches}
        print(f"[main-int8] {name}: launches {launches}")
        if device.type == "cuda":
            want = predicted_int8_serving_launches(sz)
            for k in ("fused_attention_int8_block", "fused_mlp_int8_block"):
                check(launches[k] == want, f"{name}: {k} launched {launches[k]} times, predicted {want}")
            check(launches["fused_attention_block"] == launches["fused_mlp_block"] == 0,
                  f"{name}: a bf16 encoder half ran in the int8 encode")
            needed = (scan, "unpack_candidates") + (("level2_reduce",) if name == "mixed" else ())
            for k in needed:
                check(launches[k] > 0, f"{name}: the int8 path launched no {k} kernel")
        with open(os.path.join(folder, "efficiency-metrics.json")) as f:
            perf = json.load(f)[-1]["blocks"]
        out.update(encode_psg_per_s=perf["encode"]["items_per_second"],
                   search_qps=perf["search_total"]["items_per_second"])
        if vectors is None:
            vectors, row_ids = load_encoded(os.path.join(folder, "encoded"))
            check(vectors.shape == (sz["passages"], sz["hid"]) and bool(np.isfinite(vectors).all()),
                  "int8-encoded vectors")
        out["rankings"] = {}
        for qname, _, _ in QUERY_SETS:
            ranking = out["rankings"][qname] = {}
            with open(os.path.join(folder, f"{qname}-output.txt")) as f:
                for line in f:
                    qid, did, _, _ = line.split()
                    ranking.setdefault(qid, []).append(did)

    # per-passage cosine against phase 4's bf16-kernel encode of the same passages
    bf16_vectors, bf16_ids = load_encoded(os.path.join(bf16_run, "encoded"))
    check(list(bf16_ids) == list(row_ids), "the two encodes list the passages in another order")
    a, b = torch.from_numpy(vectors).float(), torch.from_numpy(bf16_vectors).float()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())
    result["vs_bf16_min_cos"] = cos
    print(f"[main-int8] int8 vs bf16 encode of {len(a)} passages: min cosine {cos:.6f}")
    check(cos >= 0.99, f"int8-encoded passages vs the bf16 encode: min cosine {cos}")

    # exact searches with the int8 encoder's queries: over the rows the index
    # holds (its permuted codes times bin scales) and over the encoded rows
    config = dict(base, **INT8_RUNS[0][1])
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    q_vecs, qids = _encode_file(model, config, tokenizer, os.path.join(root, "queries.tsv"), "query", 32, device)
    index = FlatIndex(config, device)
    index.index(row_ids, vectors)
    index._ensure_device()
    codes, bin_scales, _ = index._device_vectors
    held = (codes.float() * bin_scales[:, 0].repeat_interleave(128)[:, None])[:len(row_ids)]
    qf = q_vecs.to(torch.bfloat16).float()
    with torch.inference_mode():
        exact_scores = {"held": (qf @ held.T, index.row_ids),
                        "encoded": (qf @ torch.from_numpy(vectors).to(device).to(torch.bfloat16).float().T, row_ids)}
    for name, _, _ in INT8_RUNS:
        for qname, key, floor in QUERY_SETS:
            k = sz[key]
            ranking = result[name]["rankings"][qname]
            for against, (scores, ids) in exact_scores.items():
                top = torch.topk(scores, k, dim=1).indices.cpu().tolist()
                exact = {qid: [str(ids[i]) for i in idx] for qid, idx in zip(qids, top)}
                recall = float(np.mean([len(set(exact[q]) & set(ranking[q])) / k for q in exact]))
                result[name][f"recall@{k}_vs_{against}"] = recall
                print(f"[main-int8] {name} {qname}: recall@{k} vs exact search of the {against} rows {recall:.4f}")
                check(recall >= floor, f"int8 {name} {qname}: recall@{k} vs the {against} rows {recall} < {floor}")
        del result[name]["rankings"]

    batch_ids = torch.randint(104, sz["vocab"], (sz["batch"], sz["doc_len"]), device=device)
    batch_mask = torch.ones(sz["batch"], sz["doc_len"], device=device)

    def encode_once():
        with torch.inference_mode():
            model.encode(batch_ids, batch_mask, "doc_encode")

    ms = _time_ms(encode_once, device, sz["reps"])
    result["encode_device_psg_per_s"] = sz["batch"] / ms * 1e3
    print(f"[main-int8] device-only encode with the int8 halves at {sz['batch']}x{sz['doc_len']}: "
          f"{result['encode_device_psg_per_s']:.1f} psg/s")
    if device.type == "cuda":
        result["encode_profile"] = _profile_steps(lambda _: encode_once(), None, ms, tag="main-int8")
    return result


# ---- phase 4c: ColBERT serving through the same CLI --------------------------

def _colbert_config(root, sz, device):
    """The DistilBERT-width ColBERT of configs/train/models/colbert.yaml
    (compression 128, 8 query [MASK]s), bf16 fused layers, random weights
    from a seed; a binmax token index with the CLI's ColBERT defaults
    (per_bin 1, 4096-row tiles, 48 candidates a token, the device merge) and
    the exact rescore of 64 candidates."""
    return dict(_main_config(root, sz, device), model="colbert", colbert_compression_dim=sz["colbert_dim"],
                query_augment_mask_number=8, max_query_length=sz["colbert_query_len"],
                query_batch_size=sz["colbert_query_batch"], colbert_rescore_n=sz["colbert_rescore_n"],
                query_sets={"colbert": {"queries_tsv": os.path.join(root, "queries.tsv"),
                                        "qrels": os.path.join(root, "qrels.txt"), "top_n": sz["colbert_top_n"],
                                        "binarization_point": 1}})


def predicted_colbert_launches(sz):
    """K1/K2 once per layer and encode batch (the collection's and the
    queries'); K3, K4 (the pool oversamples 48 by >= 128x) and K6 once per
    query batch; K14 once per query batch (the batched rescore); K13 and
    every kernel not named here never."""
    q_batches = -(-sz["queries"] // sz["colbert_query_batch"])
    encode = sz["n_layers"] * (-(-sz["passages"] // sz["batch"]) + q_batches)
    return {"fused_attention_block": encode, "fused_mlp_block": encode, "binmax_candidates": q_batches,
            "level2_reduce": q_batches, "unpack_candidates": q_batches, "maxsim_all_pairs": q_batches,
            "fused_mha": 0}


def _padded_docs(folder, device):
    """Every stored document's token vectors as one padded (N, T, D) f32
    tensor with its mask and ids (T the store's padded max tokens)."""
    import torch

    from matchmaker_tpu_torch.retrieval.encode import load_encoded

    with open(os.path.join(folder, "encode_meta.json")) as f:
        n_blocks = json.load(f)["blocks"]
    sizes = [np.load(os.path.join(folder, f"token_reps_{i}.npy"), mmap_mode="r").shape[0] for i in range(n_blocks)]
    base = np.cumsum([0] + sizes)
    data = np.load(os.path.join(folder, "doc_infos.npz"), allow_pickle=True)
    ids, spans = data["ids"], data["spans"]
    vectors, _ = load_encoded(folder)
    starts = base[spans[:, 0]] + spans[:, 1]
    lengths = spans[:, 2] - spans[:, 1]
    t = -(-int(lengths.max()) // 8) * 8
    doc = np.repeat(np.arange(len(ids)), lengths)
    pos = np.arange(len(doc)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    rows = np.repeat(starts, lengths) + pos
    docs = torch.zeros((len(ids), t, vectors.shape[1]), dtype=torch.float32, device=device)
    mask = torch.zeros((len(ids), t), dtype=torch.float32, device=device)
    di, pi = torch.from_numpy(doc).to(device), torch.from_numpy(pos).to(device)
    docs[di, pi] = torch.from_numpy(vectors[rows]).to(device).float()
    mask[di, pi] = 1.0
    return docs, mask, [str(x) for x in ids]


def token_recall_causes(q, corpus, found, k, bin_rows=128, keep=8, group=128):
    """Why a per-token binmax search (per_bin 1, keep-8-of-128 level 2)
    misses rows of the exact top k: ``q`` (T, D) query rows as searched,
    ``corpus`` (N, D) the index's rows in its own order, ``found`` (T, k)
    the search's rows. Counts over all T tokens: the misses; the exact top
    k's rows that share a 128-row bin with a better one (level 1 keeps one
    a bin: level1_collisions); the rows of bins past the 8th best in one
    level-2 group of 128 bins (with per_bin 1 a candidate's column is its
    bin: level2_overflow); the tokens whose k-th and (k+1)-th exact scores
    tie; the found rows outside the exact top k that score exactly the
    k-th score (a tie swapped, no loss); the other misses that such a found
    row passed in the final top-k because their scores agree once the low
    14 mantissa bits, where levels 1 and 2 pack their offsets, are dropped
    (packing_order); and the misses none of these explains."""
    import torch

    def packed(x):  # a score as the final top-k of packed candidates compares it
        return (x.contiguous().view(torch.int32) & ~0x3FFF).view(torch.float32)

    out = dict.fromkeys(("misses", "level1_collisions", "level2_overflow", "ties_at_k", "tie_swaps",
                         "packing_order", "unexplained"), 0)
    out.update(tokens=int(q.shape[0]), k=k)
    for s in range(0, q.shape[0], 512):
        scores = q[s:s + 512] @ corpus.T
        top_vals, top = torch.topk(scores, k + 1, dim=1)
        exact, kth = top[:, :k].cpu().numpy(), top_vals[:, k - 1]
        out["ties_at_k"] += int((top_vals[:, k] == kth).sum())
        got_scores = scores.gather(1, torch.from_numpy(np.clip(found[s:s + 512], 0, None)).to(scores.device))
        for row, (e, f) in enumerate(zip(exact.tolist(), found[s:s + 512].tolist())):
            lost, bins, per_group = set(), set(), {}
            for r in e:  # best first
                b = r // bin_rows
                if b in bins:
                    lost.add(r)
                    out["level1_collisions"] += 1
                    continue
                bins.add(b)
                per_group[b // group] = per_group.get(b // group, 0) + 1
                if per_group[b // group] > keep:
                    lost.add(r)
                    out["level2_overflow"] += 1
            missed = sorted(set(e) - set(f) - lost)
            out["misses"] += len(set(e) - set(f))
            swapped = [j for j, r in enumerate(f) if r >= 0 and r not in set(e)]
            passed = 0
            if swapped:
                out["tie_swaps"] += int((got_scores[row, swapped] == kth[row]).sum())
                if missed:
                    top_swapped = packed(got_scores[row, swapped]).max()
                    passed = int((packed(scores[row, missed]) <= top_swapped).sum())
            out["packing_order"] += passed
            out["unexplained"] += len(missed) - passed
    return out


def phase_colbert(sz, device, root):
    """ColBERT serving, ``cli.dense_retrieval.run("encode+index+search")``
    on phase 4's collection and queries: run-folder files, token rows and
    the index's device bytes, the launch count of every kernel against
    predicted_colbert_launches; for one query batch, per-token recall@48 of
    ``search_rows`` against an exact search of the same bf16 token rows
    (>= 0.95, tests/test_binmax_recall.py:99) and the device merge against
    the host merge; every (query, doc, score) of the run file for 32 queries
    against the plain exact MaxSim of the re-encoded query and the stored
    document (rtol 1e-4); recall@10 of the run against an exhaustive exact
    MaxSim over every passage through K14 (reported, not gated); encode
    psg/s and search QPS through the CLI, device-only per-token search QPS."""
    import torch

    from matchmaker_tpu_torch.cli.dense_retrieval import run
    from matchmaker_tpu_torch.data.loaders import single_sequence_loader
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import maxsim as ms
    from matchmaker_tpu_torch.retrieval import colbert_search as cs
    from matchmaker_tpu_torch.retrieval.encode import load_encoded
    from matchmaker_tpu_torch.retrieval.indexes import build_index

    config = _colbert_config(root, sz, device)
    folder = os.path.join(root, "run_colbert")
    os.makedirs(folder)
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    check(run("encode+index+search", dict(config), folder) == 0, "ColBERT run() returned non-zero")
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    result = {"wall_s": time.perf_counter() - t0, "launches": launches}
    print(f"[colbert] launches in the CLI run: {launches}")
    for rel in ("efficiency-metrics.json", "encoded/encode_meta.json", "encoded/doc_infos.npz",
                "index/flat_vectors.npy", "index/flat_ids.npy", "colbert-output.txt", "colbert-metrics.csv"):
        check(os.path.isfile(os.path.join(folder, rel)), f"colbert: missing {rel}")
    if device.type == "cuda":
        want = dict.fromkeys(launches, 0)  # every other kernel: none
        want.update(predicted_colbert_launches(sz))
        for name, n in want.items():
            check(launches[name] == n, f"colbert: {name} launched {launches[name]} times, predicted {n}")
    with open(os.path.join(folder, "efficiency-metrics.json")) as f:
        perf = json.load(f)[-1]["blocks"]
    result.update(encode_psg_per_s=perf["encode"]["items_per_second"],
                  search_qps=perf["search_total"]["items_per_second"],
                  search_blocks_s={k: perf[k]["total_seconds"] for k in perf if k.startswith("search_")})
    print(f"[colbert] CLI search blocks (s): {result['search_blocks_s']}")
    with open(os.path.join(folder, "colbert-metrics.csv")) as f:
        head, vals = [line.strip().split(",") for line in f][:2]
    result["metrics"] = dict(zip(head, map(float, vals)))
    run_file = {}
    with open(os.path.join(folder, "colbert-output.txt")) as f:
        for line in f:
            qid, did, _, score = line.split()
            run_file.setdefault(qid, []).append((did, float(score)))
    check(len(run_file) == sz["queries"] and all(len(v) == sz["colbert_top_n"] for v in run_file.values()),
          f"colbert: every query must have {sz['colbert_top_n']} hits")

    # the token index as the CLI built it (the same config, rows and permutation)
    enc = os.path.join(folder, "encoded")
    vectors, row_ids = load_encoded(enc)
    check(vectors.shape[1] == sz["colbert_dim"] and bool(np.isfinite(vectors).all()), "colbert token vectors")
    index_cfg = dict(config, mips_per_bin=1, mips_tile_rows=4096)
    index = build_index(index_cfg, device)
    index.prepare(vectors.shape[1])
    index.index(row_ids, vectors)
    index._ensure_device()
    result.update(token_rows=int(vectors.shape[0]), tokens_per_passage=vectors.shape[0] / sz["passages"],
                  index_device_bytes=index._device_vectors.numel() * index._device_vectors.element_size())
    print(f"[colbert] {result['token_rows']} token rows ({result['tokens_per_passage']:.2f} a passage), "
          f"index on the device {result['index_device_bytes'] / 1e9:.3f} GB")

    # the queries re-encoded as the CLI encodes them (one batch of 256)
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(config["random_seed"]))
    model.to(device).eval()
    cfg_q = dict(config, batch_size_inference=sz["colbert_query_batch"])
    batch, qids = next(iter(single_sequence_loader(cfg_q, tokenizer, os.path.join(root, "queries.tsv"), "query")))
    with torch.inference_mode():
        q_vecs = model.encode(torch.from_numpy(batch["seq_ids"]).to(device),
                              torch.from_numpy(batch["seq_mask"]).to(device), "query_encode").float()
    q_mask = batch["seq_mask"]
    b, lq, dim = q_vecs.shape
    flat = q_vecs.reshape(b * lq, dim)
    k = sz["colbert_candidates"]

    # per-token search against an exact search of the same bf16 rows (live query tokens)
    scores, rows = index.search_rows(flat.cpu().numpy(), k)
    live = np.flatnonzero(q_mask.reshape(-1) > 0)
    corpus = index._device_vectors[:index._row_count].float()
    qb = flat.to(torch.bfloat16).float()
    hits = 0
    for s in range(0, len(live), 512):
        part = torch.from_numpy(live[s:s + 512]).to(device)
        with torch.inference_mode():
            exact = torch.topk(qb[part] @ corpus.T, k, dim=1).indices.cpu().numpy()
        hits += sum(len(set(a) & set(e)) for a, e in zip(rows[live[s:s + 512]].tolist(), exact.tolist()))
    result["token_recall"] = hits / (len(live) * k)
    print(f"[colbert] per-token recall@{k} of search_rows vs exact bf16 search over {len(live)} live query "
          f"tokens: {result['token_recall']:.4f}")
    check(result["token_recall"] >= 0.95, f"colbert per-token recall@{k} {result['token_recall']}")
    result["token_recall_causes"] = token_recall_causes(qb[torch.from_numpy(live).to(device)], corpus, rows[live], k)
    print(f"[colbert] where recall@{k} falls short: {json.dumps(result['token_recall_causes'])}")

    # the device merge against the host merge on that batch
    vocab, row_slot = np.unique(np.asarray(index.row_ids).astype(str), return_inverse=True)
    slots = np.where(rows >= 0, row_slot[np.clip(rows, 0, len(row_slot) - 1)], -1).reshape(b, lq, k)
    keep = max(sz["colbert_top_n"], sz["colbert_rescore_n"])
    t0 = time.perf_counter()
    dev = cs.aggregate_maxsim_device(scores.reshape(b, lq, k), slots, q_mask, keep, vocab=vocab, device=device)
    t1 = time.perf_counter()
    host = cs.aggregate_maxsim_batch(scores.reshape(b, lq, k), slots, q_mask, keep, vocab=vocab)
    result.update(device_merge_s=t1 - t0, host_merge_s=time.perf_counter() - t1)
    # unpacked candidate scores keep 16 mantissa bits (the lane bits are
    # cleared), so totals tie often: a document may differ only where it ties
    # with the last kept score (1e-5 relative)
    worst, swapped = 0.0, 0
    for qi, (d_row, h_row) in enumerate(zip(dev, host)):
        dd, hd = dict(d_row), dict(h_row)
        check(len(dd) == len(hd), f"colbert: merges of query {qi} keep {len(dd)} and {len(hd)} docs")
        worst = max([worst] + [abs(v - hd[x]) / max(abs(hd[x]), 1e-30) for x, v in d_row if x in hd])
        for row, other in ((dd, hd), (hd, dd)):
            cut = min(row.values())
            for x in set(row) - set(other):
                swapped += 1
                check(abs(row[x] - cut) <= 1e-5 * abs(cut), f"colbert: merges of query {qi} differ above the "
                      f"cut: {x} at {row[x]}, cut {cut}")
    result.update(merge_max_rel=worst, merge_tie_swaps=swapped)
    print(f"[colbert] device merge vs host merge over {b} queries, {keep} kept: max relative |d| {worst:.3g}; "
          f"{swapped} documents differ, each tied with its list's last score")
    check(worst <= 1e-5, f"colbert: device vs host merge relative |d| {worst}")

    # the batched rescore (the CLI's: one K14 launch for the batch) against
    # the per-query rescore, then the run file's scores against the plain
    # exact MaxSim
    store = cs.TokenVectorStore(enc)
    pad_t = -(-store.max_tokens // 8) * 8
    result["store_padded_tokens"] = pad_t
    check(pad_t == sz["maxsim_shapes"][2][3], f"colbert: the store's padded tokens {pad_t} are not phase 3's "
          f"rescore shape")
    rescore_n, top_n = sz["colbert_rescore_n"], sz["colbert_top_n"]
    lists = [row[:rescore_n] for row in dev]
    rows_dev = store.device_rows(device)  # the store's float16 rows, uploaded once
    batched = cs.exact_rescore_batch(q_vecs, q_mask, lists, store, top_n, rescore_n, pad_t, rows_dev)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.exact_rescore_batch(q_vecs, q_mask, lists, store, top_n, rescore_n, pad_t, rows_dev)
    result["rescore_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
    q_host = q_vecs.cpu().numpy()
    t0 = time.perf_counter()
    worst = 0.0
    for qi in range(sz["colbert_checked_queries"]):
        one = cs.exact_rescore(q_host[qi], q_mask[qi], lists[qi], store, top_n, rescore_n, pad_t, device)
        check([d for d, _ in one] == [d for d, _ in batched[qi]], f"colbert: batched and per-query rescores "
              f"of query {qi} rank different documents")
        worst = max([worst] + [abs(a - c) / max(abs(c), 1e-30) for (_, a), (_, c) in zip(batched[qi], one)])
    result["rescore_ms_per_query"] = (time.perf_counter() - t0) * 1e3 / sz["colbert_checked_queries"]
    result["batched_vs_per_query_max_rel"] = worst
    print(f"[colbert] host clock: device merge {result['device_merge_s'] * 1e3:.1f} ms and host merge "
          f"{result['host_merge_s'] * 1e3:.1f} ms for {b} queries; batched exact rescore "
          f"{result['rescore_ms_per_batch']:.3f} ms for the batch of {b} ({result['rescore_ms_per_batch'] / b:.4f} "
          f"ms a query), the per-query rescore {result['rescore_ms_per_query']:.3f} ms a query; the same documents, "
          f"scores within {worst:.3g} relative")
    check(worst <= 1e-5, f"colbert: batched vs per-query rescore relative |d| {worst}")
    worst = 0.0
    for qi in range(sz["colbert_checked_queries"]):
        docs = run_file[qids[qi]]
        d = torch.zeros((len(docs), pad_t, dim), device=device)
        dm = torch.zeros((len(docs), pad_t), device=device)
        for j, (did, _) in enumerate(docs):
            v = torch.from_numpy(store.get(did)).to(device)
            d[j, :len(v)], dm[j, :len(v)] = v, 1.0
        qm = torch.from_numpy((q_mask[qi:qi + 1] > 0).astype(np.float32)).to(device)
        plain = ms.reference_maxsim_all_pairs(q_vecs[qi:qi + 1], d, qm, dm, float("-inf"))[0].cpu().numpy()
        got = np.array([sc for _, sc in docs])
        worst = max(worst, float((np.abs(got - plain) / np.maximum(np.abs(plain), 1.0)).max()))
        check(np.allclose(got, plain, rtol=1e-4, atol=1e-4), f"colbert: rescored scores of query {qids[qi]}")
    result["rescore_max_rel"] = worst
    print(f"[colbert] rescored run scores of {sz['colbert_checked_queries']} queries vs plain exact MaxSim: "
          f"max relative |d| {worst:.3g}")

    # recall@10 against an exhaustive exact MaxSim over every passage (K14)
    docs, dmask, doc_ids = _padded_docs(enc, device)
    qm_all = torch.from_numpy((q_mask > 0).astype(np.float32)).to(device)
    with torch.inference_mode():
        full = torch.cat([ms.maxsim_all_pairs(q_vecs, docs[s:s + 2048], qm_all, dmask[s:s + 2048],
                                              fill=float("-inf")) for s in range(0, len(doc_ids), 2048)], dim=1)
    top = torch.topk(full, sz["colbert_top_n"], dim=1).indices.cpu().tolist()
    recall = float(np.mean([len({doc_ids[i] for i in top[qi]} & {x for x, _ in run_file[qid]}) / sz["colbert_top_n"]
                            for qi, qid in enumerate(qids)]))
    result["recall@10_vs_exhaustive"] = recall
    print(f"[colbert] recall@{sz['colbert_top_n']} of the run vs exhaustive exact MaxSim over {len(doc_ids)} "
          f"passages: {recall:.4f} (reported, not gated)")
    del docs, dmask, full

    # device-only per-token search of one query batch
    ms_search = _time_ms(lambda: index._search_device(flat, k), device, sz["reps"])
    result.update(token_search_ms=ms_search, token_search_device_qps=b / ms_search * 1e3)
    print(f"[colbert] encode {result['encode_psg_per_s']:.1f} psg/s and search {result['search_qps']:.1f} QPS "
          f"through the CLI; device-only per-token search of {b * lq} query rows {ms_search:.3f} ms "
          f"({result['token_search_device_qps']:.1f} QPS)")
    return result


# ---- phase 5: search at scale ----------------------------------------------

def phase_scale(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    vectors, queries = rows.cpu().numpy(), q.cpu().numpy()
    del rows
    index = FlatIndex({"token_dtype": "float16", "mips_quantization": "float16", "mips_kernel": "binmax"},
                      device)
    index.prepare(vectors.shape[1])
    index.index(np.arange(n), vectors)
    del vectors
    _build.reset_launches()
    scores, ids = index.search(queries, k)
    launches = dict(_build.LAUNCHES)
    check(np.isfinite(scores).all() and ((ids >= 0) & (ids < n)).all(), "padding leaked into the results")
    if device.type == "cuda":
        check(launches["level2_reduce"] > 0, "the scale search launched no level-2 kernel")
    corpus = index._device_vectors[:n]
    with torch.inference_mode():
        exact = torch.topk(torch.from_numpy(queries).to(device).to(torch.bfloat16).float() @ corpus.float().T,
                           k, dim=1).indices.cpu().numpy()
    recall = _overlap(ids, index.row_ids[exact])
    start = time.perf_counter()
    reps = 5
    for _ in range(reps):
        index.search_rows(queries, k)
    qps = len(queries) * reps / (time.perf_counter() - start)
    qb = torch.from_numpy(queries).to(device)
    from matchmaker_tpu_torch.ops import mips_binmax as mb

    per_bin = index._per_bin(k)
    ms = _time_ms(lambda: mb.binmax_scan_topk(qb, index._device_vectors, k, n_valid=n, per_bin=per_bin),
                  device, sz["reps"])
    print(f"[scale] {n} rows x {sz['hid']}, Q={len(queries)}, k={k}, per_bin={per_bin}: recall@{k} {recall:.4f}, "
          f"search_rows {qps:.1f} QPS, device scan+top-k {ms:.3f} ms ({len(queries) / ms * 1e3:.1f} QPS)")
    check(recall >= 0.95, f"recall@{k} {recall} < 0.95")
    # K4 at this search's own candidates (its level 2 follows the pool size)
    n_cands = n // 128 * per_bin
    level2 = mb.L2_WIDE if n_cands >= 128 * k else (mb.L2_MID if n_cands >= 16 * k else None)
    l2 = None
    if level2:
        cands = mb.binmax_candidates(qb, index._device_vectors, n_valid=n, per_bin=per_bin)
        l2 = level2_timings(mb, cands, level2, device, sz["reps"])
        print(f"[scale] level 2 width={level2} over the search's candidates {list(cands.shape)}: identical "
              f"{l2['identical']:.6f}; device {_fmt(l2['device_ms'])}, events {_fmt(l2['ms'])}, host "
              f"{_fmt(l2['host_ms'])} a call, bound {l2['bound_ms']:.4f} ms; torch.topk yardstick device "
              f"{_fmt(l2['library_device_ms'])}")
        check(l2["identical"] == 1.0, f"level 2 at the scale search's candidates: {l2['identical']} identical")
    return {"launches": launches, "recall": recall, "qps": qps, "device_ms": ms,
            "device_qps": len(queries) / ms * 1e3, "per_bin": per_bin, "level2_reduce": l2}


def phase_scale_int8(sz, device):
    """FlatIndex int8 search at scale: the mixed route (K8), the int8 +
    two-stage route (K7 + rescore) and the default int8 route (K7 alone),
    each an index built from its config, recall@k against an exact search
    of the unquantized rows (>= 0.95 for the mixed and two-stage routes;
    reported for the default route) and QPS."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    n, k = sz["scale_rows"], sz["scale_k"]
    rows, q = _clustered(n, sz["hid"], sz["scale_clusters"], device, seed=9, n_queries=256)
    queries = q.cpu().numpy()
    with torch.inference_mode():
        exact = torch.topk(q.to(torch.bfloat16).float() @ rows.to(torch.bfloat16).float().T, k,
                           dim=1).indices.cpu().numpy()
    vectors = rows.cpu().numpy()
    del rows
    result = {}
    for name, extra, scan in SCALE_INT8_RUNS:
        index = FlatIndex({"token_dtype": "float16", "mips_quantization": "int8", "mips_kernel": "binmax", **extra},
                          device)
        index.prepare(vectors.shape[1])
        index.index(np.arange(n), vectors)
        index._ensure_device()
        _build.reset_launches()
        scores, ids = index.search(queries, k)
        launches = dict(_build.LAUNCHES)
        check(np.isfinite(scores).all() and ((ids >= 0) & (ids < n)).all(), f"int8 {name}: padding leaked")
        if device.type == "cuda":
            check(launches[scan] > 0, f"int8 {name} at scale launched no {scan} kernel")
        recall = _overlap(ids, exact)
        qb = torch.from_numpy(queries).to(device)
        start = time.perf_counter()
        reps = 5
        for _ in range(reps):
            index.search_rows(queries, k)
        qps = len(queries) * reps / (time.perf_counter() - start)
        ms = _time_ms(lambda: index._search_int8(qb, k), device, sz["reps"])
        print(f"[scale-int8] {name}: {n} rows x {sz['hid']}, Q={len(queries)}, k={k}: recall@{k} {recall:.4f}, "
              f"search_rows {qps:.1f} QPS, device search {ms:.3f} ms ({len(queries) / ms * 1e3:.1f} QPS)")
        if name in GATED_INT8_RUNS:
            check(recall >= 0.95, f"int8 {name}: recall@{k} {recall} < 0.95")
        result[name] = {"launches": launches, "recall": recall, "qps": qps, "device_ms": ms,
                        "device_qps": len(queries) / ms * 1e3}
        del index
    return result


# ---- phase 6: the training path through cli.train's Trainer ----------------

def _write_train_data(root, sz, seed=2):
    """Seeded synthetic triples with teacher scores, a re-rank validation
    set (its first document per query relevant: it holds the query's words)
    and a collection with queries for the dense retrieval at the end."""
    rng = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(20_000)])

    def text(lo, hi):
        return " ".join(words[rng.integers(0, len(words), size=int(rng.integers(lo, hi)))])

    paths = {k: os.path.join(root, f) for k, f in (("train", "train.tsv"), ("val", "val.tsv"),
                                                    ("val_qrels", "val_qrels.txt"))}
    with open(paths["train"], "w") as f:
        for _ in range(sz["train_batches"] * sz["train_batch"]):
            f.write(f"{rng.uniform(5, 10):.3f}\t{rng.uniform(0, 5):.3f}\t{text(3, 12)}\t{text(150, 260)}"
                    f"\t{text(150, 260)}\n")
    with open(paths["val"], "w") as fv, open(paths["val_qrels"], "w") as fq:
        for qi in range(sz["val_queries"]):
            rel = text(150, 260)
            query = " ".join(rng.choice(rel.split(), size=5))
            for di in range(sz["val_docs"]):
                fv.write(f"q{qi}\td{qi}_{di}\t{query}\t{rel if di == 0 else text(150, 260)}\n")
            fq.write(f"q{qi} 0 d{qi}_0 1\n")
    dr_root = os.path.join(root, "dr")
    os.makedirs(dr_root)
    _write_collection(dr_root, dict(sz, passages=sz["dr_passages"], queries=sz["dr_queries"]), seed=3)
    paths.update(collection=os.path.join(dr_root, "collection.tsv"), queries=os.path.join(dr_root, "queries.tsv"),
                 qrels=os.path.join(dr_root, "qrels.txt"))
    return paths


def _train_config(paths, sz, device):
    """configs/train/defaults.yaml + configs/train/models/bert_dot.yaml at
    DistilBERT width, fused layers, with gradient clipping at 1.0, the run cut
    to ``train_batches`` steps with two validations, and the dense retrieval
    at the end."""
    return {
        "model": "bert_dot", "bert_pretrained_model": sz["model_name"], "random_seed": 1234, "use_fp16": True,
        "encoder_fused_attention": True, "device": str(device), "enable_tensorboard": False,
        "loss": "margin-mse", "train_pairwise_distillation": True, "in_batch_negatives": True,
        "in_batch_neg_loss": "margin-mse", "in_batch_neg_weight": 1.0, "in_batch_main_weight": 1.0,
        "param_group0_learning_rate": 7.0e-6, "param_group1_learning_rate": 7.0e-4,
        "embedding_optimizer_learning_rate": 7.0e-6, "weight_decay": 0.0, "lr_schedule": "cosine",
        "optimizer_warmup_steps": 1000, "max_training_steps": 300000, "gradient_clip_norm": 1.0,
        "batch_size_train": sz["train_batch"], "batch_size_eval": sz["eval_batch"],
        "max_query_length": sz["train_query_len"], "max_doc_length": sz["train_doc_len"], "epochs": 1,
        "validate_every_n_batches": sz["validate_every"], "max_training_batches": sz["train_batches"],
        "validation_metric": "MRR@10", "early_stopping_patience": 30, "train_tsv": paths["train"],
        "validation_cont": {"tsv": paths["val"], "qrels": paths["val_qrels"], "binarization_point": 1},
        "test": {"synthetic": {"tsv": paths["val"], "qrels": paths["val_qrels"], "binarization_point": 1}},
        "run_dense_retrieval_eval": True, "collection_tsv": paths["collection"], "collection_batch_size": sz["dr_batch"],
        "query_batch_size": 32, "faiss_index_type": "flat", "mips_quantization": "float16", "mips_kernel": "binmax",
        "token_dtype": "float16",
        "query_sets": {"dr_dev": {"queries_tsv": paths["queries"], "qrels": paths["qrels"], "top_n": sz["dr_top_n"],
                                  "binarization_point": 1}},
    }


def predicted_train_launches(sz):
    """K1/K2 launch once per layer and encode: two encodes (queries, packed
    docs) per training step, per eval batch and per test batch; one per
    corpus and query batch of the dense retrieval. K11/K12: once per layer
    and encode of a training step."""
    layers = sz["n_layers"]
    train = sz["train_batches"] * layers * 2
    eval_batches = -(-sz["val_queries"] * sz["val_docs"] // sz["eval_batch"])
    evals = (sz["train_batches"] // sz["validate_every"] + 1) * eval_batches * 2 * layers
    dense = (-(-sz["dr_passages"] // sz["dr_batch"]) + -(-sz["dr_queries"] // 32)) * layers
    forward = train + evals + dense
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": train, "fused_mlp_block_bwd": train}


def _device_batch(config, tokenizer, path, device):
    import torch

    from matchmaker_tpu_torch.data.loaders import triple_training_loader

    batch = next(iter(triple_training_loader(config, tokenizer, path)))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _profile_steps(step, batch, step_ms, n=3, tag="train"):
    """Device time by kernel over n calls of ``step(batch)`` (torch.profiler),
    and the device's busy share of ``step_ms``, the call's time CUDA events
    measured without the profiler (whose own overhead stretches the wall
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((key, us / 1e3 / n, count // n) for key, us, count in _kernel_times(prof)), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] profile of {n} calls: kernels {busy:.2f} ms a call, {busy / step_ms:.1%} of the "
          f"{step_ms:.2f} ms call without the profiler ({wall_ms / n:.2f} ms wall under it)")
    for key, ms, count in rows[:14]:
        print(f"[{tag}]   {ms:8.3f} ms/call {ms / busy if busy else 0:6.1%}  x{count:<4d} {key[:110]}")
    return {"device_ms_per_step": busy, "busy_share": busy / step_ms, "profiled_wall_ms_per_step": wall_ms / n,
            "top": [{"kernel": k[:200], "ms_per_step": ms, "calls_per_step": c} for k, ms, c in rows[:25]]}


def _hardest_negatives(model, batch):
    """Each query's in-batch hardest negative (column of the B x 2B score
    matrix outside the diagonal: q.[d_pos; d_neg]^T, or the all-pairs
    MaxSim for token vectors), as the in-batch loss picks it."""
    import torch

    from matchmaker_tpu_torch.ops import maxsim as ms

    with torch.no_grad():
        pos, neg = model.forward_triple(batch)
        q = pos["query_vecs"].float()
        d = torch.cat([pos["doc_vecs"], neg["doc_vecs"]]).float()
        if q.dim() == 3:
            scores = ms.maxsim_all_pairs(q, d, pos["query_vecs_mask"],
                                         torch.cat([pos["doc_vecs_mask"], neg["doc_vecs_mask"]]))
        else:
            scores = q @ d.t()
    b = q.shape[0]
    scores[:, :b] = scores[:, :b].masked_fill(torch.eye(b, dtype=torch.bool, device=q.device), float("-inf"))
    return scores.argmax(dim=1)


@contextlib.contextmanager
def plain_maxsim():
    """Route the training step's all-pairs MaxSim to its plain version,
    differentiated by PyTorch (in place of K14's training form and the
    backward kernel)."""
    import matchmaker_tpu_torch.training.train_step as ts
    from matchmaker_tpu_torch.ops import maxsim as ms

    saved = ts.maxsim_all_pairs
    ts.maxsim_all_pairs = ms.reference_maxsim_all_pairs
    try:
        yield
    finally:
        ts.maxsim_all_pairs = saved


def _kernels_vs_plain_step(model, config, batch, smooth_config, tag):
    """One step's loss and gradients from the same parameters through the
    kernels and through the plain versions (encoder halves, and the
    all-pairs MaxSim where the model has one). The configured loss is
    compared as it is (relative gap <= 1e-2). The gradients are compared
    under ``smooth_config``'s loss (cosine >= 0.99 for every parameter): the
    in-batch pairwise loss picks each query's hardest negative by an argmax,
    and a score difference at bf16 rounding level can move that pick to
    another document, which changes the gradient whatever the kernels
    compute; the number of picks that move is reported."""
    import torch

    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    full = make_loss_fn(model, get_loss(config), config)
    smooth = make_loss_fn(model, get_loss(smooth_config), smooth_config)

    def run():
        with torch.no_grad():
            loss = float(full(batch)[0])
        model.zero_grad(set_to_none=True)
        smooth(batch)[0].backward()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        return loss, grads, _hardest_negatives(model, batch)

    lk, gk, hk = run()
    with plain_encoder_blocks(), plain_maxsim():
        lp, gp, hp = run()
    model.zero_grad(set_to_none=True)
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    moved = int((hk != hp).sum())
    cosines, key_bias = {}, 0.0
    for name, a in gk.items():
        b = gp[name]
        if name.endswith("attention.key.bias"):
            # zero in exact arithmetic (each softmax row's gradient sums to
            # zero): rounding noise, bounded by the query bias's gradient
            ratio = float((a - b).abs().max()) / float(gp[name.replace("key.bias", "query.bias")].abs().max())
            key_bias = max(key_bias, ratio)
            check(ratio <= 2e-2, f"{name}: gradient noise {ratio:.4g} of the query bias's, above 2e-2")
            continue
        cosines[name] = float(torch.nn.functional.cosine_similarity(a.reshape(-1), b.reshape(-1), dim=0))
    worst = sorted(cosines.items(), key=lambda kv: kv[1])[:3]
    print(f"[{tag}] one step, kernels vs plain: loss {lk:.6g} vs {lp:.6g} (relative gap {rel:.3g}); in-batch "
          f"hardest negative moved for {moved} of {len(hk)} queries; gradients of {len(cosines)} parameters "
          f"under {smooth_config.get('in_batch_neg_loss') if smooth_config.get('in_batch_negatives') else 'no'} "
          f"in-batch loss, worst cosines " + ", ".join(f"{n} {c:.6f}" for n, c in worst)
          + f"; key-bias noise {key_bias:.4g} of the query bias's (bar 2e-2)")
    check(rel <= 1e-2, f"{tag}: loss with the kernels {lk} vs plain {lp}")
    check(worst[0][1] >= 0.99, f"{tag}: gradient cosine {worst[0][1]} at {worst[0][0]}")
    return {"plain_loss_gap": rel, "plain_grad_cos": worst[0][1], "hardest_negatives_moved": moved,
            "key_bias_noise": key_bias}


def _train_through_trainer(sz, device, config, run_folder, steps, tag):
    """cli.train's Trainer on ``config`` for ``steps`` steps, its step
    recorded: the launch counts of the run, a finite loss every step, the
    Trainer's triples/s (validation included); the trainer, the result."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.training.trainer import Trainer

    os.makedirs(run_folder)
    fresh_perf_monitor()
    trainer = Trainer(config, run_folder)
    step_losses = []
    trainer_step = trainer.train_step

    def recording_step(batch):
        stats = trainer_step(batch)
        step_losses.append(stats["loss"])
        return stats

    trainer.train_step = recording_step
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    trainer.train_step = trainer_step
    print(f"[{tag}] launches in the cli.train run: {launches}")
    result = {"wall_s": wall, "launches": launches, "steps": trainer.global_step}
    check(trainer.global_step == steps and len(step_losses) == steps,
          f"{tag}: {trainer.global_step} training steps, {len(step_losses)} losses")
    losses = torch.stack(step_losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"{tag}: a non-finite training loss")
    result.update(loss_first=float(losses[0]), loss_last=float(losses[-1]))
    with open(os.path.join(run_folder, "efficiency-metrics.json")) as f:
        train_block = json.load(f)[-1]["blocks"]["train"]
    result["cli_triples_per_s"] = steps * sz["train_batch"] / train_block["total_seconds"]
    return trainer, result


def _step_speed(sz, device, trainer, batch, tag):
    """Device-only triples/s of the Trainer's step on one batch (CUDA
    events) and, on a card, a profile of three steps."""
    ms = _time_ms(lambda: trainer.train_step(batch), device, sz["reps"])
    result = {"step_ms": ms, "device_triples_per_s": sz["train_batch"] / ms * 1e3}
    if device.type == "cuda":
        result["profile"] = _profile_steps(trainer.train_step, batch, ms, tag=tag)
    return result


def _overfit(sz, trainer, config, batch, tag):
    """A one-batch overfit from the current weights, no warmup, a constant
    learning rate: ``overfit_steps`` (30) steps must halve Margin-MSE."""
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step

    fit_config = dict(config, lr_schedule="constant", optimizer_warmup_steps=0, param_group0_learning_rate=1e-4,
                      embedding_optimizer_learning_rate=1e-4, param_group1_learning_rate=1e-3)
    fit_step = make_train_step(trainer.model, trainer.losses, build_optimizer(fit_config, trainer.model), fit_config)
    fit = [float(fit_step(batch)["ranking_loss"]) for _ in range(sz["overfit_steps"])]
    print(f"[{tag}] one-batch overfit, {sz['overfit_steps']} steps: Margin-MSE {fit[0]:.4f} -> {fit[-1]:.4f}")
    check(fit[-1] <= 0.5 * fit[0], f"{tag}: overfitting one batch took Margin-MSE only from {fit[0]} to {fit[-1]}")
    return {"overfit_first": fit[0], "overfit_last": fit[-1]}


def phase_train(sz, device, root):
    import torch

    paths = _write_train_data(root, sz)
    config = _train_config(paths, sz, device)
    run_folder = os.path.join(root, "train_run")
    trainer, result = _train_through_trainer(sz, device, config, run_folder, sz["train_batches"], "train")
    launches = result["launches"]
    if device.type == "cuda":
        want = predicted_train_launches(sz)
        for name, n in want.items():
            check(launches[name] == n, f"{name}: {launches[name]} launches, predicted {n}")
        for name in ("binmax_candidates", "unpack_candidates"):
            check(launches[name] > 0, f"the dense retrieval after training launched no {name} kernel")
    for rel in ("training-loss.csv", "validation-metrics-cont.csv", "best-model.npz", "best-info.csv",
                "efficiency-metrics.json", "test-synthetic-output.txt", "test-synthetic-metrics.csv",
                "dense-retrieval/dr_dev-output.txt", "dense-retrieval/dr_dev-metrics.csv"):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel} in the training run folder")
    with open(os.path.join(run_folder, "validation-metrics-cont.csv")) as f:
        check(len(f.read().strip().splitlines()) == 1 + sz["train_batches"] // sz["validate_every"],
              "one validation row per validation")

    batch = _device_batch(config, trainer.tokenizer, paths["train"], device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    result.update(_step_speed(sz, device, trainer, batch, "train"))
    print(f"[train] {trainer.global_step} steps: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}; "
          f"{result['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{result['device_triples_per_s']:.1f} device-only ({result['step_ms']:.2f} ms a step)")
    if device.type == "cuda":
        result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[train] peak device memory over the profiled steps {result['peak_mem_gb']:.2f} GB")
    # the gradients under Margin-MSE alone (the in-batch loss's hardest negative is an argmax)
    result.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, in_batch_negatives=False),
                                         "train"))
    result.update(_overfit(sz, trainer, config, batch, "train"))
    return result


# ---- phase 6b: ColBERT training through the same Trainer -----------------------

def _colbert_train_config(paths, sz, device):
    """configs/train/defaults.yaml + configs/train/models/colbert.yaml (model
    colbert, compression 128, 8 query [MASK]s, in-batch margin-mse) at
    DistilBERT width, fused layers, as phase 6's config: the run cut to
    ``colbert_train_batches`` steps with one validation and the test pass,
    no dense retrieval."""
    return dict(_train_config(paths, sz, device), model="colbert", colbert_compression_dim=128,
                query_augment_mask_number=8, in_batch_negatives=True, in_batch_neg_loss="margin-mse",
                validate_every_n_batches=sz["colbert_train_batches"], max_training_batches=sz["colbert_train_batches"],
                run_dense_retrieval_eval=False)


def predicted_colbert_train_launches(sz):
    """K1/K2 once per layer and encode: two encodes (queries, packed docs) a
    training step, an eval batch and a test batch; K11/K12 once per layer
    and encode of a training step; K14's training form and the backward
    kernel once a step (the in-batch all-pairs MaxSim); K14's plain launch
    never (re-ranking scores pairs in torch, as JAX does in jnp)."""
    layers, steps = sz["n_layers"], sz["colbert_train_batches"]
    eval_batches = -(-sz["val_queries"] * sz["val_docs"] // sz["eval_batch"])
    forward = steps * layers * 2 + 2 * eval_batches * 2 * layers
    return {"fused_attention_block": forward, "fused_mlp_block": forward,
            "fused_attention_block_bwd": steps * layers * 2, "fused_mlp_block_bwd": steps * layers * 2,
            "maxsim_all_pairs_argmax": steps, "maxsim_all_pairs_bwd": steps, "maxsim_all_pairs": 0}


def phase_train_colbert(sz, device, root):
    """ColBERT training through cli.train's Trainer at DistilBERT width
    (phase 6's data and checks): launch counts against the prediction, a
    finite loss every step, the run-folder files, triples/s through the
    Trainer and device-only, one step with the kernels against one with the
    plain versions, and a one-batch overfit (30 steps halve Margin-MSE).
    The gradients are compared under Margin-MSE plus the in-batch
    KLDivTeacherList over the same all-pairs MaxSim (against JAX's [I | 0]
    teacher): smooth in the scores, unlike the in-batch margin-mse's
    hardest-negative argmax, and it keeps K14's training form and backward
    kernel in the comparison."""
    steps = sz["colbert_train_batches"]
    paths = _write_train_data(root, dict(sz, train_batches=steps))
    config = _colbert_train_config(paths, sz, device)
    run_folder = os.path.join(root, "colbert_train_run")
    trainer, result = _train_through_trainer(sz, device, config, run_folder, steps, "train_colbert")
    launches = result["launches"]
    if device.type == "cuda":
        for name, n in predicted_colbert_train_launches(sz).items():
            check(launches[name] == n, f"ColBERT training: {name} {launches[name]} launches, predicted {n}")
    for rel in ("validation-metrics-cont.csv", "best-model.npz", "best-info.csv", "efficiency-metrics.json",
                "test-synthetic-output.txt", "test-synthetic-metrics.csv"):
        check(os.path.isfile(os.path.join(run_folder, rel)), f"missing {rel} in the ColBERT training run folder")

    batch = _device_batch(config, trainer.tokenizer, paths["train"], device)
    result.update(_step_speed(sz, device, trainer, batch, "train_colbert"))
    print(f"[train_colbert] {steps} steps: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}; "
          f"{result['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{result['device_triples_per_s']:.1f} device-only ({result['step_ms']:.2f} ms a step)")
    result.update(_kernels_vs_plain_step(trainer.model, config, batch, dict(config, in_batch_neg_loss="KLDivTeacherList"),
                                         "train_colbert"))
    result.update(_overfit(sz, trainer, config, batch, "train_colbert"))
    return result


# ---- phase 8: the TAS-Balanced recipe and the effectiveness check --------------

def phase_recipe(sz, device, root):
    """cli/tasb_recipe.py's run_recipe with the JAX recipe's configuration
    (the mini-lm encoder, MLM warm start, a normalized ColBERT teacher, the
    TAS-Balanced student with the dynamic in-batch teacher, the scann
    search) at ``recipe_args``' scale, on the card: each stage's wall time,
    the teacher's pairwise accuracy, the cluster count, MRR@10 and
    Recall@100, gated on tests/test_tasb_recipe.py:31-32 (>= 0.2, >= 0.6);
    the launches of the whole run, K14's training form and backward (the
    teacher's training), its plain launch (the teacher's in-batch matrix)
    and the search's K3/K6 at least once each. Then cli/effectiveness_check
    at tests/test_effectiveness.py:38-45's scale, gated on MRR@10 >= 0.5."""
    from matchmaker_tpu_torch.cli.effectiveness_check import run_check
    from matchmaker_tpu_torch.cli.tasb_recipe import run_recipe, summarize
    from matchmaker_tpu_torch.ops import _build

    result = {}
    work = os.path.join(root, "tasb")
    fresh_perf_monitor()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run_recipe(work, device=str(device), **sz["recipe_args"])
    result["recipe_wall_s"] = time.perf_counter() - t0
    result["launches"] = launches = dict(_build.LAUNCHES)
    result.update(out, **summarize(work))
    print(f"[recipe] {sz['recipe_args']}: stages (s) {out['timings_s']}, {result['recipe_wall_s']:.1f} s in all; "
          f"teacher pairwise accuracy {result['teacher_pairwise_accuracy']:.4f} (margin "
          f"{result['teacher_margin_mean']:.3f} +/- {result['teacher_margin_std']:.3f} over "
          f"{result['scored_pairs']} pairs), {result['clusters']} clusters; MRR@10 {out['MRR@10']:.4f}, "
          f"Recall@100 {out['Recall@100']:.4f} over {out['QueriesRanked']:.0f} queries")
    print(f"[recipe] launches: {({k: v for k, v in launches.items() if v})}")
    check(out["MRR@10"] >= 0.2 and out["Recall@100"] >= 0.6,
          f"the recipe's MRR@10 {out['MRR@10']} / Recall@100 {out['Recall@100']} below 0.2 / 0.6")
    if device.type == "cuda":
        for name in ("maxsim_all_pairs_argmax", "maxsim_all_pairs_bwd", "maxsim_all_pairs", "binmax_candidates",
                     "unpack_candidates"):
            check(launches[name] > 0, f"the recipe launched no {name} kernel")
    fresh_perf_monitor()
    t0 = time.perf_counter()
    check_out = run_check(os.path.join(root, "eff"), device=str(device), **sz["effectiveness_args"])
    result["effectiveness"] = dict(check_out, wall_s=time.perf_counter() - t0)
    print(f"[recipe] effectiveness check {sz['effectiveness_args']}: MRR@10 {check_out['MRR@10']:.4f}, "
          f"Recall@100 {check_out['Recall@100']:.4f} in {result['effectiveness']['wall_s']:.1f} s")
    check(check_out["MRR@10"] >= 0.5, f"the effectiveness check's MRR@10 {check_out['MRR@10']} below 0.5")
    return result


# ---- phase 7: the probes' own path ---------------------------------------------

# the probe that launches each probe kernel
PROBE_OF = {"attn_inner": "attn_inner", "int8_matmul": "int8_matmul", "mlp_rows2d": "mlp_rows",
            "mlp_rowsblk": "mlp_rows"}


def phase_probes(sz, device):
    """Each probe as a user runs it, ``python -m
    matchmaker_tpu_torch.probes.<name>`` (its main()), at the JAX probes'
    shapes: the launch counts set to 0 just before each probe and read just
    after, every kernel of that probe launched; its JSON line kept in the
    report."""
    import importlib
    import io

    import torch

    from matchmaker_tpu_torch.ops import _build

    result = {"launches": {}, "results": {}}
    for name, args in sz["probe_args"].items():
        probe = importlib.import_module(f"matchmaker_tpu_torch.probes.{name}")
        _build.reset_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            line = probe.main(args + ["--device", device.type])
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(json.loads(printed.getvalue().strip().splitlines()[-1]) == line, f"probe {name}: its JSON line")
        for kernel, owner in PROBE_OF.items():
            if owner == name:
                check(launches[kernel] > 0 or device.type != "cuda", f"probe {name} launched no {kernel} kernel")
                result["launches"][kernel] = launches[kernel]
        others = {k: v for k, v in launches.items() if v and PROBE_OF.get(k) != name}
        result["results"][name] = line
        print(f"[probes] {name}: launches {({k: launches[k] for k, o in PROBE_OF.items() if o == name})}, "
              f"other kernels {others}")
    res = result["results"]
    print(f"[probes] attn_inner ms: " + ", ".join(f"{k} {v['ms']:.4f}" for k, v in res["attn_inner"].items()
                                                  if isinstance(v, dict) and "ms" in v))
    print(f"[probes] int8_matmul ms: {res['int8_matmul']['ms']}, int8_vs_bf16 {res['int8_matmul']['int8_vs_bf16']:.3f},"
          f" chain_vs_bf16 {res['int8_matmul']['chain_vs_bf16']:.3f}")
    for shape in res["mlp_rows"]["shapes"]:
        print(f"[probes] mlp_rows {shape['shape']} ms: " + ", ".join(
            f"{key} {shape[key]['ms']:.4f}" for key in ("prod_3d", "rows2d", "rowsblk_1024", "rowsblk_2048", "chain")))
    return result


SERVING = ("fused_attention_block", "fused_mlp_block", "binmax_candidates", "level2_reduce", "unpack_candidates")
SERVING_INT8 = ("fused_attention_int8_block", "fused_mlp_int8_block", "binmax_candidates_int8f",
                "binmax_candidates_int8")

KERNELS = [  # name, source, TPU kernel it replaces, TPU kernels folded into it
    ("fused_attention_block", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:186", None),
    ("fused_mlp_block", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:386", None),
    ("binmax_candidates", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:247", "matchmaker_tpu/ops/mips_binmax.py:317 (K5 transpose, in the store)"),
    ("level2_reduce", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:327", None),
    ("unpack_candidates", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:139", None),
    ("fused_mlp_block_bwd", "matchmaker_tpu_torch/csrc/encoder_backward_kernels.cu",
     "matchmaker_tpu/ops/fused_backward.py:124", None),
    ("fused_attention_block_bwd", "matchmaker_tpu_torch/csrc/encoder_backward_kernels.cu",
     "matchmaker_tpu/ops/fused_backward.py:290", None),
    ("fused_mlp_int8_block", "matchmaker_tpu_torch/csrc/encoder_int8_kernels.cu",
     "matchmaker_tpu/ops/fused_int8.py:72", None),
    ("fused_attention_int8_block", "matchmaker_tpu_torch/csrc/encoder_int8_kernels.cu",
     "matchmaker_tpu/ops/fused_int8.py:163", None),
    ("binmax_candidates_int8f", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:288", None),
    ("binmax_candidates_int8", "matchmaker_tpu_torch/csrc/binmax_kernels.cu",
     "matchmaker_tpu/ops/mips_binmax.py:259", None),
    ("maxsim_all_pairs", "matchmaker_tpu_torch/csrc/maxsim_kernels.cu",
     "matchmaker_tpu/ops/pallas_kernels.py:62", None),
    ("maxsim_all_pairs_argmax", "matchmaker_tpu_torch/csrc/maxsim_kernels.cu",
     "matchmaker_tpu/ops/pallas_kernels.py:62",
     "matchmaker_tpu/ops/maxsim.py:34 (the jnp all-pairs MaxSim JAX trains through: K14's all-pairs form that also "
     "saves each max's doc token; no pallas_call of its own)"),
    ("maxsim_all_pairs_bwd", "matchmaker_tpu_torch/csrc/maxsim_kernels.cu", "matchmaker_tpu/ops/maxsim.py:34",
     "the gradient JAX takes by autodiff of the jnp all-pairs MaxSim (matchmaker_tpu/training/train_step.py:212-221);"
     " no pallas_call"),
    ("fused_mha", "matchmaker_tpu_torch/csrc/encoder_kernels.cu",
     "matchmaker_tpu/ops/fused_attention.py:49", None),
    ("attn_inner", "matchmaker_tpu_torch/csrc/probe_attn_inner.cu", "benchmarks/attn_inner_probe.py:56",
     "benchmarks/attn_inner_probe.py:75,90,109 (k_unrolled, k_allheads, k_blockdiag: the same function)"),
    ("int8_matmul", "matchmaker_tpu_torch/csrc/probe_int8_matmul.cu", "benchmarks/int8_matmul_probe.py:97", None),
    ("mlp_rows2d", "matchmaker_tpu_torch/csrc/probe_mlp_rows.cu", "benchmarks/mlp_rows_probe.py:43", None),
    ("mlp_rowsblk", "matchmaker_tpu_torch/csrc/probe_mlp_rows.cu", "benchmarks/mlp_rows_probe.py:101", None),
]


# other times and agreements measured beside a kernel, carried into its entry
# the design of the kernels redesigned for Hopper since their first port
DESIGN = {
    "fused_attention_block": "QKV and Wo on the persistent wgmma/TMA GEMM (wgmma_gemm.cuh, bias and bias + residual "
                             "epilogues, weights read MN-major where they lie); attention core on mma.sync with each "
                             "64-key tile's scores in registers, two passes, f32 p as a bf16 hi + lo pair, key tiles "
                             "past the last unmasked key skipped; LayerNorm",
    "fused_mlp_block": "W1 and W2 on the persistent wgmma/TMA GEMM (wgmma_gemm.cuh, bias + gelu poly and bias + "
                       "residual epilogues, weights read MN-major where they lie); LayerNorm",
    "fused_mha": "K1's register-resident mma.sync attention core, the normalised p rounded to bf16",
    "fused_attention_int8_block": "s8 wgmma/TMA products (encoder_int8_kernels.cu); K1's register-resident "
                                  "attention core with an f32 output, p as three bf16 terms",
    "binmax_candidates": "persistent warp-specialised scan (binmax_kernels.cu scan_kernel): TMA ring of queries "
                         "(wgmma A, 128 or 256 a unit) and one 128-row bin (B), m64n128k16 bf16 -> f32, each bin's "
                         "top per_bin selected in registers by the quad of lanes holding a query row, merged with "
                         "two xor shuffles, stored packed into the (Q, C) layout",
    "binmax_candidates_int8": "the same scan with m64n128k32 s8 -> s32 products, f32(raw) * bin scale * query "
                              "scale before the selection; bit-identical to its plain version",
    "binmax_candidates_int8f": "the same scan (SCAN_MIXED): the bin's int8 codes by TMA into a staging area, turned "
                               "into the 128-byte-swizzled bf16 B operand by the producer warpgroup's three idle warps "
                               "(exact), m64n128k16 bf16 -> f32 products, f32 sum * bin scale before the selection",
    "attn_inner": "one warpgroup a (head, example), two CTAs an SM: Q tiles, K and V by TMA through 3-D maps "
                  "(rows past L zero on loads, clipped on stores), read once; S = Q.K^T by wgmma m64n64k16 with the "
                  "whole row (<= 256 keys) in registers, softmax in registers over the quad of lanes, p as register-A "
                  "bf16 fragments (hi + lo for f32_p) into wgmma m64n64k16 against V MN-major; past 256 keys two "
                  "halves (max and sum, then S again); the output tile through shared memory by TMA store",
    "int8_matmul": "persistent s8 wgmma/TMA GEMM: a producer warp keeps a 5-stage ring of both K-major operands "
                   "and runs into the next tile; two consumer warpgroups of m64n128k32; the int32 tile through a "
                   "swizzled shared-memory buffer a warpgroup to TMA stores that run under the next tile's mainloop",
    "mlp_rows2d": "a cluster of 4 CTAs a 128-row tile, each owning 192 output columns: per round of 256 FF "
                  "columns each CTA computes a 64-column chunk of h = gelu(x.W1 + b1) by wgmma m64n64k16 (x "
                  "multicast by TMA to the four CTAs), rounds it to bf16 and copies it into its peers' shared "
                  "memory (cp.async.bulk, double-buffered), then every CTA adds h.W2 for its columns by wgmma "
                  "m64n192k16; the LayerNorm's row sums and centred squares exchanged over distributed shared "
                  "memory and added in CTA order; y out by TMA store; neither h nor the pre-LN sums reach device "
                  "memory",
    "maxsim_all_pairs_argmax": "K14's all-pairs kernel (ARGMAX instances): each running max carries its doc token "
                               "through the lanes, the quad shuffles and the warps' shared-memory merge (the first "
                               "of equal maxima, -1 where the fill wins), written as int32 (Bq, Lq, Bd)",
    "maxsim_all_pairs_bwd": "one launch, two block roles, no float atomics: a block a (doc, 128-column slab) holds "
                            "the doc's dd rows in shared memory and adds g[b,k] w(b,l) q[b,l] into the saved token's "
                            "row over (b, l) in order, exact ties (bit-equal rows, found by a hash and a compare) "
                            "sharing w / count; a block of four warps owns 8 dq rows, each summed over the docs in "
                            "order from the saved tokens' rows",
    "maxsim_all_pairs": "split-TF32 mma.sync m16n8k8 (hi + lo of each f32 operand, three products; two for float16 "
                        "tokens), whole queries packed in row tiles of Lq rounded to 16, token chunks of 64 through a "
                        "3-stage cp.async ring, the max in registers, across the quad by shuffles and across warps in "
                        "shared memory; one launch serves a query batch's gathered candidate spans or all pairs",
}
DESIGN["mlp_rowsblk"] = DESIGN["mlp_rows2d"]  # one kernel behind both wrappers

BESIDE = ("headline", "fused_mha_ms", "fused_mha_device_ms", "x_bound", "chain_ms", "fused_mlp_block_ms",
          "chain_device_ms", "fused_mlp_block_device_ms",
          "device_ms", "host_ms", "library_device_ms", "library_call", "floor_device_ms",
          "f32_p_vs_f32_plain_mean_abs", "batched_vs_f32_plain_mean_abs", "parts", "parts_total_ms",
          "library_chain_ms", "product_library_ms", "product_library_call", "colbert_shape_identical")


def run_phases(sz, device, card: str) -> dict:
    import torch

    from matchmaker_tpu_torch.ops import _build

    report = {"card": card}
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library()
        report["build_s"] = time.perf_counter() - t0
        print(f"[build] kernels built and loaded in {report['build_s']:.1f} s ({_build.library_path().name})")
    kern = phase_encoder_kernels(sz, device)
    kern.update(phase_backward_kernels(sz, device))
    report["backward_parts"] = phase_backward_parts(sz, device)
    kern.update(phase_binmax_kernels(sz, device))
    kern.update(phase_int8_encoder_kernels(sz, device))
    kern.update(phase_int8_binmax_kernels(sz, device))
    kern.update(phase_maxsim_kernel(sz, device))
    kern.update(phase_maxsim_training(sz, device))
    kern.update(phase_mha_kernel(sz, device))
    t0 = time.perf_counter()
    kern.update(phase_probe_kernels(sz, device))
    report["probe_kernels_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        report["main"] = phase_main_path(sz, device, root)
        report["main_int8"] = phase_main_path_int8(sz, device, root, os.path.join(root, "run"))
        report["colbert"] = phase_colbert(sz, device, root)
    report["scale"] = phase_scale(sz, device)
    report["scale_int8"] = phase_scale_int8(sz, device)
    with tempfile.TemporaryDirectory() as root:
        report["train"] = phase_train(sz, device, root)
    with tempfile.TemporaryDirectory() as root:
        report["train_colbert"] = phase_train_colbert(sz, device, root)
    t0 = time.perf_counter()
    report["probes"] = phase_probes(sz, device)
    report["probes_s"] = time.perf_counter() - t0
    print(f"[probes] the probes' kernels against their plain versions took {report['probe_kernels_s']:.1f} s, "
          f"their own path {report['probes_s']:.1f} s")
    with tempfile.TemporaryDirectory() as root:
        report["recipe"] = phase_recipe(sz, device, root)
    check(set(report["main"]["launches"]) == {k[0] for k in KERNELS}, "a kernel without an entry")
    report["kernels"] = []
    for name, src, rep, inc in KERNELS:
        # "launches": the run of the kernel's own path: the bf16 serving run,
        # the int8 serving run that uses it (K9/K10 and K8: the mixed run,
        # K7: the two-stage run), the ColBERT serving run (K14) or the
        # training run, or for K15-K18 their probe's run; K13 lies on no
        # path; "launches_scale": the scale search of the same route (bf16
        # or int8; training and the probes: the bf16)
        runs = {"serve": report["main"]["launches"][name], "train": report["train"]["launches"][name],
                **{f"serve_int8_{r}": report["main_int8"][r]["launches"][name] for r, _, _ in INT8_RUNS},
                "serve_colbert": report["colbert"]["launches"][name],
                "train_colbert": report["train_colbert"]["launches"][name],
                "recipe": report["recipe"]["launches"][name],
                "probes": report["probes"]["launches"].get(name, 0)}
        scale_runs = {"scale_bf16": report["scale"]["launches"][name],
                      **{f"scale_int8_{r}": report["scale_int8"][r]["launches"][name]
                         for r, _, _ in SCALE_INT8_RUNS}}
        if name in SERVING:
            path, scale_path = "serve", "scale_bf16"
        elif name == "binmax_candidates_int8":
            path, scale_path = "serve_int8_int8_twostage", "scale_int8_int8"
        elif name in SERVING_INT8:
            path, scale_path = "serve_int8_mixed", "scale_int8_mixed"
        elif name == "maxsim_all_pairs":
            path, scale_path = "serve_colbert", "scale_bf16"
        elif name in ("maxsim_all_pairs_argmax", "maxsim_all_pairs_bwd"):
            path, scale_path = "train_colbert", "scale_bf16"
        elif name == "fused_mha":
            path, scale_path = None, "scale_bf16"
        elif name in PROBE_OF:
            path, scale_path = "probes", "scale_bf16"
        else:
            path, scale_path = "train", "scale_bf16"
        report["kernels"].append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep, **({"includes": inc} if inc else {}),
             **({"design": DESIGN[name]} if name in DESIGN else {}),
             "path": path, "launches": runs[path] if path else 0, **{f"launches_{r}": v for r, v in runs.items()},
             "launches_scale": scale_runs[scale_path], **{f"launches_{r}": v for r, v in scale_runs.items()},
             "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
             "bound_ms": kern[name]["bound_ms"], "bound_by": kern[name]["bound_by"],
             "library_ms": kern[name].get("library_ms"),
             "timed_shape": kern[name]["timed_shape"], **{k: kern[name][k] for k in BESIDE if k in kern[name]}})
    report["kernel_timings"] = {k[0]: kern[k[0]]["timings"] for k in KERNELS}
    if report["scale"]["level2_reduce"]:
        report["kernel_timings"]["level2_reduce"].append(dict(report["scale"]["level2_reduce"], path="scale_bf16"))
    report["torch"] = torch.__version__
    return report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import matchmaker_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    card = card_line()
    print(card)
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    report = run_phases(FULL, device, card)
    main_, scale = report["main"], report["scale"]
    print(f"[{card}] encode {main_['encode_psg_per_s']:.1f} psg/s end to end in the CLI "
          f"(tokenization included), {main_['encode_device_psg_per_s']:.1f} psg/s device-only at "
          f"{FULL['batch']}x{FULL['doc_len']}")
    print(f"[{card}] search {main_['search_qps']:.1f} QPS in the CLI (16,384 rows, top-{FULL['top_n']} and "
          f"top-{FULL['top_n_small']} sets, query encode included); {scale['qps']:.1f} QPS FlatIndex.search_rows and "
          f"{scale['device_qps']:.1f} QPS device-only at {FULL['scale_rows']} rows, k={FULL['scale_k']}")
    train = report["train"]
    print(f"[{card}] train {train['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer (validation "
          f"included), {train['device_triples_per_s']:.1f} triples/s device-only at batch {FULL['train_batch']} "
          f"(query {FULL['train_query_len']}, doc {FULL['train_doc_len']})")
    tc = report["train_colbert"]
    print(f"[{card}] ColBERT train {tc['cli_triples_per_s']:.1f} triples/s through cli.train's Trainer (validation "
          f"included), {tc['device_triples_per_s']:.1f} triples/s device-only at batch {FULL['train_batch']} "
          f"(query {FULL['train_query_len']}, doc {FULL['train_doc_len']}, compression 128); kernels vs plain: loss "
          f"gap {tc['plain_loss_gap']:.3g}, worst gradient cosine {tc['plain_grad_cos']:.6f}; overfit "
          f"{tc['overfit_first']:.4g} -> {tc['overfit_last']:.4g}")
    rc = report["recipe"]
    print(f"[{card}] TAS-B recipe ({rc['n_docs']} docs, {rc['model']}): MRR@10 {rc['MRR@10']:.4f}, Recall@100 "
          f"{rc['Recall@100']:.4f}, teacher pairwise accuracy {rc['teacher_pairwise_accuracy']:.4f}, "
          f"{rc['clusters']} clusters, stages (s) {rc['timings_s']}; effectiveness check MRR@10 "
          f"{rc['effectiveness']['MRR@10']:.4f}")
    int8, scale8 = report["main_int8"], report["scale_int8"]
    print(f"[{card}] int8 encode {int8['mixed']['encode_psg_per_s']:.1f} psg/s end to end in the CLI, "
          f"{int8['encode_device_psg_per_s']:.1f} psg/s device-only at {FULL['batch']}x{FULL['doc_len']} "
          f"(bf16 halves: {main_['encode_device_psg_per_s']:.1f}, int8 / bf16 "
          f"{int8['encode_device_psg_per_s'] / main_['encode_device_psg_per_s']:.3f}); int8 search at "
          f"{FULL['scale_rows']} rows, "
          f"k={FULL['scale_k']}: " + ", ".join(
              f"{r} recall@{FULL['scale_k']} {scale8[r]['recall']:.4f}, {scale8[r]['qps']:.1f} QPS search_rows, "
              f"{scale8[r]['device_qps']:.1f} device-only" for r, _, _ in SCALE_INT8_RUNS))
    col = report["colbert"]
    print(f"[{card}] colbert: {col['token_rows']} token rows ({col['index_device_bytes'] / 1e9:.3f} GB bf16 on the "
          f"card), encode {col['encode_psg_per_s']:.1f} psg/s and search {col['search_qps']:.1f} QPS in the CLI "
          f"(rescore included: {col['rescore_ms_per_batch']:.3f} ms a batch of {FULL['colbert_query_batch']} "
          f"queries), device-only per-token search {col['token_search_device_qps']:.1f} QPS; per-token "
          f"recall@{FULL['colbert_candidates']} {col['token_recall']:.4f}, recall@{FULL['colbert_top_n']} vs "
          f"exhaustive MaxSim {col['recall@10_vs_exhaustive']:.4f}")
    for k in report["kernels"]:
        device = (f" (device {k['device_ms']:.4f} ms, {k['x_bound']:.2f}x bound; library device "
                  f"{_fmt(k.get('library_device_ms'))})" if k.get("x_bound") else "")
        print(f"[{card}] {k['name']}: kernel {k['ms']:.4f} ms{device}, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}) at {k['timed_shape']}, max |d| {k['max_abs_err']:.3g}, "
              f"launches {k['launches']} in its path's run ({k['path']}), {k['launches_scale']} in the scale search")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
