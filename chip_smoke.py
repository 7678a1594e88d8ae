#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``matchmaker_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
1. the card's name and power limit; no CUDA device → exit 1;
2. build the CUDA kernels from ``matchmaker_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes: the encoder halves at DistilBERT width for (B, L) =
   (256, 128), (256, 200), (64, 30); their backward kernels (K11, K12) at the
   training shapes (64, 200) and (32, 30), at (256, 200) and at an odd
   L = 77 with padded keys, every gradient compared; the binmax scan, level 2
   and unpack on 262,144 x 768 rows and 256 queries; with CUDA-event timings
   of both;
4. the main path, ``cli.dense_retrieval.run("encode+index+search")``, on a
   seeded 16,384-passage collection with a DistilBERT-width BERT_DOT
   (random weights from a seed), searching one query set at top-100 and one
   at top-10 (the latter takes the level-2 tournament): output files, the
   launch count of every kernel in that run, recall against an exact search
   of the same bf16 rows, and a re-encode with the plain versions;
5. ``FlatIndex`` search at 1,048,576 x 768 rows, Q = 256, k = 1000 (the
   keep-8/32 level-2 path): recall@1000 against an exact search and QPS;
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
   steps.

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


def _pair_ms(kernel, plain, device, reps):
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    p1 = _time_ms(plain, device, reps)
    k1 = _time_ms(kernel, device, reps)
    k2 = _time_ms(kernel, device, reps)
    p2 = _time_ms(plain, device, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _record(entry, shape, kernel, plain, device, reps, headline):
    """Time kernel and plain at one shape into entry["timings"]; the
    headline shape also gives the entry's "ms" / "plain_ms"."""
    ms, plain_ms = _pair_ms(kernel, plain, device, reps)
    entry.setdefault("timings", []).append({"shape": shape, "ms": ms, "plain_ms": plain_ms})
    print(f"[kernels]   timed {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if headline:
        entry.update(ms=ms, plain_ms=plain_ms, timed_shape=shape)


def _rows_close(a, b):
    import torch

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    return float(cos.min()), float((a - b).abs().max())


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
        g = torch.Generator(device=device).manual_seed(100 + i)
        x = torch.randn(b, l, sz["hid"], generator=g, device=device).to(torch.bfloat16)
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
        a_args = (*attn, mask, sz["heads"], *ln1)
        m_args = (*mlp, *ln2)
        cases = (("fused_attention_block", fa.fused_attention_block, fa.reference_attention_block, a_args),
                 ("fused_mlp_block", fa.fused_mlp_block, fa.reference_mlp_block, m_args))
        for name, kernel, plain, args in cases:
            got, want = kernel(x, *args), plain(x, *args)
            cos, err = _rows_close(got, want)
            print(f"[kernels] {name} B={b} L={l}: min row cosine {cos:.6f}, max |d| {err:.4g}")
            check(got.shape == x.shape and bool(torch.isfinite(got.float()).all()), f"{name} output at {(b, l)}")
            check(cos >= 0.999 and err <= 0.1, f"{name} vs plain at {(b, l)}: cos {cos}, max |d| {err}")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], lambda k=kernel, a=args: k(x, *a),
                    lambda p=plain, a=args: p(x, *a), device, sz["reps"], headline=i == 0)
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
        for name, kernel, plain, name_k, name_p, scale_of in cases:
            got, want = name_k(kernel()), name_p(plain())
            check(got["dx"].shape == x.shape and all(bool(torch.isfinite(t).all()) for t in got.values()),
                  f"{name} gradients at {(b, l)}")
            err = grads_close(got, want, scale_of)
            print(f"[kernels] {name} B={b} L={l}: {len(got)} gradients within cosine 0.999, "
                  f"max |d| <= 2e-2 max |plain| (largest |d| {err:.4g})")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            _record(out[name], [b, l, sz["hid"]], kernel, plain, device, sz["bwd_reps"], headline=i == 0)
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


def phase_binmax_kernels(sz, device):
    import torch

    from matchmaker_tpu_torch.ops import mips_binmax as mb

    n, tile = sz["scan_rows"], 2048
    rows, q = _clustered(n, sz["hid"], 256, device, seed=5, n_queries=sz["scan_queries"])
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    out = {"binmax_candidates": {"max_abs_err": 0.0}, "level2_reduce": {"max_abs_err": 0.0},
           "unpack_candidates": {"max_abs_err": 0.0}}
    packed8 = None
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
                lambda pb=per_bin: mb._scan_plain(qb, c, n, pb, tile), device, sz["reps"], headline=per_bin == 8)
        packed8 = got
    for width in (mb.L2_MID, mb.L2_WIDE):
        got = mb._level2_reduce(packed8, width)
        want = mb._level2_plain(packed8, width)
        share = float((got.view(torch.int32) == want.view(torch.int32)).float().mean())
        fin = torch.isfinite(want)
        err = float((got - want)[fin].abs().max())
        print(f"[kernels] level 2 width={width}: identical {share:.6f}, max |d| {err:.3g}")
        check(share >= 0.999, f"level 2 width {width}: {share} identical")
        out["level2_reduce"]["max_abs_err"] = max(out["level2_reduce"]["max_abs_err"], err)
        _record(out["level2_reduce"], list(packed8.shape) + [width],
                lambda w=width: mb._level2_reduce(packed8, w), lambda w=width: mb._level2_plain(packed8, w),
                device, sz["reps"], headline=width == mb.L2_MID)
    k = sz["scan_k"]
    reduced = mb._level2_reduce(packed8, mb.L2_MID)
    top, pos = torch.topk(reduced, k, dim=1)
    gv, gi = mb.unpack_candidates(top, pos, tile, 8, mb.L2_MID)
    wv, wi = mb._unpack_plain(top, pos, tile, 8, mb.L2_MID)
    check(bool(torch.equal(gi, wi)), "unpack ids differ from the plain version")
    out["unpack_candidates"]["max_abs_err"] = float((gv - wv).abs().max())
    _record(out["unpack_candidates"], list(top.shape), lambda: mb.unpack_candidates(top, pos, tile, 8, mb.L2_MID),
            lambda: mb._unpack_plain(top, pos, tile, 8, mb.L2_MID), device, sz["reps"], headline=True)
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
    from matchmaker_tpu_torch.ops.mips_binmax import binmax_scan_topk

    per_bin = index._per_bin(k)
    ms = _time_ms(lambda: binmax_scan_topk(qb, index._device_vectors, k, n_valid=n, per_bin=per_bin),
                  device, sz["reps"])
    print(f"[scale] {n} rows x {sz['hid']}, Q={len(queries)}, k={k}, per_bin={per_bin}: recall@{k} {recall:.4f}, "
          f"search_rows {qps:.1f} QPS, device scan+top-k {ms:.3f} ms ({len(queries) / ms * 1e3:.1f} QPS)")
    check(recall >= 0.95, f"recall@{k} {recall} < 0.95")
    return {"launches": launches, "recall": recall, "qps": qps, "device_ms": ms,
            "device_qps": len(queries) / ms * 1e3, "per_bin": per_bin}


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

    from matchmaker_tpu.data.loaders import triple_training_loader

    batch = next(iter(triple_training_loader(config, tokenizer, path)))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _profile_steps(step, batch, step_ms, n=3):
    """Device time by kernel over n training steps (torch.profiler), and the
    device's busy share of ``step_ms``, the step time CUDA events measured
    without the profiler (whose own overhead stretches the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernels only: a kernel launched through ctypes is also counted as
        # self device time of the CPU range around it (the autograd Function),
        # and a GPU user annotation (Optimizer.step) spans kernels of its own
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / n, ev.count // n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[train] profile of {n} steps: kernels {busy:.2f} ms a step, {busy / step_ms:.1%} of the "
          f"{step_ms:.2f} ms step without the profiler ({wall_ms / n:.2f} ms wall under it)")
    for key, ms, count in rows[:14]:
        print(f"[train]   {ms:8.3f} ms/step {ms / busy if busy else 0:6.1%}  x{count:<4d} {key[:110]}")
    return {"device_ms_per_step": busy, "busy_share": busy / step_ms, "profiled_wall_ms_per_step": wall_ms / n,
            "top": [{"kernel": k[:200], "ms_per_step": ms, "calls_per_step": c} for k, ms, c in rows[:25]]}


def _hardest_negatives(model, batch):
    """Each query's in-batch hardest negative (column of q·[d_pos; d_neg]ᵀ
    outside the diagonal), as the in-batch loss picks it."""
    import torch

    with torch.no_grad():
        pos, neg = model.forward_triple(batch)
    q = pos["query_vecs"].float()
    scores = q @ torch.cat([pos["doc_vecs"], neg["doc_vecs"]]).float().t()
    b = q.shape[0]
    scores[:, :b] = scores[:, :b].masked_fill(torch.eye(b, dtype=torch.bool, device=q.device), float("-inf"))
    return scores.argmax(dim=1)


def _kernels_vs_plain_step(model, config, batch):
    """One step's loss and gradients from the same parameters through the
    kernels and through the plain versions. The loss with in-batch negatives
    is compared as it is (relative gap <= 1e-2). The gradients are compared
    under its Margin-MSE part (cosine >= 0.99 for every parameter): the
    in-batch loss picks each query's hardest negative by an argmax, and a
    score difference at bf16 rounding level can move that pick to another
    document, which changes the gradient whatever the kernels compute; the
    number of picks that move is reported."""
    import torch

    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    full = make_loss_fn(model, get_loss(config), config)
    smooth = make_loss_fn(model, get_loss(dict(config, in_batch_negatives=False)), config)

    def run():
        with torch.no_grad():
            loss = float(full(batch)[0])
        model.zero_grad(set_to_none=True)
        smooth(batch)[0].backward()
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        return loss, grads, _hardest_negatives(model, batch)

    lk, gk, hk = run()
    with plain_encoder_blocks():
        lp, gp, hp = run()
    model.zero_grad(set_to_none=True)
    rel = abs(lk - lp) / max(abs(lp), 1e-12)
    moved = int((hk != hp).sum())
    cosines = {}
    for name, a in gk.items():
        b = gp[name]
        if name.endswith("attention.key.bias"):
            # zero in exact arithmetic (each softmax row's gradient sums to
            # zero): rounding noise, bounded by the query bias's gradient
            ref = float(gp[name.replace("key.bias", "query.bias")].abs().max())
            check(float((a - b).abs().max()) <= 2e-2 * ref, f"{name}: gradient noise above 2e-2 of the query bias's")
            continue
        cosines[name] = float(torch.nn.functional.cosine_similarity(a.reshape(-1), b.reshape(-1), dim=0))
    worst = sorted(cosines.items(), key=lambda kv: kv[1])[:3]
    print(f"[train] one step, kernels vs plain: loss {lk:.6g} vs {lp:.6g} (relative gap {rel:.3g}); in-batch "
          f"hardest negative moved for {moved} of {len(hk)} queries; Margin-MSE gradients of {len(cosines)} "
          f"parameters, worst cosines " + ", ".join(f"{n} {c:.6f}" for n, c in worst))
    check(rel <= 1e-2, f"loss with the kernels {lk} vs plain {lp}")
    check(worst[0][1] >= 0.99, f"gradient cosine {worst[0][1]} at {worst[0][0]}")
    return rel, worst[0][1], moved


def phase_train(sz, device, root):
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.training.optim import build_optimizer
    from matchmaker_tpu_torch.training.train_step import make_train_step
    from matchmaker_tpu_torch.training.trainer import Trainer

    paths = _write_train_data(root, sz)
    config = _train_config(paths, sz, device)
    run_folder = os.path.join(root, "train_run")
    os.makedirs(run_folder)
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
    print(f"[train] launches in the cli.train run: {launches}")
    result = {"wall_s": wall, "launches": launches, "steps": trainer.global_step}
    check(trainer.global_step == sz["train_batches"] and len(step_losses) == sz["train_batches"],
          f"{trainer.global_step} training steps, {len(step_losses)} losses")
    losses = torch.stack(step_losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), "a non-finite training loss")
    result.update(loss_first=float(losses[0]), loss_last=float(losses[-1]))
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
    with open(os.path.join(run_folder, "efficiency-metrics.json")) as f:
        train_block = json.load(f)[-1]["blocks"]["train"]
    result["cli_triples_per_s"] = sz["train_batches"] * sz["train_batch"] / train_block["total_seconds"]

    batch = _device_batch(config, trainer.tokenizer, paths["train"], device)
    ms = _time_ms(lambda: trainer.train_step(batch), device, sz["reps"])
    result.update(step_ms=ms, device_triples_per_s=sz["train_batch"] / ms * 1e3)
    print(f"[train] {trainer.global_step} steps: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}; "
          f"{result['cli_triples_per_s']:.1f} triples/s through the Trainer (validation included), "
          f"{result['device_triples_per_s']:.1f} device-only ({ms:.2f} ms a step)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        result["profile"] = _profile_steps(trainer.train_step, batch, ms)
        result["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[train] peak device memory over the profiled steps {result['peak_mem_gb']:.2f} GB")
    result["plain_loss_gap"], result["plain_grad_cos"], result["hardest_negatives_moved"] = \
        _kernels_vs_plain_step(trainer.model, config, batch)

    # one-batch overfit: no warmup, a constant learning rate
    fit_config = dict(config, lr_schedule="constant", optimizer_warmup_steps=0, param_group0_learning_rate=1e-4,
                      embedding_optimizer_learning_rate=1e-4, param_group1_learning_rate=1e-3)
    fit_step = make_train_step(trainer.model, trainer.losses, build_optimizer(fit_config, trainer.model), fit_config)
    fit = [float(fit_step(batch)["ranking_loss"]) for _ in range(sz["overfit_steps"])]
    result.update(overfit_first=fit[0], overfit_last=fit[-1])
    print(f"[train] one-batch overfit, {sz['overfit_steps']} steps: Margin-MSE {fit[0]:.4f} -> {fit[-1]:.4f}")
    check(fit[-1] <= 0.5 * fit[0], f"overfitting one batch took Margin-MSE only from {fit[0]} to {fit[-1]}")
    return result


SERVING = ("fused_attention_block", "fused_mlp_block", "binmax_candidates", "level2_reduce", "unpack_candidates")

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
]


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
    kern.update(phase_binmax_kernels(sz, device))
    with tempfile.TemporaryDirectory() as root:
        report["main"] = phase_main_path(sz, device, root)
    report["scale"] = phase_scale(sz, device)
    with tempfile.TemporaryDirectory() as root:
        report["train"] = phase_train(sz, device, root)
    check(set(report["main"]["launches"]) == {k[0] for k in KERNELS}, "a kernel without an entry")
    report["kernels"] = []
    for name, src, rep, inc in KERNELS:
        # "launches": the run of the kernel's own path (serving or training)
        path = "serve" if name in SERVING else "train"
        runs = {"serve": report["main"]["launches"][name], "train": report["train"]["launches"][name]}
        report["kernels"].append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep, **({"includes": inc} if inc else {}),
             "path": path, "launches": runs[path], "launches_serve": runs["serve"],
             "launches_train": runs["train"], "launches_scale": report["scale"]["launches"][name],
             "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]})
    report["kernel_timings"] = {k[0]: kern[k[0]]["timings"] for k in KERNELS}
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
    for k in report["kernels"]:
        print(f"[{card}] {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"max |d| {k['max_abs_err']:.3g}, launches {k['launches_serve']} in the serving CLI run, "
              f"{k['launches_train']} in the training run, {k['launches_scale']} in the scale search")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
