#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``matchmaker_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):
1. the card's name and power limit; no CUDA device → exit 1;
2. build the CUDA kernels from ``matchmaker_tpu_torch/csrc``;
3. every kernel against its plain PyTorch version on the card, at the main
   path's shapes: the encoder halves at DistilBERT width for (B, L) =
   (256, 128), (256, 200), (64, 30); the binmax scan, level 2 and unpack on
   262,144 x 768 rows and 256 queries; with CUDA-event timings of both;
4. the main path, ``cli.dense_retrieval.run("encode+index+search")``, on a
   seeded 16,384-passage collection with a DistilBERT-width BERT_DOT
   (random weights from a seed), searching one query set at top-100 and one
   at top-10 (the latter takes the level-2 tournament): output files, the
   launch count of every kernel in that run, recall against an exact search
   of the same bf16 rows, and a re-encode with the plain versions;
5. ``FlatIndex`` search at 1,048,576 x 768 rows, Q = 256, k = 1000 (the
   keep-8/32 level-2 path): recall@1000 against an exact search and QPS.

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
    """Route the encoder's fused halves to their plain versions."""
    import matchmaker_tpu_torch.models.encoder as enc
    from matchmaker_tpu_torch.ops import fused_attention as fa

    def plain_attention(x, wqkv, bqkv, wo, bo, *rest):
        wq, wk, wv = wqkv.chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return fa.reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, *rest)

    saved = enc.fused_attention_block_qkv, enc.fused_mlp_block
    enc.fused_attention_block_qkv, enc.fused_mlp_block = plain_attention, fa.reference_mlp_block
    try:
        yield
    finally:
        enc.fused_attention_block_qkv, enc.fused_mlp_block = saved


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
        for name in launches:  # every kernel of the path, level 2 through the top-10 set
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
    kern.update(phase_binmax_kernels(sz, device))
    with tempfile.TemporaryDirectory() as root:
        report["main"] = phase_main_path(sz, device, root)
    report["scale"] = phase_scale(sz, device)
    check(set(report["main"]["launches"]) == {k[0] for k in KERNELS}, "a kernel without an entry")
    report["kernels"] = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, **({"includes": inc} if inc else {}),
         "launches": report["main"]["launches"][name], "launches_scale": report["scale"]["launches"][name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"]}
        for name, src, rep, inc in KERNELS]
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
    for k in report["kernels"]:
        print(f"[{card}] {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"max |d| {k['max_abs_err']:.3g}, launches {k['launches']} in the CLI run, "
              f"{k['launches_scale']} in the scale search")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
