#!/usr/bin/env python3
"""Time the binmax scans (K3, K7, K8), level 2 (K4), unpack (K6) and searches of two checkouts on one card, in turns.

    python3 tools/binmax_scan_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 10] [--out FILE]

BASE_DIR and NEW_DIR are roots of checkouts of this repository (for example
a parent commit unpacked with ``git archive`` under ``build/``, and ``.``).
Each turn is a fresh process that imports ``matchmaker_tpu_torch`` from its
checkout (the turn loop of ``tools/ab_turns.py``), so its kernels build from
that checkout's sources into that checkout's ``build/``, and times, with CUDA events after two warm-up calls
and on data made from seeds as ``chip_smoke.py`` makes it (its
``_clustered`` rows, of this checkout):

- ``binmax_candidates`` over 262,144 x 768 rows and 256 queries: K3 (bf16
  rows and queries), K7 (int8 codes with bin scales, int8 query codes) and
  K8 (the same codes, bf16 queries) at per_bin 2 and 8, the shapes of
  ``chip_smoke.py`` phase 3;
- ``FlatIndex`` device searches (scan, level 2, top-k, unpack) of 256
  queries at k 1000 over 1,048,576 x 768 rows, the rows of phase 5: the
  bf16 route (K3), the default int8 route (int8 queries, K7 alone) and the
  mixed route (``mips_int8_queries: float``, K8);
- K4 and K6 alone, each at the shapes the paths launch it: K4 width 32 and
  128 over the per_bin-8 candidates above (256 x 16,384) and width 32 over
  the 1M-row bf16 search's own (per_bin 2); K6 on the top 1,000 of the
  width-32 reductions (256 x 1,000) and on the top 4,000 of per_bin-4
  candidates (the two-stage route's fetch); each held to its plain version
  bit for bit, with its device time (``chip_smoke._device_ms``: the
  kernels' durations from torch.profiler), its CUDA-event time over
  back-to-back calls and its host time a call; beside K4 the device time
  of ``torch.topk(x.view(Q, G, w), 8)``, beside K6 that of an empty
  kernel at K6's grid (where the checkout has one);
- ColBERT's per-token search over 1,350,000 token rows of width 128 (a
  ``FlatIndex`` with the CLI's ColBERT geometry: per_bin 1, 4096-row tiles,
  48 candidates a token) for one batch of 8,192 query token rows: the
  route's event and device time, then K4 (width 128, 8,192 x 11,264) and
  K6 (8,192 x 48) on its scan's candidates.

The turns run in the order of ``--turns`` (A = BASE_DIR, B = NEW_DIR), so
both checkouts meet the same card. One JSON line per turn, then the card's
name and power limit, then a JSON line with each checkout's mean of each
time (the device and host times under ``device_ms`` and ``host_ms``; None
off the card). ``--device cpu --tiny`` rehearses the script on a CPU at a
small size (the plain versions).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import ab_turns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py, for its timer and its seeded rows."""
    spec = importlib.util.spec_from_file_location("_binmax_scan_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_turn(checkout: str, reps: int, device_name: str, tiny: bool) -> dict:
    """Time the scans and searches of the port in ``checkout`` (this process)."""
    ab_turns.import_port(checkout)
    import numpy as np
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import mips_binmax as mb
    from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus_binwise, quantize_queries
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    cs = _chip_smoke()
    device = torch.device(device_name)
    sz = dict(cs.FULL)
    if tiny:
        sz.update(hid=64, scan_rows=8192, scan_queries=16, scan_k=10, scale_rows=32_768, scale_k=10, scale_clusters=64,
                  colbert_token_rows=20_000, colbert_query_batch=4, colbert_dim=32)
    if device.type == "cuda":
        _build.library()
    torch.set_float32_matmul_precision("highest")

    n, hid = sz["scan_rows"], sz["hid"]
    rows, q = cs._clustered(n, hid, 256, device, seed=5, n_queries=sz["scan_queries"])
    c, qb = rows.to(torch.bfloat16), q.to(torch.bfloat16)
    codes, scales = (torch.from_numpy(a).to(device) for a in quantize_corpus_binwise(rows.cpu().numpy()))
    q8, qs = quantize_queries(q)
    del rows
    scans, dev, host, bounds = {}, {}, {}, {}
    for per_bin in (2, 8):
        scans[f"K3 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(qb, c, n_valid=n, per_bin=pb), device, reps)
        scans[f"K7 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(q8, codes, n_valid=n, per_bin=pb, corpus_scales=scales,
                                                    query_scales=qs), device, reps)
        scans[f"K8 per_bin {per_bin}"] = cs._time_ms(
            lambda pb=per_bin: mb.binmax_candidates(qb, codes, n_valid=n, per_bin=pb, corpus_scales=scales),
            device, reps)
    del codes

    def level2(name, packed, width):
        rec = cs.level2_timings(mb, packed, width, device, reps)
        if rec["identical"] != 1.0:
            raise RuntimeError(f"{name}: level 2 differs from its plain version ({rec['identical']} identical)")
        scans[name], dev[name], host[name] = rec["ms"], rec["device_ms"], rec["host_ms"]
        bounds[name] = rec["bound_ms"]
        dev[f"{name} torch.topk"] = rec["library_device_ms"]

    def unpack(name, packed, k, tile, per_bin, width):
        top, pos = torch.topk(packed, k, dim=1)
        rec = cs.unpack_timings(mb, _build, top, pos, tile, per_bin, width, device, reps)
        if not rec["exact"]:
            raise RuntimeError(f"{name}: unpack differs from its plain version")
        scans[name], dev[name], host[name] = rec["ms"], rec["device_ms"], rec["host_ms"]
        bounds[name] = rec["bound_ms"]
        dev[f"{name} empty kernel"] = rec["floor_device_ms"]

    # K4 and K6 at chip_smoke.py phase 3's shapes
    packed8 = mb.binmax_candidates(qb, c, n_valid=n, per_bin=8)
    level2("K4 w32 per_bin 8", packed8, mb.L2_MID)
    level2("K4 w128 per_bin 8", packed8, mb.L2_WIDE)
    unpack("K6 level2 32", mb._level2_reduce(packed8, mb.L2_MID), sz["scan_k"], 2048, 8, mb.L2_MID)
    unpack("K6 two-stage", mb.binmax_candidates(qb, c, n_valid=n, per_bin=4), 4 * sz["scan_k"], 2048, 4, None)
    del c, packed8

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
        if name == "bf16":  # the search's own level-2 input (per_bin 2 at 1M rows: keep-8/32)
            cands = mb.binmax_candidates(q, index._device_vectors, n_valid=n, per_bin=index._per_bin(k))
            level2("K4 w32 1M search", cands, mb.L2_MID)
            unpack("K6 1M search", mb._level2_reduce(cands, mb.L2_MID), k, 2048, index._per_bin(k), mb.L2_MID)
            del cands
        del index
    del vectors

    # ColBERT's per-token search: a query batch's token rows over the token
    # index with the CLI's ColBERT geometry (per_bin 1, 4096-row tiles,
    # colbert_candidates a token), the whole route, then K4 and K6 on its
    # scan's candidates
    n_tok, dim, cand = sz["colbert_token_rows"], sz["colbert_dim"], sz["colbert_candidates"]
    rows, qt = cs._clustered(n_tok, dim, 1024, device, seed=8,
                             n_queries=sz["colbert_query_batch"] * sz["colbert_query_len"])
    index = FlatIndex({"token_dtype": "float16", "mips_quantization": "float16", "mips_kernel": "binmax",
                       "mips_per_bin": 1, "mips_tile_rows": 4096}, device)
    index.prepare(dim)
    index.index(np.arange(n_tok), rows.cpu().numpy())
    del rows
    index._ensure_device()
    route = "colbert per-token search"
    searches[route] = cs._time_ms(lambda: index._search_device(qt, cand), device, reps)
    dev[route] = cs._device_ms(lambda: index._search_device(qt, cand), device, reps)
    cands = mb.binmax_candidates(qt, index._device_vectors, n_valid=n_tok, per_bin=1, tile_rows=4096)
    cands = torch.nn.functional.pad(cands, (0, -cands.shape[1] % 1024), value=float("-inf"))
    level2("K4 w128 colbert", cands, mb.L2_WIDE)
    unpack("K6 colbert", mb._level2_reduce(cands, mb.L2_WIDE), cand, 4096, 1, mb.L2_WIDE)
    return {"checkout": checkout, "scan_shape": [sz["scan_rows"], hid, sz["scan_queries"]],
            "search_shape": [n, hid, 256, k], "colbert_shape": [n_tok, dim, qt.shape[0], cand],
            "ms": {**scans, **searches}, "device_ms": dev, "host_ms": host, "bound_ms": bounds}


if __name__ == "__main__":
    sys.exit(ab_turns.main(argparse.ArgumentParser(description=__doc__.split("\n\n")[0]), run_turn,
                           kinds=("device_ms", "host_ms")))
