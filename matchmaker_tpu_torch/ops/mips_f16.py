"""Exact scan over a 16-bit corpus: counterpart of
``matchmaker_tpu/ops/mips_f16.py:f16_scan_topk`` — FlatIndex's
``mips_quantization: float16`` + ``mips_kernel: scan`` route, and the exact
fallback of its binmax route for corpora too small for its candidate pool.

Plain PyTorch: both operands rounded to bf16 (as the JAX scan does) and
upcast to f32 for a full-f32 product — a bf16 ``torch.matmul`` on CUDA would
round its output to bf16, where JAX asks for f32 — then the top-k, ties to
the lower row (``ops.topk_lowest_first``). With ``block_size`` the corpus is
scanned in blocks of that many rows, each block's top-k merged by one more
top-k, so the (Q, rows) scores never exist at once. The top-k is exact: the
JAX package's ``approx=True`` (``lax.approx_max_k``, a TPU hardware top-k)
has no counterpart here. :func:`sharded_f16_scan_topk` runs the scan a
shard over a row-sharded corpus, each shard masked at its local validity
bound, and merges the partials (parallel/mesh.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first
from matchmaker_tpu_torch.parallel.mesh import Mesh, merge_topk, n_shards, pad_partial


def f16_scan_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, n_valid: Optional[int] = None,
                  block_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of queries (Q, D) against corpus (N, D) over bf16-rounded
    operands; rows at/after ``n_valid`` never enter (zero padding scores 0.0,
    which can displace real sub-zero hits). ``block_size`` None: one product
    over the whole corpus. → (values f32, ids int64)"""
    n = corpus.shape[0]
    k = min(k, n)
    limit = n if n_valid is None else min(int(n_valid), n)
    qb = queries.to(torch.bfloat16)
    step = n if block_size is None or block_size >= n else block_size
    vals, ids = [], []
    for start in range(0, n, step):
        scores = matmul_f32(qb, corpus[start:start + step].to(torch.bfloat16).T)
        if start + scores.shape[1] > limit:
            scores[:, max(limit - start, 0):] = float("-inf")
        v, i = topk_lowest_first(scores, min(k, scores.shape[1]))
        vals.append(v)
        ids.append(i + start)
    if len(vals) == 1:
        return vals[0], ids[0]
    v, pos = topk_lowest_first(torch.cat(vals, dim=1), k)
    return v, torch.gather(torch.cat(ids, dim=1), 1, pos)


def sharded_f16_scan_topk(queries: torch.Tensor, corpus, k: int, mesh: Optional[Mesh] = None,
                          n_valid: Optional[int] = None,
                          block_size: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`f16_scan_topk` over a corpus row-sharded over ``mesh`` (a
    :class:`ShardedRows`; a plain tensor without a mesh of more than one
    entry): a shard's rows past the global ``n_valid`` never enter its
    partial, whose -inf slots carry id -1."""
    if n_shards(mesh) <= 1:
        return f16_scan_topk(queries, corpus, k, n_valid=n_valid, block_size=block_size)
    rows = corpus.rows
    n_valid = rows * corpus.n_shards if n_valid is None else n_valid
    partials = []
    for s, part in corpus:
        base = s * rows
        local_valid = min(max(n_valid - base, 0), rows)
        vals, idx = pad_partial(*f16_scan_topk(queries.to(part.device), part, k, n_valid=local_valid,
                                               block_size=block_size), k)
        partials.append((vals, torch.where(torch.isfinite(vals) & (idx >= 0), idx + base, -1)))
    return merge_topk(partials, k, queries.device)
