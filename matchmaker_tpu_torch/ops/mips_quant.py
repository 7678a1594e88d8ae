"""Int8 corpus quantization and the exact int8 scan: counterpart of
``matchmaker_tpu/ops/mips_quant.py`` (single device; that module has no
Pallas kernel).

- :func:`quantize_corpus`: per-row or one global absmax scale;
- :func:`quantize_corpus_binwise`: one scale per 128-row bin, the int8
  binmax scan's layout (ops/mips_binmax.py);
- :func:`quantized_blocked_topk`: the blocked top-k over an int8 corpus
  that FlatIndex's ``mips_kernel: scan`` route runs and its binmax route
  falls back to for corpora too small for the candidate pool.

The quantizers are host numpy code, copied from the JAX package, so codes
and scales are bit-identical. They run row-parallel over a thread pool
(``row_parallel``: numpy releases the GIL in its loops), each block of
rows (of whole bins) through the same per-row arithmetic, so the codes
and scales are the serial ones bit for bit. The scan runs torch ops: an int8 product as
the f32 product of the codes (exact while 127²·D < 2²⁴, i.e. D ≤ 1040,
checked) with TF32 kept out (``ops.matmul_codes``). The top-k is exact,
ties to the lower row as in JAX (``ops.topk_lowest_first``); the JAX
package's ``approx=True`` (``lax.approx_max_k``, a TPU hardware
top-k) has no counterpart here, so ``mips_approx_topk`` changes nothing.
:func:`sharded_quantized_topk` runs the scan a shard over a row-sharded
corpus (per-row scales sharded alike, a global scale on every shard) and
merges the partials (parallel/mesh.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import matmul_codes, over_127, topk_lowest_first
from matchmaker_tpu_torch.parallel.mesh import Mesh, ShardedRows, merge_topk, n_shards, pad_partial


# rows a block of the host's row-parallel work (a few MB of f32 rows at 768 wide)
ROW_BLOCK = 4096


def row_parallel(n: int, fn: Callable[[int, int], object], block: int = ROW_BLOCK) -> list:
    """``fn(start, stop)`` over the blocks of ``block`` rows that cover
    [0, n), on a pool of a thread a core; the results in block order."""
    ranges = [(a, min(n, a + block)) for a in range(0, n, block)]
    workers = min(len(ranges), os.cpu_count() or 1)
    if workers <= 1:
        return [fn(a, b) for a, b in ranges]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda r: fn(*r), ranges))


def quantize_corpus(vectors: np.ndarray, per_row: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) float → (int8 values, f32 scales): per-row absmax scales (N,),
    or with ``per_row=False`` one global scale (shape ``()``), under which
    score order is scale-free and only the k winners are rescaled. Row
    blocks on a thread pool (``row_parallel``)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    values = np.empty(vectors.shape, dtype=np.int8)
    if per_row:
        scales_out = np.empty(vectors.shape[0], dtype=np.float32)

        def part(a, b):
            scales = np.abs(vectors[a:b]).max(axis=1, keepdims=True) / 127.0
            scales = np.maximum(scales, 1e-10)
            values[a:b] = np.clip(np.round(vectors[a:b] / scales), -127, 127).astype(np.int8)
            scales_out[a:b] = scales.astype(np.float32).squeeze(1)

        row_parallel(vectors.shape[0], part)
        return values, scales_out
    absmax = max(row_parallel(vectors.shape[0], lambda a, b: np.abs(vectors[a:b]).max()))
    scale = np.float32(max(absmax / 127.0, 1e-10))

    def part_global(a, b):
        values[a:b] = np.clip(np.round(vectors[a:b] / scale), -127, 127).astype(np.int8)

    row_parallel(vectors.shape[0], part_global)
    return values, np.asarray(scale, dtype=np.float32)


def quantize_corpus_binwise(vectors: np.ndarray, bin_width: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) float → (int8 values padded to a bin multiple, (N'/bin_width, 1)
    f32 bin scales): one absmax scale per ``bin_width`` consecutive rows.
    FlatIndex permutes the rows first, so each bin is an i.i.d. sample of the
    corpus and the bin's absmax is a tight envelope of its rows'. Blocks of
    whole bins on a thread pool (``row_parallel``)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    n_pad = -(-n // bin_width) * bin_width
    if n_pad != n:
        vectors = np.pad(vectors, ((0, n_pad - n), (0, 0)))
    values = np.empty((n_pad, d), dtype=np.int8)
    scales_out = np.empty(n_pad // bin_width, dtype=np.float32)

    def part(a, b):
        scales = np.abs(vectors[a:b]).reshape(-1, bin_width, d).max(axis=(1, 2)) / 127.0
        scales = np.maximum(scales, 1e-10).astype(np.float32)
        values[a:b] = np.clip(np.round(vectors[a:b] / np.repeat(scales, bin_width)[:, None]), -127, 127
                              ).astype(np.int8)
        scales_out[a // bin_width: b // bin_width] = scales

    row_parallel(n_pad, part, -(-ROW_BLOCK // bin_width) * bin_width)
    return values, scales_out.reshape(-1, 1)


def quantize_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and (Q, 1) f32 scales of float queries,
    max(absmax / 127, 1e-10), rounded half to even (as the JAX scans)."""
    qf = queries.float()
    q_scale = torch.clamp(over_127(qf.abs().amax(dim=1, keepdim=True)), min=1e-10)
    return torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8), q_scale


def quantized_blocked_topk(
    queries: torch.Tensor,  # (Q, D) f32
    values: torch.Tensor,  # (N, D) int8
    scales: torch.Tensor,  # (N,) f32, or () for one global scale
    k: int,
    block_size: int = 131072,
    n_valid: Optional[int] = None,
    index_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact blocked top-k over an int8 corpus, (values (Q, k), int64 ids
    shifted by ``index_offset``).

    The queries are quantized per row too, so the product is int8 × int8 and
    scores are rescaled by both sides' scales. ``n_valid`` masks zero-padded
    tail rows."""
    n = values.shape[0]
    limit = n if n_valid is None else min(int(n_valid), n)
    k = min(k, n)
    n_blocks = -(-n // block_size)
    k_block = min(k, block_size)
    global_scale = scales.dim() == 0
    padded_n = n_blocks * block_size
    if padded_n != n:
        values = F.pad(values, (0, 0, 0, padded_n - n))
        if not global_scale:
            scales = F.pad(scales, (0, padded_n - n))
    q_int, q_scale = quantize_queries(queries)

    block_vals, block_idx = [], []
    for b in range(n_blocks):
        base = b * block_size
        vb = values[base:base + block_size]
        raw = matmul_codes(q_int, vb.T)
        scores = raw if global_scale else raw * q_scale * scales[base:base + block_size][None, :]
        rows = base + torch.arange(block_size, device=scores.device)
        scores = torch.where(rows[None, :] < limit, scores, float("-inf"))
        v, i = topk_lowest_first(scores, k_block)
        block_vals.append(v)
        block_idx.append(base + i)
    all_vals = torch.cat(block_vals, dim=1)
    all_idx = torch.cat(block_idx, dim=1)
    vals, pos = topk_lowest_first(all_vals, min(k, all_vals.shape[1]))
    idx = torch.gather(all_idx, 1, pos) + index_offset
    if global_scale:
        vals = vals * scales * q_scale
    return vals, idx


def sharded_quantized_topk(queries: torch.Tensor, values, scales, k: int, mesh: Optional[Mesh] = None,
                           block_size: int = 131072,
                           n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantized_blocked_topk` over a corpus row-sharded over
    ``mesh`` (``values`` and per-row ``scales`` :class:`ShardedRows`, or a
    0-d global scale; plain tensors without a mesh of more than one entry),
    each shard masked at its local validity bound, -1 on its -inf slots."""
    if n_shards(mesh) <= 1:
        return quantized_blocked_topk(queries, values, scales, k, block_size=block_size, n_valid=n_valid)
    rows = values.rows
    n_valid = rows * values.n_shards if n_valid is None else n_valid
    partials = []
    for i, (s, part) in enumerate(values):
        base = s * rows
        local_valid = min(max(n_valid - base, 0), rows)
        shard_scales = scales.parts[i] if isinstance(scales, ShardedRows) else scales.to(part.device)
        vals, idx = pad_partial(*quantized_blocked_topk(queries.to(part.device), part, shard_scales, k,
                                                        block_size=block_size, n_valid=local_valid,
                                                        index_offset=base), k)
        partials.append((vals, torch.where(torch.isfinite(vals), idx, -1)))
    return merge_topk(partials, k, queries.device)
