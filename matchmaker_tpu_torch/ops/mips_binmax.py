"""Fused MIPS scan with bin-max candidates: counterpart of
``matchmaker_tpu/ops/mips_binmax.py`` (single device).

Every 128-row corpus bin keeps its top ``per_bin`` scores per query (ties to
the lowest row offset); each candidate carries its 7-bit offset in the low
mantissa bits of its f32 score, and its (tile, bin) from its column, so the
ids come back by arithmetic, with no gather. Candidate layout, per query row:
column = tile·(per_bin·nb) + rank·nb + bin, nb = tile_rows/128 — the layout
the TPU path has after its transpose pass. A second tournament level
(:func:`_level2_reduce`) keeps the top 8 of every 32 or 128 candidates when
the pool oversamples k by 16x or 128x, its offset at mantissa bits [7, 14).
On a GPU the bit tricks are exact (``Tensor.view(torch.int32)``,
``__float_as_int``), so unlike the TPU path the plain version packs too.

Kernels (``csrc/binmax_kernels.cu``), each with its plain version here:

- :func:`_scan_cuda` / :func:`_scan_plain`: level-1 candidates (TPU K3
  ``_binmax_kernel`` + ``_topk_per_bin_t``, with K5 ``_transpose_kernel``
  folded into the store);
- :func:`_level2_cuda` / :func:`_level2_plain`: level 2 (TPU K4);
- :func:`_unpack_cuda` / :func:`_unpack_plain`: decode (TPU K6).

The final top-k is ``torch.topk``, as JAX leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import _build, matmul_f32

BIN_WIDTH = 128
LANE_BITS = 7
LANE_MASK = BIN_WIDTH - 1
LEVEL2_PER_BIN = 8
_L2_BLOCK = 1024
L2_WIDE, L2_MID = 128, 32
_NEG_INF = float("-inf")


def padding_grain(tile_rows: int = 2048, per_bin: int = 2) -> int:
    """Corpus-row padding grain: a multiple of the tile whose candidate count
    is a multiple of 128 (the same grain as the JAX package)."""
    grain = tile_rows
    while (grain // BIN_WIDTH) * per_bin % 128:
        grain *= 2
    return grain


def _pack_lane(vals: torch.Tensor, lane: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """Pack a [0, 128) offset into mantissa bits [shift, shift+7) of finite f32."""
    bits = vals.contiguous().view(torch.int32)
    packed = ((bits & ~(LANE_MASK << shift)) | (lane.to(torch.int32) << shift)).view(torch.float32)
    return torch.where(torch.isfinite(vals), packed, vals)


def _group_topk(x: torch.Tensor, keep: int, shift: int) -> torch.Tensor:
    """(..., G, W) → (..., G, keep): each group's ``keep`` largest values in
    rank order, ties to the lowest offset, offsets packed at ``shift``."""
    off = torch.arange(x.shape[-1], device=x.device)
    out = []
    cur = x
    for r in range(keep):
        idx = cur.argmax(dim=-1, keepdim=True)  # first maximum
        m = cur.gather(-1, idx)
        out.append(_pack_lane(m, idx, shift))
        if r + 1 < keep:
            cur = torch.where(off == idx, _NEG_INF, cur)
    return torch.cat(out, dim=-1)


def _topk_per_bin_t(scores_t: torch.Tensor, base: int, n_valid: int, per_bin: int,
                    lane_shift: int = 0, bin_width: int = BIN_WIDTH) -> torch.Tensor:
    """scores_t (T, Q) f32 → packed candidates (T//bin_width·per_bin, Q),
    rank-major, rows at/after ``n_valid`` (counting from ``base``) masked."""
    t, q = scores_t.shape
    row = torch.arange(t, device=scores_t.device)[:, None]
    scores_t = torch.where(base + row < n_valid, scores_t, _NEG_INF)
    top = _group_topk(scores_t.T.reshape(q, t // bin_width, bin_width), per_bin, lane_shift)
    return top.transpose(1, 2).reshape(q, -1).T


def _scan_plain(queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, per_bin: int,
                tile_rows: int) -> torch.Tensor:
    """Plain level-1 candidates: queries (Q, D) bf16, corpus (N, D) bf16 with
    N % tile_rows == 0 → (Q, N/128·per_bin) f32."""
    q = queries.shape[0]
    n = corpus.shape[0]
    nb = tile_rows // BIN_WIDTH
    scores = matmul_f32(queries, corpus.T)  # (Q, N) f32 of bf16 operands
    cols = torch.arange(n, device=scores.device)
    scores = torch.where(cols < n_valid, scores, _NEG_INF)
    top = _group_topk(scores.reshape(q, n // tile_rows, nb, BIN_WIDTH), per_bin, 0)
    return top.transpose(2, 3).reshape(q, -1)  # (Q, tiles, per_bin, nb) flattened


def _scan_cuda(queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, per_bin: int,
               tile_rows: int, width: Optional[int] = None) -> torch.Tensor:
    """Level-1 candidates on the card; ``width`` ≥ N/128·per_bin columns are
    allocated and those past the candidates filled with -inf (level 2's
    padding, without a copy)."""
    q, dim = queries.shape
    n = corpus.shape[0]
    if per_bin not in (1, 2, 4, 8) or dim % 32 or n % tile_rows or tile_rows % BIN_WIDTH:
        raise ValueError(f"binmax scan: the CUDA kernel needs per_bin in (1, 2, 4, 8), D % 32 == 0 and "
                         f"N % tile_rows == 0; got per_bin={per_bin}, D={dim}, N={n}, tile_rows={tile_rows}")
    _build.check_cuda(queries, "binmax_candidates.queries", torch.bfloat16)
    _build.check_cuda(corpus, "binmax_candidates.corpus", torch.bfloat16)
    n_cands = n // BIN_WIDTH * per_bin
    width = width or n_cands
    with torch.cuda.device(corpus.device):
        out = torch.empty((q, width), dtype=torch.float32, device=corpus.device)
        if width > n_cands:
            out[:, n_cands:].fill_(_NEG_INF)
        _build.call("mm_binmax_scan", _build.ptr(queries), _build.ptr(corpus), _build.ptr(out),
                    q, n, dim, min(n_valid, n), per_bin, tile_rows // BIN_WIDTH, width,
                    _build.stream(corpus.device))
    _build.LAUNCHES["binmax_candidates"] += 1
    return out


def _level2_width(c: int, bin_width: int) -> int:
    out = c // bin_width * LEVEL2_PER_BIN
    return -(-out // 128) * 128


def _level2_plain(packed: torch.Tensor, bin_width: int) -> torch.Tensor:
    """(Q, C) with C % 1024 == 0 → (Q, C/bin_width·8) rank-major per block,
    -inf-padded to a multiple of 128 columns."""
    q, c = packed.shape
    nb2 = _L2_BLOCK // bin_width
    top = _group_topk(packed.reshape(q, c // _L2_BLOCK, nb2, bin_width), LEVEL2_PER_BIN, LANE_BITS)
    out = top.transpose(2, 3).reshape(q, -1)
    return F.pad(out, (0, _level2_width(c, bin_width) - out.shape[1]), value=_NEG_INF)


def _level2_cuda(packed: torch.Tensor, bin_width: int) -> torch.Tensor:
    q, c = packed.shape
    if bin_width not in (L2_MID, L2_WIDE) or c % _L2_BLOCK:
        raise ValueError(f"level 2: the CUDA kernel takes widths 32/128 over C % 1024 == 0, got {bin_width}, {c}")
    _build.check_cuda(packed, "level2_reduce.packed", torch.float32)
    width = _level2_width(c, bin_width)
    n_out = c // bin_width * LEVEL2_PER_BIN
    with torch.cuda.device(packed.device):
        out = torch.empty((q, width), dtype=torch.float32, device=packed.device)
        if width > n_out:
            out[:, n_out:].fill_(_NEG_INF)
        _build.call("mm_level2", _build.ptr(packed), _build.ptr(out), q, c, bin_width, c, width,
                    _build.stream(packed.device))
    _build.LAUNCHES["level2_reduce"] += 1
    return out


def _level2_reduce(packed: torch.Tensor, bin_width: int = L2_WIDE) -> torch.Tensor:
    """Tournament level 2 over (Q, C) level-1 candidates: -inf padding to a
    multiple of 1024 columns on input and of 128 on output, as in JAX."""
    c = packed.shape[1]
    if c % _L2_BLOCK:
        packed = F.pad(packed, (0, _L2_BLOCK - c % _L2_BLOCK), value=_NEG_INF)
    return (_level2_cuda if packed.is_cuda else _level2_plain)(packed, bin_width)


def binmax_candidates(queries: torch.Tensor, corpus: torch.Tensor, n_valid: Optional[int] = None,
                      per_bin: int = 2, tile_rows: int = 2048,
                      level2: Optional[int] = None) -> torch.Tensor:
    """Packed per-bin candidates over the whole corpus, (Q, N/128·per_bin)
    f32 (or the level-2 reduction when ``level2`` is the group width).
    Store the corpus bf16 and padded to :func:`padding_grain` to avoid a copy."""
    n = corpus.shape[0]
    if corpus.dtype != torch.bfloat16:
        corpus = corpus.to(torch.bfloat16)
    grain = padding_grain(tile_rows, per_bin)
    if n % grain:
        corpus = F.pad(corpus, (0, 0, 0, grain - n % grain))
    n_valid = n if n_valid is None else n_valid
    qb = queries.to(torch.bfloat16).contiguous()
    if corpus.is_cuda:
        width = None
        if level2:
            n_cands = corpus.shape[0] // BIN_WIDTH * per_bin
            width = -(-n_cands // _L2_BLOCK) * _L2_BLOCK
        packed = _scan_cuda(qb, corpus, n_valid, per_bin, tile_rows, width)
    else:
        packed = _scan_plain(qb, corpus, n_valid, per_bin, tile_rows)
    if level2:
        packed = _level2_reduce(packed, level2)
    return packed


def _unpack_plain(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                  per_bin: int, level2: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    nb = tile_rows // BIN_WIDTH
    bits = packed_vals.contiguous().view(torch.int32)
    clear = LANE_MASK | (LANE_MASK << LANE_BITS) if level2 else LANE_MASK
    finite = torch.isfinite(packed_vals)
    vals = torch.where(finite, (bits & ~clear).view(torch.float32), packed_vals)
    pos = positions.long()
    if level2:
        nb2 = _L2_BLOCK // level2
        lane2 = ((bits >> LANE_BITS) & LANE_MASK).long()
        rc = pos // (nb2 * LEVEL2_PER_BIN) * _L2_BLOCK + pos % nb2 * level2 + lane2
    else:
        rc = pos
    ids = rc // (per_bin * nb) * tile_rows + rc % nb * BIN_WIDTH + (bits & LANE_MASK).long()
    return vals, torch.where(finite, ids, -1)


def _unpack_cuda(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                 per_bin: int, level2: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    _build.check_cuda(packed_vals, "unpack_candidates.packed_vals", torch.float32)
    _build.check_cuda(positions, "unpack_candidates.positions", torch.int64)
    if packed_vals.shape != positions.shape:
        raise ValueError("unpack_candidates: values and positions differ in shape")
    with torch.cuda.device(packed_vals.device):
        vals = torch.empty_like(packed_vals)
        ids = torch.empty_like(positions)
        _build.call("mm_unpack", _build.ptr(packed_vals), _build.ptr(positions), _build.ptr(vals),
                    _build.ptr(ids), packed_vals.numel(), tile_rows, per_bin, level2 or 0,
                    _build.stream(packed_vals.device))
    _build.LAUNCHES["unpack_candidates"] += 1
    return vals, ids


def unpack_candidates(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                      per_bin: int, level2: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 corpus row ids, -1 for -inf) of selected candidates;
    ``positions`` are their columns in the (level-1 or level-2) array."""
    fn = _unpack_cuda if packed_vals.is_cuda else _unpack_plain
    return fn(packed_vals, positions, tile_rows, per_bin, level2)


def binmax_scan_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     n_valid: Optional[int] = None, per_bin: int = 2,
                     tile_rows: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a bf16 corpus: candidate scan + one exact top-k; the same
    (values, ids) contract as :func:`f16_scan_topk` (ids int64, -1 for
    empty slots). The tournament level follows the real pool size
    (``n_valid`` rows), as in JAX."""
    n_cands = (corpus.shape[0] if n_valid is None else n_valid) // BIN_WIDTH * per_bin
    if n_cands >= 128 * k:
        level2 = L2_WIDE
    elif n_cands >= 16 * k:
        level2 = L2_MID
    else:
        level2 = None
    packed = binmax_candidates(queries, corpus, n_valid=n_valid, per_bin=per_bin,
                               tile_rows=tile_rows, level2=level2)
    top_packed, pos = torch.topk(packed, min(k, packed.shape[1]), dim=1)
    return unpack_candidates(top_packed, pos, tile_rows, per_bin, level2)
