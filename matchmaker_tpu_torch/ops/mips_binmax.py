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

- :func:`_scan_cuda` / :func:`_scan_plain`: level-1 candidates over a bf16
  corpus (TPU K3 ``_binmax_kernel`` + ``_topk_per_bin_t``, with K5
  ``_transpose_kernel`` folded into the store);
- :func:`_scan_int8f_cuda` / :func:`_scan_int8f_plain`: the same over an
  int8 corpus with one scale per 128-row bin, bf16 queries (TPU K8
  ``_binmax_kernel_int8f``): codes × queries in f32, × bin scale;
- :func:`_scan_int8_cuda` / :func:`_scan_int8_plain`: int8 corpus and int8
  query codes (TPU K7 ``_binmax_kernel_int8``): exact int32 sums, then
  (raw × bin scale) × query scale;
- :func:`_level2_cuda` / :func:`_level2_plain`: level 2 (TPU K4): a warp
  reads a (query row, 1024-column block) coalesced into shared memory and
  selects by int32 keys that carry each score's offset in their low bits,
  with an exact path for near ties (emulated on the CPU in
  ``tests/test_torch_mips_binmax.py``);
- :func:`_unpack_cuda` / :func:`_unpack_plain`: decode (TPU K6), 32-bit
  column arithmetic with a multiply-shift division (also emulated there).

``binmax_candidates`` and ``binmax_scan_topk`` hand the scan's output to K4,
and ``torch.topk``'s to K6, through ``_level2_launch`` / ``_unpack_launch``
without the checks the scan and topk already make true.

K3, K7 and K8 are one persistent wgmma/TMA scan on the card that keeps
each bin's scores in registers and selects there (the kernel's selection,
and K8's conversion of the codes to bf16 and its score order, are emulated
on the CPU in ``tests/test_torch_binmax_selection.py``); K7 is
bit-identical to its plain version, K8 wherever its f32 sums are exact.

Over a mesh (parallel/mesh.py), :func:`sharded_binmax_topk` and
:func:`sharded_binmax_rescore_topk` launch the scan once a shard on its row
view, each shard with its own validity bound (``valid_bound``: torch
operations on the candidates around the same launches), and merge the
(Q, k) partials into one top-k.

The final top-k is ``torch.topk``, as JAX leaves it to XLA.
:func:`binmax_rescore_topk` rescores an int8 scan's oversampled candidates
exactly (a gather and a bf16 product with f32 sums in torch ops, as JAX
leaves it to XLA).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import _build, matmul_codes, matmul_f32
from matchmaker_tpu_torch.ops.mips_quant import quantize_queries
from matchmaker_tpu_torch.parallel.mesh import Mesh, ShardedRows, merge_topk, n_shards, pad_partial

BIN_WIDTH = 128
# the vector width of every binmax scan kernel is a multiple of this (K3 and
# K8 take 32-value steps, K7 64-code ones): FlatIndex pads its rows' columns
# with zeros to it on the card
DIM_GRAIN = 64
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


def _select_plain(scores: torch.Tensor, n_valid: int, per_bin: int, tile_rows: int) -> torch.Tensor:
    """(Q, N) f32 scores, N % tile_rows == 0 → (Q, N/128·per_bin) packed
    level-1 candidates, rows at/after ``n_valid`` masked."""
    q, n = scores.shape
    nb = tile_rows // BIN_WIDTH
    cols = torch.arange(n, device=scores.device)
    scores = torch.where(cols < n_valid, scores, _NEG_INF)
    top = _group_topk(scores.reshape(q, n // tile_rows, nb, BIN_WIDTH), per_bin, 0)
    return top.transpose(2, 3).reshape(q, -1)  # (Q, tiles, per_bin, nb) flattened


def _row_scales(bin_scales: torch.Tensor) -> torch.Tensor:
    """(N/128, 1) bin scales → (N,) per-row scales."""
    return bin_scales.reshape(-1).float().repeat_interleave(BIN_WIDTH)


def _scan_plain(queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, per_bin: int,
                tile_rows: int) -> torch.Tensor:
    """Plain level-1 candidates: queries (Q, D) bf16, corpus (N, D) bf16 with
    N % tile_rows == 0 → (Q, N/128·per_bin) f32."""
    return _select_plain(matmul_f32(queries, corpus.T), n_valid, per_bin, tile_rows)


def _scan_int8f_plain(queries: torch.Tensor, corpus: torch.Tensor, bin_scales: torch.Tensor, n_valid: int,
                      per_bin: int, tile_rows: int) -> torch.Tensor:
    """Plain mixed candidates: queries (Q, D) bf16, corpus (N, D) int8 codes
    (exact in bf16), bin_scales (N/128, 1) f32: (codes · queries in f32) × bin scale."""
    scores = matmul_f32(queries, corpus.to(torch.bfloat16).T) * _row_scales(bin_scales)[None, :]
    return _select_plain(scores, n_valid, per_bin, tile_rows)


def _scan_int8_plain(queries: torch.Tensor, corpus: torch.Tensor, bin_scales: torch.Tensor,
                     query_scales: torch.Tensor, n_valid: int, per_bin: int, tile_rows: int) -> torch.Tensor:
    """Plain int8 candidates: query codes (Q, D) int8 with scales (Q, 1),
    corpus codes (N, D) int8 with bin scales (N/128, 1): (raw × bin scale) ×
    query scale, raw the exact int32 sum."""
    raw = matmul_codes(queries, corpus.T)
    scores = raw * _row_scales(bin_scales)[None, :] * query_scales.reshape(-1, 1).float()
    return _select_plain(scores, n_valid, per_bin, tile_rows)


def _scan_output(name: str, queries: torch.Tensor, corpus: torch.Tensor, per_bin: int, tile_rows: int,
                 width: Optional[int], dim_grain: int) -> torch.Tensor:
    """Check a scan's geometry and allocate its (Q, width) output; columns
    past the N/128·per_bin candidates are -inf (level 2's padding, without
    a copy)."""
    q, dim = queries.shape
    n = corpus.shape[0]
    if per_bin not in (1, 2, 4, 8) or dim % dim_grain or n % tile_rows or tile_rows % BIN_WIDTH:
        raise ValueError(f"{name}: the CUDA kernel needs per_bin in (1, 2, 4, 8), D % {dim_grain} == 0 and "
                         f"N % tile_rows == 0; got per_bin={per_bin}, D={dim}, N={n}, tile_rows={tile_rows}")
    n_cands = n // BIN_WIDTH * per_bin
    out = torch.empty((q, width or n_cands), dtype=torch.float32, device=corpus.device)
    if out.shape[1] > n_cands:
        out[:, n_cands:].fill_(_NEG_INF)
    return out


def _scan_cuda(queries: torch.Tensor, corpus: torch.Tensor, n_valid: int, per_bin: int,
               tile_rows: int, width: Optional[int] = None) -> torch.Tensor:
    """Level-1 candidates of a bf16 corpus on the card (K3), ``width`` ≥
    N/128·per_bin output columns."""
    _build.check_cuda(queries, "binmax_candidates.queries", torch.bfloat16)
    _build.check_cuda(corpus, "binmax_candidates.corpus", torch.bfloat16)
    q, dim = queries.shape
    n = corpus.shape[0]
    with torch.cuda.device(corpus.device):
        out = _scan_output("binmax scan", queries, corpus, per_bin, tile_rows, width, 32)
        _build.call("mm_binmax_scan", _build.ptr(queries), _build.ptr(corpus), _build.ptr(out),
                    q, n, dim, min(n_valid, n), per_bin, tile_rows // BIN_WIDTH, out.shape[1],
                    _build.stream(corpus.device))
    _build.LAUNCHES["binmax_candidates"] += 1
    return out


def _scan_int8_launch(queries, corpus, bin_scales, query_scales, n_valid, per_bin, tile_rows, width, mixed):
    name = "binmax_candidates_int8f" if mixed else "binmax_candidates_int8"
    _build.check_cuda(queries, f"{name}.queries", torch.bfloat16 if mixed else torch.int8)
    _build.check_cuda(corpus, f"{name}.corpus", torch.int8)
    q, dim = queries.shape
    n = corpus.shape[0]
    bin_scales = bin_scales.reshape(-1).float().contiguous()
    _build.check_cuda(bin_scales, f"{name}.bin_scales", torch.float32)
    if bin_scales.shape[0] != n // BIN_WIDTH:
        raise ValueError(f"{name}: {bin_scales.shape[0]} bin scales for {n} rows")
    # held in a name until the launch: the kernel reads it on the stream
    q_scales = None if mixed else query_scales.reshape(-1).float().contiguous()
    if not mixed:
        _build.check_cuda(q_scales, f"{name}.query_scales", torch.float32)
        if q_scales.shape[0] != q:
            raise ValueError(f"{name}: {q_scales.shape[0]} query scales for {q} queries")
    with torch.cuda.device(corpus.device):
        out = _scan_output(name, queries, corpus, per_bin, tile_rows, width, 32 if mixed else 64)
        qs = ctypes.c_void_p() if mixed else _build.ptr(q_scales)
        _build.call("mm_binmax_scan_int8", _build.ptr(queries), _build.ptr(corpus), _build.ptr(bin_scales), qs,
                    _build.ptr(out), q, n, dim, min(n_valid, n), per_bin, tile_rows // BIN_WIDTH, out.shape[1],
                    int(mixed), _build.stream(corpus.device))
    _build.LAUNCHES[name] += 1
    return out


def _scan_int8f_cuda(queries, corpus, bin_scales, n_valid, per_bin, tile_rows, width=None):
    """Mixed candidates on the card (K8): bf16 queries, int8 corpus codes."""
    return _scan_int8_launch(queries, corpus, bin_scales, None, n_valid, per_bin, tile_rows, width, True)


def _scan_int8_cuda(queries, corpus, bin_scales, query_scales, n_valid, per_bin, tile_rows, width=None):
    """Int8 candidates on the card (K7): int8 query codes, int8 corpus codes."""
    return _scan_int8_launch(queries, corpus, bin_scales, query_scales, n_valid, per_bin, tile_rows, width,
                             False)


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


def _level2_launch(packed: torch.Tensor, bin_width: int) -> torch.Tensor:
    """K4 on a scan's output as the scan leaves it (contiguous f32 on the
    card, C % 1024 == 0): one allocation and one C call; the kernel writes
    the -inf tail columns itself."""
    q, c = packed.shape
    out = torch.empty((q, _level2_width(c, bin_width)), dtype=torch.float32, device=packed.device)
    with _build.on(packed.device):
        _build.call("mm_level2", packed.data_ptr(), out.data_ptr(), q, c, bin_width, c, out.shape[1],
                    _build.stream(packed.device))
    _build.LAUNCHES["level2_reduce"] += 1
    return out


def _level2_cuda(packed: torch.Tensor, bin_width: int) -> torch.Tensor:
    c = packed.shape[1]
    if bin_width not in (L2_MID, L2_WIDE) or c % _L2_BLOCK:
        raise ValueError(f"level 2: the CUDA kernel takes widths 32/128 over C % 1024 == 0, got {bin_width}, {c}")
    _build.check_cuda(packed, "level2_reduce.packed", torch.float32)
    return _level2_launch(packed, bin_width)


def _level2_reduce(packed: torch.Tensor, bin_width: int = L2_WIDE) -> torch.Tensor:
    """Tournament level 2 over (Q, C) level-1 candidates: -inf padding to a
    multiple of 1024 columns on input and of 128 on output, as in JAX."""
    c = packed.shape[1]
    if c % _L2_BLOCK:
        packed = F.pad(packed, (0, _L2_BLOCK - c % _L2_BLOCK), value=_NEG_INF)
    return (_level2_cuda if packed.is_cuda else _level2_plain)(packed, bin_width)


def binmax_candidates(queries: torch.Tensor, corpus: torch.Tensor, n_valid: Optional[int] = None,
                      per_bin: int = 2, tile_rows: int = 2048,
                      level2: Optional[int] = None,
                      corpus_scales: Optional[torch.Tensor] = None,
                      query_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed per-bin candidates over the whole corpus, (Q, N/128·per_bin)
    f32 (or the level-2 reduction when ``level2`` is the group width).
    Store the corpus bf16 (or int8) and padded to :func:`padding_grain` to
    avoid a copy.

    An int8 corpus needs ``corpus_scales`` (N/128, 1) f32, one per 128-row
    bin (:func:`ops.mips_quant.quantize_corpus_binwise`). With
    ``query_scales`` (Q, 1) the queries are int8 codes (K7); without, float
    queries are taken in bf16 against the codes (the mixed mode, K8)."""
    n = corpus.shape[0]
    int8_mode = corpus.dtype == torch.int8
    mixed = int8_mode and query_scales is None
    if int8_mode:
        if corpus_scales is None or n % BIN_WIDTH or corpus_scales.shape[0] != n // BIN_WIDTH:
            raise ValueError("an int8 corpus needs (N/128, 1) bin scales and N % 128 == 0 "
                             "(quantize_corpus_binwise pads)")
    elif corpus.dtype != torch.bfloat16:
        corpus = corpus.to(torch.bfloat16)
    grain = padding_grain(tile_rows, per_bin)
    if n % grain:
        corpus = F.pad(corpus, (0, 0, 0, grain - n % grain))
        if int8_mode:  # padded bins: scale 0, so scores exactly 0, masked by n_valid
            corpus_scales = F.pad(corpus_scales.reshape(-1, 1), (0, 0, 0, (grain - n % grain) // BIN_WIDTH))
    n_valid = n if n_valid is None else n_valid
    qb = queries.contiguous() if int8_mode and not mixed else queries.to(torch.bfloat16).contiguous()
    if corpus.is_cuda:
        width = None
        if level2:
            n_cands = corpus.shape[0] // BIN_WIDTH * per_bin
            width = -(-n_cands // _L2_BLOCK) * _L2_BLOCK
        if mixed:
            packed = _scan_int8f_cuda(qb, corpus, corpus_scales, n_valid, per_bin, tile_rows, width)
        elif int8_mode:
            packed = _scan_int8_cuda(qb, corpus, corpus_scales, query_scales, n_valid, per_bin, tile_rows, width)
        else:
            packed = _scan_cuda(qb, corpus, n_valid, per_bin, tile_rows, width)
    elif mixed:
        packed = _scan_int8f_plain(qb, corpus, corpus_scales, n_valid, per_bin, tile_rows)
    elif int8_mode:
        packed = _scan_int8_plain(qb, corpus, corpus_scales, query_scales, n_valid, per_bin, tile_rows)
    else:
        packed = _scan_plain(qb, corpus, n_valid, per_bin, tile_rows)
    if level2:  # on the card the scan's output is K4's input as it lies
        packed = _level2_launch(packed, level2) if packed.is_cuda else _level2_reduce(packed, level2)
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


def _unpack_launch(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                   per_bin: int, level2: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on ``torch.topk``'s output as it lies (contiguous f32 values and
    int64 columns of one shape on the card): two allocations, one C call."""
    vals = torch.empty_like(packed_vals)
    ids = torch.empty_like(positions)
    with _build.on(packed_vals.device):
        _build.call("mm_unpack", packed_vals.data_ptr(), positions.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                    packed_vals.numel(), tile_rows, per_bin, level2 or 0, _build.stream(packed_vals.device))
    _build.LAUNCHES["unpack_candidates"] += 1
    return vals, ids


def _unpack_cuda(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                 per_bin: int, level2: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    _build.check_cuda(packed_vals, "unpack_candidates.packed_vals", torch.float32)
    _build.check_cuda(positions, "unpack_candidates.positions", torch.int64)
    if packed_vals.shape != positions.shape:
        raise ValueError("unpack_candidates: values and positions differ in shape")
    return _unpack_launch(packed_vals, positions, tile_rows, per_bin, level2)


def unpack_candidates(packed_vals: torch.Tensor, positions: torch.Tensor, tile_rows: int,
                      per_bin: int, level2: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 corpus row ids, -1 for -inf) of selected candidates;
    ``positions`` are their columns in the (level-1 or level-2) array."""
    fn = _unpack_cuda if packed_vals.is_cuda else _unpack_plain
    return fn(packed_vals, positions, tile_rows, per_bin, level2)


def _column_bin_starts(n_cols: int, tile_rows: int, per_bin: int, level2: Optional[int],
                       device: torch.device) -> torch.Tensor:
    """The first corpus row of the earliest bin each candidate column can
    carry, from the candidate layout alone (a level-2 column spans
    ``level2`` level-1 columns: the least of their bins' starts)."""
    nb = tile_rows // BIN_WIDTH
    cols = torch.arange(n_cols, device=device)
    if level2:
        nb2 = _L2_BLOCK // level2
        first = cols // (nb2 * LEVEL2_PER_BIN) * _L2_BLOCK + cols % nb2 * level2
        span = first[:, None] + torch.arange(level2, device=device)[None, :]
    else:
        span = cols[:, None]
    return (span // (per_bin * nb) * tile_rows + span % nb * BIN_WIDTH).amin(dim=1)


def binmax_scan_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     n_valid: Optional[int] = None, per_bin: int = 2,
                     tile_rows: int = 2048, corpus_scales: Optional[torch.Tensor] = None,
                     mixed_queries: bool = False, valid_bound: Optional[int] = None,
                     gate_rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a bf16 (or int8 + bin scales) corpus: candidate scan + one
    exact top-k; the same (values, ids) contract as :func:`f16_scan_topk`
    (ids int64, -1 for empty slots). The tournament level follows the real
    pool size (``gate_rows``, else ``n_valid`` rows), as in JAX. Over an
    int8 corpus, float queries are quantized per row here (scale
    max(absmax / 127, 1e-10)), unless ``mixed_queries`` keeps them bf16
    against the codes.

    ``valid_bound`` (the sharded search's): every candidate column whose
    bins all start at or past this row is set to -inf before the top-k, so
    a tail shard's wholly padded bins (zero rows score 0.0) cannot displace
    real hits below zero; a torch operation on the candidates, the kernels
    unchanged."""
    query_scales = None
    if corpus.dtype == torch.int8 and not mixed_queries:
        queries, query_scales = quantize_queries(queries)
    basis = gate_rows if gate_rows is not None else (corpus.shape[0] if n_valid is None else n_valid)
    n_cands = basis // BIN_WIDTH * per_bin
    if n_cands >= 128 * k:
        level2 = L2_WIDE
    elif n_cands >= 16 * k:
        level2 = L2_MID
    else:
        level2 = None
    packed = binmax_candidates(queries, corpus, n_valid=n_valid, per_bin=per_bin,
                               tile_rows=tile_rows, level2=level2, corpus_scales=corpus_scales,
                               query_scales=query_scales)
    if valid_bound is not None and valid_bound < corpus.shape[0]:
        starts = _column_bin_starts(packed.shape[1], tile_rows, per_bin, level2, packed.device)
        packed = torch.where(starts[None, :] < valid_bound, packed, _NEG_INF)
    top_packed, pos = torch.topk(packed, min(k, packed.shape[1]), dim=1)
    if top_packed.is_cuda:  # topk's outputs are what K6 takes
        return _unpack_launch(top_packed, pos, tile_rows, per_bin, level2)
    return _unpack_plain(top_packed, pos, tile_rows, per_bin, level2)


# rows of the (queries, fetch, D) rescore gather held at once
_RESCORE_GATHER_ELEMENTS = 1 << 26


def binmax_rescore_topk(queries: torch.Tensor, values: torch.Tensor, bin_scales: torch.Tensor, k: int,
                        oversample: int = 4, per_bin: int = 4, n_valid: Optional[int] = None,
                        rescore_corpus: Optional[torch.Tensor] = None,
                        tile_rows: int = 2048, valid_bound: Optional[int] = None,
                        gate_rows: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 binmax candidates + an exact rescore of oversample·k of them.

    The int8 scan (K7) fetches the candidates; each fetched row is then
    scored again as bf16(query) · its row in f32 sums: the int8 codes
    (exact in bf16) × the bin scale, or the 16-bit ``rescore_corpus`` row.
    The gather runs in query chunks to bound its memory."""
    n = values.shape[0]
    pool = max((n // BIN_WIDTH) * per_bin, 1)
    fetch = min(max(k * oversample, k), n, max(pool, k))
    cand_vals, cand_idx = binmax_scan_topk(queries, values, fetch, n_valid=n_valid, per_bin=per_bin,
                                           tile_rows=tile_rows, corpus_scales=bin_scales,
                                           valid_bound=valid_bound, gate_rows=gate_rows)
    valid = torch.isfinite(cand_vals) & (cand_idx >= 0)
    safe = cand_idx.clamp(0, n - 1)
    qf = queries.to(torch.bfloat16)
    source = values if rescore_corpus is None else rescore_corpus
    scales = bin_scales.reshape(-1).float()
    exact = torch.empty(cand_vals.shape, dtype=torch.float32, device=cand_vals.device)
    chunk = max(1, _RESCORE_GATHER_ELEMENTS // (fetch * values.shape[1]))
    for s in range(0, qf.shape[0], chunk):
        rows = source[safe[s:s + chunk]].to(torch.bfloat16)  # (chunk, fetch, D)
        part = matmul_f32(rows, qf[s:s + chunk, :, None])[..., 0]
        if rescore_corpus is None:
            part = part * scales[safe[s:s + chunk] // BIN_WIDTH]
        exact[s:s + chunk] = part
    exact = torch.where(valid, exact, _NEG_INF)
    k_eff = min(k, fetch)
    vals, pos = torch.topk(exact, k_eff, dim=1)
    idx = torch.gather(cand_idx, 1, pos)
    idx = torch.where(torch.isfinite(vals), idx, -1)
    if k_eff < k:
        vals = F.pad(vals, (0, k - k_eff), value=_NEG_INF)
        idx = F.pad(idx, (0, k - k_eff), value=-1)
    return vals, idx


def _sharded_binmax(scan, queries: torch.Tensor, corpus: ShardedRows, k: int, n_valid: Optional[int],
                    extras) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's per-shard composition: each shard scans its rows
    with its own local validity bound, its partial keeps only ids before
    ``n_valid`` (a boundary bin's padded rows), -1 on every -inf slot, ids
    shifted by the shard's first row; then one merge."""
    rows = corpus.rows
    n_valid = corpus.rows * corpus.n_shards if n_valid is None else n_valid
    partials = []
    for s, part in corpus:
        base = s * rows
        local_valid = min(max(n_valid - base, 0), rows)
        # gate on the fullest shard's real fill (rows are contiguous: shard 0's)
        vals, idx = scan(queries.to(part.device), part, *(e[s - corpus.first] for e in extras),
                         n_valid=rows, valid_bound=local_valid, gate_rows=min(rows, n_valid))
        vals = torch.where((idx >= 0) & (idx + base < n_valid), vals, _NEG_INF)
        vals, idx = pad_partial(vals, idx, k)
        partials.append((vals, torch.where(torch.isfinite(vals) & (idx >= 0), idx + base, -1)))
    return merge_topk(partials, k, queries.device)


def sharded_binmax_topk(queries: torch.Tensor, corpus, k: int, mesh: Optional[Mesh] = None,
                        n_valid: Optional[int] = None, corpus_scales=None,
                        **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binmax scan over a corpus row-sharded over ``mesh`` (a
    :class:`ShardedRows`, with ``corpus_scales`` sharded alike for an int8
    corpus; plain tensors without a mesh of more than one entry): one scan
    launch a shard, each with its local bound (``valid_bound``), a
    (Q, k) partial a shard, one merge. As in the JAX package, a boundary
    bin can leave up to per_bin·(1 + 8) of its padded rows' slots at -inf
    in a tail shard's partial."""
    if n_shards(mesh) <= 1:
        return binmax_scan_topk(queries, corpus, k, n_valid=n_valid, corpus_scales=corpus_scales, **kw)

    def scan(q, part, *scales, **local):
        return binmax_scan_topk(q, part, k, corpus_scales=scales[0] if scales else None, **local, **kw)

    return _sharded_binmax(scan, queries, corpus, k, n_valid,
                           [corpus_scales.parts] if corpus_scales is not None else [])


def sharded_binmax_rescore_topk(queries: torch.Tensor, values, bin_scales, k: int, mesh: Optional[Mesh] = None,
                                n_valid: Optional[int] = None, rescore_corpus=None,
                                **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 scan + exact rescore over a row-sharded corpus: both stages
    a shard on its rows (``values``, ``bin_scales`` and ``rescore_corpus``
    :class:`ShardedRows` alike), one merge."""
    if n_shards(mesh) <= 1:
        return binmax_rescore_topk(queries, values, bin_scales, k, n_valid=n_valid, rescore_corpus=rescore_corpus,
                                   **kw)

    def scan(q, part, scales, *rescore, **local):
        return binmax_rescore_topk(q, part, scales, k, rescore_corpus=rescore[0] if rescore else None, **local,
                                   **kw)

    extras = [bin_scales.parts] + ([rescore_corpus.parts] if rescore_corpus is not None else [])
    return _sharded_binmax(scan, queries, values, k, n_valid, extras)
