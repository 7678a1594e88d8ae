"""Nearest-neighbour index layer: counterpart of
``matchmaker_tpu/retrieval/indexes.py`` (single device), with
``retrieval/scann_tree_ah.py`` (ScaNN's tree-AH shape) and
``retrieval/hnsw.py`` (the native HNSW graph) beside it. ``build_index``
serves every ``faiss_index_type`` the JAX factory does: ``flat`` (also
``exact``, ``full``), ``scann`` (binmax, or ``scann_backend: tree_ah``),
``ivf``, ``hnsw``, ``streaming`` (also ``sharded_ondisk``) and
``dynamic``. Every index reads the folder the JAX index of its kind saves.

``FlatIndex`` keeps the corpus matrix on the device and serves these routes:

- ``mips_quantization: float16`` with ``mips_kernel: binmax``: rows stored
  bf16, searched by the binmax scan (ops/mips_binmax.py), or by the exact
  bf16 scan (ops/mips_f16.py) when the corpus is too small for the candidate
  pool to oversample k by 8x;
- ``mips_quantization: float16`` with ``mips_kernel: scan``: rows stored
  float16, the exact bf16 scan, in blocks of ``mips_block_size`` rows above
  that size;
- ``mips_quantization: int8`` (or ``int8-global``) with ``mips_kernel:
  binmax``: int8 codes with one scale per 128-row bin
  (ops/mips_quant.py:quantize_corpus_binwise), searched by the mixed scan
  (``mips_int8_queries: float``: bf16 queries against the codes), the int8
  scan (``mips_int8_queries: int8``, the default) or the int8 scan plus an
  exact rescore of ``mips_oversample``·k candidates (``mips_twostage``,
  against the codes or, with ``mips_rescore_dtype: float16``, bf16 rows);
  the same 8x gate falls back to the exact int8 scan;
- ``mips_quantization: int8`` / ``int8-global`` with ``mips_kernel: scan``:
  the exact int8 scan (ops/mips_quant.py:quantized_blocked_topk) with
  per-row or one global scale, and with ``mips_twostage`` its candidates
  rescored exactly (ops/mips_twostage.py) against the codes or, with
  ``mips_rescore_dtype: float16``, float16 rows;
- ``mips_quantization: none``: rows stored f32, exact blocked scan
  (ops/mips.py).

The binmax routes honour ``mips_per_bin`` and ``mips_tile_rows`` (the
corpus tile of the candidate layout, 2048 rows by default; it sets the
padding grain and, for per_bin > 1, which candidates share a level-2 group,
so it changes results) as the JAX FlatIndex does. ``mips_q_chunk`` is
accepted and unused: the JAX kernels split the query rows into launches of
that many only to fit VMEM, which changes no result.

``IVFIndex``: k-means centroids (a seeded subsample above
``ivf_train_points_per_centroid``·lists rows, every row then assigned in
device blocks) and the corpus sorted by cluster (CSR: rows, original row
per sorted row, cluster offsets). A search probes the ``faiss_ivf_nprobe``
best centroids, gathers each query's probed rows best probe first into a
budget of ``ivf_candidate_slack`` x nprobe x the mean cluster (at least the
largest cluster, rounded up to 128; ``ivf_candidate_rows`` overrides), so
an over-budget set loses only the worst probes, and scores them in f32
(16-bit storage rounded to bf16 first, as JAX scores it). Queries go in
chunks that keep the gathered rows near 1 GB. ``search_rows`` makes it a
candidate generator for ColBERT's per-token search.

``StreamingFlatIndex``: the encode folder's ``token_reps_N.npy`` blocks
are the index; a search streams them to the device (pinned host copies,
non-blocking copies on a side stream) under a device-side running top-k,
with no host sync until the final fetch.

``kmeans`` / ``assign_clusters`` (Lloyd from a random and, for k <= 2048,
a k-means++ init, the lower-distortion solution kept; nearest-centroid
assignment in blocks) and ``DynamicClusterIndex`` (TAS-Balanced's query
clusters, cli/cluster_queries.py) run in torch on the index's device, drawn
from an explicit ``torch.Generator``, so clusters built independently of
JAX's (``jax.random``) differ.

The top-k of the IVF, tree-AH, streaming, float16-scan and int8-scan
routes puts the lower row first among equal scores, as ``jax.lax.top_k``
does (``ops.topk_lowest_first``). Not ported: ``mips_approx_topk``
(``lax.approx_max_k``, a TPU hardware top-k: the port's top-k is exact,
ROADMAP.md).

Over a mesh of more than one entry (parallel/mesh.py, ``mesh=``), as in the
JAX package: ``FlatIndex`` pads the rows to the shard count times each
route's grain and keeps every route's storage as row shards, each searched
on its own device by the route's sharded op (ops/mips*.py: one scan launch
a shard on the binmax routes), the (Q, k) partials merged into one top-k;
``IVFIndex`` cuts the clusters into contiguous ranges of about equal rows,
one a shard, each with its own CSR, probes the global nprobe best
centroids, gathers each shard's own probed rows into a budget of 2 x
slack x nprobe x the mean cluster / shards (at least the largest cluster),
scores them in f32 and merges the shards' top-k; ``ScaNNTreeAHIndex``
routes to that sharded IVF search (ROADMAP.md §3).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first
from matchmaker_tpu_torch.ops.mips import sharded_topk_mips
from matchmaker_tpu_torch.ops.mips_binmax import (BIN_WIDTH, DIM_GRAIN, padding_grain, sharded_binmax_rescore_topk,
                                                  sharded_binmax_topk)
from matchmaker_tpu_torch.ops.mips_f16 import sharded_f16_scan_topk
from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus, quantize_corpus_binwise, sharded_quantized_topk
from matchmaker_tpu_torch.ops.mips_twostage import sharded_twostage_topk
from matchmaker_tpu_torch.parallel.mesh import Mesh, ShardedRows, host_rows, merge_topk, n_shards, shard_rows


def gather_ids(ids_array: np.ndarray, idx: np.ndarray, row_count: int, scores: np.ndarray):
    """Row indices → sequence ids; invalid slots get score -inf and id -1
    (numeric ids) or "" (string ids)."""
    idx = np.asarray(idx)
    scores = np.asarray(scores)
    valid = (idx >= 0) & (idx < row_count) & np.isfinite(scores)
    out = ids_array[np.clip(idx, 0, row_count - 1)]
    if not valid.all():
        out = out.copy()
        out[~valid] = -1 if out.dtype.kind in "iuf" else ""
        scores = np.where(valid, scores, -np.inf)
    return scores, out


class BaseNNIndexer:
    def __init__(self, config=None, device="cuda"):
        config = config or {}
        self.dtype = np.float16 if config.get("token_dtype", "float16") == "float16" else np.float32
        self.device = torch.device(device)
        self.dim: Optional[int] = None

    def prepare(self, dim: int) -> None:
        self.dim = dim

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        raise NotImplementedError

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores (Q, top_n), ids (Q, top_n))"""
        raise NotImplementedError

    def save(self, folder: str) -> None:
        raise NotImplementedError

    def load(self, folder: str) -> None:
        raise NotImplementedError


def _rows_of_bins(scales):
    """(N/128, 1) bin scales → (N,) row scales (each shard's over a mesh)."""
    if isinstance(scales, ShardedRows):
        return ShardedRows([_rows_of_bins(p) for p in scales.parts], scales.rows * BIN_WIDTH, scales.first,
                           scales.n_shards)
    return scales[:, 0].repeat_interleave(BIN_WIDTH)


class FlatIndex(BaseNNIndexer):
    """MIPS over the full corpus matrix, on one device or row-sharded over a
    mesh of more than one entry (module docstring)."""

    def __init__(self, config=None, device="cuda", mesh: Optional[Mesh] = None):
        super().__init__(config, mesh.local_devices[0] if mesh is not None else device)
        self.mesh = mesh
        self.n_shards = n_shards(mesh)
        config = config or {}
        quant = config.get("mips_quantization", "none")
        self.mips_kernel = config.get("mips_kernel", "binmax")
        if quant not in ("none", "float16", "int8", "int8-global"):
            raise ValueError(f"unknown mips_quantization {quant!r} (none, float16, int8 or int8-global)")
        if self.mips_kernel not in ("binmax", "scan"):
            raise ValueError(f"unknown mips_kernel {self.mips_kernel!r} (binmax or scan)")
        self.quantized = quant in ("int8", "int8-global")
        self.global_scale = quant == "int8-global"
        self.f16_scan = quant == "float16"
        self.twostage = config.get("mips_twostage", False)
        self.oversample = config.get("mips_oversample", 4)
        self.rescore_dtype = config.get("mips_rescore_dtype", "int8")  # int8 | float16
        self.int8_queries = config.get("mips_int8_queries", "int8")  # int8 | float (the mixed scan)
        # the binmax routes: bf16 rows (float16) or int8 codes with bin scales
        self.binmax = (self.f16_scan or self.quantized) and self.mips_kernel == "binmax"
        self.block_size = config.get("mips_block_size", 65536)
        self.per_bin_override = config.get("mips_per_bin")
        self.tile_rows = config.get("mips_tile_rows") or 2048
        self._vectors: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._device_vectors = None
        self._row_count = 0
        self._dim = 0

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._ids = np.asarray(ids)
        self._vectors = np.asarray(vectors, dtype=self.dtype)
        # a seeded row permutation makes every 128-row bin an i.i.d. corpus
        # sample, so binmax's bin-collision recall model holds for clustered
        # corpora too (same seed as the JAX package)
        if self.binmax and len(self._ids) > 1:
            perm = np.random.default_rng(0xB1A5).permutation(len(self._ids))
            self._ids = self._ids[perm]
            self._vectors = self._vectors[perm]
        self._device_vectors = None

    def _grain(self) -> int:
        """Rows the corpus pads to a multiple of: one grain a shard for the
        binmax routes (per_bin 2..8, so the scan never re-pads), else the
        shard count."""
        if not self.binmax:
            return self.n_shards
        pbs = [self.per_bin_override] if self.per_bin_override else [2, 4, 8]
        return self.n_shards * max(padding_grain(self.tile_rows, pb) for pb in pbs)

    def _ensure_device(self) -> None:
        """Every route's storage, as the JAX FlatIndex places it: the rows
        padded to ``_grain()``, in the route's dtype or as int8 codes with
        their scales, on the device, or as row shards over the mesh
        (parallel/mesh.py:shard_rows)."""
        if self._device_vectors is not None:
            return
        vectors = self._vectors
        n = self._row_count = vectors.shape[0]
        if self.binmax and self.device.type == "cuda" and vectors.shape[1] % DIM_GRAIN:
            # the binmax scans' D grain: zero columns (the queries' too, at search) add nothing
            vectors = np.pad(vectors, ((0, 0), (0, -vectors.shape[1] % DIM_GRAIN)))
        self._dim = vectors.shape[1]
        pad_to = self._grain() * -(-n // self._grain())

        def put(a, dtype=None, padded_rows=None):
            """Host rows (zero rows up to ``padded_rows`` added on the device)."""
            if self.n_shards > 1:
                return shard_rows(self.mesh, a, dtype, padded_rows)
            src = host_rows(a, dtype)
            out = torch.zeros((padded_rows or len(a),) + tuple(src.shape[1:]), dtype=dtype or src.dtype,
                              device=self.device)
            out[:len(a)] = src.to(self.device)
            return out

        if self.quantized:
            padded = np.asarray(vectors, dtype=np.float32)
            if pad_to != n:
                padded = np.zeros((pad_to, vectors.shape[1]), dtype=np.float32)
                padded[:n] = vectors
            f16_rescore = self.twostage and self.rescore_dtype == "float16"
            if self.binmax:
                values, scales = quantize_corpus_binwise(padded)
                rescore = put(padded, torch.bfloat16) if f16_rescore else None
            else:
                values, scales = quantize_corpus(padded, per_row=not self.global_scale)
                rescore = put(padded.astype(np.float16)) if f16_rescore else None
            scales = put(scales) if np.ndim(scales) else torch.from_numpy(np.asarray(scales)).to(self.device)
            self._device_vectors = (put(values), scales, rescore)
        else:
            dtype = torch.bfloat16 if self.binmax else (torch.float16 if self.f16_scan else torch.float32)
            self._device_vectors = put(vectors, dtype, pad_to)

    def _per_bin(self, k: int) -> Optional[int]:
        """binmax geometry for k, or None for the exact fallback: the pool
        must oversample k by 8x at per_bin 8 (JAX FlatIndex gate)."""
        rows = self._row_count
        if rows // 128 * 8 < 8 * k:
            return None
        want = int(min(8, max(2, -(-8 * k * 128 // rows))))
        per_bin = 1 << (want - 1).bit_length()
        if self.per_bin_override and rows // 128 * self.per_bin_override >= 8 * k:
            per_bin = self.per_bin_override
        return per_bin

    def _search_device(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every route (module docstring), as the JAX FlatIndex runs it:
        over a mesh each shard's search on its own device and one merge;
        without one, the sharded ops take their unsharded paths."""
        if q.shape[1] < self._dim:
            q = torch.nn.functional.pad(q, (0, self._dim - q.shape[1]))
        if self.quantized:
            return self._search_int8(q, k)
        corpus, rows, mesh = self._device_vectors, self._row_count, self.mesh
        scan_block = self.block_size if rows > self.block_size else None
        if self.f16_scan and not self.binmax:
            return sharded_f16_scan_topk(q, corpus, k, mesh, n_valid=rows, block_size=scan_block)
        if not self.binmax:
            return sharded_topk_mips(q, corpus, k, mesh, self.block_size)
        per_bin = self._per_bin(k)
        if per_bin is None:
            return sharded_f16_scan_topk(q, corpus, k, mesh, n_valid=rows, block_size=scan_block)
        return sharded_binmax_topk(q, corpus, k, mesh, n_valid=rows, per_bin=per_bin, tile_rows=self.tile_rows)

    def _search_int8(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int8 routes (module docstring)."""
        values, scales, rescore = self._device_vectors
        mesh, rows = self.mesh, self._row_count
        if not self.binmax:
            if self.twostage:
                return sharded_twostage_topk(q, values, scales, k, mesh, rescore_corpus=rescore, n_valid=rows,
                                             oversample=self.oversample, block_size=self.block_size)
            return sharded_quantized_topk(q, values, scales, k, mesh, block_size=self.block_size, n_valid=rows)
        per_bin = self._per_bin(k)
        if per_bin is None:  # the exact int8 scan over the bin scales expanded to rows
            return sharded_quantized_topk(q, values, _rows_of_bins(scales), k, mesh, block_size=self.block_size,
                                          n_valid=rows)
        geom = dict(n_valid=rows, tile_rows=self.tile_rows)
        if self.int8_queries == "float":
            return sharded_binmax_topk(q, values, k, mesh, per_bin=per_bin, corpus_scales=scales, mixed_queries=True,
                                       **geom)
        if self.twostage:
            # in-bin candidate loss needs per_bin >= 4; the rescore undoes the quantized ranking
            return sharded_binmax_rescore_topk(q, values, scales, k, mesh, per_bin=max(per_bin, 4),
                                               oversample=self.oversample, rescore_corpus=rescore, **geom)
        return sharded_binmax_topk(q, values, k, mesh, per_bin=per_bin, corpus_scales=scales, **geom)

    def search_rows(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`search` but returns raw row indices (-1 for padded or
        invalid slots)."""
        self._ensure_device()
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(self.device)
        with torch.inference_mode():
            vals, idx = self._search_device(q, top_n)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if vals.shape[1] < top_n:  # corpus smaller than top_n
            pad = top_n - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        invalid = (idx < 0) | (idx >= self._row_count) | ~np.isfinite(vals)
        if invalid.any():
            idx = np.where(invalid, -1, idx)
            vals = np.where(invalid, -np.inf, vals)
        return vals, idx

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        vals, idx = self.search_rows(queries, top_n)
        return gather_ids(self._ids, idx, self._row_count, vals)

    @property
    def row_ids(self) -> np.ndarray:
        return self._ids

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        np.save(os.path.join(folder, "flat_vectors.npy"), self._vectors)
        np.save(os.path.join(folder, "flat_ids.npy"), self._ids)
        with open(os.path.join(folder, "flat_meta.json"), "w") as f:
            json.dump({"dim": int(self._vectors.shape[1]), "dtype": str(self._vectors.dtype)}, f)

    def load(self, folder: str) -> None:
        self._vectors = np.load(os.path.join(folder, "flat_vectors.npy"))
        self._ids = np.load(os.path.join(folder, "flat_ids.npy"))
        self._device_vectors = None


def _kmeanspp_init(vectors: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ (D² sampling) seeds: the first row uniform, each next one
    drawn with probability proportional to its squared distance to the
    nearest seed so far."""
    n = vectors.shape[0]
    x = vectors.float()
    centers = torch.empty((k, vectors.shape[1]), dtype=vectors.dtype, device=vectors.device)
    first = torch.randint(0, n, (), generator=generator, device=vectors.device)
    centers[0] = vectors[first]
    d2 = torch.full((n,), float("inf"), device=vectors.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, ((x - centers[i - 1].float()) ** 2).sum(-1))
        idx = torch.multinomial(torch.clamp(d2, min=1e-30), 1, generator=generator)[0]
        centers[i] = vectors[idx]
    return centers


def _scores(block: torch.Tensor, centroids: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance up to each row's own |x|²: -2 x·c + |c|²."""
    return -2 * matmul_f32(block, centroids.t()) + c_sq[None, :]


def kmeans(vectors: torch.Tensor, k: int, iters: int = 10, seed: int = 42,
           block_size: int = 131072) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means on the vectors' device → (centroids (k, d), assignment (n,)),
    the assignment being the last Lloyd step's (to the centroids before its
    update), as the JAX package returns it.

    Lloyd runs from a random init (k distinct rows) and, for k <= 2048, from
    a k-means++ init; the solution with the lower distortion wins (random
    init suits noise-like data, k-means++ skewed data). Assignment runs in
    row blocks (memory O(block · k)); the centroid update sums each cluster's
    rows by one-hot products, in a fixed order. Draws come from a
    ``torch.Generator`` on the device, seeded with ``seed``."""
    n, d = vectors.shape
    vectors = vectors.float()
    generator = torch.Generator(device=vectors.device).manual_seed(seed)
    inits = [vectors[torch.randperm(n, generator=generator, device=vectors.device)[:k]]]
    if k <= 2048:
        inits.append(_kmeanspp_init(vectors, k, generator))
    blocks = torch.split(vectors, block_size)

    def step(centroids):
        c_sq = (centroids ** 2).sum(-1)
        assign = torch.cat([torch.argmin(_scores(b, centroids, c_sq), dim=1) for b in blocks])
        sums = torch.zeros_like(centroids)
        counts = torch.zeros((k, 1), device=vectors.device)
        for b, a in zip(blocks, torch.split(assign, block_size)):
            one_hot = torch.nn.functional.one_hot(a, k).float()
            sums += matmul_f32(one_hot.t(), b)
            counts += one_hot.sum(0)[:, None]
        return torch.where(counts > 0, sums / torch.clamp(counts, min=1), centroids), assign

    def distortion(centroids):
        # comparable across candidate solutions: the dropped |x|² is the same for all
        c_sq = (centroids ** 2).sum(-1)
        return float(sum(_scores(b, centroids, c_sq).amin(dim=1).sum() for b in blocks))

    best = None
    for centroids in inits:
        assign = None
        for _ in range(iters):
            centroids, assign = step(centroids)
        d_val = distortion(centroids) if len(inits) > 1 else 0.0
        if best is None or d_val < best[0]:
            best = (d_val, centroids, assign)
    return best[1], best[2]


def assign_clusters(vectors: np.ndarray, centroids, block_size: int = 262144, device="cuda") -> np.ndarray:
    """Nearest-centroid id (int32) of each host row, the rows sent to the
    device in blocks and only the ids brought back."""
    device = torch.device(device)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=device)
    c_sq = (c ** 2).sum(-1)
    out = np.empty(len(vectors), dtype=np.int32)
    for start in range(0, len(vectors), block_size):
        blk = torch.as_tensor(np.asarray(vectors[start:start + block_size], np.float32), device=device)
        out[start:start + len(blk)] = torch.argmin(_scores(blk, c, c_sq), dim=1).cpu().numpy()
    return out


class DynamicClusterIndex(BaseNNIndexer):
    """Query-clustering index for TAS-Balanced: k-means centroids of the
    indexed vectors, each row's centroid, per-centroid member lists and
    re-assignment updates (``faiss_ivf_list_count`` clusters,
    ``ivf_train_iters`` Lloyd steps)."""

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
        config = config or {}
        self.n_clusters = config.get("faiss_ivf_list_count", 2000)
        self.train_iters = config.get("ivf_train_iters", 10)
        self._centroids = None
        self._assignments = None  # row -> centroid
        self._ids = None

    def index_all(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._ids = np.asarray(ids)
        k = min(self.n_clusters, len(ids))
        centroids, assign = kmeans(torch.as_tensor(np.asarray(vectors, np.float32), device=self.device), k,
                                   self.train_iters)
        self._centroids = centroids.cpu().numpy()
        self._assignments = assign.cpu().numpy()

    def assign(self, vectors: np.ndarray, block: int = 65536) -> np.ndarray:
        """Nearest centroid id of each vector (L2, as the k-means trains)."""
        return assign_clusters(vectors, self._centroids, block, self.device).astype(np.int64)

    def cluster_members(self, cluster_id: int) -> np.ndarray:
        return self._ids[self._assignments == cluster_id]

    def update(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        """Re-assign the given rows."""
        new_assign = self.assign(vectors)
        id_to_pos = {i: p for p, i in enumerate(self._ids)}
        for i, a in zip(ids, new_assign):
            self._assignments[id_to_pos[i]] = a

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        np.savez_compressed(os.path.join(folder, "dynamic_index.npz"), centroids=self._centroids,
                            assignments=self._assignments, ids=self._ids)

    def load(self, folder: str) -> None:
        data = np.load(os.path.join(folder, "dynamic_index.npz"), allow_pickle=True)
        self._centroids = data["centroids"]
        self._assignments = data["assignments"]
        self._ids = data["ids"]


_TORCH_DTYPES = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}
# the gathered (queries, candidates, D) rows of one chunk of an IVF search stay near this many bytes
IVF_GATHER_BYTES = 1e9


def _probed_slots(starts: torch.Tensor, lens: torch.Tensor, budget: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's probed clusters (CSR ``starts``, ``lens``, best probe
    first) laid out in ``budget`` slots: slot j falls in the probe whose
    prefix of sizes it passes. → (sorted-row index (Q, budget), 0 where
    invalid; valid (Q, budget))."""
    prefix = torch.cat([torch.zeros_like(lens[:, :1]), torch.cumsum(lens, dim=1)], dim=1)
    slots = torch.arange(budget, device=lens.device).expand(lens.shape[0], budget).contiguous()
    seg = (torch.searchsorted(prefix, slots, right=True) - 1).clamp(0, lens.shape[1] - 1)
    idx = torch.gather(starts, 1, seg) + (slots - torch.gather(prefix, 1, seg))
    valid = slots < prefix[:, -1:]
    return torch.where(valid, idx, 0), valid


class IVFIndex(BaseNNIndexer):
    """Inverted-file index: k-means centroids + the corpus sorted by cluster
    (CSR: no padding, the flat footprint). See the module docstring."""

    def __init__(self, config=None, device="cuda", mesh: Optional[Mesh] = None):
        super().__init__(config, mesh.local_devices[0] if mesh is not None else device)
        self.mesh = mesh
        config = config or {}
        self.n_clusters = config.get("faiss_ivf_list_count", 100)
        self.nprobe = config.get("faiss_ivf_nprobe", 8)
        self.train_iters = config.get("ivf_train_iters", 10)
        self.candidate_rows = config.get("ivf_candidate_rows")
        self.candidate_slack = config.get("ivf_candidate_slack", 2.0)
        self.train_points_per_centroid = config.get("ivf_train_points_per_centroid", 256)
        self.train_max_rows = config.get("ivf_train_max_rows", 2_500_000)
        self._centroids: Optional[np.ndarray] = None
        self._sorted_vectors: Optional[np.ndarray] = None  # (N, D) corpus sorted by cluster
        self._sorted_rows: Optional[np.ndarray] = None  # (N,) original row of each sorted row
        self._offsets: Optional[np.ndarray] = None  # (C + 1,) cluster starts in the sorted rows
        self._ids: Optional[np.ndarray] = None
        self._dev: dict = {}
        self._shards: Optional[dict] = None  # the per-shard CSR of a sharded search, built at first use

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self._ids = np.asarray(ids)
        vectors = np.asarray(vectors, dtype=np.float32)
        n = vectors.shape[0]
        k = min(self.n_clusters, n)
        # at most ivf_train_points_per_centroid rows a list (faiss's max_points_per_centroid), never
        # fewer than 131,072, at most ivf_train_max_rows; every row then assigned in device blocks
        sample_cap = min(max(self.train_points_per_centroid * k, 131072), self.train_max_rows)
        if n > sample_cap:
            sel = np.random.default_rng(42).choice(n, sample_cap, replace=False)
            centroids, _ = kmeans(torch.from_numpy(vectors[sel]).to(self.device), k, self.train_iters)
            assign = assign_clusters(vectors, centroids.cpu().numpy(), device=self.device)
        else:
            centroids, assign = kmeans(torch.from_numpy(vectors).to(self.device), k, self.train_iters)
            assign = assign.cpu().numpy()
        order = np.argsort(assign, kind="stable")
        self._centroids = centroids.cpu().numpy()
        self._sorted_vectors = vectors[order].astype(self.dtype)
        self._sorted_rows = order.astype(np.int64)
        counts = np.bincount(assign, minlength=k)
        self._offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_clusters_eff = k
        self._dev = {}
        self._shards = None

    def _max_cluster_rows(self) -> int:
        return int(np.diff(self._offsets).max()) if self._offsets is not None else 0

    def _budget(self, nprobe: int) -> int:
        """Candidate rows a query: slack x nprobe x the mean cluster, at least
        the largest cluster (a probed mega-cluster keeps its tail), rounded up
        to 128, at most the corpus."""
        if self.candidate_rows:
            return int(self.candidate_rows)
        n = self._sorted_vectors.shape[0]
        mean_cluster = max(1.0, n / self.n_clusters_eff)
        r = max(int(self.candidate_slack * nprobe * mean_cluster), self._max_cluster_rows())
        return min(n, -(-r // 128) * 128)

    def _device_state(self, *names: str) -> Tuple[torch.Tensor, ...]:
        """The index's arrays on the device, uploaded at first use: centroids
        (f32), offsets, and the sorted corpus as ``corpus`` (scored: bf16 for
        16-bit storage, else f32) or ``stored`` (its stored values, for an
        exact rescore)."""
        for name in names:
            if name not in self._dev:
                if name == "centroids":
                    arr = torch.from_numpy(np.asarray(self._centroids, np.float32))
                elif name == "offsets":
                    arr = torch.from_numpy(np.asarray(self._offsets, np.int64))
                elif name == "corpus":
                    arr = torch.from_numpy(np.ascontiguousarray(self._sorted_vectors))
                    arr = arr.to(self.device).to(torch.bfloat16 if arr.element_size() == 2 else torch.float32)
                else:
                    arr = self._state_array(name)
                self._dev[name] = arr.to(self.device)
        return tuple(self._dev[name] for name in names)

    def _state_array(self, name: str) -> torch.Tensor:
        if name == "stored":
            return torch.from_numpy(np.ascontiguousarray(self._sorted_vectors))
        raise KeyError(name)

    def _candidates(self, qc: torch.Tensor, nprobe: int, r_budget: int):
        """Probe the nprobe best centroids (best first) and lay each query's
        probed rows out in a row budget (``_probed_slots``): → (centroid
        scores (Qc, C), sorted-row index (Qc, R), valid (Qc, R))."""
        centroids, offsets = self._device_state("centroids", "offsets")
        cent_scores = matmul_f32(qc, centroids.T)
        _, probe = topk_lowest_first(cent_scores, nprobe)
        starts = offsets[probe]
        return (cent_scores, *_probed_slots(starts, offsets[probe + 1] - starts, r_budget))

    def _chunked(self, queries: np.ndarray, chunk_q: int, run_chunk) -> Tuple[np.ndarray, np.ndarray]:
        """run_chunk over query chunks on the device; one fetch at the end."""
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(self.device)
        vals, rows = [], []
        with torch.inference_mode():
            for start in range(0, q.shape[0], chunk_q):
                v, r = run_chunk(q[start:start + chunk_q])
                vals.append(v)
                rows.append(r)
            vals, sorted_rows = torch.cat(vals).cpu().numpy(), torch.cat(rows).cpu().numpy()
        rows = np.where(sorted_rows >= 0, self._sorted_rows[np.clip(sorted_rows, 0, None)], -1)
        return vals, rows

    @staticmethod
    def _pad(vals: np.ndarray, rows: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        if vals.shape[1] < top_n:
            pad = top_n - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            rows = np.pad(rows, ((0, 0), (0, pad)), constant_values=-1)
        return vals, rows

    # -- the sharded search (faiss's index_cpu_to_all_gpus analog): the
    # clusters cut into contiguous ranges of about equal rows, one a mesh
    # entry; every shard probes the global nprobe best centroids, gathers
    # the probed rows it owns into its own budget, keeps a local top-k, and
    # the partials merge (the JAX IVFIndex's _search_rows_sharded).

    def _n_shards(self) -> int:
        return n_shards(self.mesh)

    def _ensure_sharded(self) -> dict:
        """This process's shards of the CSR: each its stored rows, their
        original rows and its clusters' local offsets, on its device."""
        if self._shards is not None:
            return self._shards
        size, offsets = self._n_shards(), self._offsets
        n, c = self._sorted_vectors.shape[0], self.n_clusters_eff
        # cluster cuts at the row boundaries nearest s·N/shards
        cuts = np.searchsorted(offsets, [round(s * n / size) for s in range(size + 1)], side="left")
        cuts[0], cuts[-1] = 0, c
        cuts = np.maximum.accumulate(np.clip(cuts, 0, c))
        c_max = max(1, int(np.diff(cuts).max()))
        s_rows = max(128, -(-int((offsets[cuts[1:]] - offsets[cuts[:-1]]).max()) // 128) * 128)
        shards = []
        for i, device in enumerate(self.mesh.local_devices):
            s = self.mesh.first_shard + i
            rs, re = int(offsets[cuts[s]]), int(offsets[cuts[s + 1]])
            loffs = np.full(c_max + 1, re - rs, dtype=np.int64)
            lo = offsets[cuts[s]:cuts[s + 1] + 1] - rs
            loffs[:len(lo)] = lo
            vecs = np.zeros((max(re - rs, 1), self._sorted_vectors.shape[1]), dtype=self._sorted_vectors.dtype)
            vecs[:re - rs] = self._sorted_vectors[rs:re]
            rows = np.zeros(max(re - rs, 1), dtype=np.int64)
            rows[:re - rs] = self._sorted_rows[rs:re]
            shards.append({"device": device, "c_start": int(cuts[s]), "c_count": int(cuts[s + 1] - cuts[s]),
                           "vecs": torch.from_numpy(vecs).to(device), "rows": torch.from_numpy(rows).to(device),
                           "loffs": torch.from_numpy(loffs).to(device)})
        self._shards = {"parts": shards, "c_max": c_max, "s_rows": s_rows}
        return self._shards

    def _search_rows_sharded(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Original row ids (-1 for an empty place) of the sharded search.
        Scores are f32 products of the f32 query and the stored rows, as the
        JAX package's sharded search computes them."""
        sd = self._ensure_sharded()
        size = self._n_shards()
        nprobe = min(self.nprobe, self.n_clusters_eff)
        mean_cluster = max(1.0, self._sorted_vectors.shape[0] / self.n_clusters_eff)
        # a shard owns about nprobe·mean/shards probed rows a query; twice the
        # single-device slack absorbs skew, never below the largest cluster
        if self.candidate_rows:
            r_local = int(self.candidate_rows)
        else:
            r_local = max(int(2 * self.candidate_slack * nprobe * mean_cluster / size), self._max_cluster_rows())
        r_local = min(sd["s_rows"], max(256, -(-r_local // 128) * 128))
        k_eff = min(top_n, r_local)
        c_max = sd["c_max"]
        (centroids,) = self._device_state("centroids")
        chunk_q = max(1, int(IVF_GATHER_BYTES / (r_local * self._sorted_vectors.shape[1] * 4)))

        def run_chunk(qc):
            _, probe = topk_lowest_first(matmul_f32(qc, centroids.T), nprobe)  # global, best first
            partials = []
            for part in sd["parts"]:
                dev = part["device"]
                q, pl = qc.to(dev), probe.to(dev) - part["c_start"]  # each probe's local cluster
                own = (pl >= 0) & (pl < part["c_count"])
                plc = pl.clamp(0, c_max - 1)
                starts = part["loffs"][plc]
                idx, valid = _probed_slots(starts, torch.where(own, part["loffs"][plc + 1] - starts, 0), r_local)
                scores = matmul_f32(part["vecs"][idx], q[:, :, None])[..., 0]
                scores = torch.where(valid, scores, float("-inf"))
                vals, pos = topk_lowest_first(scores, k_eff)
                sel = torch.gather(idx, 1, pos)
                partials.append((vals, torch.where(torch.isfinite(vals), part["rows"][sel], -1)))
            return merge_topk(partials, top_n, qc.device)

        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(self.device)
        vals, rows = [], []
        with torch.inference_mode():
            for start in range(0, q.shape[0], chunk_q):
                v, r = run_chunk(q[start:start + chunk_q])
                vals.append(v)
                rows.append(r)
            vals, rows = torch.cat(vals).cpu().numpy(), torch.cat(rows).cpu().numpy()
        return self._pad(vals, rows, top_n)

    def search_rows(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Like :meth:`search` but returns original row indices (-1 for an
        empty place): the integer path ColBERT's per-token merge reads."""
        if self._n_shards() > 1:
            return self._search_rows_sharded(queries, top_n)
        nprobe = min(self.nprobe, self.n_clusters_eff)
        r_budget = self._budget(nprobe)
        dim = self._sorted_vectors.shape[1]
        chunk_q = max(1, int(IVF_GATHER_BYTES / (r_budget * dim * self._sorted_vectors.dtype.itemsize)))
        k = min(top_n, r_budget)
        (corpus,) = self._device_state("corpus")

        def run_chunk(qc):
            _, idx, valid = self._candidates(qc, nprobe, r_budget)
            scores = matmul_f32(corpus[idx], qc.to(corpus.dtype)[:, :, None])[..., 0]
            scores = torch.where(valid, scores, float("-inf"))
            vals, pos = topk_lowest_first(scores, k)
            return vals, torch.where(torch.isfinite(vals), torch.gather(idx, 1, pos), -1)

        return self._pad(*self._chunked(queries, chunk_q, run_chunk), top_n)

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        vals, rows = self.search_rows(queries, top_n)
        return gather_ids(self._ids, rows, len(self._ids), vals)

    @property
    def row_ids(self) -> np.ndarray:
        """Sequence id of each original corpus row (aligns with search_rows)."""
        return self._ids

    def storage_bytes(self) -> int:
        """Index footprint: the sorted rows, their original rows, the offsets
        and the centroids (about the flat corpus)."""
        return (self._sorted_vectors.nbytes + self._sorted_rows.nbytes + self._offsets.nbytes
                + self._centroids.nbytes)

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        np.savez_compressed(os.path.join(folder, "ivf_index.npz"), centroids=self._centroids,
                            sorted_vectors=self._sorted_vectors, sorted_rows=self._sorted_rows,
                            offsets=self._offsets, ids=self._ids)

    def load(self, folder: str) -> None:
        data = np.load(os.path.join(folder, "ivf_index.npz"), allow_pickle=True)
        self._centroids = data["centroids"]
        self._sorted_vectors = data["sorted_vectors"]
        self._sorted_rows = data["sorted_rows"]
        self._offsets = data["offsets"]
        self._ids = data["ids"]
        self.n_clusters_eff = self._centroids.shape[0]
        self._dev = {}
        self._shards = None


class StreamingFlatIndex(BaseNNIndexer):
    """Exact MIPS over a corpus streamed from disk blocks: the encode
    folder's ``token_reps_N.npy`` blocks are the index (see the module
    docstring and :meth:`search`). Capacity is bounded by disk, not device
    memory."""

    def __init__(self, config=None, device="cuda", mesh: Optional[Mesh] = None):
        super().__init__(config, mesh.local_devices[0] if mesh is not None else device)
        self.encode_folder: Optional[str] = (config or {}).get("encode_folder")
        self._blocks: list = []
        self._row_ids: Optional[np.ndarray] = None
        self._offsets = np.array([0])

    def index_from_folder(self, folder: str) -> None:
        """Memory-map the folder's blocks (retrieval/encode.py's format) and
        map every row to its sequence id."""
        with open(os.path.join(folder, "encode_meta.json")) as f:
            meta = json.load(f)
        self._blocks = [np.load(os.path.join(folder, f"token_reps_{i}.npy"), mmap_mode="r")
                        for i in range(meta["blocks"])]
        data = np.load(os.path.join(folder, "doc_infos.npz"), allow_pickle=True)
        ids, spans = data["ids"], data["spans"]
        offsets = np.cumsum([0] + [b.shape[0] for b in self._blocks])
        row_ids = np.empty(int(offsets[-1]), dtype=ids.dtype)
        for sid, (block, start, end) in zip(ids, spans):
            row_ids[offsets[block] + start:offsets[block] + end] = sid
        self._row_ids = row_ids
        self._offsets = offsets

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        """In memory: the matrix is one block."""
        self._blocks = [np.asarray(vectors, dtype=self.dtype)]
        self._row_ids = np.asarray(ids)
        self._offsets = np.array([0, len(vectors)])

    @property
    def row_ids(self) -> np.ndarray:
        return self._row_ids

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Streamed exact top-k (f32 products of the f32 queries and the
        stored rows), merged on the device with no host sync in the loop.

        Each block is copied on the host into a pinned buffer of the uniform
        block shape (its tail zeroed) and sent to the device by a
        non-blocking copy on a side stream, which the compute stream waits
        for by an event: the copy of block i + 1 and the host's disk read
        run while the device scores block i. A block's top min(top_n, block
        rows), its padded tail masked by its row count (a zero row scores 0.0
        and could displace real sub-zero hits), merges into a running top
        min(top_n, rows) on the device. Nothing comes back until the final
        fetch; PyTorch's pinned-memory allocator reuses a host buffer only
        once the copy that read it has finished, without the host waiting."""
        q_host = np.ascontiguousarray(queries, dtype=np.float32)
        if not self._blocks:
            return (np.full((len(q_host), top_n), -np.inf, np.float32), np.full((len(q_host), top_n), -1))
        block_rows = max(b.shape[0] for b in self._blocks)
        block_k = min(top_n, block_rows)
        k = min(top_n, int(self._offsets[-1]))
        dim = self._blocks[0].shape[1]
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        with torch.inference_mode():
            q = torch.from_numpy(q_host).to(self.device)
            merged_v = torch.full((len(q_host), k), float("-inf"), device=self.device)
            merged_i = torch.full((len(q_host), k), -1, dtype=torch.int64, device=self.device)
            cols = torch.arange(block_rows, device=self.device)
            for bi, block in enumerate(self._blocks):
                n = block.shape[0]
                host = torch.empty((block_rows, dim), dtype=_TORCH_DTYPES[block.dtype], pin_memory=cuda)
                host.numpy()[:n] = block  # the disk read
                host[n:] = 0
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        dev = host.to(self.device, non_blocking=True)
                    torch.cuda.current_stream(self.device).wait_stream(copy_stream)
                    dev.record_stream(torch.cuda.current_stream(self.device))
                else:
                    dev = host
                scores = matmul_f32(q, dev.T)
                scores = torch.where(cols[None, :] < n, scores, float("-inf"))
                v, i = topk_lowest_first(scores, block_k)
                i = torch.where(torch.isfinite(v), i + int(self._offsets[bi]), -1)
                v, pos = topk_lowest_first(torch.cat([merged_v, v], dim=1), k)
                merged_v, merged_i = v, torch.gather(torch.cat([merged_i, i], dim=1), 1, pos)
            vals, idx = merged_v.cpu().numpy(), merged_i.cpu().numpy()  # the one sync
        if vals.shape[1] < top_n:
            pad = top_n - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        return gather_ids(self._row_ids, idx, len(self._row_ids), vals)

    def save(self, folder: str) -> None:
        """The encode folder is the on-disk index: record where it is."""
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "streaming_meta.json"), "w") as f:
            json.dump({"encode_folder": self.encode_folder}, f)

    def load(self, folder: str) -> None:
        with open(os.path.join(folder, "streaming_meta.json")) as f:
            self.encode_folder = json.load(f)["encode_folder"]
        self.index_from_folder(self.encode_folder)


def build_index(config, device="cuda", mesh: Optional[Mesh] = None) -> BaseNNIndexer:
    """Index factory keyed on ``faiss_index_type``: ``flat`` (also
    ``exact``, ``full``); ``scann``: the binmax operating point (float16 +
    binmax) or, with ``scann_backend: tree_ah``, ScaNN's tree-AH shape
    (retrieval/scann_tree_ah.py); ``ivf``; ``hnsw`` (retrieval/hnsw.py: the
    native graph, built from ``native/hnsw.cpp`` at first use; raises when
    it cannot be built, where the JAX factory quietly builds an IVF index);
    ``streaming`` (also ``sharded_ondisk``); ``dynamic``. ``mesh`` goes to
    every kind the JAX factory hands it to: FlatIndex, IVF and tree-AH
    shard over a mesh of more than one entry; HNSW and the streaming index
    take it and stay on its first device."""
    kind = config.get("faiss_index_type", "flat")
    if kind in ("flat", "exact", "full"):
        return FlatIndex(config, device, mesh)
    if kind == "scann":
        if config.get("scann_backend") == "tree_ah":
            from matchmaker_tpu_torch.retrieval.scann_tree_ah import ScaNNTreeAHIndex

            return ScaNNTreeAHIndex(config, device, mesh)
        cfg = dict(config)
        cfg.setdefault("mips_quantization", "float16")
        cfg.setdefault("mips_kernel", "binmax")
        return FlatIndex(cfg, device, mesh)
    if kind == "hnsw":
        from matchmaker_tpu_torch.retrieval.hnsw import HNSWIndex

        return HNSWIndex(config, device, mesh)
    if kind == "ivf":
        return IVFIndex(config, device, mesh)
    if kind in ("sharded_ondisk", "streaming"):
        return StreamingFlatIndex(config, device, mesh)
    if kind == "dynamic":
        return DynamicClusterIndex(config, device)
    raise ValueError(f"unknown faiss_index_type: {kind}")
