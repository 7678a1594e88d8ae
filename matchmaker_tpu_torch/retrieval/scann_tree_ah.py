"""ScaNN's tree-AH shape (``scann_backend: tree_ah``): counterpart of
``matchmaker_tpu/retrieval/scann_tree_ah.py`` (single device).

- **tree**: k-means leaves over the corpus, the IVFIndex CSR layout;
  ``scann_num_leaves`` defaults to ``int(sqrt(N))``, and a search probes
  ``scann_leaves_to_search`` (100) leaves, best first, into IVF's row budget;
- **AH scoring**: each row's residual to its leaf centroid as int8 codes
  with one scale a row (absmax / 127, rounded half to even), the scale
  multiplied by the anisotropic gamma of Guo et al. (ICML'20) that weights
  the score-direction error by (d − 1)·T²/(1 − T²) (T =
  ``scann_anisotropic_threshold``, 0.2). The codes are host numpy code
  copied from the JAX package, so given the same leaves they are JAX's bit
  for bit; the index computes them by blocks of rows on a thread pool
  (``ah_codes_parallel``), each row through the same arithmetic, so bit
  for bit the serial ones too. A candidate scores q·centroid(leaf) + scale·(q·codes), the query
  rounded to bf16 and the products summed in f32;
- **reorder**: the top ``scann_reorder_mult``·top_n AH candidates are
  rescored exactly (f32 products of the f32 query and the stored rows) and
  re-ranked.

Plain PyTorch on the device, queries in chunks that keep the gathered codes
near 1 GB; every top-k puts the lower candidate first among equal scores.
``search_rows`` is IVF's (probed-exact), as in the JAX package. Over a
mesh of more than one entry, ``search`` is IVF's sharded search over the
tree's leaves (exact f32 scores within the probed leaves), the route the
JAX module's docstring gives; the JAX search itself raises
``AttributeError`` there, calling a ``_search_sharded`` its parent lacks
(ROADMAP.md §3).
"""

from __future__ import annotations

import os
from math import sqrt
from typing import Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first
from matchmaker_tpu_torch.ops.mips_quant import row_parallel
from matchmaker_tpu_torch.retrieval.indexes import IVF_GATHER_BYTES, IVFIndex, gather_ids


def ah_codes(v: np.ndarray, centroids: np.ndarray, leaf: np.ndarray, aniso_threshold: float):
    """Residual int8 codes (N, D) of the rows ``v`` (sorted by leaf) and
    their (N,) f32 scales with the anisotropic gamma folded in."""
    r = v - centroids[leaf]  # residuals, f32
    s = np.abs(r).max(axis=1) / 127.0
    s = np.maximum(s, 1e-12)
    codes = np.clip(np.rint(r / s[:, None]), -127, 127).astype(np.int8)
    # gamma = c·h_par / (c²(h_par − h_perp)/|r|² + h_perp·|r~|²), c = <r, r~>, h_perp = 1
    d = v.shape[1]
    t = aniso_threshold
    h_par = max(1.0, (d - 1) * t * t / max(1e-9, 1.0 - t * t))
    r_tilde = codes.astype(np.float32) * s[:, None]
    c = np.einsum("nd,nd->n", r, r_tilde)
    rr = np.maximum(np.einsum("nd,nd->n", r, r), 1e-12)
    tt = np.maximum(np.einsum("nd,nd->n", r_tilde, r_tilde), 1e-12)
    gamma = c * h_par / (c * c * (h_par - 1.0) / rr + tt)
    return codes, (s * gamma).astype(np.float32)


def ah_codes_parallel(vectors: np.ndarray, rows: np.ndarray, centroids: np.ndarray, leaf: np.ndarray,
                      aniso_threshold: float):
    """``ah_codes(vectors[rows], centroids, leaf, aniso_threshold)``, by
    blocks of rows on a thread pool (``row_parallel``), bit for bit."""
    codes = np.empty((len(rows), vectors.shape[1]), dtype=np.int8)
    scales = np.empty(len(rows), dtype=np.float32)

    def part(a, b):
        codes[a:b], scales[a:b] = ah_codes(np.asarray(vectors[rows[a:b]], dtype=np.float32), centroids, leaf[a:b],
                                           aniso_threshold)

    row_parallel(len(rows), part)
    return codes, scales


class ScaNNTreeAHIndex(IVFIndex):
    """tree (k-means leaves) → AH int8 scan → exact reorder."""

    def __init__(self, config=None, device="cuda", mesh=None):
        super().__init__(config, device, mesh)
        config = config or {}
        self.num_leaves = config.get("scann_num_leaves")
        self.nprobe = config.get("scann_leaves_to_search", 100)
        self.reorder_mult = config.get("scann_reorder_mult", 1)
        self.aniso_threshold = config.get("scann_anisotropic_threshold", 0.2)
        self._codes = None  # (N, D) int8, sorted-by-leaf order
        self._scales = None  # (N,) f32, gamma·s
        self._leaf_of_row = None  # (N,) int32, sorted order

    def index(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        self.n_clusters = int(self.num_leaves or max(1, int(sqrt(len(vectors)))))
        super().index(ids, vectors)  # the tree: k-means + the CSR sort
        leaf = np.repeat(np.arange(self.n_clusters_eff, dtype=np.int32), np.diff(self._offsets).astype(np.int64))
        self._codes, self._scales = ah_codes_parallel(vectors, self._sorted_rows, self._centroids, leaf,
                                                      self.aniso_threshold)
        self._leaf_of_row = leaf

    def _state_array(self, name: str) -> torch.Tensor:
        if name == "codes":
            return torch.from_numpy(np.ascontiguousarray(self._codes))
        if name == "scales":
            return torch.from_numpy(np.ascontiguousarray(self._scales, dtype=np.float32))
        if name == "leaf":
            return torch.from_numpy(self._leaf_of_row.astype(np.int64))
        return super()._state_array(name)

    def search(self, queries: np.ndarray, top_n: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._n_shards() > 1:  # IVF's sharded probed-exact search over the leaves
            return IVFIndex.search(self, queries, top_n)
        nprobe = min(self.nprobe, self.n_clusters_eff)
        r_budget = self._budget(nprobe)
        reorder_k = min(r_budget, max(top_n, int(self.reorder_mult * top_n)))
        k_out = min(top_n, reorder_k)
        chunk_q = max(1, int(IVF_GATHER_BYTES / (r_budget * self._codes.shape[1])))
        codes, scales, leaf, stored = self._device_state("codes", "scales", "leaf", "stored")

        def run_chunk(qc):
            cent_scores, idx, valid = self._candidates(qc, nprobe, r_budget)
            # AH: q·x~ = q·centroid(leaf) + scale·(q·codes), the codes exact in bf16
            ah = matmul_f32(codes[idx], qc.to(torch.bfloat16)[:, :, None])[..., 0] * scales[idx]
            ah = ah + torch.gather(cent_scores, 1, leaf[idx])
            ah = torch.where(valid, ah, float("-inf"))
            # reorder: the AH top reorder_k rescored exactly in f32
            _, pos = topk_lowest_first(ah, reorder_k)
            ridx = torch.gather(idx, 1, pos)
            exact = matmul_f32(stored[ridx], qc[:, :, None])[..., 0]
            exact = torch.where(torch.gather(valid, 1, pos), exact, float("-inf"))
            vals, pos2 = topk_lowest_first(exact, k_out)
            return vals, torch.where(torch.isfinite(vals), torch.gather(ridx, 1, pos2), -1)

        vals, rows = self._pad(*self._chunked(queries, chunk_q, run_chunk), top_n)
        return gather_ids(self._ids, rows, len(self._ids), vals)

    def storage_bytes(self) -> int:
        return super().storage_bytes() + self._codes.nbytes + self._scales.nbytes + self._leaf_of_row.nbytes

    def save(self, folder: str) -> None:
        super().save(folder)
        np.savez_compressed(os.path.join(folder, "scann_ah.npz"), codes=self._codes, scales=self._scales,
                            leaf_of_row=self._leaf_of_row)

    def load(self, folder: str) -> None:
        super().load(folder)
        data = np.load(os.path.join(folder, "scann_ah.npz"))
        self._codes = data["codes"]
        self._scales = data["scales"]
        self._leaf_of_row = data["leaf_of_row"]
