"""Nearest-neighbour index layer: counterpart of
``matchmaker_tpu/retrieval/indexes.py`` (single device).

``FlatIndex`` keeps the corpus matrix on the device and serves two routes:

- ``mips_quantization: float16`` with ``mips_kernel: binmax``: rows stored
  bf16, searched by the binmax scan (ops/mips_binmax.py), or by the exact
  bf16 scan (ops/mips_f16.py) when the corpus is too small for the candidate
  pool to oversample k by 8x;
- ``mips_quantization: none``: rows stored f32, exact blocked scan
  (ops/mips.py).

The int8 routes, the XLA-scan route (``mips_kernel: scan``) and the other
index types are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.ops.mips import blocked_topk_scores
from matchmaker_tpu_torch.ops.mips_binmax import binmax_scan_topk, padding_grain
from matchmaker_tpu_torch.ops.mips_f16 import f16_scan_topk


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


class FlatIndex(BaseNNIndexer):
    """MIPS over the full corpus matrix on one device."""

    _TILE_ROWS = 2048

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
        config = config or {}
        quant = config.get("mips_quantization", "none")
        self.mips_kernel = config.get("mips_kernel", "binmax")
        if quant not in ("none", "float16"):
            raise NotImplementedError(f"mips_quantization {quant!r} is not ported yet (ROADMAP.md)")
        if quant == "float16" and self.mips_kernel != "binmax":
            raise NotImplementedError(f"mips_kernel {self.mips_kernel!r} is not ported yet (ROADMAP.md)")
        self.binmax = quant == "float16"
        self.block_size = config.get("mips_block_size", 65536)
        self.per_bin_override = config.get("mips_per_bin")
        self._vectors: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._device_vectors: Optional[torch.Tensor] = None
        self._row_count = 0

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

    def _ensure_device(self) -> None:
        if self._device_vectors is not None:
            return
        vectors = self._vectors
        self._row_count = vectors.shape[0]
        if self.binmax:
            # one grain for per_bin 2..8, so the scan never re-pads the corpus
            pbs = [self.per_bin_override] if self.per_bin_override else [2, 4, 8]
            grain = max(padding_grain(self._TILE_ROWS, pb) for pb in pbs)
            pad_to = grain * -(-vectors.shape[0] // grain)
            dev = torch.zeros((pad_to, vectors.shape[1]), dtype=torch.bfloat16, device=self.device)
            dev[:vectors.shape[0]] = torch.from_numpy(np.ascontiguousarray(vectors)).to(
                self.device).to(torch.bfloat16)
        else:
            dev = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(self.device)
        self._device_vectors = dev

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
        corpus, rows = self._device_vectors, self._row_count
        if not self.binmax:
            return blocked_topk_scores(q, corpus, k, self.block_size)
        per_bin = self._per_bin(k)
        if per_bin is None:
            return f16_scan_topk(q, corpus, k, n_valid=rows)
        return binmax_scan_topk(q, corpus, k, n_valid=rows, per_bin=per_bin, tile_rows=self._TILE_ROWS)

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


def build_index(config, device="cuda") -> BaseNNIndexer:
    """Index factory keyed on ``faiss_index_type``: ``flat`` (also ``exact``,
    ``full``) and ``scann`` (the binmax operating point: float16 + binmax)."""
    kind = config.get("faiss_index_type", "flat")
    if kind in ("flat", "exact", "full"):
        return FlatIndex(config, device)
    if kind == "scann" and config.get("scann_backend") != "tree_ah":
        cfg = dict(config)
        cfg.setdefault("mips_quantization", "float16")
        cfg.setdefault("mips_kernel", "binmax")
        return FlatIndex(cfg, device)
    raise NotImplementedError(f"faiss_index_type {kind!r} is not ported yet (ROADMAP.md)")
