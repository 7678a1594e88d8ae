"""Nearest-neighbour index layer: counterpart of
``matchmaker_tpu/retrieval/indexes.py`` (single device).

``FlatIndex`` keeps the corpus matrix on the device and serves these routes:

- ``mips_quantization: float16`` with ``mips_kernel: binmax``: rows stored
  bf16, searched by the binmax scan (ops/mips_binmax.py), or by the exact
  bf16 scan (ops/mips_f16.py) when the corpus is too small for the candidate
  pool to oversample k by 8x;
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
  per-row or one global scale; ``mips_approx_topk`` gives the exact top-k;
- ``mips_quantization: none``: rows stored f32, exact blocked scan
  (ops/mips.py).

The binmax routes honour ``mips_per_bin`` and ``mips_tile_rows`` (the
corpus tile of the candidate layout, 2048 rows by default; it sets the
padding grain and, for per_bin > 1, which candidates share a level-2 group,
so it changes results) as the JAX FlatIndex does. ``mips_q_chunk`` is
accepted and unused: the JAX kernels split the query rows into launches of
that many only to fit VMEM, which changes no result.

Not ported yet (ROADMAP.md): ``mips_twostage`` with ``mips_kernel: scan``
(ops/mips_twostage.py), the float16 XLA-scan route and the other index
types.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.ops.mips import blocked_topk_scores
from matchmaker_tpu_torch.ops.mips_binmax import BIN_WIDTH, binmax_rescore_topk, binmax_scan_topk, padding_grain
from matchmaker_tpu_torch.ops.mips_f16 import f16_scan_topk
from matchmaker_tpu_torch.ops.mips_quant import quantize_corpus, quantize_corpus_binwise, quantized_blocked_topk


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

    def __init__(self, config=None, device="cuda"):
        super().__init__(config, device)
        config = config or {}
        quant = config.get("mips_quantization", "none")
        self.mips_kernel = config.get("mips_kernel", "binmax")
        if quant not in ("none", "float16", "int8", "int8-global"):
            raise NotImplementedError(f"mips_quantization {quant!r} is not ported yet (ROADMAP.md)")
        if self.mips_kernel not in ("binmax", "scan") or (quant == "float16" and self.mips_kernel != "binmax"):
            raise NotImplementedError(f"mips_kernel {self.mips_kernel!r} with mips_quantization {quant!r} "
                                      "is not ported yet (ROADMAP.md)")
        self.quantized = quant in ("int8", "int8-global")
        self.global_scale = quant == "int8-global"
        self.twostage = config.get("mips_twostage", False)
        if self.quantized and self.twostage and self.mips_kernel == "scan":
            raise NotImplementedError("mips_twostage with mips_kernel: scan needs ops/mips_twostage.py, "
                                      "not ported yet (ROADMAP.md, queue 1 item 11)")
        self.oversample = config.get("mips_oversample", 4)
        self.rescore_dtype = config.get("mips_rescore_dtype", "int8")  # int8 | float16
        self.int8_queries = config.get("mips_int8_queries", "int8")  # int8 | float (the mixed scan)
        # the binmax routes: bf16 rows (float16) or int8 codes with bin scales
        self.binmax = (quant == "float16" or self.quantized) and self.mips_kernel == "binmax"
        self.block_size = config.get("mips_block_size", 65536)
        self.per_bin_override = config.get("mips_per_bin")
        self.tile_rows = config.get("mips_tile_rows") or 2048
        self._vectors: Optional[np.ndarray] = None
        self._ids: Optional[np.ndarray] = None
        self._device_vectors = None
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
            grain = max(padding_grain(self.tile_rows, pb) for pb in pbs)
            pad_to = grain * -(-vectors.shape[0] // grain)
        if self.binmax and self.quantized:
            padded = np.zeros((pad_to, vectors.shape[1]), dtype=np.float32)
            padded[:vectors.shape[0]] = vectors
            values, bin_scales = quantize_corpus_binwise(padded)
            rescore = None
            if self.twostage and self.rescore_dtype == "float16":
                rescore = torch.from_numpy(padded).to(self.device).to(torch.bfloat16)
            self._device_vectors = (torch.from_numpy(values).to(self.device),
                                    torch.from_numpy(bin_scales).to(self.device), rescore)
        elif self.binmax:
            dev = torch.zeros((pad_to, vectors.shape[1]), dtype=torch.bfloat16, device=self.device)
            dev[:vectors.shape[0]] = torch.from_numpy(np.ascontiguousarray(vectors)).to(self.device).to(torch.bfloat16)
            self._device_vectors = dev
        elif self.quantized:
            values, scales = quantize_corpus(vectors, per_row=not self.global_scale)
            self._device_vectors = (torch.from_numpy(values).to(self.device),
                                    torch.from_numpy(np.asarray(scales)).to(self.device))
        else:
            self._device_vectors = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(self.device)

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
        if self.quantized:
            return self._search_int8(q, k)
        if not self.binmax:
            return blocked_topk_scores(q, corpus, k, self.block_size)
        per_bin = self._per_bin(k)
        if per_bin is None:
            return f16_scan_topk(q, corpus, k, n_valid=rows)
        return binmax_scan_topk(q, corpus, k, n_valid=rows, per_bin=per_bin, tile_rows=self.tile_rows)

    def _search_int8(self, q: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The int8 routes (module docstring), as the JAX FlatIndex runs them
        on one device."""
        rows = self._row_count
        if not self.binmax:
            values, scales = self._device_vectors
            return quantized_blocked_topk(q, values, scales, k, block_size=self.block_size, n_valid=rows)
        values, bin_scales, rescore = self._device_vectors
        per_bin = self._per_bin(k)
        if per_bin is None:  # exact int8 scan over the bin scales expanded to rows
            row_scales = bin_scales[:, 0].repeat_interleave(BIN_WIDTH)[:values.shape[0]]
            return quantized_blocked_topk(q, values, row_scales, k, block_size=self.block_size, n_valid=rows)
        geom = dict(n_valid=rows, tile_rows=self.tile_rows)
        if self.int8_queries == "float":
            return binmax_scan_topk(q, values, k, per_bin=per_bin, corpus_scales=bin_scales, mixed_queries=True,
                                    **geom)
        if self.twostage:
            # in-bin candidate loss needs per_bin >= 4; the rescore undoes the quantized ranking
            return binmax_rescore_topk(q, values, bin_scales, k, oversample=self.oversample,
                                       per_bin=max(per_bin, 4), rescore_corpus=rescore, **geom)
        return binmax_scan_topk(q, values, k, per_bin=per_bin, corpus_scales=bin_scales, **geom)

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
