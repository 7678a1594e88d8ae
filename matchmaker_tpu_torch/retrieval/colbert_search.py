"""ColBERT full-corpus retrieval, multi-vector queries over a token-vector
index: counterpart of ``matchmaker_tpu/retrieval/colbert_search.py``.

phase 1  every query token vector searches the token-vector corpus (one
         batched ``search_rows`` over the (B·Lq) query rows: the binmax scan
         K3 on a card);
phase 2  per (query, doc) the retrieved per-token scores are combined with
         the MaxSim sum: over query tokens, the max retrieved score of the
         doc (a token that did not retrieve the doc adds 0, a lower bound of
         the true MaxSim), on the device (:func:`aggregate_maxsim_device`) or
         on the host (:func:`aggregate_maxsim_batch`);
optional exact MaxSim rescoring of the top candidates with the stored doc
vectors: :func:`exact_rescore_batch` rescores a whole query batch in one K14
launch on a card (``ops/maxsim.py:maxsim_gathered``), the candidates given
as spans of the store's token rows, which go to the card once
(:meth:`TokenVectorStore.device_rows`, a second copy of the token vectors
beside the index's); :func:`exact_rescore`, one query in padded
shapes as JAX computes it, stays as the counterpart of JAX's
``exact_rescore``. Both give the same ordering and scores (non-finite → 0).

The per-document result lists are Python loops, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, single_sequence_loader
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.ops import matmul_f32
from matchmaker_tpu_torch.ops.maxsim import maxsim_all_pairs, maxsim_gathered


class TokenVectorStore:
    """Random access to per-document token vectors of an encode folder: the
    fixed-size ``token_reps_N.npy`` blocks (memmapped) and the ``doc_infos``
    span table resolve ``doc_id → (n_tokens, D)``."""

    def __init__(self, folder: str):
        with open(os.path.join(folder, "encode_meta.json")) as f:
            meta = json.load(f)
        self._blocks = [np.load(os.path.join(folder, f"token_reps_{i}.npy"), mmap_mode="r")
                        for i in range(meta["blocks"])]
        data = np.load(os.path.join(folder, "doc_infos.npz"), allow_pickle=True)
        ids, spans = data["ids"], data["spans"]
        self._span = {str(sid): tuple(span) for sid, span in zip(ids, spans)}
        self.dim = int(meta["dim"])
        self.max_tokens = int(max((e - s for _, s, e in self._span.values()), default=1))
        # the blocks' first rows in their concatenation (retrieval/encode.py:load_encoded's order)
        self._offsets = np.cumsum([0] + [b.shape[0] for b in self._blocks])
        self.rows = int(self._offsets[-1])
        self._device_rows: Dict[str, torch.Tensor] = {}

    def get(self, doc_id: str) -> np.ndarray:
        block, start, end = self._span[str(doc_id)]
        return np.asarray(self._blocks[block][start:end], dtype=np.float32)

    def span(self, doc_id: str) -> Tuple[int, int]:
        """(first row, token count) of a document in the blocks' concatenation."""
        block, start, end = self._span[str(doc_id)]
        return int(self._offsets[block]) + int(start), int(end) - int(start)

    def device_rows(self, device: torch.device) -> torch.Tensor:
        """Every token row, in the blocks' order and their dtype (float16 by
        default), on ``device``: uploaded once, at the first call, block by
        block into one tensor, so the host holds one block at a time, never
        a second copy of the store. The rescore reads these rows and not the
        index's: the binmax routes hold the rows permuted by a seeded
        permutation, padded to the tile grain and as bf16 (3 mantissa bits
        fewer than float16) or int8 codes, and the exact route as f32. So on
        a card the store takes its own rows × D × 2 bytes (float16) beside
        the index; where that exceeds the memory the card has free, a
        MemoryError names both sizes before anything is allocated."""
        device = torch.device(device)
        key = str(device)
        if key not in self._device_rows:
            dtype = torch.from_numpy(np.zeros(0, dtype=self._blocks[0].dtype)).dtype
            need = self.rows * self.dim * dtype.itemsize
            if device.type == "cuda":
                free = torch.cuda.mem_get_info(device)[0]
                free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
                if need > free:
                    raise MemoryError(f"the token store's {self.rows} rows x {self.dim} ({need / 2**30:.2f} GiB "
                                      f"of {dtype}) do not fit the {free / 2**30:.2f} GiB free on {device}")
            rows = torch.empty((self.rows, self.dim), dtype=dtype, device=device)
            for block, first in zip(self._blocks, self._offsets):
                rows[int(first):int(first) + block.shape[0]].copy_(torch.from_numpy(np.array(block)))
            self._device_rows[key] = rows
        return self._device_rows[key]


def exact_rescore(q_vecs: np.ndarray, q_mask: np.ndarray, candidates: List[Tuple[str, float]],
                  store: TokenVectorStore, top_n: int, pad_candidates: int, pad_tokens: int,
                  device: torch.device = torch.device("cuda")) -> List[Tuple[str, float]]:
    """Re-score candidate docs with the true MaxSim over their stored token
    vectors, in padded (pad_candidates, pad_tokens, D) shapes as in JAX:
    padded doc tokens take −inf, a padded query token adds 0 and a document
    without a live token scores 0 (JAX ``_exact_maxsim``)."""
    c = min(len(candidates), pad_candidates)
    d_vecs = np.zeros((pad_candidates, pad_tokens, store.dim), dtype=np.float32)
    d_mask = np.zeros((pad_candidates, pad_tokens), dtype=np.float32)
    for i, (doc_id, _) in enumerate(candidates[:c]):
        vecs = store.get(doc_id)[:pad_tokens]
        d_vecs[i, :vecs.shape[0]] = vecs
        d_mask[i, :vecs.shape[0]] = 1.0
    q_mask = (np.asarray(q_mask) > 0).astype(np.float32)
    dev = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
           for a in (q_vecs[None], q_mask[None], d_vecs, d_mask)]
    with torch.inference_mode():
        scores = maxsim_all_pairs(dev[0], dev[2], dev[1], dev[3], fill=float("-inf"))[0]
        scores = torch.where(torch.isfinite(scores), scores, 0.0).cpu().numpy()
    rescored = [(candidates[i][0], float(scores[i])) for i in range(c)]
    rescored.sort(key=lambda kv: kv[1], reverse=True)
    return rescored[:top_n]


def exact_rescore_batch(q_vecs, q_mask: np.ndarray, candidates: List[List[Tuple[str, float]]],
                        store: TokenVectorStore, top_n: int, pad_candidates: int, pad_tokens: int,
                        tokens: torch.Tensor) -> List[List[Tuple[str, float]]]:
    """:func:`exact_rescore` for a batch of queries in one K14 launch and one
    download: q_vecs (B, Lq, D) (a tensor on ``tokens``' device or an
    array), q_mask (B, Lq), each query's first ``pad_candidates``
    candidates given as spans of ``tokens`` (the store's rows,
    :meth:`TokenVectorStore.device_rows`) cut to ``pad_tokens``; padded doc slots take
    −inf, a padded query token adds 0, a non-finite score (a document
    without a live token) becomes 0, and each list is sorted as
    :func:`exact_rescore` sorts it (stable, score descending)."""
    kept = [cands[:pad_candidates] for cands in candidates]
    first = np.zeros((len(kept), pad_candidates), dtype=np.int64)
    count = np.zeros((len(kept), pad_candidates), dtype=np.int32)
    for i, cands in enumerate(kept):
        for j, (doc_id, _) in enumerate(cands):
            start, n = store.span(doc_id)
            first[i, j], count[i, j] = start, min(n, pad_tokens)
    q = torch.as_tensor(q_vecs, dtype=torch.float32).to(tokens.device)
    qm = torch.from_numpy((np.asarray(q_mask) > 0).astype(np.float32)).to(tokens.device)
    with torch.inference_mode():
        scores = maxsim_gathered(q, qm, tokens, torch.from_numpy(first), torch.from_numpy(count), pad_tokens,
                                 fill=float("-inf"))
        scores = torch.where(torch.isfinite(scores), scores, 0.0).cpu().numpy()
    out = []
    for i, cands in enumerate(kept):
        rescored = [(doc_id, float(scores[i, j])) for j, (doc_id, _) in enumerate(cands)]
        rescored.sort(key=lambda kv: kv[1], reverse=True)
        out.append(rescored[:top_n])
    return out


def aggregate_maxsim_batch(
    scores: np.ndarray,  # (B, Lq, K) per-token candidate scores
    ids: np.ndarray,  # (B, Lq, K) candidate doc ids (any dtype)
    mask: np.ndarray,  # (B, Lq) query-token mask
    top_n: int,
    vocab: Optional[np.ndarray] = None,  # int code → doc-id string
) -> List[List[Tuple[str, float]]]:
    """ONE vectorized MaxSim merge for the whole batch: per (query, doc,
    token) take the best retrieved score, then sum over tokens — a missing
    (token, doc) retrieval contributes 0 (a lower bound of true MaxSim).
    Scatter keys are factorized once instead of per query/token (the
    per-query loop was the e2e bottleneck: 82 → ~8 ms/batch at
    B=64/Lq=32/K=64 on one host core)."""
    b, lq, _ = scores.shape
    valid = np.isfinite(scores) & (mask[:, :, None] > 0)
    qi_v, ti_v, _ = np.nonzero(valid)
    ids_v = ids[valid]
    sc_v = scores[valid]
    merged: List[List[Tuple[str, float]]] = [[] for _ in range(b)]
    if not ids_v.size:
        return merged
    # one factorization only for non-integer ids (strings); integer ids are
    # their own codes
    if ids_v.dtype.kind in "iu":
        uvals, code = None, ids_v.astype(np.int64)
        d_span = int(code.max()) + 1
    else:
        uvals, code = np.unique(ids_v, return_inverse=True)
        d_span = len(uvals)
    # single composite sort key (query, doc, token) + reduceat groupbys —
    # one argsort replaces three np.unique sorts
    key = (qi_v.astype(np.int64) * d_span + code) * lq + ti_v
    order = np.argsort(key, kind="stable")
    k_sorted = key[order]
    s_sorted = sc_v[order]
    starts = np.r_[0, np.flatnonzero(np.diff(k_sorted)) + 1]
    pt_max = np.maximum.reduceat(s_sorted, starts)  # per (q, doc, token) max
    pair_sorted = k_sorted[starts] // lq  # (q, doc), still sorted
    starts2 = np.r_[0, np.flatnonzero(np.diff(pair_sorted)) + 1]
    totals = np.add.reduceat(pt_max, starts2)  # MaxSim sum over tokens
    pair_u = pair_sorted[starts2]
    pair_q = pair_u // d_span
    pair_doc = pair_u % d_span
    q_starts = np.searchsorted(pair_q, np.arange(b + 1))
    for q_idx in range(b):
        s, e = q_starts[q_idx], q_starts[q_idx + 1]
        if s == e:
            continue
        seg = totals[s:e]
        keep = min(top_n, e - s)
        top = np.argpartition(-seg, keep - 1)[:keep]
        top = top[np.argsort(-seg[top])]
        docs = pair_doc[s:e][top]
        if uvals is not None:
            names = uvals[docs]
        elif vocab is not None:
            names = vocab[docs]
        else:
            names = docs
        merged[q_idx] = [(str(names[j]), float(seg[top[j]])) for j in range(keep)]
    return merged


# rows of the equality mask built at once (JAX: i-chunks of 512 under lax.map)
_MERGE_I_CHUNK = 512


def _device_maxsim_merge(scores: torch.Tensor, slots: torch.Tensor, valid: torch.Tensor,
                         top_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch MaxSim merge on the device: (B, Lq, K) per-token candidate
    scores + doc-slot codes → per-query top-``top_n`` (scores, slots), slot
    -1 for an empty place.

    The per-token lists arrive score-descending from the top-k, so the max
    per (token, doc) is the doc's first occurrence in its token's list; later
    duplicates are zeroed, and the MaxSim sum is a sum over equal slots: an
    equality-mask product (f32, no TF32), with one result row per distinct
    doc (its first occurrence in the flat list). The (B, C, C) equality mask,
    C = Lq·K, is built in row chunks of 512 as in JAX. The top-n is a stable
    descending sort, so ties go to the lower position as ``lax.top_k`` gives."""
    b, lq, k = scores.shape
    c = lq * k
    dev = scores.device
    # 1. within-token dedup: keep only the first (= max) occurrence of a slot
    eq_tok = slots[:, :, :, None] == slots[:, :, None, :]  # (B, Lq, K, K)
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool, device=dev), -1)
    dup_in_tok = (eq_tok & lower).any(dim=-1)
    contrib = torch.where(valid & ~dup_in_tok, scores, 0.0)

    flat_slots = slots.reshape(b, c)
    flat_valid = valid.reshape(b, c)
    flat_contrib = contrib.reshape(b, c, 1)
    j_idx = torch.arange(c, device=dev)
    agg = torch.empty((b, c), dtype=torch.float32, device=dev)
    first = torch.empty((b, c), dtype=torch.bool, device=dev)
    for i0 in range(0, c, _MERGE_I_CHUNK):
        i1 = min(i0 + _MERGE_I_CHUNK, c)
        # 2. sum over all kept entries with the same slot (this chunk's rows)
        eq = (flat_slots[:, i0:i1, None] == flat_slots[:, None, :]) & flat_valid[:, None, :]
        agg[:, i0:i1] = matmul_f32(eq.float(), flat_contrib)[..., 0]
        # 3. one result row per distinct doc: suppress non-first occurrences
        earlier = j_idx[None, None, :] < j_idx[i0:i1][None, :, None]
        first[:, i0:i1] = ~(eq & earlier).any(dim=-1)
    agg = torch.where(first & flat_valid, agg, float("-inf"))
    order = torch.sort(agg, dim=1, descending=True, stable=True).indices[:, :top_n]
    vals = torch.gather(agg, 1, order)
    sel = torch.gather(flat_slots, 1, order)
    return vals, torch.where(torch.isfinite(vals), sel, -1)


def aggregate_maxsim_device(
    scores: np.ndarray,  # (B, Lq, K) per-token candidate scores
    slots: np.ndarray,  # (B, Lq, K) factorized int doc codes (-1 invalid)
    mask: np.ndarray,  # (B, Lq) query-token mask
    top_n: int,
    vocab: np.ndarray,  # slot code → doc-id string
    q_chunk: int = 16,
    device: torch.device = torch.device("cuda"),
) -> List[List[Tuple[str, float]]]:
    """Device-side drop-in for :func:`aggregate_maxsim_batch` (integer-slot
    path): queries run in chunks of ``q_chunk``, each chunk's candidates
    merged by :func:`_device_maxsim_merge`."""
    b, lq, k = scores.shape
    valid = np.isfinite(scores) & (slots >= 0) & (mask[:, :, None] > 0)
    scores = np.where(valid, scores, 0.0).astype(np.float32)
    out: List[List[Tuple[str, float]]] = []
    eff_top = min(top_n, lq * k)
    for start in range(0, b, q_chunk):
        sl = slice(start, min(start + q_chunk, b))
        pad = q_chunk - (sl.stop - sl.start)
        s_c = np.pad(scores[sl], ((0, pad), (0, 0), (0, 0)))
        d_c = np.pad(slots[sl], ((0, pad), (0, 0), (0, 0)), constant_values=-1)
        v_c = np.pad(valid[sl], ((0, pad), (0, 0), (0, 0)))
        with torch.inference_mode():
            vals, sel = _device_maxsim_merge(torch.from_numpy(s_c).to(device),
                                             torch.from_numpy(d_c.astype(np.int64)).to(device),
                                             torch.from_numpy(v_c).to(device), eff_top)
        vals, sel = vals.cpu().numpy(), sel.cpu().numpy()
        for qi in range(sl.stop - sl.start):
            out.append([(str(vocab[sel[qi, j]]), float(vals[qi, j])) for j in range(eff_top) if sel[qi, j] >= 0])
    return out


def colbert_search_queries(
    encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],  # → (B, Lq, D) query token vectors
    config,
    tokenizer,
    indexer,
    query_path: str,
    top_n: int,
    device: torch.device,
    per_token_candidates: int = 64,
    rescore_store: Optional[TokenVectorStore] = None,
    rescore_n: int = 0,
    device_merge: bool = True,
) -> Dict[str, List[Tuple[str, float]]]:
    """→ {query_id: [(doc_id, score) ...]} sorted by score, descending."""
    perf = PerformanceMonitor.get()
    results: Dict[str, List[Tuple[str, float]]] = {}
    rescore = rescore_store is not None and rescore_n > 0
    if rescore:
        # the JAX package's padded shapes: rescore_n candidates, the longest
        # document's tokens rounded up to 8
        pad_c = rescore_n
        pad_t = -(-rescore_store.max_tokens // 8) * 8
        rescore_rows = rescore_store.device_rows(device)  # the store's rows, uploaded once

    loader = single_sequence_loader(config, tokenizer, query_path, "query")
    # integer path: factorize the index's per-row ids once, search raw rows,
    # merge on int codes (strings only for the final top-n)
    row_slot = slot_vocab = None
    if hasattr(indexer, "search_rows"):
        slot_vocab, row_slot = np.unique(np.asarray(indexer.row_ids).astype(str), return_inverse=True)
        row_slot = row_slot.astype(np.int64)
    perf.start_block("search_total")
    n = 0
    for batch, qids in device_prefetch(loader, device):
        perf.start_block("search_query_encode")
        q_dev = encode_fn(batch["seq_ids"], batch["seq_mask"]).float()  # (B, Lq, D)
        q_vecs = q_dev.cpu().numpy()
        perf.stop_block("search_query_encode", len(qids))
        b, lq, dim = q_vecs.shape
        mask = batch["seq_mask"].cpu().numpy()  # (B, Lq)

        perf.start_block("search_nn_lookup")
        flat = q_vecs.reshape(b * lq, dim)
        if row_slot is not None:
            scores, rows = indexer.search_rows(flat, per_token_candidates)
            ids = np.where(rows >= 0, row_slot[np.clip(rows, 0, len(row_slot) - 1)], -1)
        else:
            scores, ids = indexer.search(flat, per_token_candidates)
        perf.stop_block("search_nn_lookup", len(qids))

        perf.start_block("search_aggregation")
        scores = scores.reshape(b, lq, per_token_candidates)
        ids = ids.reshape(b, lq, per_token_candidates)
        keep = max(top_n, rescore_n if rescore_store is not None else 0)
        if row_slot is not None and device_merge:
            merged = aggregate_maxsim_device(scores, ids, mask, keep, vocab=slot_vocab, device=device)
        else:
            merged = aggregate_maxsim_batch(scores, ids, mask, keep, vocab=slot_vocab)
        if rescore:  # one launch for the batch
            merged = exact_rescore_batch(q_dev[:len(qids)], mask[:len(qids)], merged[:len(qids)], rescore_store,
                                         top_n, pad_c, pad_t, rescore_rows)
        for q_idx, qid in enumerate(qids):
            results[qid] = merged[q_idx][:top_n]
        perf.stop_block("search_aggregation", len(qids))
        n += len(qids)
    perf.stop_block("search_total", n)
    return results
