"""Batch search phase: counterpart of ``matchmaker_tpu/retrieval/search.py``.

Queries stream through the encoder, the index returns (scores, sequence ids)
per row, and aggregation gives the ranking: plain top-n, or max-dedup when
several corpus rows share a document id. A multi-vector query encoder
(ColBERT) hands the whole query stream to
retrieval/colbert_search.py:colbert_search_queries.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, single_sequence_loader
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.retrieval.colbert_search import TokenVectorStore, colbert_search_queries


def aggregate_plain(scores_row, ids_row, top_n: int) -> List[Tuple[str, float]]:
    out = []
    for s, i in zip(scores_row, ids_row):
        if np.isfinite(s):
            out.append((str(i), float(s)))
        if len(out) == top_n:
            break
    return out


def aggregate_max_dedup(scores_row, ids_row, top_n: int) -> List[Tuple[str, float]]:
    """Keep the max score per doc id, in score order."""
    best: Dict[str, float] = {}
    for s, i in zip(scores_row, ids_row):
        if not np.isfinite(s):
            continue
        key = str(i)
        if key not in best:
            best[key] = float(s)
        if len(best) == top_n:
            break
    return sorted(best.items(), key=lambda kv: kv[1], reverse=True)


def search_queries(encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], config, tokenizer,
                   indexer, query_path: str, top_n: int, device: torch.device, dedup: bool = False,
                   oversample: int = 2) -> Dict[str, List[Tuple[str, float]]]:
    """→ {query_id: [(doc_id, score) ...]} sorted by score, descending."""
    perf = PerformanceMonitor.get()
    results: Dict[str, List[Tuple[str, float]]] = {}
    fetch_n = top_n * oversample if dedup else top_n
    agg = aggregate_max_dedup if dedup else aggregate_plain

    loader = single_sequence_loader(config, tokenizer, query_path, "query")
    perf.start_block("search_total")
    n = 0
    for batch, qids in device_prefetch(loader, device):
        perf.start_block("search_query_encode")
        q_vecs = encode_fn(batch["seq_ids"], batch["seq_mask"])
        if q_vecs.dim() == 3:
            # multi-vector queries (ColBERT): per-token search + MaxSim merge.
            # A caller that skips the CLI's model-type branch lands here on
            # the first batch; the query stream restarts from the file there.
            perf.stop_block("search_query_encode", len(qids))
            perf.stop_block("search_total", 0)
            rescore_n = int(config.get("colbert_rescore_n", 0))
            enc_folder = config.get("encode_folder")  # the exact rescore's token store
            rescore_store = None
            if rescore_n > 0 and enc_folder and os.path.isdir(enc_folder):
                rescore_store = TokenVectorStore(enc_folder)
            return colbert_search_queries(
                encode_fn, config, tokenizer, indexer, query_path, top_n, device,
                per_token_candidates=int(config.get("colbert_per_token_candidates", 64)),
                rescore_store=rescore_store, rescore_n=rescore_n,
                device_merge=bool(config.get("colbert_device_merge", True)))
        q_vecs = q_vecs.float().cpu().numpy()
        perf.stop_block("search_query_encode", len(qids))
        perf.start_block("search_nn_lookup")
        scores, ids = indexer.search(q_vecs, fetch_n)
        perf.stop_block("search_nn_lookup", len(qids))
        perf.start_block("search_aggregation")
        for qi, qid in enumerate(qids):
            results[qid] = agg(scores[qi], ids[qi], top_n)
        perf.stop_block("search_aggregation", len(qids))
        n += len(qids)
    perf.stop_block("search_total", n)
    return results
