"""TAS-B query clustering of the port: counterpart of
``matchmaker_tpu/cli/cluster_queries.py``.

Encode every training query with a baseline dense retriever (a run
folder: ``best-model.npz``, or a JAX run's ``best-model.flax``), cluster the vectors with k-means on the card
(retrieval/indexes.py:DynamicClusterIndex), and write one cluster of query
ids per line (the file the TAS-Balanced sampler reads). A multi-vector
encoder (ColBERT) gives a query its token vectors' masked mean.

Usage:
    python -m matchmaker_tpu_torch.cli.cluster_queries --model <bert_dot run folder> \\
        --queries train_queries.tsv --out cluster-assignment-ids.tsv [--clusters 2000]

Named on the command line, the run folder's ``config.yaml`` is read (which
needs PyYAML); ``run(..., config=...)`` takes the run's config from the
caller instead (the TAS-B recipe does). Extra config key: ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

import numpy as np
import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, single_sequence_loader
from matchmaker_tpu_torch.distillation.dynamic_teacher import load_teacher
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.retrieval.indexes import DynamicClusterIndex


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help="baseline bert_dot run folder")
    parser.add_argument("--queries", required=True, help="id\\ttext query file")
    parser.add_argument("--out", required=True)
    parser.add_argument("--clusters", type=int, default=2000)
    parser.add_argument("--batch-size", type=int, default=128)
    args = parser.parse_args()
    return run(args.model, args.queries, args.out, args.clusters, args.batch_size)


def query_vectors(model, batch) -> torch.Tensor:
    """One vector a query: the encoder's, or for a multi-vector encoder its
    token vectors' mean over the query mask."""
    with torch.inference_mode():
        vecs = model.encode(batch["seq_ids"], batch["seq_mask"], "query")
        if vecs.dim() == 3:
            m = batch["seq_mask"].to(vecs.dtype)[..., None]
            vecs = (vecs * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)
    return vecs


def run(model_path: str, queries: str, out: str, clusters: int = 2000, batch_size: int = 128,
        config=None) -> int:
    """Clustering in process (callable from the TAS-B recipe driver); 0 on success."""
    model, config, tokenizer = load_teacher(model_path, config=config)
    device = next(model.parameters()).device
    cfg = dict(config)
    cfg["batch_size_inference"] = batch_size

    perf = PerformanceMonitor.get()
    perf.start_block("query_encode")
    all_ids, all_vecs = [], []
    for batch, qids in device_prefetch(single_sequence_loader(cfg, tokenizer, queries, "query"), device):
        keep = int(batch["valid"].sum())
        all_vecs.append(query_vectors(model, batch)[:keep].float().cpu().numpy())
        all_ids.extend(qids[:keep])
    vectors = np.concatenate(all_vecs, axis=0)
    perf.stop_block("query_encode", len(all_ids))

    perf.start_block("clustering")
    index = DynamicClusterIndex({"faiss_ivf_list_count": clusters}, device)
    index.index_all(np.array(all_ids), vectors)
    perf.stop_block("clustering", len(all_ids))

    members = defaultdict(list)
    for qid, c in zip(all_ids, index._assignments):
        members[int(c)].append(qid)
    with open(out, "w", encoding="utf-8") as f:
        for c in sorted(members):
            f.write(" ".join(members[c]) + "\n")
    perf.print_summary()
    print(f"wrote {len(members)} clusters for {len(all_ids)} queries -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
