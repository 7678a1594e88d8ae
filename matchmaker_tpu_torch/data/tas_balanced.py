"""TAS-Balanced training batch sampler (Hofstätter et al., SIGIR'21).

Behavior contract: reference dataloaders/tas_balanced_training_loader.py:21-242 —
inputs: collection (id\\ttext), queries (id\\ttext), scored pairs
(``pos_score neg_score q_id pos_id neg_id``), query cluster file (one cluster
of query ids per line). Pairs are binned per query into
``uniform_percentile_sampling_bins`` margin bins; each batch picks random
clusters, ``batch_size/clusters_per_batch`` queries per cluster, and one pair
per query sampled bin-uniform (balanced margins).

TPU shape: a plain seeded generator on the host thread feeding the
device-prefetch pipeline — no forked subprocess + queue needed since batches
are tokenized into fixed-shape numpy arrays on the fly.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from matchmaker_tpu_torch.data.batching import pad_to_batch


class TASBalancedSampler:
    def __init__(
        self,
        collection_file: str,
        query_file: str,
        pairs_with_teacher_scores: str,
        query_cluster_file: str,
        batch_size: int = 32,
        clusters_per_batch: int = 1,
        pair_balancing_strategy: str = "bins",  # "bins" | "random"
        n_bins: int = 10,
        seed: int = 42,
    ):
        self.batch_size = batch_size
        self.clusters_per_batch = clusters_per_batch
        self.use_bins = pair_balancing_strategy == "bins"
        self.n_bins = n_bins
        self.seed = seed

        self.collection: Dict[str, str] = {}
        with open(collection_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2:
                    self.collection[parts[0]] = parts[1].rstrip()[:100_000]

        self.queries: Dict[str, str] = {}
        with open(query_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2:
                    self.queries[parts[0]] = parts[1].rstrip()

        pairs_by_qid: Dict[str, List[Tuple[str, str, float, float]]] = defaultdict(list)
        with open(pairs_with_teacher_scores, "r", encoding="utf-8") as f:
            for line in f:
                ls = line.split()
                if len(ls) < 5:
                    continue
                pairs_by_qid[ls[2]].append((ls[3], ls[4], float(ls[0]), float(ls[1])))

        if self.use_bins:
            # margin-percentile binning (reference :130-146)
            self.pairs_by_qid: Dict[str, List[List[tuple]]] = {}
            for q_id, pair_list in pairs_by_qid.items():
                if len(pair_list) < 2:
                    continue
                margins = np.array([p[2] - p[3] for p in pair_list])
                lo, hi = margins.min(), margins.max()
                if hi <= lo:
                    self.pairs_by_qid[q_id] = [list(pair_list)]
                    continue
                edges = np.arange(lo, hi, (hi - lo) / self.n_bins)
                indices = np.digitize(margins, edges)
                bins: List[List[tuple]] = [[] for _ in range(self.n_bins + 1)]
                for i, p in enumerate(pair_list):
                    bins[indices[i] - 1].append(p)
                self.pairs_by_qid[q_id] = [b for b in bins]
        else:
            self.pairs_by_qid = {q: [list(p)] for q, p in pairs_by_qid.items()}

        clusters: List[List[str]] = []
        all_ids = set()
        with open(query_cluster_file, "r", encoding="utf-8") as f:
            for line in f:
                ids = line.split()
                clusters.append(ids)
                all_ids.update(ids)
        usable = set(self.pairs_by_qid.keys()) & all_ids & set(self.queries.keys())
        self.clusters = [c for c in (sorted(set(c) & usable) for c in clusters) if c]
        if not self.clusters:
            raise ValueError("no usable query clusters after intersecting with pair/query files")

    def sample_pairs(self) -> Iterator[Tuple[str, str, str, float, float]]:
        """Infinite stream of (query_text, pos_text, neg_text, pos_score, neg_score)."""
        rng = random.Random(self.seed)
        query_target = max(1, self.batch_size // self.clusters_per_batch)
        while True:
            cluster = self.clusters[rng.randint(0, len(self.clusters) - 1)]
            q_ids = rng.sample(cluster, query_target) if query_target < len(cluster) else cluster
            for q_id in q_ids:
                bins = self.pairs_by_qid[q_id]
                pair = None
                while pair is None:
                    b = bins[rng.randint(0, len(bins) - 1)]
                    if b:
                        pair = rng.choice(b)
                pos_id, neg_id, pos_score, neg_score = pair
                if pos_id not in self.collection or neg_id not in self.collection:
                    continue
                yield (
                    self.queries[q_id],
                    self.collection[pos_id],
                    self.collection[neg_id],
                    pos_score,
                    neg_score,
                )

    def batches(self, config, tokenizer, max_batches: Optional[int] = None):
        """Fixed-shape training batches matching triple_training_loader's keys."""
        max_q = config.get("max_query_length", 30)
        max_d = config.get("max_doc_length", 200)
        q_aug = config.get("query_augment_mask_number", 0)
        from matchmaker_tpu_torch.data.loaders import _encode_query_aug

        buf: List[dict] = []
        produced = 0
        for query, pos, neg, pos_score, neg_score in self.sample_pairs():
            q_ids, q_mask = _encode_query_aug(tokenizer, query, max_q, q_aug)
            p_ids, p_mask = tokenizer.encode(pos, max_d)
            n_ids, n_mask = tokenizer.encode(neg, max_d)
            buf.append(
                {
                    "query_ids": q_ids, "query_mask": q_mask,
                    "doc_pos_ids": p_ids, "doc_pos_mask": p_mask,
                    "doc_neg_ids": n_ids, "doc_neg_mask": n_mask,
                    "pos_score": np.float32(pos_score), "neg_score": np.float32(neg_score),
                }
            )
            if len(buf) == self.batch_size:
                batch = {k: np.stack([s[k] for s in buf]) for k in buf[0]}
                buf.clear()
                yield pad_to_batch(batch, self.batch_size)
                produced += 1
                if max_batches is not None and produced >= max_batches:
                    return
