"""Listwise dynamic sampler: qrels positives + candidate-run negatives.

Behavioral contract with the reference ``IrDynamicTripleDatasetLoader``
(dataloaders/list_training_loader.py:30-166, unwired there —
utils/input_pipeline.py:98-104 commented): every sampled query contributes a
LIST of documents — one judged-relevant positive from the qrels (graded
label 3), ``candidate_count`` hard negatives sampled from the query's
candidate run with judged positives removed (label 1), and the remainder
random collection documents (label 0) — feeding the listwise losses
(ListNet / LambdaLoss / smooth-MRR).

TPU shape: the reference emits ragged AllenNLP instance batches; here each
batch is a fixed-shape tensor dict — queries (Q, Lq), documents
(Q, L, Ld), labels (Q, L) — consumed by the dedicated list branch of the
jitted train step (training/train_step.py), which scores all Q·L pairs in
one forward. Queries whose candidate pool is too small are skipped, exactly
like the reference's ``continue``.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from matchmaker_tpu_torch.metrics.ir_metrics import load_qrels


def load_candidates(path: str) -> Dict[str, List[str]]:
    """Candidate run file → qid → [doc_id ...] (rank order).

    Accepts both TREC 6-col (qid Q0 did rank score tag) and the compact
    ``qid did rank score`` form (reference core_metrics.py:560-577)."""
    out: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            ls = line.split()
            if len(ls) >= 6:
                qid, did = ls[0], ls[2]
            elif len(ls) >= 3:
                qid, did = ls[0], ls[1]
            else:
                continue
            out.setdefault(qid, []).append(did)
    return out


class ListwiseDynamicSampler:
    def __init__(
        self,
        collection_file: str,
        query_file: str,
        qrels_file: str,
        candidate_file: str,
        list_size: int = 8,
        queries_per_batch: int = 4,
        candidate_fraction: float = 0.5,
        seed: int = 42,
    ):
        self.list_size = list_size
        self.queries_per_batch = queries_per_batch
        # reference: candidate_target_count = list//2, rest random
        # (list_training_loader.py:119-120); the positive takes slot 0 here
        self.candidate_count = max(1, int((list_size - 1) * candidate_fraction))
        self.random_count = (list_size - 1) - self.candidate_count
        self.seed = seed

        self.collection: Dict[str, str] = {}
        self.collection_ids: List[str] = []
        with open(collection_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2:
                    self.collection[parts[0]] = parts[1].rstrip()[:100_000]
                    self.collection_ids.append(parts[0])

        self.queries: Dict[str, str] = {}
        with open(query_file, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2:
                    self.queries[parts[0]] = parts[1].rstrip()

        self.qrels = load_qrels(qrels_file)
        candidates = load_candidates(candidate_file)
        # positives never appear as label-1 candidates (reference :131-134)
        self.candidates: Dict[str, List[str]] = {}
        for qid, cands in candidates.items():
            judged = set(self.qrels.get(qid, {}))
            kept = [d for d in cands if d not in judged and d in self.collection]
            if kept:
                self.candidates[qid] = kept
        self.query_ids = sorted(
            set(self.qrels) & set(self.candidates) & set(self.queries)
        )
        if not self.query_ids:
            raise ValueError("no queries with both qrels and candidates")

    def sample_lists(self) -> Iterator[tuple]:
        """Infinite stream of (query_text, [doc_text × L], labels (L,))."""
        rng = random.Random(self.seed)
        while True:
            q_id = rng.choice(self.query_ids)
            cands = self.candidates[q_id]
            if len(cands) < self.candidate_count:
                continue  # reference: skip under-candidated queries
            pos_ids = [d for d in self.qrels[q_id] if d in self.collection]
            if not pos_ids:
                continue
            pos_id = rng.choice(pos_ids)
            doc_ids = [pos_id]
            doc_ids += rng.sample(cands, self.candidate_count)
            doc_ids += [rng.choice(self.collection_ids) for _ in range(self.random_count)]
            labels = np.array(
                [3.0] + [1.0] * self.candidate_count + [0.0] * self.random_count,
                dtype=np.float32,
            )
            yield self.queries[q_id], [self.collection[d] for d in doc_ids], labels

    def batches(self, config, tokenizer, max_batches: Optional[int] = None):
        """Fixed-shape list batches: query (Q, Lq), docs (Q, L, Ld),
        labels (Q, L), valid (Q,)."""
        max_q = config.get("max_query_length", 30)
        max_d = config.get("max_doc_length", 200)
        buf: List[dict] = []
        produced = 0
        for query, docs, labels in self.sample_lists():
            q_ids, q_mask = tokenizer.encode(query, max_q)
            encoded = [tokenizer.encode(d, max_d) for d in docs]
            d_ids = np.stack([e[0] for e in encoded])
            d_mask = np.stack([e[1] for e in encoded])
            buf.append({
                "query_ids": q_ids, "query_mask": q_mask,
                "list_doc_ids": d_ids, "list_doc_mask": d_mask,
                "list_labels": labels,
            })
            if len(buf) == self.queries_per_batch:
                batch = {k: np.stack([s[k] for s in buf]) for k in buf[0]}
                batch["valid"] = np.ones(self.queries_per_batch, np.float32)
                buf.clear()
                yield batch
                produced += 1
                if max_batches is not None and produced >= max_batches:
                    return
