"""Vectorized IR metric engine.

Behavioral contract with the reference implementation
(reference `matchmaker/utils/core_metrics.py:12-16,365-494,22-210`): same
metric battery (MRR/Recall@{10,20,100,200,1000}, nDCG@{3,5,10,20,1000},
MAP@1000), same output-dict key names, same binarization semantics (a judgement
counts as relevant for MRR/Recall/MAP iff grade >= binarization_point; nDCG uses
raw graded judgements), and the same re-ranking-depth ("cs@N") sweep semantics:
documents whose first-stage candidate rank exceeds the depth cutoff are removed
and the remaining documents are re-ranked by cumulative position.

The implementation here is a fresh design: each query is reduced once to a
compact `_QueryJudgement` record, and every cutoff/depth is then evaluated by
broadcasting over a (num_queries, ...) matrix instead of per-query python work.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

GLOBAL_METRIC_CONFIG = {
    "MRR+Recall@": [10, 20, 100, 200, 1000],
    "nDCG@": [3, 5, 10, 20, 1000],
    "MAP@": 1000,  # single cutoff
}


@dataclass
class _QueryJudgement:
    """Everything metric math needs about one ranked query, as flat arrays."""

    # 1-based ranks (in the evaluated ranking) of binary-relevant documents, ascending.
    binary_ranks: np.ndarray
    binary_num_relevant: int
    # 1-based ranks and grades of all graded-relevant documents (for nDCG).
    graded_ranks: np.ndarray
    grades_at_ranks: np.ndarray
    # all judged grades sorted descending (for the ideal DCG).
    sorted_grades: np.ndarray


def _judge_query(
    ranked_doc_ids: Sequence[str],
    query_qrels: Mapping[str, float],
    binarization_point: float,
    ranks_override: np.ndarray | None = None,
) -> _QueryJudgement:
    """Reduce one query's ranking + judgements to the arrays the metrics need.

    ``ranks_override`` substitutes the implicit 1..N ranking positions with
    externally computed ranks (used by the candidate-depth sweep, where rank 0
    means "document was cut away").
    """
    grade_by_id = query_qrels
    n = len(ranked_doc_ids)
    if ranks_override is None:
        positions = np.arange(1, n + 1)
    else:
        positions = ranks_override

    graded_ranks: List[int] = []
    grades: List[float] = []
    binary_ranks: List[int] = []
    for i, doc_id in enumerate(ranked_doc_ids):
        g = grade_by_id.get(doc_id)
        if g is None or positions[i] == 0:
            continue
        graded_ranks.append(positions[i])
        grades.append(g)
        if g >= binarization_point:
            binary_ranks.append(positions[i])

    all_grades = np.array(sorted(grade_by_id.values(), reverse=True), dtype=np.float64)
    binary_num_relevant = int(sum(1 for g in grade_by_id.values() if g >= binarization_point))
    order = np.argsort(graded_ranks, kind="stable") if graded_ranks else np.array([], dtype=int)
    return _QueryJudgement(
        binary_ranks=np.sort(np.array(binary_ranks, dtype=np.int64)),
        binary_num_relevant=binary_num_relevant,
        graded_ranks=np.array(graded_ranks, dtype=np.int64)[order],
        grades_at_ranks=np.array(grades, dtype=np.float64)[order],
        sorted_grades=all_grades,
    )


def _metrics_from_judgements(judgements: List[_QueryJudgement], evaluated_queries: int):
    """Compute the full metric battery from per-query judgement records.

    Returns (metric_dict, rr_per_query, ap_per_query, recall_per_query,
    ndcg_per_query) with per-query arrays shaped (num_cutoffs, Q) — matching the
    reference's `return_per_query` contract (core_metrics.py:365-498).
    """
    q = len(judgements)
    mrr_cuts = GLOBAL_METRIC_CONFIG["MRR+Recall@"]
    ndcg_cuts = GLOBAL_METRIC_CONFIG["nDCG@"]
    map_cut = GLOBAL_METRIC_CONFIG["MAP@"]

    rr = np.zeros((len(mrr_cuts), q))
    first = np.zeros((len(mrr_cuts), q))
    recall = np.zeros((len(mrr_cuts), q))
    ap = np.zeros(q)
    ndcg = np.zeros((len(ndcg_cuts), q))

    for qi, j in enumerate(judgements):
        if j.binary_ranks.size:
            ranks = j.binary_ranks
            first_rank = ranks[0]
            # average precision @ map_cut
            within = ranks <= map_cut
            precis = np.arange(1, ranks.size + 1)[within] / ranks[within]
            ap[qi] = precis.sum() / j.binary_num_relevant
            for ci, cut in enumerate(mrr_cuts):
                recall[ci, qi] = (ranks <= cut).sum() / j.binary_num_relevant
                if first_rank <= cut:
                    rr[ci, qi] = 1.0 / first_rank
                    first[ci, qi] = first_rank
        if j.graded_ranks.size:
            for ci, cut in enumerate(ndcg_cuts):
                ideal = j.sorted_grades[:cut] / np.log2(2 + np.arange(min(j.sorted_grades.size, cut)))
                sel = j.graded_ranks <= cut
                dcg = (j.grades_at_ranks[sel] / np.log2(1 + j.graded_ranks[sel])).sum()
                ndcg[ci, qi] = dcg / ideal.sum() if ideal.size else 0.0

    def nonzero_stat(rows: np.ndarray, fn) -> np.ndarray:
        out = np.zeros(rows.shape[0])
        for i in range(rows.shape[0]):
            nz = rows[i][rows[i] > 0]
            out[i] = fn(nz) if nz.size else 0.0
        return out

    denom = max(evaluated_queries, 1)
    local: Dict[str, float] = {}
    avg_rank = nonzero_stat(first, np.mean)
    median_rank = nonzero_stat(first, np.median)
    for ci, cut in enumerate(mrr_cuts):
        local[f"MRR@{cut}"] = rr[ci].sum() / denom
        local[f"Recall@{cut}"] = recall[ci].sum() / denom
        local[f"QueriesWithNoRelevant@{cut}"] = int((rr[ci] == 0).sum())
        local[f"QueriesWithRelevant@{cut}"] = int((rr[ci] > 0).sum())
        local[f"AverageRankGoldLabel@{cut}"] = avg_rank[ci]
        local[f"MedianRankGoldLabel@{cut}"] = median_rank[ci]
    for ci, cut in enumerate(ndcg_cuts):
        local[f"nDCG@{cut}"] = ndcg[ci].sum() / denom
    local["QueriesRanked"] = evaluated_queries
    local[f"MAP@{map_cut}"] = ap.sum() / denom
    return local, rr, ap, recall, ndcg


def calculate_metrics_plain(
    ranking: Mapping[str, Sequence[str]],
    qrels: Mapping[str, Mapping[str, float]],
    binarization_point: float = 1.0,
    return_per_query: bool = False,
):
    """Metric battery over a {query_id: [doc_id ...]} ranking (no candidate sweep).

    Parity target: core_metrics.py:365-498 (same keys, same math).
    """
    judgements = []
    evaluated = 0
    for query_id, ranked_doc_ids in ranking.items():
        if query_id not in qrels:
            continue
        evaluated += 1
        judgements.append(_judge_query(ranked_doc_ids, qrels[query_id], binarization_point))
    local, rr, ap, recall, ndcg = _metrics_from_judgements(judgements, evaluated)
    if return_per_query:
        return local, rr, ap, recall, ndcg
    return local


def _depth_limited_ranks(
    ranked_doc_ids: Sequence[str],
    candidate_positions: np.ndarray,
    depth: int,
) -> np.ndarray:
    """Re-rank positions after pruning the first-stage candidate list at `depth`.

    A document survives iff its candidate rank <= depth; surviving documents
    keep their re-ranked relative order and are re-numbered 1..k. Cut documents
    get rank 0 (= "not retrieved"). Mirrors the reference's cumsum-mask trick
    (core_metrics.py:104-108).
    """
    keep = candidate_positions <= depth
    return np.cumsum(keep) * keep


def calculate_metrics_along_candidate_depth(
    ranking: Mapping[str, Sequence[str]],
    qrels: Mapping[str, Mapping[str, float]],
    candidate_ranking: Mapping[str, Mapping[str, int]],
    candidate_range: Tuple[int, int],
    binarization_point: float = 1.0,
):
    """cs@N sweep: metric battery at every candidate-set depth in candidate_range.

    ``candidate_ranking`` maps query_id -> {doc_id: first-stage rank (1-based)}.
    Returns {depth: metric_dict}. Parity target: core_metrics.py:22-210.
    """
    lo, hi = candidate_range
    per_depth_judgements: Dict[int, List[_QueryJudgement]] = {d: [] for d in range(lo, hi + 1)}
    evaluated = 0
    for query_id, ranked_doc_ids in ranking.items():
        if query_id not in qrels:
            continue
        evaluated += 1
        candidates = candidate_ranking[query_id]
        # unknown candidates are treated as "beyond any depth" (reference pads
        # with candidate_range[1]+2, core_metrics.py:86-91)
        positions = np.array([candidates.get(d, hi + 2) for d in ranked_doc_ids], dtype=np.int64)
        for depth in range(lo, hi + 1):
            ranks = _depth_limited_ranks(ranked_doc_ids, positions, depth)
            per_depth_judgements[depth].append(
                _judge_query(ranked_doc_ids, qrels[query_id], binarization_point, ranks_override=ranks)
            )

    result: Dict[int, Dict[str, float]] = {}
    for depth in range(lo, hi + 1):
        local, *_ = _metrics_from_judgements(per_depth_judgements[depth], evaluated)
        result[depth] = local
    return result


def calculate_metrics_single_candidate_threshold(
    ranking: Mapping[str, Sequence[str]],
    qrels: Mapping[str, Mapping[str, float]],
    candidate_ranking: Mapping[str, Mapping[str, int]],
    candidate_threshold: int,
    binarization_point: float = 1.0,
    return_per_query: bool = False,
):
    """Metric battery at one candidate-set depth (core_metrics.py:212-358)."""
    judgements = []
    evaluated = 0
    for query_id, ranked_doc_ids in ranking.items():
        if query_id not in qrels:
            continue
        evaluated += 1
        candidates = candidate_ranking[query_id]
        positions = np.array(
            [candidates.get(d, candidate_threshold + 2) for d in ranked_doc_ids], dtype=np.int64
        )
        ranks = _depth_limited_ranks(ranked_doc_ids, positions, candidate_threshold)
        judgements.append(
            _judge_query(ranked_doc_ids, qrels[query_id], binarization_point, ranks_override=ranks)
        )
    local, rr, ap, recall, ndcg = _metrics_from_judgements(judgements, evaluated)
    if return_per_query:
        return local, rr, ap, recall, ndcg
    return local


def unrolled_to_ranked_result(
    unrolled_results: Mapping[str, Sequence[Tuple[str, float]]],
) -> Dict[str, List[str]]:
    """{qid: [(doc_id, score)]} -> {qid: [doc_id ...]} sorted by score descending."""
    return {
        qid: [doc_id for doc_id, _ in sorted(pairs, key=lambda p: p[1], reverse=True)]
        for qid, pairs in unrolled_results.items()
    }


def load_qrels(path: str) -> Dict[str, Dict[str, float]]:
    """TREC qrels (`qid _ did grade`); grades <= 0 are dropped (core_metrics.py:560-573)."""
    qrels: Dict[str, Dict[str, float]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) < 4:
                raise IOError(f'"{line.strip()}" is not valid qrel format')
            qid, _, did, grade = parts[0], parts[1], parts[2], float(parts[3])
            if grade > 0.0001:
                qrels.setdefault(qid, {})[did] = grade
    return qrels


def load_ranking(path: str, qrels=None) -> Dict[str, List[str]]:
    """Ranking file in matchmaker 3/4-col or TREC 6-col format (core_metrics.py:575-598)."""
    ranking: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) in (3, 4):
                qid, did = parts[0], parts[1]
            elif len(parts) == 6:
                qid, did = parts[0], parts[2]
            else:
                raise IOError(f'"{line.strip()}" is not valid ranking format')
            if qrels is not None and qid not in qrels:
                continue
            ranking.setdefault(qid, []).append(did)
    return ranking


def print_metric_summary(metrics: Mapping[str, float]) -> None:
    headline = ["nDCG@10", "MRR@10", "Recall@1000", "MAP@1000"]
    print("  ".join(f"{m}={metrics[m]:.3f}" for m in headline if m in metrics))


def _main() -> None:
    import sys

    if len(sys.argv) == 4:
        metrics = calculate_metrics_plain(
            load_ranking(sys.argv[2]), load_qrels(sys.argv[1]), binarization_point=float(sys.argv[3])
        )
        for k, v in metrics.items():
            print(f"{k}: {v}")
    else:
        print("Usage: python -m matchmaker_tpu_torch.metrics.ir_metrics <qrels> <ranking> <binarization_point>")


if __name__ == "__main__":
    _main()
