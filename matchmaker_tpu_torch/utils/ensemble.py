"""Run-output rank fusion (score-average and reciprocal-rank fusion).

Contract: reference utils/ensemble.py:43-265 — combine several ranked result
files (4-col ``qid did rank score``) by mean normalized score ("avg") or RRF
with k=60, write a fused run file, optionally evaluate against qrels.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from matchmaker_tpu_torch.metrics import load_ranking


def _load_run_with_scores(path: str) -> Dict[str, List[Tuple[str, float]]]:
    run: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                qid, did, _rank, score = parts
            elif len(parts) == 6:
                qid, _, did, _rank, score, _ = parts
            else:
                continue
            run[qid].append((did, float(score)))
    return run


def _normalize(scores: List[float]) -> List[float]:
    lo, hi = min(scores), max(scores)
    if hi <= lo:
        return [0.5] * len(scores)
    return [(s - lo) / (hi - lo) for s in scores]


def fuse_runs(
    paths: List[str], method: str = "rrf", rrf_k: int = 60
) -> Dict[str, List[Tuple[str, float]]]:
    """→ {qid: [(did, fused_score)]} sorted desc."""
    fused: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for path in paths:
        if method == "rrf":
            run = load_ranking(path)
            for qid, docs in run.items():
                for rank, did in enumerate(docs, start=1):
                    fused[qid][did] += 1.0 / (rrf_k + rank)
        elif method == "avg":
            run = _load_run_with_scores(path)
            for qid, pairs in run.items():
                norm = _normalize([s for _, s in pairs])
                for (did, _), ns in zip(pairs, norm):
                    fused[qid][did] += ns / len(paths)
        else:
            raise ValueError(f"unknown fusion method {method}")
    return {
        qid: sorted(scores.items(), key=lambda kv: kv[1], reverse=True)
        for qid, scores in fused.items()
    }


def main() -> int:
    import argparse

    from matchmaker_tpu_torch.evaluation import save_sorted_results
    from matchmaker_tpu_torch.metrics import calculate_metrics_plain, load_qrels, print_metric_summary, unrolled_to_ranked_result

    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", nargs="+", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--method", choices=["rrf", "avg"], default="rrf")
    parser.add_argument("--qrels")
    args = parser.parse_args()

    fused = fuse_runs(args.runs, args.method)
    save_sorted_results(fused, args.out)
    if args.qrels:
        metrics = calculate_metrics_plain(unrolled_to_ranked_result(fused), load_qrels(args.qrels))
        print_metric_summary(metrics)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
