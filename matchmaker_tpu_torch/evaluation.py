"""Result files: counterpart of ``matchmaker_tpu/evaluation.py:save_sorted_results``."""

from __future__ import annotations

from typing import Dict, List, Tuple


def save_sorted_results(results: Dict[str, List[Tuple[str, float]]], path: str, until_rank: int = -1) -> None:
    """4-column TREC-style output: qid did rank score."""
    with open(path, "w", encoding="utf-8") as f:
        for qid, pairs in results.items():
            for rank, (did, score) in enumerate(sorted(pairs, key=lambda p: p[1], reverse=True), start=1):
                f.write(f"{qid} {did} {rank} {score}\n")
                if until_rank > -1 and rank == until_rank:
                    break
