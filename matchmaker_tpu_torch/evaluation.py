"""Re-ranking evaluation and result files: counterpart of
``matchmaker_tpu/evaluation.py``.

``evaluate_model`` scores every (query, doc) tuple of a file through an eval
step (a model forward without autograd), ``validate_model`` adds the metric
battery and the candidate-depth sweep and appends the metrics CSV,
``test_model`` writes the ranked run file and its metrics. Tokenized batches
can be kept across validations in a cache the caller owns. The port runs one
process, so every file is written by it. QA answer evaluation and secondary
(interpretability) outputs are not ported yet (ROADMAP.md, queue 1 item 10).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from matchmaker_tpu.data.loaders import reranking_inference_loader
from matchmaker_tpu.metrics import (
    calculate_metrics_along_candidate_depth,
    calculate_metrics_plain,
    load_qrels,
    unrolled_to_ranked_result,
)
from matchmaker_tpu.obs.perf_monitor import PerformanceMonitor

from matchmaker_tpu_torch.data.loaders import device_prefetch
from matchmaker_tpu_torch.experiment import parse_candidate_set

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1 item 10)"


def evaluate_model(eval_step: Callable, config, tokenizer, tuples_path: str, device: torch.device,
                   cache: Optional[Dict[str, list]] = None) -> Dict[str, List[Tuple[str, float]]]:
    """Score all (query, doc) tuples; returns {qid: [(did, score)]}. With a
    ``cache`` dict the tokenized batches of ``tuples_path`` are kept in it."""
    if config.get("submodel_validation_cache_path"):
        raise NotImplementedError(f"the submodel validation cache {_NOT_PORTED}")
    perf = PerformanceMonitor.get()
    if cache is not None and tuples_path in cache:
        batches = cache[tuples_path]
    else:
        batches = reranking_inference_loader(config, tokenizer, tuples_path)
        if cache is not None:
            batches = cache[tuples_path] = list(batches)
    results: Dict[str, List[Tuple[str, float]]] = {}
    n = 0
    perf.start_block("eval")
    for batch, qids, dids in device_prefetch(iter(batches), device):
        scores = eval_step(batch)["score"].float().cpu().numpy()
        for i, (qid, did) in enumerate(zip(qids, dids)):
            results.setdefault(qid, []).append((did, float(scores[i])))
            n += 1
    perf.stop_block("eval", n)
    return results


def validate_model(kind: str, eval_step, config, tokenizer, run_folder: str, validation_config: dict,
                   device: torch.device, epoch: int = -1, batch_number: int = -1,
                   cache: Optional[Dict[str, list]] = None) -> Tuple[Dict[str, float], float, Dict[str, List[str]]]:
    """Score + metric battery + CSV bookkeeping. Returns (metrics, the
    validation metric's value, ranked results)."""
    if config.get("train_qa_spans", False) and validation_config.get("qa_answers"):
        raise NotImplementedError(f"QA answer evaluation {_NOT_PORTED}")
    results = evaluate_model(eval_step, config, tokenizer, validation_config["tsv"], device, cache)
    ranked = unrolled_to_ranked_result(results)
    qrels = load_qrels(validation_config["qrels"])
    binarization = validation_config.get("binarization_point", 1.0)
    metric_name = config.get("validation_metric", "MRR@10")
    candidate_set_path = validation_config.get("candidate_set_path")
    if candidate_set_path and validation_config.get("candidate_set_from_to"):
        lo, hi = validation_config["candidate_set_from_to"]
        sweep = calculate_metrics_along_candidate_depth(
            ranked, qrels, parse_candidate_set(candidate_set_path, hi), (lo, hi), binarization)
        best_depth = max(sweep, key=lambda d: sweep[d][metric_name])
        metrics = sweep[best_depth]
        metrics["cs@n"] = best_depth
        for depth, m in sweep.items():
            append_metrics_csv(os.path.join(run_folder, f"validation-metrics-{kind}-cs_{depth}.csv"), m, epoch,
                               batch_number)
    else:
        metrics = calculate_metrics_plain(ranked, qrels, binarization)
        metrics["cs@n"] = "-"
    append_metrics_csv(os.path.join(run_folder, f"validation-metrics-{kind}.csv"), metrics, epoch, batch_number)
    return metrics, float(metrics[metric_name]), ranked


def test_model(eval_step, config, tokenizer, run_folder: str, test_name: str, test_config: dict,
               device: torch.device) -> Dict[str, float]:
    """End-of-training test evaluation: ranked output and metrics CSV (and
    the candidate-depth sweep where configured)."""
    if test_config.get("save_secondary_output", False):
        raise NotImplementedError(f"secondary outputs {_NOT_PORTED}")
    if config.get("train_qa_spans", False) and test_config.get("qa_answers"):
        raise NotImplementedError(f"QA answer evaluation {_NOT_PORTED}")
    results = evaluate_model(eval_step, config, tokenizer, test_config["tsv"], device)
    save_sorted_results(results, os.path.join(run_folder, f"{test_name}-output.txt"))
    metrics: Dict[str, float] = {}
    if test_config.get("qrels"):
        ranked = unrolled_to_ranked_result(results)
        qrels = load_qrels(test_config["qrels"])
        binarization = test_config.get("binarization_point", 1.0)
        metrics = calculate_metrics_plain(ranked, qrels, binarization)
        append_metrics_csv(os.path.join(run_folder, f"{test_name}-metrics.csv"), metrics, -1, -1)
        if test_config.get("candidate_set_path") and test_config.get("candidate_set_from_to"):
            lo, hi = test_config["candidate_set_from_to"]
            sweep = calculate_metrics_along_candidate_depth(
                ranked, qrels, parse_candidate_set(test_config["candidate_set_path"], hi), (lo, hi), binarization)
            for depth, m in sweep.items():
                append_metrics_csv(os.path.join(run_folder, f"{test_name}-metrics-cs_{depth}.csv"), m, -1, -1)
    return metrics


def save_sorted_results(results: Dict[str, List[Tuple[str, float]]], path: str, until_rank: int = -1) -> None:
    """4-column TREC-style output: qid did rank score."""
    with open(path, "w", encoding="utf-8") as f:
        for qid, pairs in results.items():
            for rank, (did, score) in enumerate(sorted(pairs, key=lambda p: p[1], reverse=True), start=1):
                f.write(f"{qid} {did} {rank} {score}\n")
                if until_rank > -1 and rank == until_rank:
                    break


def append_metrics_csv(path: str, metrics: Dict[str, float], epoch: int, batch_number: int) -> None:
    """Append one row (time, epoch, batch_number, metrics by sorted name);
    the header is written with the first row."""
    exists = os.path.exists(path)
    with open(path, "a", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        keys = sorted(metrics.keys())
        if not exists:
            w.writerow(["time", "epoch", "batch_number"] + keys)
        w.writerow([time.strftime("%Y-%m-%d %H:%M:%S"), epoch, batch_number] + [metrics[k] for k in keys])
