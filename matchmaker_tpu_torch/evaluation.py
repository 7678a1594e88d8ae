"""Re-ranking evaluation and result files: counterpart of
``matchmaker_tpu/evaluation.py``.

``evaluate_model`` scores every (query, doc) tuple of a file through an eval
step (a model forward without autograd), ``validate_model`` adds the metric
battery and the candidate-depth sweep and appends the metrics CSV,
``test_model`` writes the ranked run file and its metrics and, with
``save_secondary_output``, the model's secondary (interpretability) tensors
of each query's top-ranked pairs as ``<test name>-secondary.npz``. Tokenized
batches can be kept across validations in a cache the caller owns. Under a
process group every process scores the whole tuple stream (each a slice of
every batch: training/train_step.py:make_eval_step) and computes the same
metrics, so early stopping stays in lockstep; only the primary process
writes files, and only it writes a new replay cache. With
``submodel_validation_cache_path`` the first pass writes IDCM's chunk scores
(the model's ``passage_scores``) to a replay cache and every later pass
(also in a later run) hands them back to the model as ``bert_part_cached``,
batch by batch in the same order (utils/replay_cache.py). With
``train_qa_spans`` and a set's ``qa_answers`` file, ``qa_evaluate`` walks
each query's ranking, takes the first answerable document's extracted span
(one (query, document) QA forward each) and scores it against the gold
answers (SQuAD exact match and F1, ``QA/ExactMatch_TopRanked`` and
``QA/F1_TopRanked`` in the metrics), writing ``last-qa-output.tsv``
(validation) or ``<test name>-qa-output.tsv``.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, reranking_inference_loader
from matchmaker_tpu_torch.data.readers import read_reranking_tuples
from matchmaker_tpu_torch.experiment import parse_candidate_set
from matchmaker_tpu_torch.metrics import (
    calculate_metrics_along_candidate_depth,
    calculate_metrics_plain,
    load_qrels,
    qa_metric_battery,
    unrolled_to_ranked_result,
)
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.parallel import multihost
from matchmaker_tpu_torch.utils.replay_cache import CrossExperimentReplayCache


def evaluate_model(eval_step: Callable, config, tokenizer, tuples_path: str, device: torch.device,
                   cache: Optional[Dict[str, list]] = None, output_secondary: bool = False):
    """Score all (query, doc) tuples; returns {qid: [(did, score)]}. With a
    ``cache`` dict the tokenized batches of ``tuples_path`` are kept in it.
    With ``output_secondary`` returns (results, secondary), the latter
    {"qid<->did": {name: array}} from the model's ``secondary`` outputs."""
    perf = PerformanceMonitor.get()
    if cache is not None and tuples_path in cache:
        batches = cache[tuples_path]
    else:
        batches = reranking_inference_loader(config, tokenizer, tuples_path)
        if cache is not None:
            batches = cache[tuples_path] = list(batches)
    replay, replay_write = None, False
    replay_path = config.get("submodel_validation_cache_path")
    if replay_path:
        replay_write = not os.path.exists(os.path.join(replay_path, "cache-meta.json"))
        if replay_write and not multihost.is_primary():
            replay_write = False  # one writer; the other processes skip the cache this pass
        else:
            replay = CrossExperimentReplayCache(replay_path, write=replay_write)
            if not replay_write:
                batches = replay_cached(batches, replay, lambda item, scores: (dict(item[0], bert_part_cached=scores),
                                                                               *item[1:]))
    results: Dict[str, List[Tuple[str, float]]] = {}
    secondary: Dict[str, dict] = {}
    n = 0
    perf.start_block("eval")
    for batch, qids, dids in device_prefetch(iter(batches), device):
        out = eval_step(batch, output_secondary=True) if output_secondary else eval_step(batch)
        if replay_write and "passage_scores" in out:
            replay.cache(out["passage_scores"].float().cpu().numpy())
        scores = out["score"].float().cpu().numpy()
        for i, (qid, did) in enumerate(zip(qids, dids)):
            results.setdefault(qid, []).append((did, float(scores[i])))
            n += 1
        if output_secondary and "secondary" in out:
            sec = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
                   for k, v in out["secondary"].items()}
            for i, (qid, did) in enumerate(zip(qids, dids)):
                secondary[f"{qid}<->{did}"] = {k: v[i] for k, v in sec.items()}
    perf.stop_block("eval", n)
    if replay_write:
        replay.finish()
    return (results, secondary) if output_secondary else results


def replay_cached(items, replay, attach):
    """Each of ``items`` with the replay cache's next chunk scores (f32)
    attached by ``attach(item, scores)``, which the model reads in place of
    its BERT part (IDCM's ``bert_part_cached``)."""
    for item in items:
        cached = replay.get_next()
        yield item if cached is None else attach(item, np.array(cached, np.float32))


def validate_model(kind: str, eval_step, config, tokenizer, run_folder: str, validation_config: dict,
                   device: torch.device, epoch: int = -1, batch_number: int = -1,
                   cache: Optional[Dict[str, list]] = None) -> Tuple[Dict[str, float], float, Dict[str, List[str]]]:
    """Score + metric battery + CSV bookkeeping. Returns (metrics, the
    validation metric's value, ranked results)."""
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
    qa_answer_metrics(eval_step, config, tokenizer, validation_config, ranked, device, metrics,
                      os.path.join(run_folder, "last-qa-output.tsv"))
    append_metrics_csv(os.path.join(run_folder, f"validation-metrics-{kind}.csv"), metrics, epoch, batch_number)
    return metrics, float(metrics[metric_name]), ranked


def test_model(eval_step, config, tokenizer, run_folder: str, test_name: str, test_config: dict,
               device: torch.device, model: Optional[torch.nn.Module] = None) -> Dict[str, float]:
    """End-of-training test evaluation: ranked output and metrics CSV (and
    the candidate-depth sweep where configured); with
    ``save_secondary_output`` the secondary tensors of each query's top
    ``secondary_output.top_n`` (100) ranked pairs, and the small parameters
    of ``model``, in ``<test_name>-secondary.npz``."""
    want_secondary = bool(test_config.get("save_secondary_output", False))
    results = evaluate_model(eval_step, config, tokenizer, test_config["tsv"], device,
                             output_secondary=want_secondary)
    if want_secondary:
        results, secondary = results
        if secondary:
            top_n = config.get_path("secondary_output.top_n", 100) if hasattr(config, "get_path") else 100
            limited = {}
            for qid, doc_ids in unrolled_to_ranked_result(results).items():
                for did in doc_ids[:top_n]:
                    key = f"{qid}<->{did}"
                    if key in secondary:
                        limited[key] = secondary[key]
            save_secondary_output(limited, os.path.join(run_folder, f"{test_name}-secondary.npz"), model)
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
    qa_answer_metrics(eval_step, config, tokenizer, test_config, unrolled_to_ranked_result(results), device, metrics,
                      os.path.join(run_folder, f"{test_name}-qa-output.tsv"))
    return metrics


def qa_answer_metrics(eval_step, config, tokenizer, set_config: dict, ranked, device, metrics: Dict, path: str):
    """With ``train_qa_spans`` and the set's ``qa_answers``: the QA answers'
    exact match and F1 on the top-ranked documents into ``metrics``, the
    answers to ``path``."""
    if not (config.get("train_qa_spans", False) and set_config.get("qa_answers")):
        return
    gold = read_qa_answers(set_config["qa_answers"])
    qa_stats, predictions = qa_evaluate(eval_step, config, tokenizer, set_config["tsv"], gold, device, ranked)
    metrics["QA/ExactMatch_TopRanked"] = qa_stats.get("QA_EM", 0.0)
    metrics["QA/F1_TopRanked"] = qa_stats.get("QA_F1", 0.0)
    save_qa_answers(predictions, gold, path)


def read_qa_answers(path: str) -> Dict[str, List[str]]:
    """``qid \\t answer1 \\t answer2 ...`` gold-answer file."""
    out: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = [p for p in parts[1:] if p]
    return out


def _extract_answer(eval_step, config, tokenizer, query: str, doc: str, device: torch.device):
    """One (query, doc) QA forward → (answer string, answerable flag): the
    start at the argmax of the document's start logits, the end at the
    argmax of its end logits from the start on."""
    max_q = config.get("max_query_length", 30)
    max_d = config.get("max_doc_length", 200)
    q_ids, q_mask = tokenizer.encode(query, max_q)
    d_ids, d_mask, offsets = tokenizer.encode_with_offsets(doc, max_d)
    batch = {"seq_ids": np.concatenate([q_ids, d_ids])[None, :],
             "seq_mask": np.concatenate([q_mask, d_mask])[None, :],
             "seq_type_ids": np.concatenate([np.zeros(max_q, np.int32), (d_mask > 0).astype(np.int32)])[None, :]}
    out = eval_step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    if "qa_logits_start" not in out:
        raise ValueError("model has no QA head (set train_qa_spans)")
    answerable = True
    if out.get("answerability_logits") is not None:
        answerable = int(out["answerability_logits"][0].float().argmax()) != 0
    start_logits = out["qa_logits_start"][0, q_ids.shape[0]:].float().cpu().numpy()
    end_logits = out["qa_logits_end"][0, q_ids.shape[0]:].float().cpu().numpy()
    s = int(start_logits.argmax())
    e = int(end_logits[s:].argmax()) + s
    if offsets[s] is None or offsets[e] is None:
        return "", answerable
    return doc[offsets[s][0]: offsets[e][1]], answerable


def qa_evaluate(eval_step, config, tokenizer, tuples_path: str, gold_answers: Dict[str, List[str]],
                device: torch.device, ranked: Optional[Dict[str, List[str]]] = None,
                max_depth: int = 10) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Extractive-QA answer evaluation: for each query, walk its ranking (the
    tuples' file order without ``ranked``) down to ``max_depth``, take the
    first answerable document's extracted span, and score the answers
    against ``gold_answers`` {query id: [answer ...]} → (SQuAD EM/F1 stats,
    {query id: answer})."""
    texts: Dict[Tuple[str, str], Tuple[str, str]] = {}
    order: Dict[str, List[str]] = {}
    for sample in read_reranking_tuples(tuples_path):
        texts[(sample.query_id, sample.doc_id)] = (sample.query, sample.doc)
        order.setdefault(sample.query_id, []).append(sample.doc_id)
    predictions: Dict[str, str] = {}
    for qid, doc_ids in (ranked if ranked is not None else order).items():
        predictions[qid] = ""
        for did in doc_ids[:max_depth]:
            if (qid, did) not in texts:
                continue
            answer, answerable = _extract_answer(eval_step, config, tokenizer, *texts[(qid, did)], device)
            if answerable:
                predictions[qid] = answer
                break
    return qa_metric_battery(predictions, gold_answers), predictions


def save_qa_answers(predictions: Dict[str, str], gold: Dict[str, List[str]], path: str) -> None:
    """``qid \\t predicted \\t gold...`` for every query with gold answers."""
    if not multihost.is_primary():
        return
    with open(path, "w", encoding="utf-8") as f:
        for qid, pred in predictions.items():
            if qid in gold:
                f.write("\t".join([qid, pred] + list(gold[qid])) + "\n")


def save_secondary_output(secondary: Dict[str, dict], path: str, model: Optional[torch.nn.Module] = None,
                          max_param_size: int = 4096) -> None:
    """Interpretability dumps as a compressed ``.npz``: ``<qid<->did>::<name>``
    per pair and, with ``model``, each parameter of at most
    ``max_param_size`` elements under ``model::<flax path>``."""
    if not multihost.is_primary():
        return
    flat = {f"{pair}::{name}": arr for pair, tensors in secondary.items() for name, arr in tensors.items()}
    if model is not None:
        for name, p in model.state_dict().items():
            if p.numel() <= max_param_size:
                flat[f"model::{name.replace('.', '/')}"] = p.detach().float().cpu().numpy()
    np.savez_compressed(path, **flat)


def save_sorted_results(results: Dict[str, List[Tuple[str, float]]], path: str, until_rank: int = -1) -> None:
    """4-column TREC-style output: qid did rank score."""
    if not multihost.is_primary():
        return
    with open(path, "w", encoding="utf-8") as f:
        for qid, pairs in results.items():
            for rank, (did, score) in enumerate(sorted(pairs, key=lambda p: p[1], reverse=True), start=1):
                f.write(f"{qid} {did} {rank} {score}\n")
                if until_rank > -1 and rank == until_rank:
                    break


def append_metrics_csv(path: str, metrics: Dict[str, float], epoch: int, batch_number: int) -> None:
    """Append one row (time, epoch, batch_number, metrics by sorted name);
    the header is written with the first row."""
    if not multihost.is_primary():
        return
    exists = os.path.exists(path)
    with open(path, "a", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        keys = sorted(metrics.keys())
        if not exists:
            w.writerow(["time", "epoch", "batch_number"] + keys)
        w.writerow([time.strftime("%Y-%m-%d %H:%M:%S"), epoch, batch_number] + [metrics[k] for k in keys])
