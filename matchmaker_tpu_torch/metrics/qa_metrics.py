"""SQuAD-style extractive-QA metrics (exact match / token F1).

Parity target: the official SQuAD normalization rules as used by the reference
(core_metrics.py:518-553): lowercase, strip punctuation, drop articles
(a/an/the), collapse whitespace; per-question score is the max over gold
answers.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, Iterable, Mapping, Sequence

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def squad_exact_match(prediction: str, ground_truth: str) -> float:
    return float(normalize_answer(prediction) == normalize_answer(ground_truth))


def squad_f1(prediction: str, ground_truth: str) -> float:
    pred_tokens = normalize_answer(prediction).split()
    gold_tokens = normalize_answer(ground_truth).split()
    common = Counter(pred_tokens) & Counter(gold_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


def _max_over_gold(metric_fn, prediction: str, gold_answers: Iterable[str]) -> float:
    return max((metric_fn(prediction, g) for g in gold_answers), default=0.0)


def qa_metric_battery(
    predictions: Mapping[str, str],
    gold: Mapping[str, Sequence[str]],
) -> Dict[str, float]:
    """Average EM/F1 over {qa_id: predicted answer} vs {qa_id: [gold answers]}."""
    em = 0.0
    f1 = 0.0
    n = 0
    for qa_id, pred in predictions.items():
        if qa_id not in gold:
            continue
        n += 1
        em += _max_over_gold(squad_exact_match, pred, gold[qa_id])
        f1 += _max_over_gold(squad_f1, pred, gold[qa_id])
    denom = max(n, 1)
    return {"QA_EM": em / denom, "QA_F1": f1 / denom, "QA_Evaluated": n}
