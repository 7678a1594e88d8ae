"""Early stopping and best-checkpoint bookkeeping: counterpart of the
jax-free parts of ``matchmaker_tpu/experiment.py``.

The JAX module imports ``matchmaker_tpu.config``, which imports PyYAML, so
the port keeps its own copies of the pieces the trainer and the evaluation
run (``EarlyStopping``, ``save_best_info``, ``read_best_info``,
``parse_candidate_set``); the command-line
parser and run-folder creation are imported from the JAX package inside
``cli/train.py:main`` only.
"""

from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass
class EarlyStopping:
    """Patience-based stopper on a validation metric; ``mode='max'`` (IR
    metrics) or ``'min'`` (losses); a NaN metric stops at once."""

    patience: int = 10
    mode: str = "max"
    min_delta: float = 0.0
    best: float = field(init=False)
    bad_count: int = field(default=0, init=False)
    stopped: bool = field(default=False, init=False)

    def __post_init__(self) -> None:
        self.best = -math.inf if self.mode == "max" else math.inf

    def step(self, metric: float) -> bool:
        """Record a validation result; returns True if training should stop."""
        if math.isnan(metric):
            self.stopped = True
            return True
        improved = (
            metric > self.best + self.min_delta if self.mode == "max" else metric < self.best - self.min_delta
        )
        if improved:
            self.best = metric
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count > self.patience:
                self.stopped = True
        return self.stopped


def save_best_info(run_folder: str, metric_name: str, metric_value: float, epoch: int, batch_number: int) -> None:
    """best-info.csv: header + one row."""
    with open(os.path.join(run_folder, "best-info.csv"), "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["metric_name", "metric_value", "epoch", "batch_number"])
        w.writerow([metric_name, metric_value, epoch, batch_number])


def read_best_info(run_folder: str) -> Tuple[str, float, int, int]:
    """Inverse of :func:`save_best_info`."""
    with open(os.path.join(run_folder, "best-info.csv"), newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    name, value, epoch, batch = rows[1]
    return name, float(value), int(epoch), int(batch)


def parse_candidate_set(path: str, depth: int) -> Dict[str, Dict[str, int]]:
    """A first-stage ranking file → {qid: {did: rank}} down to ``depth``
    (1-based ranks; TREC 6-column or ``qid did rank`` lines)."""
    out: Dict[str, Dict[str, int]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if len(parts) == 6:
                qid, did, rank = parts[0], parts[2], int(parts[3])
            else:
                qid, did, rank = parts[0], parts[1], int(parts[2])
            if rank <= depth:
                out.setdefault(qid, {})[did] = rank
    return out
