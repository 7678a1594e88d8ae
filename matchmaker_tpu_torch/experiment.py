"""Experiment/run-folder management, early stopping and best-checkpoint
bookkeeping: the port's copy of ``matchmaker_tpu/experiment.py``.

``prepare_experiment`` creates a timestamped run folder, saves the merged
config (PyYAML, imported by ``config.save_config`` when it runs) and
snapshots the source; ``EarlyStopping`` tracks a validation metric with a
patience budget and stops at once on NaN; ``best-info.csv`` records the best
metric with its epoch/batch position.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import subprocess
import time
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple

from matchmaker_tpu_torch.config import save_config


def get_parser() -> argparse.ArgumentParser:
    """CLI surface shared by all entry points (reference utils/utils.py:32-69)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", nargs="+", action="extend", help="YAML config files (merged in order)")
    parser.add_argument("--run-name", type=str, help="experiment name; run folder = <expirement_base_path>/<ts>_<name>")
    parser.add_argument("--config-overwrites", type=str, default=None, help='"key: value,key2: value2" overrides')
    parser.add_argument("--continue-folder", type=str, default=None, help="resume/evaluate an existing run folder")
    return parser


def _git_commit(repo_root: str) -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=repo_root, capture_output=True, text=True, timeout=10
            ).stdout.strip()
            or "unknown"
        )
    except Exception:
        return "unknown"


def snapshot_source(run_folder: str) -> None:
    """Zip the matchmaker_tpu_torch package into the run folder (reproducibility
    equivalent of the reference's full source-tree copy, utils/utils.py:78-85)."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(pkg_dir)
    archive = os.path.join(run_folder, "source-snapshot.zip")
    with zipfile.ZipFile(archive, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(pkg_dir):
            if "__pycache__" in root:
                continue
            for fname in files:
                full = os.path.join(root, fname)
                zf.write(full, os.path.relpath(full, repo_root))
    with open(os.path.join(run_folder, "run-info.json"), "w", encoding="utf-8") as f:
        json.dump({"git_commit": _git_commit(repo_root), "created": time.time()}, f)


def prepare_experiment(base_path: str, run_name: str, config: Mapping[str, Any]) -> str:
    """Create ``<base_path>/<YYYY-MM-DD_HHMMSS>_<run_name>/`` and persist config + source."""
    stamp = time.strftime("%Y-%m-%d_%H%M%S")
    run_folder = os.path.join(base_path, f"{stamp}_{run_name}")
    suffix = 0
    while os.path.exists(run_folder):  # same-second collision
        suffix += 1
        run_folder = os.path.join(base_path, f"{stamp}_{run_name}-{suffix}")
    os.makedirs(run_folder, exist_ok=False)
    save_config(config, os.path.join(run_folder, "config.yaml"))
    snapshot_source(run_folder)
    return run_folder




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
