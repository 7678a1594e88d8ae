"""Cross-experiment results table (reference utils/rich_results.py:22-125):
counterpart of ``matchmaker_tpu/utils/results_viewer.py``, copied as it is.

Walks experiment folders, reads each run's best-info.csv / *-metrics.csv and
efficiency-metrics.json, prints a comparison table sorted by the chosen metric.

Usage: python -m matchmaker_tpu_torch.utils.results_viewer <experiments_base> [metric]
"""

from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, List, Optional


def collect_run(run_folder: str) -> Optional[Dict[str, str]]:
    info = {"run": os.path.basename(run_folder)}
    best = os.path.join(run_folder, "best-info.csv")
    if os.path.exists(best):
        with open(best, newline="") as f:
            rows = list(csv.reader(f))
        if len(rows) > 1:
            info["best_metric"] = rows[1][0]
            info["best_value"] = rows[1][1]
    for name in sorted(os.listdir(run_folder)):
        if name.endswith("-metrics.csv"):
            with open(os.path.join(run_folder, name), newline="") as f:
                rows = list(csv.reader(f))
            if len(rows) >= 2:
                header, values = rows[0], rows[-1]
                for key in ("MRR@10", "nDCG@10", "Recall@1000", "MAP@1000"):
                    if key in header:
                        info[f"{name[:-12]}:{key}"] = values[header.index(key)]
    eff = os.path.join(run_folder, "efficiency-metrics.json")
    if os.path.exists(eff):
        try:
            with open(eff) as f:
                blocks = json.load(f)[-1]["blocks"]
            if "train" in blocks:
                info["train_h"] = f"{blocks['train']['total_seconds'] / 3600:.2f}"
        except Exception:
            pass
    return info if len(info) > 1 else None


def main() -> int:
    if len(sys.argv) < 2:
        print("Usage: python -m matchmaker_tpu_torch.utils.results_viewer <experiments_base> [sort_key]")
        return 2
    base = sys.argv[1]
    sort_key = sys.argv[2] if len(sys.argv) > 2 else "best_value"

    runs: List[Dict[str, str]] = []
    for name in sorted(os.listdir(base)):
        folder = os.path.join(base, name)
        if os.path.isdir(folder):
            info = collect_run(folder)
            if info:
                runs.append(info)
    if not runs:
        print("no runs found")
        return 1

    runs.sort(key=lambda r: float(r.get(sort_key, "-inf") or "-inf"), reverse=True)
    columns = sorted({k for r in runs for k in r}, key=lambda c: (c != "run", c))
    widths = {c: max(len(c), max(len(str(r.get(c, ""))) for r in runs)) for c in columns}
    print("  ".join(c.ljust(widths[c]) for c in columns))
    for r in runs:
        print("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
