#!/usr/bin/env python3
"""The port's TAS-Balanced recipe at its defaults (100k planted docs, the
``mini-lm`` encoder) and its effectiveness check at the 100k scale of
``tests/test_effectiveness.py:21-32`` (600 training queries, 60 evaluation
queries, 4 epochs), each run once on one card through its CLI's ``run``
function, as a user would run them:

    python3 tools/tasb_recipe_100k.py [--seed 7] [--out build/tasb_recipe_100k.json]

Prints the card's name and power limit, the recipe's RESULT (MRR@10,
Recall@100, each stage's wall time), what the stages left (the teacher's
pairwise accuracy and margins, the cluster count;
``cli/tasb_recipe.py:summarize``), the effectiveness check's metrics and
wall time, and the floors they are held to: the recipe's tests' floors
(MRR@10 >= 0.2, Recall@100 >= 0.6, ``tests/test_tasb_recipe.py:31-32``) and
the check's 100k floors (MRR@10 >= 0.70, Recall@100 >= 0.85,
``tests/test_effectiveness.py:31-32``). Exits 1 if a floor is missed."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "tasb_recipe_100k.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=7, help="both runs' seed (the corpus, the weights, the sampling)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from matchmaker_tpu_torch.cli.effectiveness_check import run_check
    from matchmaker_tpu_torch.cli.tasb_recipe import run_recipe, summarize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip() if args.device == "cuda" else "cpu"
    print(card, flush=True)
    report = {"card": card, "seed": args.seed}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        recipe = run_recipe(os.path.join(root, "tasb"), seed=args.seed, device=args.device)
        report["recipe"] = dict(recipe, wall_s=time.perf_counter() - t0, **summarize(os.path.join(root, "tasb")))
        print(f"[tasb_recipe_100k] recipe {json.dumps(report['recipe'])}", flush=True)
        t0 = time.perf_counter()
        check = run_check(os.path.join(root, "eff"), n_docs=100_000, n_train_queries=600, n_eval_queries=60,
                          epochs=4, seed=args.seed, device=args.device)
        report["effectiveness"] = dict(check, wall_s=time.perf_counter() - t0)
        print(f"[tasb_recipe_100k] effectiveness {json.dumps(report['effectiveness'])}", flush=True)
    floors = {"recipe MRR@10 >= 0.2": report["recipe"]["MRR@10"] >= 0.2,
              "recipe Recall@100 >= 0.6": report["recipe"]["Recall@100"] >= 0.6,
              "effectiveness MRR@10 >= 0.70": report["effectiveness"]["MRR@10"] >= 0.70,
              "effectiveness Recall@100 >= 0.85": report["effectiveness"]["Recall@100"] >= 0.85}
    report["floors"] = floors
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(floors.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
