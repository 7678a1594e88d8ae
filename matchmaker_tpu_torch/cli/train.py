"""Training entry point of the port: counterpart of ``matchmaker_tpu/cli/train.py``.

Usage (same config keys as the JAX CLI, plus ``device``, default ``"cuda"``):
    python -m matchmaker_tpu_torch.cli.train --config-file cfg1.yaml cfg2.yaml \\
        --run-name my_run [--config-overwrites "k: v,k2: v2"]
    python -m matchmaker_tpu_torch.cli.train --continue-folder <run folder>   # eval only
    (with ``train_mode: resume`` in the folder's config: resume from the saved train state)

The run folder receives ``training-loss.csv``, ``validation-metrics-cont.csv``,
``best-model.npz`` (loadable by ``cli.dense_retrieval``'s ``trained_model``),
``best-info.csv``, the test run files and ``efficiency-metrics.json``.
"""

from __future__ import annotations

import os
import sys
import traceback

from matchmaker_tpu.obs.perf_monitor import PerformanceMonitor

from matchmaker_tpu_torch.training.checkpoints import BEST_MODEL, load_params
from matchmaker_tpu_torch.training.trainer import Trainer


def main() -> int:
    # YAML config handling and argument parsing live in the JAX package's
    # host modules; imported here only, so importing this module needs no yaml
    from matchmaker_tpu.config import get_config, get_config_single
    from matchmaker_tpu.experiment import get_parser, prepare_experiment

    args = get_parser().parse_args()
    perf = PerformanceMonitor.get()
    perf.start_block("startup")
    if args.continue_folder:
        run_folder = args.continue_folder
        config = get_config_single(os.path.join(run_folder, "config.yaml"), args.config_overwrites)
        evaluate_only = True
    else:
        if not args.config_file or not args.run_name:
            print("either --continue-folder or --config-file + --run-name are required")
            return 2
        config = get_config(args.config_file, args.config_overwrites)
        run_folder = prepare_experiment(config["expirement_base_path"], args.run_name, config)
        evaluate_only = False

    print(f"[matchmaker-tpu-torch] run folder: {run_folder}")
    try:
        trainer = Trainer(config, run_folder)
        perf.stop_block("startup")
        if evaluate_only and config.get("train_mode", "Evaluate") == "resume":
            trainer.resume_from_train_state()
            trainer.train()
        elif evaluate_only:
            best = os.path.join(run_folder, BEST_MODEL)
            if os.path.exists(best):
                load_params(best, trainer.model)
            trainer.final_evaluations()
        else:
            trainer.train()
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
