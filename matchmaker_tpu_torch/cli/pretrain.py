"""MLM pre-training entry point of the port: counterpart of
``matchmaker_tpu/cli/pretrain.py``.

Masked-language-model pre-training of the port's encoder on an
``id \\t text`` collection (data/mlm.py's whole-word masking), with the
optional POD in-batch CLS contrastive loss (``pod_contrastive_weight``),
the port's AdamW (training/optim.py), on the card by default (``device``,
default ``"cuda"``). The parameters go to ``best-model.npz`` in the run
folder (every ``save_every_n_batches`` steps and at the end); its
``encoder`` warm-starts any transformer ranker
(``warmstart_encoder_path``).

Usage:
    python -m matchmaker_tpu_torch.cli.pretrain --config-file cfg.yaml --run-name mlm
Required config: collection_tsv, expirement_base_path; see
configs/train/defaults.yaml for the shared keys (batch_size_train,
max_doc_length, learning rates, ...).
"""

from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.config import get_config
from matchmaker_tpu_torch.data.loaders import device_prefetch
from matchmaker_tpu_torch.data.mlm import IGNORE_LABEL, mlm_training_loader
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.experiment import get_parser, prepare_experiment
from matchmaker_tpu_torch.models.encoder import encoder_config_from_model_name
from matchmaker_tpu_torch.models.weights import init_parameters
from matchmaker_tpu_torch.modules.mlm_head import MLMPretrainModel
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.training.checkpoints import BEST_MODEL, save_params
from matchmaker_tpu_torch.training.optim import build_optimizer


def main() -> int:
    args = get_parser().parse_args()
    config = get_config(args.config_file, args.config_overwrites)
    run_folder = prepare_experiment(config["expirement_base_path"], args.run_name, config)
    print(f"[matchmaker-tpu-torch] MLM pretrain run folder: {run_folder}")
    return run(config, run_folder)


def mlm_loss_fn(model: MLMPretrainModel, pod_weight: float):
    """``loss_fn(batch) -> (loss, stats)``: the masked tokens' mean negative
    log-likelihood, plus ``pod_weight`` times the in-batch CLS contrastive
    cross entropy."""

    def loss_fn(batch):
        out = model(batch)
        labels = batch["mlm_labels"].long()
        mask = (labels != IGNORE_LABEL).float()
        logp = torch.log_softmax(out["mlm_logits"], dim=-1)
        token_ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
        mlm_loss = -(token_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        loss = mlm_loss
        stats = {"mlm_loss": mlm_loss}
        if pod_weight > 0:
            cls = out["cls_vecs"]
            pod = F.cross_entropy(cls @ cls.t(), torch.arange(cls.shape[0], device=cls.device))
            stats["pod_loss"] = pod
            loss = loss + pod_weight * pod
        stats["loss"] = loss
        return loss, stats

    return loss_fn


def run(config, run_folder: str) -> int:
    """MLM pre-training in process (callable from other drivers, e.g. the
    TAS-B recipe, cli/tasb_recipe.py); 0 on success."""
    try:
        device = torch.device(config.get("device", "cuda"))
        tokenizer = build_tokenizer(config)
        model = MLMPretrainModel(encoder_config_from_model_name(config),
                                 torch.bfloat16 if config.get("use_fp16", True) else torch.float32)
        init_parameters(model, torch.Generator().manual_seed(config.get("random_seed", 42)))
        model.to(device).train()
        optimizer = build_optimizer(config, model)
        loss_fn = mlm_loss_fn(model, config.get("pod_contrastive_weight", 0.0))
        best = os.path.join(run_folder, BEST_MODEL)

        perf = PerformanceMonitor.get()
        perf.start_block("pretrain")
        global_step = 0
        max_steps = config.get("pretrain_max_steps", 0)
        for epoch in range(config.get("epochs", 1)):
            if max_steps and global_step >= max_steps:
                break
            loader = mlm_training_loader(config, tokenizer, config["collection_tsv"])
            for batch in device_prefetch(loader, device):
                if max_steps and global_step >= max_steps:
                    break
                optimizer.zero_grad()
                loss, stats = loss_fn(batch)
                loss.backward()
                optimizer.step()
                global_step += 1
                if global_step % 100 == 0:
                    print(f"epoch {epoch} step {global_step} mlm_loss={float(stats['mlm_loss'].detach()):.4f}")
                if global_step % config.get("save_every_n_batches", 10000) == 0:
                    save_params(best, model)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        perf.stop_block("pretrain", global_step)
        save_params(best, model)
        perf.save_summary(os.path.join(run_folder, "efficiency-metrics.json"))
        perf.print_summary()
        return 0
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
