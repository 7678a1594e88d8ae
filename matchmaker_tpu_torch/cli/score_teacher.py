"""Static teacher scoring: counterpart of ``matchmaker_tpu/cli/score_teacher.py``.

Reads ``query \t doc_pos \t doc_neg`` triples, scores each (query, doc)
pair with a trained teacher (a run folder of ``cli.train``: BERT_CAT or any
other ported model) under ``torch.inference_mode`` on the card, and writes
``pos_score \t neg_score \t query \t doc_pos \t doc_neg`` (the 5-column
scored-triple format that ``train_pairwise_distillation: true`` reads, the
scores as float32), timed in the ``teacher_scoring`` perf block.

Usage:
    python -m matchmaker_tpu_torch.cli.score_teacher --teacher <run_folder> \\
        --triples in.tsv --out train_scores.tsv [--batch-size 64] [--device cuda]

The teacher's ``config.yaml`` is read with PyYAML only when a folder is
named here; a caller holding the config passes it to :func:`score_triples`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, triple_training_loader
from matchmaker_tpu_torch.data.readers import read_triples
from matchmaker_tpu_torch.distillation.dynamic_teacher import load_teacher
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.training.train_step import forward_triple


def score_triples(teacher_path: str, triples: str, out: str, batch_size: int = 64, config=None,
                  device: Optional[str] = None) -> int:
    """Score every triple of ``triples`` with the teacher of ``teacher_path``
    (a run folder: its weights ``best-model.npz`` or a JAX run's
    ``best-model.flax``; a hub name: its config stub, the cached checkpoint's
    encoder; its config ``config`` if given, else the folder's
    ``config.yaml``) on ``device`` (default: the config's, else
    ``"cuda"``) and write the 5-column file ``out``. Returns the number of
    triples written."""
    model, config, tokenizer = load_teacher(teacher_path, config=config, device=device)
    device = next(model.parameters()).device
    cfg = dict(config)
    cfg["batch_size_train"] = batch_size
    cfg["train_pairwise_distillation"] = False  # plain 3-column triples in

    perf = PerformanceMonitor.get()
    perf.start_block("teacher_scoring")
    texts = read_triples(triples)
    n = 0
    with open(out, "w", encoding="utf-8") as f:
        loader = triple_training_loader(cfg, tokenizer, triples, batch_size=batch_size)
        for batch in device_prefetch(loader, device):
            with torch.inference_mode():
                pos_out, neg_out = forward_triple(model, batch)
                pos = pos_out["score"].float().cpu().numpy()
                neg = neg_out["score"].float().cpu().numpy()
            valid = batch["valid"].cpu().numpy()
            for i in range(len(valid)):
                if valid[i] == 0:
                    continue
                sample = next(texts)
                f.write(f"{pos[i]}\t{neg[i]}\t{sample.query}\t{sample.doc_pos}\t{sample.doc_neg}\n")
                n += 1
    perf.stop_block("teacher_scoring", n)
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--teacher", required=True, help="teacher run folder (config.yaml + best-model.npz)")
    parser.add_argument("--triples", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", default=None, help="default: the teacher config's device, else cuda")
    args = parser.parse_args(argv)
    n = score_triples(args.teacher, args.triples, args.out, args.batch_size, device=args.device)
    PerformanceMonitor.get().print_summary()
    print(f"scored {n} triples -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
