"""One-command end-to-end effectiveness check on a planted-relevance corpus:
the port's counterpart of ``matchmaker_tpu/cli/effectiveness_check.py``.

``python -m matchmaker_tpu_torch.cli.effectiveness_check --work-dir /tmp/eff``

Drives the REAL user surfaces in sequence — train (cli.train machinery) →
encode → index → full-corpus search (cli.dense_retrieval) → IR metrics — on
a pinned-seed synthetic corpus whose planted relevance gives a known MRR
ceiling of 1.0 (data/synthetic.py). This is the closeable half of the
BASELINE effectiveness north star (BERT_DOT MS MARCO-dev MRR@10 ≥ 0.34,
reference README.md:148-165): the same pipeline, the same index family
(binmax via ``faiss_index_type: scann``), validated end-to-end without
external data. The real-data runbook lives in docs/msmarco_runbook.md;
the regression floors are enforced by tests/test_effectiveness.py.

Runs on the card by default (``--device``, default ``cuda``; ``cpu`` for
the tests); the weights go to ``train_run/best-model.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional


def run_check(
    work_dir: str,
    n_docs: int = 100_000,
    n_train_queries: int = 1000,
    n_eval_queries: int = 100,
    epochs: int = 2,
    index_type: str = "scann",
    top_n: int = 100,
    seed: int = 7,
    device: str = "cuda",
    overrides: Optional[dict] = None,
) -> Dict[str, float]:
    """Train, encode, index and search the planted corpus; MRR@10 and
    Recall@min(top_n, 100) over its eval queries. ``overrides``: config keys
    set on top of the check's own, in training and retrieval alike (another
    encoder, the fused layers, another learning rate)."""
    from matchmaker_tpu_torch.config import Config, auto_fill
    from matchmaker_tpu_torch.data.synthetic import make_planted_corpus
    from matchmaker_tpu_torch.training.trainer import Trainer

    data_dir = os.path.join(work_dir, "data")
    paths = make_planted_corpus(
        data_dir, n_train_queries=n_train_queries,
        n_eval_queries=n_eval_queries, n_docs=n_docs, seed=seed,
    )

    train_folder = os.path.join(work_dir, "train_run")
    os.makedirs(train_folder, exist_ok=True)
    base = {
        "model": "bert_dot",
        "model_input_type": "auto",
        "token_embedder_type": "huggingface_bpe",
        "bert_pretrained_model": "tiny-test",
        "use_fp16": False,
        "max_query_length": 8,
        "max_doc_length": 24,
        "random_seed": seed,
        "device": device,
    }
    overrides = dict(overrides or {})
    train_cfg = Config(auto_fill({
        **base,
        "batch_size_train": 64,
        "batch_size_eval": 64,
        "epochs": epochs,
        # ranknet, not margin-mse: the synthetic triples carry no teacher
        # scores, and margin-mse against default-zero targets would actively
        # squash the margin instead of ranking
        "loss": "ranknet",
        "in_batch_negatives": True,
        "in_batch_neg_loss": "ranknet",
        "learning_rate": 1e-3,
        "param_group1_learning_rate": 1e-3,
        "optimizer_warmup_steps": 20,
        "lr_schedule": "constant",
        "gradient_clip_norm": 100.0,
        "validate_every_n_batches": -1,
        "validation_metric": "MRR@10",
        "expirement_base_path": work_dir,
        "train_tsv": paths["train_tsv"],
        **overrides,
    }))
    trainer = Trainer(train_cfg, train_folder)
    trainer.train()  # saves best-model.npz in the run folder

    retrieval_folder = os.path.join(work_dir, "retrieval_run")
    os.makedirs(retrieval_folder, exist_ok=True)
    from matchmaker_tpu_torch.cli.dense_retrieval import run as dr_run

    dr_cfg = Config(auto_fill({
        **base,
        "trained_model": train_folder,
        "collection_tsv": paths["collection"],
        "collection_batch_size": 256,
        "query_batch_size": 64,
        "token_dtype": "float16",
        "token_block_size": 50_000,
        "faiss_index_type": index_type,
        "query_sets": {
            "planted": {
                "queries_tsv": paths["queries"],
                "qrels": paths["qrels"],
                "top_n": top_n,
                "binarization_point": 1.0,
            }
        },
        **overrides,
    }))
    rc = dr_run("encode+index+search", dr_cfg, retrieval_folder)
    if rc != 0:
        raise RuntimeError(f"dense_retrieval failed rc={rc}")

    import csv

    with open(os.path.join(retrieval_folder, "planted-metrics.csv")) as f:
        rows = list(csv.reader(f))
    metrics = {k: float(v) for k, v in zip(rows[0], rows[1]) if _is_float(v)}
    out = {
        "n_docs": n_docs,
        "MRR@10": metrics.get("MRR@10"),
        f"Recall@{min(top_n, 100)}": metrics.get(f"Recall@{min(top_n, 100)}"),
        "QueriesRanked": metrics.get("QueriesRanked"),
    }
    return out


def _is_float(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--train-queries", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--index", default="scann", help="faiss_index_type (scann=binmax)")
    ap.add_argument("--min-mrr", type=float, default=None,
                    help="exit nonzero if MRR@10 falls below this floor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    result = run_check(
        args.work_dir, n_docs=args.docs, n_train_queries=args.train_queries,
        epochs=args.epochs, index_type=args.index, device=args.device,
    )
    print(json.dumps(result))
    if args.min_mrr is not None and (result["MRR@10"] or 0.0) < args.min_mrr:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
