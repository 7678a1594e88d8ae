"""The FULL TAS-Balanced training recipe, end to end, one command: the
port's counterpart of ``matchmaker_tpu/cli/tasb_recipe.py``.

``python -m matchmaker_tpu_torch.cli.tasb_recipe --work-dir /tmp/tasb``

This is the reference's headline result pipeline (reference README.md:148-165
+ distillation docs: TAS-B sampler + dynamic ColBERT teacher + Margin-MSE +
in-batch KL) executed end-to-end on a planted-relevance corpus:

  0. planted corpus w/ TAS artifacts  (data/synthetic.make_planted_tas_corpus)
  1. MLM pre-train the encoder (cli/pretrain.py) — the "pretrained weights" proxy
  2. short-train a baseline BERT_DOT (MLM warmstart) → k-means query clusters
     (cli/cluster_queries, reference query_clusterer.py / runbook step 1b)
  3. ColBERT teacher trained on the triples, MLM warmstart (training/trainer)
  4. teacher-score candidate pairs → pairs_with_teacher_scores.tsv
  5. STUDENT: TAS-Balanced sampler + dynamic ColBERT teacher (in-batch
     B×2B matrices → KLDivTeacherList) + Margin-MSE pairwise
  6. encode → binmax index → full-corpus search → MRR@10 / Recall floors

Why a proxy corpus: no MS MARCO and no pretrained weights are at hand, and
nothing is downloaded. Step 1 stands in for "pretrained DistilBERT": the
encoder enters student training with language structure learned from the
corpus rather than a random init, which is the role pretraining plays in the
recipe. Every other component is the real production surface (100k docs by
default).

The JAX package's run of these defaults reached MRR@10 0.820 / Recall@100
0.99 over 100k docs (RECIPE_RESULT_r4.json); PERF.md holds the port's.

The stages run on the card by default (``--device``, default ``cuda``;
``cpu`` for the tests). Each stage's weights go to its run folder's
``best-model.npz`` and its config to ``config.yaml``, written as JSON (a
subset of YAML, so no PyYAML is needed); every stage takes the earlier
stages' configs from this process, so no stage reads a YAML file, and
``--resume`` reuses a stage's artefacts when they exist.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict



def _write_run_folder(folder: str, config) -> None:
    """The stage's config as ``config.yaml``, in JSON (which YAML readers
    read), so no PyYAML is needed to write it."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.yaml"), "w") as f:
        json.dump(dict(config), f, indent=1, sort_keys=True)


def run_recipe(
    work_dir: str,
    model_name: str = "mini-lm",
    n_docs: int = 100_000,
    n_train_queries: int = 1000,
    n_eval_queries: int = 100,
    mlm_steps: int = 1000,
    teacher_epochs: int = 10,
    tas_batches_per_epoch: int = 300,
    student_epochs: int = 6,
    batch_size: int = 64,
    n_clusters: int = 50,
    teacher_lr: float = 3e-4,
    student_lr: float = 3e-4,
    index_type: str = "scann",
    top_n: int = 100,
    seed: int = 7,
    resume: bool = False,
    device: str = "cuda",
) -> Dict[str, float]:
    """Defaults bootstrap a ``mini`` (4x256, ~11M param) encoder FROM SCRATCH:
    measured on the planted corpus, a DistilBERT-size tower without real
    pretrained weights stays at chance on ranking triples for thousands of
    steps (teacher pairwise acc ~0.5 at every stable lr; the mini tier hits
    0.999 in 10 epochs). With real MS MARCO + pretrained DistilBERT
    (docs/msmarco_runbook.md) pass ``--model distilbert-base-uncased``."""
    from matchmaker_tpu_torch.config import Config, auto_fill
    from matchmaker_tpu_torch.data.synthetic import make_planted_tas_corpus

    t_start = time.time()
    timings: Dict[str, float] = {}

    def lap(name):
        timings[name] = round(time.time() - t_start - sum(timings.values()), 1)
        print(f"[tasb-recipe] {name} done ({timings[name]}s)", flush=True)

    def have(*artifacts):
        """Stage-resume: skip a stage whose artifacts already exist (hyper-
        parameter iteration on the later stages shouldn't repay the earlier
        ones; delete the artifact to force a stage to rerun)."""
        hit = resume and all(os.path.exists(a) for a in artifacts)
        if hit:
            print(f"[tasb-recipe] resume: reusing {', '.join(artifacts)}", flush=True)
        return hit

    # ---- 0. corpus ----------------------------------------------------
    data_dir = os.path.join(work_dir, "data")
    paths = make_planted_tas_corpus(
        data_dir, n_train_queries=n_train_queries, n_eval_queries=n_eval_queries,
        n_docs=n_docs, seed=seed,
    )
    lap("corpus")

    base = {
        "model_input_type": "auto",
        "token_embedder_type": "auto",
        "bert_pretrained_model": model_name,
        "use_fp16": True,
        "max_query_length": 8,
        "max_doc_length": 24,
        "random_seed": seed,
        "expirement_base_path": work_dir,
        "lr_schedule": "constant",
        "gradient_clip_norm": 100.0,
        "validate_every_n_batches": -1,
        "validation_metric": "MRR@10",
        "device": device,
    }

    # ---- 1. MLM pre-train (the "pretrained weights" proxy) ------------
    from matchmaker_tpu_torch.cli import pretrain as pretrain_cli

    mlm_folder = os.path.join(work_dir, "mlm_run")
    os.makedirs(mlm_folder, exist_ok=True)
    mlm_cfg = Config(auto_fill({
        **base,
        "model": "bert_dot",
        "collection_tsv": paths["collection"],
        "batch_size_train": batch_size,
        "epochs": 50,  # bounded by pretrain_max_steps
        "pretrain_max_steps": mlm_steps,
        "learning_rate": 5e-4,
        "param_group0_learning_rate": 5e-4,
        "param_group1_learning_rate": 5e-4,
        "optimizer_warmup_steps": 20,
        "mlm_mask_whole_words": True,
    }))
    mlm_ckpt = os.path.join(mlm_folder, "best-model.npz")
    if not have(mlm_ckpt):
        rc = pretrain_cli.run(mlm_cfg, mlm_folder)
        if rc != 0:
            raise RuntimeError("MLM pretrain failed")
    lap("mlm_pretrain")

    # ---- 2. baseline BERT_DOT + query clusters -------------------------
    # the reference clusters train queries with a PREVIOUSLY TRAINED dense
    # retriever (query_clusterer.py; runbook step 1b) — an untrained CLS maps
    # every query to one k-means cluster. Short ranknet run from the MLM
    # warmstart gives the baseline its query geometry.
    from matchmaker_tpu_torch.training.trainer import Trainer

    baseline_folder = os.path.join(work_dir, "baseline_bert_dot")
    baseline_cfg = Config(auto_fill({
        **base,
        "model": "bert_dot",
        "train_tsv": paths["train_tsv"],
        "batch_size_train": batch_size,
        "batch_size_eval": batch_size,
        "epochs": max(2, teacher_epochs // 2),
        "loss": "ranknet",
        "in_batch_negatives": True,
        "in_batch_neg_loss": "ranknet",
        "learning_rate": teacher_lr,
        "param_group0_learning_rate": teacher_lr,
        "param_group1_learning_rate": teacher_lr * 3,
        "optimizer_warmup_steps": 20,
        "warmstart_encoder_path": mlm_ckpt,
    }))
    clusters_path = os.path.join(work_dir, "query_clusters.tsv")
    if not have(clusters_path):
        _write_run_folder(baseline_folder, baseline_cfg)
        Trainer(baseline_cfg, baseline_folder).train()

        from matchmaker_tpu_torch.cli import cluster_queries as cluster_cli

        rc = cluster_cli.run(
            baseline_folder, paths["train_queries"], clusters_path,
            clusters=min(n_clusters, max(2, n_train_queries // 8)),
            batch_size=128, config=baseline_cfg,
        )
        if rc != 0:
            raise RuntimeError("query clustering failed")
    lap("clusters")

    # ---- 3. ColBERT teacher ------------------------------------------
    teacher_folder = os.path.join(work_dir, "colbert_teacher")
    teacher_cfg = Config(auto_fill({
        **base,
        "model": "colbert",
        # cosine MaxSim (original-ColBERT normalization): a ranknet-trained
        # teacher's raw-dot scale is unanchored (measured margins ~150 —
        # Margin-MSE then forces the student to chase huge targets and
        # diverges); unit token vectors bound the targets to O(query length)
        "colbert_normalize": True,
        "colbert_compression_dim": 128,
        "train_tsv": paths["train_tsv"],
        "batch_size_train": batch_size,
        "batch_size_eval": batch_size,
        "epochs": teacher_epochs,
        "loss": "ranknet",
        "in_batch_negatives": True,
        "in_batch_neg_loss": "ranknet",
        "learning_rate": teacher_lr,
        "param_group0_learning_rate": teacher_lr,
        "param_group1_learning_rate": teacher_lr * 3,
        "optimizer_warmup_steps": 20,
        "warmstart_encoder_path": mlm_ckpt,
    }))
    if not have(os.path.join(teacher_folder, "best-model.npz")):
        _write_run_folder(teacher_folder, teacher_cfg)
        Trainer(teacher_cfg, teacher_folder).train()
    lap("teacher_train")

    # ---- 4. teacher-score the candidate pairs -------------------------
    pairs_path = os.path.join(work_dir, "pairs_with_teacher_scores.tsv")
    if not have(pairs_path):
        _score_candidates(
            teacher_folder, paths["candidates"], paths["train_queries"],
            paths["collection"], pairs_path, batch_size=128, config=teacher_cfg,
        )
    lap("pair_scoring")

    # ---- 5. student: TAS-B + dynamic teacher --------------------------
    student_folder = os.path.join(work_dir, "student_run")
    student_cfg = Config(auto_fill({
        **base,
        "model": "bert_dot",
        "train_tsv": paths["train_tsv"],  # unused (dynamic sampler), kept for config parity
        "batch_size_train": batch_size,
        "batch_size_eval": batch_size,
        "epochs": student_epochs,
        "tas_batches_per_epoch": tas_batches_per_epoch,
        "loss": "margin-mse",
        "train_pairwise_distillation": True,
        "in_batch_negatives": True,
        "in_batch_neg_loss": "KLDivTeacherList",
        "dynamic_sampler": True,
        "dynamic_sampler_collection": paths["collection"],
        "dynamic_sampler_queries": paths["train_queries"],
        "dynamic_sampler_pairs_with_teacher_scores": pairs_path,
        "dynamic_sampler_query_cluster_file": clusters_path,
        "tas_balanced_pair_strategy": "bins",
        "tas_balanced_clusters_per_batch": 2,
        "dynamic_teacher": True,
        "dynamic_teacher_path": teacher_folder,
        "dynamic_teacher_in_batch_scoring": True,
        "learning_rate": student_lr,
        "param_group0_learning_rate": student_lr,
        "param_group1_learning_rate": student_lr * 3,
        "optimizer_warmup_steps": 50,
        "warmstart_encoder_path": mlm_ckpt,
    }))
    if not have(os.path.join(student_folder, "best-model.npz")):
        _write_run_folder(student_folder, student_cfg)
        Trainer(student_cfg, student_folder, teacher_config=teacher_cfg).train()
    lap("student_train")

    # ---- 6. encode → binmax index → full-corpus search ----------------
    from matchmaker_tpu_torch.cli.dense_retrieval import run as dr_run

    retrieval_folder = os.path.join(work_dir, "retrieval_run")
    os.makedirs(retrieval_folder, exist_ok=True)
    dr_cfg = Config(auto_fill({
        **base,
        "model": "bert_dot",
        "trained_model": student_folder,
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
    }))
    rc = dr_run("encode+index+search", dr_cfg, retrieval_folder)
    if rc != 0:
        raise RuntimeError(f"dense_retrieval failed rc={rc}")
    lap("retrieval")

    import csv

    with open(os.path.join(retrieval_folder, "planted-metrics.csv")) as f:
        rows = list(csv.reader(f))
    metrics = {k: float(v) for k, v in zip(rows[0], rows[1]) if _is_float(v)}
    out = {
        "n_docs": n_docs,
        "model": model_name,
        "MRR@10": metrics.get("MRR@10"),
        f"Recall@{min(top_n, 100)}": metrics.get(f"Recall@{min(top_n, 100)}"),
        "QueriesRanked": metrics.get("QueriesRanked"),
        "timings_s": timings,
    }
    with open(os.path.join(work_dir, "tasb_recipe_result.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"[tasb-recipe] RESULT {json.dumps(out)}", flush=True)
    return out


def _score_candidates(
    teacher_folder: str, candidates_path: str, queries_path: str,
    collection_path: str, out_path: str, batch_size: int = 128, config=None,
) -> None:
    """Score ``qid \\t pos_pid \\t neg_pid`` candidates with a trained teacher
    → ``s_pos s_neg qid pos_pid neg_pid`` (the TAS pairs format);
    ``config``: the teacher run's config (else its ``config.yaml``)."""
    import numpy as np
    import torch

    from matchmaker_tpu_torch.data.batching import pad_to_batch
    from matchmaker_tpu_torch.data.loaders import _encode_query_aug, _place
    from matchmaker_tpu_torch.distillation.dynamic_teacher import load_teacher

    model, config, tokenizer = load_teacher(teacher_folder, config=config)
    device = next(model.parameters()).device
    max_q = config.get("max_query_length", 30)
    max_d = config.get("max_doc_length", 200)

    queries, collection = {}, {}
    with open(queries_path) as f:
        for line in f:
            qid, text = line.rstrip("\n").split("\t")
            queries[qid] = text
    with open(collection_path) as f:
        for line in f:
            pid, text = line.rstrip("\n").split("\t")
            collection[pid] = text

    buf, meta = [], []
    with open(out_path, "w") as fo:
        def flush():
            n = len(buf)
            batch = {k: np.stack([s[k] for s in buf]) for k in buf[0]}
            batch = _place(pad_to_batch(batch, batch_size), device)
            with torch.inference_mode():
                pos_out, neg_out = model.forward_triple(batch)
            s_pos, s_neg = pos_out["score"][:n].float().cpu().numpy(), neg_out["score"][:n].float().cpu().numpy()
            for (qid, pp, np_), sp, sn in zip(meta, s_pos, s_neg):
                fo.write(f"{sp:.4f} {sn:.4f} {qid} {pp} {np_}\n")
            buf.clear()
            meta.clear()

        with open(candidates_path) as f:
            for line in f:
                qid, pos_pid, neg_pid = line.split()
                q_ids, q_mask = _encode_query_aug(tokenizer, queries[qid], max_q, 0)
                p_ids, p_mask = tokenizer.encode(collection[pos_pid], max_d)
                n_ids, n_mask = tokenizer.encode(collection[neg_pid], max_d)
                buf.append({
                    "query_ids": q_ids, "query_mask": q_mask,
                    "doc_pos_ids": p_ids, "doc_pos_mask": p_mask,
                    "doc_neg_ids": n_ids, "doc_neg_mask": n_mask,
                })
                meta.append((qid, pos_pid, neg_pid))
                if len(buf) == batch_size:
                    flush()
        if buf:
            flush()


def summarize(work_dir: str) -> Dict[str, float]:
    """What the stages left in ``work_dir`` says of them: the teacher's
    pairwise accuracy on the scored candidate pairs (s_pos > s_neg), the
    mean and standard deviation of its margins, and the query clusters'
    count and sizes."""
    import numpy as np

    with open(os.path.join(work_dir, "pairs_with_teacher_scores.tsv")) as f:
        scores = np.array([[float(x) for x in line.split()[:2]] for line in f if line.strip()])
    margins = scores[:, 0] - scores[:, 1]
    with open(os.path.join(work_dir, "query_clusters.tsv")) as f:
        sizes = [len(line.split()) for line in f if line.strip()]
    return {"teacher_pairwise_accuracy": float((margins > 0).mean()), "teacher_margin_mean": float(margins.mean()),
            "teacher_margin_std": float(margins.std()), "scored_pairs": int(len(margins)), "clusters": len(sizes),
            "largest_cluster": max(sizes), "smallest_cluster": min(sizes)}


def _is_float(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--model", default="mini-lm")
    ap.add_argument("--n-docs", type=int, default=100_000)
    ap.add_argument("--n-train-queries", type=int, default=1000)
    ap.add_argument("--n-eval-queries", type=int, default=100)
    ap.add_argument("--mlm-steps", type=int, default=1000)
    ap.add_argument("--teacher-epochs", type=int, default=10)
    ap.add_argument("--tas-batches", type=int, default=300)
    ap.add_argument("--student-epochs", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--index-type", default="scann")
    ap.add_argument("--teacher-lr", type=float, default=3e-4)
    ap.add_argument("--student-lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--resume", action="store_true",
                    help="reuse existing stage artifacts in --work-dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run_recipe(
        args.work_dir, model_name=args.model, n_docs=args.n_docs,
        n_train_queries=args.n_train_queries, n_eval_queries=args.n_eval_queries,
        mlm_steps=args.mlm_steps, teacher_epochs=args.teacher_epochs,
        tas_batches_per_epoch=args.tas_batches, student_epochs=args.student_epochs,
        batch_size=args.batch_size, index_type=args.index_type, seed=args.seed,
        teacher_lr=args.teacher_lr, student_lr=args.student_lr, resume=args.resume,
        device=args.device,
    )
    print(f"[tasb-recipe] STAGES {json.dumps(summarize(args.work_dir))}", flush=True)
    return 0 if out.get("MRR@10") is not None else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
