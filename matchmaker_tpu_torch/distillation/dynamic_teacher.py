"""Dynamic teacher: counterpart of ``matchmaker_tpu/distillation/dynamic_teacher.py``.

A trained model scores each training batch on the fly, before it reaches
the student: pairwise ``pos_score`` / ``neg_score`` and, with
``dynamic_teacher_in_batch_scoring``, the B × 2B in-batch matrix
(``dyn_teacher_matrix``: ColBERT's all-pairs MaxSim, K14's plain launch on a
card, or q·dᵀ for single vectors) for the in-batch listwise losses; with
``dynamic_teacher_per_term_scores`` the per-query-term MaxSim scores for
term-level distillation. The teacher runs under ``torch.inference_mode`` on
the student's device, in the training loop's thread, queued on the card's
stream ahead of the student's step (the host never waits for its scores).

The teacher's config comes from the caller (``teacher_config``; the TAS-B
recipe keeps each stage's config in process) or, when a user names a run
folder, from its ``config.yaml`` (which needs PyYAML); its weights from the
folder's ``best-model.npz``, else a JAX run's ``best-model.flax``. A
Hugging Face hub name that ``config.resolve_hub_config`` knows
(``configs/huggingface_modelhub/``) is a hub teacher: its config is the
stub's, its encoder the checkpoint in the local Hugging Face cache (through
``init_params``), and its heads keep their seed-0 init, as the JAX
package's do (its ``init_params`` replaces only the encoder subtrees). A
teacher without a packed ``forward_triple`` (a cross-encoder, PreTTR, a
chunk adapter) scores the positive and the negative pairs in two passes,
as the training step does.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import torch

from matchmaker_tpu_torch.config import Config, get_config_single, resolve_hub_config
from matchmaker_tpu_torch.parallel.multihost import gather_rows


def load_teacher(teacher_path: str, overrides: Optional[dict] = None, config=None, device=None):
    """(model, config, tokenizer) of a trained run or a hub teacher:
    ``config`` the run's (or the stub's) config as the caller holds it,
    else read from ``teacher_path``'s ``config.yaml`` or its hub stub; the
    weights from the run folder's snapshot when it has one (``.npz`` first,
    else ``.flax``), a hub teacher's encoder from the local Hugging Face
    cache. The model sits on ``device`` (default: the config's ``device``,
    else ``"cuda"``) in eval mode."""
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models import get_model, init_params
    from matchmaker_tpu_torch.training.checkpoints import load_params, resolve_snapshot

    if config is not None:
        config = Config(dict(config))
    elif os.path.isdir(teacher_path):
        config = get_config_single(os.path.join(teacher_path, "config.yaml"))
    elif resolve_hub_config(teacher_path):
        config = get_config_single(teacher_path)  # the stub; the encoder from the local HF cache
    else:
        raise FileNotFoundError(f"teacher {teacher_path} is neither a run folder nor a known hub config")
    if overrides:
        config.update(overrides)
    tokenizer = build_tokenizer(config)
    model = get_model(config, tokenizer)
    init_params(model, config, torch.Generator().manual_seed(0))
    if os.path.isdir(teacher_path):
        try:
            snapshot = resolve_snapshot(teacher_path)
        except FileNotFoundError:
            snapshot = None
        if snapshot is not None:
            load_params(snapshot, model)
    model.to(torch.device(device or config.get("device", "cuda"))).eval()
    return model, config, tokenizer


class DynamicTeacher:
    def __init__(self, config, teacher_path: Optional[str] = None, teacher_config=None):
        teacher_path = teacher_path or config["dynamic_teacher_path"]
        self.in_batch_scoring = config.get("dynamic_teacher_in_batch_scoring", False)
        self.per_term_scores = config.get("dynamic_teacher_per_term_scores", False)
        overrides = {}
        if self.in_batch_scoring:
            overrides["in_batch_negatives"] = True
        if self.per_term_scores:
            overrides["colbert_per_term_scores"] = True
        self.model, self.teacher_config, _ = load_teacher(teacher_path, overrides or None, teacher_config,
                                                          config.get("device", "cuda"))

    @torch.inference_mode()
    def _score(self, batch: dict) -> dict:
        from matchmaker_tpu_torch.ops.maxsim import maxsim_all_pairs
        from matchmaker_tpu_torch.training.train_step import forward_triple

        pos_out, neg_out = forward_triple(self.model, batch)
        out = {"pos": pos_out["score"], "neg": neg_out["score"]}
        if self.per_term_scores and "per_term_scores" in pos_out:
            out["pos_per_term"] = pos_out["per_term_scores"]
            out["neg_per_term"] = neg_out["per_term_scores"]
        if self.in_batch_scoring and "query_vecs" in pos_out:
            # this process's queries against every process's documents (the
            # global batch's columns, as the student's in-batch scores)
            q = pos_out["query_vecs"]
            d_all = torch.cat([gather_rows(pos_out["doc_vecs"]), gather_rows(neg_out["doc_vecs"])], dim=0)
            if q.dim() == 3:  # ColBERT: the all-pairs MaxSim
                d_mask = torch.cat([gather_rows(pos_out["doc_vecs_mask"]), gather_rows(neg_out["doc_vecs_mask"])],
                                   dim=0)
                out["matrix"] = maxsim_all_pairs(q, d_all, pos_out["query_vecs_mask"], d_mask)
            else:
                out["matrix"] = torch.matmul(q.float(), d_all.float().t())
        return out

    def wrap(self, batch_iterator: Iterator[dict]) -> Iterator[dict]:
        """Yield the batches (already on the teacher's device) with the
        teacher's scores attached: ``pos_score``, ``neg_score`` and, as
        configured, ``dyn_teacher_matrix`` and the per-term scores. The
        scores leave inference mode as ordinary tensors (clones), so the
        student's loss can use them under autograd."""
        for batch in batch_iterator:
            scored = {k: v.clone() for k, v in self._score(batch).items()}
            batch = dict(batch)
            batch["pos_score"] = scored["pos"]
            batch["neg_score"] = scored["neg"]
            if "matrix" in scored:
                batch["dyn_teacher_matrix"] = scored["matrix"]
            if "pos_per_term" in scored:
                batch["dyn_teacher_pos_per_term"] = scored["pos_per_term"]
                batch["dyn_teacher_neg_per_term"] = scored["neg_per_term"]
            yield batch
