"""The training step: counterpart of ``matchmaker_tpu/training/train_step.py``,
single process.

One step is the packed triple forward (``forward_triple``: one query pass,
one 2B-row document pass) where the model has one (BERT_DOT, ColBERT), else
two passes, one over the positive and one over the negative pairs
(``split_triple_batch``: concatenated cross-encoder triples, PreTTR, PARADE,
the chunk adapters, the kernel-pooling family, IDCM), the ranking loss (a
passage loss, ``MSETeacherPointwisePassages`` or
``MarginMSE_InterPassageLoss``, over the models' per-chunk
``passage_scores`` against the batch's teacher passage scores), IDCM's
``selection_loss`` (the mean of the two passes'), the optional term-level
distillation (the student's per-term MaxSim against a dynamic teacher's),
the optional in-batch negative loss over the B × 2B score matrix of the
queries against [d_pos; d_neg] (q·dᵀ for single vectors, the all-pairs
MaxSim for ColBERT's token vectors: K14's training form and its backward
kernel on a card), pairwise (positive = diagonal, hardest negative) or
listwise against the dynamic teacher's matrix (``[I | 0]`` without one),
TK-Sparse's sparsity loss (``minimize_sparsity_weight`` x the mean |gate|
of the two passes), backward (through the fused layers' backward kernels on
a card), the global gradient norm before clipping, and the optimizer
update, in the JAX loss's order. With ``submodel_train_cache_path`` the
passage scores are handed to the trainer's replay cache (``_cache_*``
stats). List batches raise ``NotImplementedError`` naming their ROADMAP.md
item (the top-level listwise and the QA losses already raise in
``get_loss``).
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.losses import LossBundle
from matchmaker_tpu_torch.ops.maxsim import maxsim_all_pairs
from matchmaker_tpu_torch.training.optim import Optimizer


def split_triple_batch(batch):
    """Triple batch → (positive pairs' batch, negative pairs' batch): the
    concatenated sequences of a cross-encoder's triples, or the query with
    each document."""
    if "pos_ids" in batch:  # concatenated input
        pos = {"seq_ids": batch["pos_ids"], "seq_mask": batch["pos_mask"], "seq_type_ids": batch["pos_type_ids"]}
        neg = {"seq_ids": batch["neg_ids"], "seq_mask": batch["neg_mask"], "seq_type_ids": batch["neg_type_ids"]}
    else:
        query = {"query_ids": batch["query_ids"], "query_mask": batch["query_mask"]}
        if "query_idfs" in batch:
            query["query_idfs"] = batch["query_idfs"]
        pos = {**query, "doc_ids": batch["doc_pos_ids"], "doc_mask": batch["doc_pos_mask"]}
        neg = {**query, "doc_ids": batch["doc_neg_ids"], "doc_mask": batch["doc_neg_mask"]}
        # IDCM's chunk scores replayed from the train cache
        if "bert_part_cached_pos" in batch:
            pos["bert_part_cached"] = batch["bert_part_cached_pos"]
            neg["bert_part_cached"] = batch["bert_part_cached_neg"]
    return pos, neg


def forward_triple(model, batch):
    """(pos_out, neg_out) of a triple batch: the model's packed
    ``forward_triple`` where it has one and the batch has separate
    documents, else two passes."""
    if hasattr(model, "forward_triple") and "doc_pos_ids" in batch:
        return model.forward_triple(batch)
    pos_batch, neg_batch = split_triple_batch(batch)
    return model(pos_batch), model(neg_batch)


def make_loss_fn(model, losses: LossBundle, config):
    """``loss_fn(batch) -> (loss, stats)`` with the JAX loss's triple branch
    (through the model's packed ``forward_triple``), passage-loss,
    selection-loss, term-level distillation, in-batch and sparsity
    branches, in the JAX loss's order."""
    sparsity_weight = config.get("minimize_sparsity_weight", 0.0)
    cache_passage_scores = bool(config.get("submodel_train_cache_path"))
    ib_main_weight = config.get("in_batch_main_weight", 1.0)
    ib_weight = config.get("in_batch_neg_weight", 1.0)
    per_term_weight = config.get("per_term_loss_weight", 0.5)

    def loss_fn(batch):
        if "list_doc_ids" in batch:
            raise NotImplementedError("list batches (listwise training, data/list_sampler.py) are not ported yet "
                                      "(ROADMAP.md, queue 1 item 6)")
        pos_out, neg_out = forward_triple(model, batch)
        pos_score, neg_score = pos_out["score"], neg_out["score"]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones_like(pos_score)
        t_pos = batch.get("pos_score", torch.zeros_like(pos_score))
        t_neg = batch.get("neg_score", torch.zeros_like(neg_score))
        if losses.is_passage_loss:
            if "passage_scores" not in pos_out:
                raise ValueError(f"the passage loss {config.get('loss')!r} needs a model with passage scores")
            pos_psg, neg_psg = pos_out["passage_scores"], neg_out["passage_scores"]
            loss = losses.ranking_loss(pos_psg, neg_psg, batch.get("pos_passage_scores", torch.zeros_like(pos_psg)),
                                       batch.get("neg_passage_scores", torch.zeros_like(neg_psg)), valid)
        else:
            loss = losses.ranking_loss(pos_score, neg_score, t_pos, t_neg, valid)
        stats = {"ranking_loss": loss}

        if "selection_loss" in pos_out:
            sel = (pos_out["selection_loss"] + neg_out["selection_loss"]) / 2.0
            stats["selection_loss"] = sel
            loss = loss + sel

        if cache_passage_scores and "passage_scores" in pos_out:
            # for the trainer's replay cache, which pops them before logging
            stats["_cache_pos_passage_scores"] = pos_out["passage_scores"]
            stats["_cache_neg_passage_scores"] = neg_out["passage_scores"]

        if "dyn_teacher_pos_per_term" in batch and "per_term_scores" in pos_out:
            # term-level distillation: the student's per-term MaxSim against
            # the teacher's (masked MSE)
            q_mask = batch["query_mask"] * valid[:, None]
            denom = torch.clamp(q_mask.sum(), min=1.0)
            pt_loss = (((pos_out["per_term_scores"] - batch["dyn_teacher_pos_per_term"]) ** 2 * q_mask).sum()
                       + ((neg_out["per_term_scores"] - batch["dyn_teacher_neg_per_term"]) ** 2 * q_mask).sum()
                       ) / (2.0 * denom)
            stats["per_term_loss"] = pt_loss
            loss = loss + per_term_weight * pt_loss

        if losses.inbatch_loss is not None and "query_vecs" in pos_out:
            q = pos_out["query_vecs"].float()
            d_all = torch.cat([pos_out["doc_vecs"], neg_out["doc_vecs"]], dim=0).float()
            if q.dim() == 3:  # ColBERT's token vectors: the all-pairs MaxSim
                d_mask_all = torch.cat([pos_out["doc_vecs_mask"], neg_out["doc_vecs_mask"]], dim=0)
                ib_scores = maxsim_all_pairs(q, d_all, pos_out["query_vecs_mask"], d_mask_all)
            else:
                # a plain product, as the JAX package leaves this einsum to XLA
                ib_scores = torch.matmul(q, d_all.t())
            b = q.shape[0]
            if losses.use_inbatch_list_loss:
                teacher = batch.get("dyn_teacher_matrix")
                if teacher is None:
                    teacher = torch.cat([torch.eye(b, device=q.device), torch.zeros(b, b, device=q.device)], dim=1)
                ib_loss = losses.inbatch_loss(ib_scores, teacher, valid[:, None] * torch.ones_like(ib_scores))
            else:
                # positive = diagonal; hardest negative over the off-diagonal
                # in-batch docs and the explicit negatives
                pos_diag = torch.diagonal(ib_scores[:, :b])
                eye = torch.eye(b, dtype=torch.bool, device=q.device)
                off_diag = ib_scores[:, :b].masked_fill(eye, float("-inf"))
                neg_max = torch.maximum(off_diag.amax(dim=1), ib_scores[:, b:].amax(dim=1))
                ib_loss = losses.inbatch_loss(pos_diag, neg_max, t_pos, t_neg, valid)
            stats["inbatch_loss"] = ib_loss
            loss = ib_main_weight * loss + ib_weight * ib_loss

        if sparsity_weight > 0.0 and "sparsity" in pos_out:
            sp = (pos_out["sparsity"].abs().mean() + neg_out["sparsity"].abs().mean()) / 2.0
            stats["sparsity_loss"] = sp
            loss = loss + sparsity_weight * sp

        stats["loss"] = loss
        stats["score_pos_mean"] = (pos_score * valid).sum() / torch.clamp(valid.sum(), min=1)
        stats["score_neg_mean"] = (neg_score * valid).sum() / torch.clamp(valid.sum(), min=1)
        return loss, stats

    return loss_fn


def make_train_step(model, losses: LossBundle, optimizer: Optimizer, config):
    """``step(batch) -> stats``: forward, backward, global norm of the
    gradients before clipping (``grad_norm``), update. Parameters and
    optimizer state change in place."""
    loss_fn = make_loss_fn(model, losses, config)

    def step(batch):
        optimizer.zero_grad()
        loss, stats = loss_fn(batch)
        loss.backward()
        stats = {k: v.detach() for k, v in stats.items()}
        stats["grad_norm"] = optimizer.global_norm()
        optimizer.step(stats["grad_norm"])
        return stats

    return step


def make_eval_step(model, output_secondary: bool = False):
    """``step(batch, output_secondary=...) -> outputs`` without autograd
    (re-ranking evaluation); ``output_secondary`` asks for the model's
    ``secondary`` tensors, by default as the step was made."""

    def step(batch, output_secondary: bool = output_secondary):
        with torch.inference_mode():
            return model(batch, output_secondary=output_secondary)

    return step
