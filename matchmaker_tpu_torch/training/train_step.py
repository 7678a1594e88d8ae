"""The training step: counterpart of ``matchmaker_tpu/training/train_step.py``,
single process.

One step is the packed triple forward (``forward_triple``: one query pass,
one 2B-row document pass), the ranking loss, the optional term-level
distillation (the student's per-term MaxSim against a dynamic teacher's),
the optional in-batch negative loss over the B × 2B score matrix of the
queries against [d_pos; d_neg] (q·dᵀ for single vectors, the all-pairs
MaxSim for ColBERT's token vectors: K14's training form and its backward
kernel on a card), pairwise (positive = diagonal, hardest negative) or
listwise against the dynamic teacher's matrix (``[I | 0]`` without one),
backward (through the fused layers' backward kernels on a card), the global
gradient norm before clipping, and the optimizer update. The branches of
the JAX loss that the port does not run yet raise ``NotImplementedError``
naming their ROADMAP.md item: list batches, cross-encoder triples, passage
losses, sparsity (the top-level listwise and the QA losses already raise in
``get_loss``).
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.losses import LossBundle
from matchmaker_tpu_torch.ops.maxsim import maxsim_all_pairs
from matchmaker_tpu_torch.training.optim import Optimizer


def make_loss_fn(model, losses: LossBundle, config):
    """``loss_fn(batch) -> (loss, stats)`` with the JAX loss's triple branch
    (through the model's packed ``forward_triple``), term-level distillation
    and in-batch branches."""
    if config.get("minimize_sparsity_weight", 0.0) > 0.0:
        raise NotImplementedError("the sparsity loss is not ported yet (ROADMAP.md, queue 1 item 10)")
    ib_main_weight = config.get("in_batch_main_weight", 1.0)
    ib_weight = config.get("in_batch_neg_weight", 1.0)
    per_term_weight = config.get("per_term_loss_weight", 0.5)

    def loss_fn(batch):
        if "list_doc_ids" in batch:
            raise NotImplementedError("list batches (listwise training, data/list_sampler.py) are not ported yet "
                                      "(ROADMAP.md, queue 1 item 6)")
        if "pos_ids" in batch:
            raise NotImplementedError("concatenated (cross-encoder) triples are not ported yet "
                                      "(ROADMAP.md, queue 1 item 10)")
        if losses.is_passage_loss:
            raise NotImplementedError("passage losses are not ported yet (ROADMAP.md, queue 1 item 7)")
        pos_out, neg_out = model.forward_triple(batch)
        pos_score, neg_score = pos_out["score"], neg_out["score"]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones_like(pos_score)
        t_pos = batch.get("pos_score", torch.zeros_like(pos_score))
        t_neg = batch.get("neg_score", torch.zeros_like(neg_score))
        loss = losses.ranking_loss(pos_score, neg_score, t_pos, t_neg, valid)
        stats = {"ranking_loss": loss}

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


def make_eval_step(model):
    """``step(batch) -> outputs`` without autograd (re-ranking evaluation)."""

    def step(batch):
        with torch.inference_mode():
            return model(batch)

    return step
