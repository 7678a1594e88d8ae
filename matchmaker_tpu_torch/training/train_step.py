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
stats). With ``train_qa_spans`` the QA heads' span and answerability
losses on the positive pass (the negative pass's answerability against
label 0, weighted 0.1), merged with the ranking loss by the uncertainty
weighting over the model's ``mtl_log_vars`` (slots [0] ranking, [1] span,
[2] answerability; ``losses.merge_loss``), else added as
``qa_loss_lambda`` x (span + answerability). A list batch
(``dynamic_sampler: listwise``, data/list_sampler.py) scores all Q·L
(query, document) pairs in one forward, the query repeated L times as in
the JAX step, under a top-level listwise loss (``mrr``, ``listnet``,
``lambdarank``): the positive sits in slot 0.

Under a process group (parallel/multihost.py) each process steps on its own
rows of the global batch: the in-batch negatives see the global batch, as
JAX's jitted step does (every process's document vectors gathered in rank
order by an all-gather that carries gradients back to their process, each
query's positive at its global column). Every loss term is JAX's one mean
over the global batch: the step all-reduces the global batch's count of
valid rows once before the forward and hands the losses a
``losses.global_batch.GlobalBatch``, and a process divides its own sums by
the global batch's counts of valid rows or elements, so the processes'
terms are shares that add up to the global mean, whatever each holds of the
padded last batch (none at all included). Every gradient is summed over the
processes before the norm and the clipping, and the stats that are shares
of a mean (``SHARES_OF_A_MEAN``) ride in the same all-reduce. One step of N
processes on their shares of a batch, padded or not, then leaves the
parameters of one step on the whole batch (tests/test_torch_multiprocess.py).
``make_eval_step`` scores a slice of each batch a process and gathers the
scores, so every process holds all of them.
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.losses import LossBundle, merge_loss
from matchmaker_tpu_torch.losses.global_batch import LOCAL, GlobalBatch
from matchmaker_tpu_torch.ops.maxsim import maxsim_all_pairs
from matchmaker_tpu_torch.parallel.multihost import (all_gather, all_reduce_sum, gather_rows, is_distributed,
                                                     process_count, process_index, process_shard_bounds,
                                                     sum_gradients)
from matchmaker_tpu_torch.training.optim import Optimizer


def split_triple_batch(batch, gb: GlobalBatch = LOCAL):
    """Triple batch → (positive pairs' batch, negative pairs' batch): the
    concatenated sequences of a cross-encoder's triples, or the query with
    each document; each carries ``gb`` as ``global_batch`` under a process
    group (IDCM's selection loss reads it)."""
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
    if gb is not LOCAL:
        pos["global_batch"] = neg["global_batch"] = gb
    return pos, neg


def forward_triple(model, batch, gb: GlobalBatch = LOCAL):
    """(pos_out, neg_out) of a triple batch: the model's packed
    ``forward_triple`` where it has one and the batch has separate
    documents, else two passes."""
    if hasattr(model, "forward_triple") and "doc_pos_ids" in batch:
        return model.forward_triple(batch)
    pos_batch, neg_batch = split_triple_batch(batch, gb)
    return model(pos_batch), model(neg_batch)


def list_scores(model, batch):
    """(Q, L) scores of a list batch (query (Q, Lq), documents (Q, L, Ld)):
    every (query, document) pair in one forward, the query repeated L
    times."""
    d_ids, d_mask = batch["list_doc_ids"], batch["list_doc_mask"]
    qn, l, ld = d_ids.shape
    flat = {"query_ids": torch.repeat_interleave(batch["query_ids"], l, dim=0),
            "query_mask": torch.repeat_interleave(batch["query_mask"], l, dim=0),
            "doc_ids": d_ids.reshape(qn * l, ld), "doc_mask": d_mask.reshape(qn * l, ld)}
    return model(flat)["score"].reshape(qn, l)


def list_loss_fn(model, losses: LossBundle, batch, gb: GlobalBatch = LOCAL):
    """A list batch (``list_scores``, labels (Q, L)): the listwise loss over
    its (Q, L) scores."""
    if not losses.use_list_loss:
        raise ValueError("list batches require a listwise loss (ListNet/LambdaLoss/...)")
    scores = list_scores(model, batch)
    qn = scores.shape[0]
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones(qn, device=scores.device)
    loss = losses.ranking_loss(scores, batch["list_labels"], valid[:, None] * torch.ones_like(scores), gb=gb)
    n = torch.clamp(gb.valid_count(valid), min=1)
    return loss, {"ranking_loss": loss, "loss": loss, "score_pos_mean": (scores[:, 0] * valid).sum() / n,
                  "score_neg_mean": (scores[:, 1:].mean(dim=1) * valid).sum() / n}


def qa_loss_terms(model, losses: LossBundle, batch, pos_out, neg_out, loss, qa_weight, gb: GlobalBatch = LOCAL):
    """The QA multi-task terms added to the ranking ``loss`` → (loss, stats)."""
    stats = {}
    span_loss, answer_loss = losses.qa_loss(pos_out["qa_logits_start"], pos_out["qa_logits_end"], batch["qa_start"],
                                            batch["qa_end"], pos_out.get("answerability_logits"),
                                            batch.get("qa_has_answer"), gb=gb)
    if span_loss is not None:
        stats["qa_span_loss"] = span_loss
    if answer_loss is not None:
        stats["qa_answerability_loss"] = answer_loss
        if neg_out.get("answerability_logits") is not None:
            # a negative document is unanswerable (label 0), weighted 0.1
            neg_logits = neg_out["answerability_logits"]
            _, answer_loss_neg = losses.qa_loss(None, None, None, None, neg_logits,
                                                torch.zeros(neg_logits.shape[0], dtype=torch.long,
                                                            device=neg_logits.device), gb=gb)
            stats["qa_answerability_loss_neg"] = answer_loss_neg
            answer_loss = answer_loss + 0.1 * answer_loss_neg
    log_vars_all = getattr(model, "mtl_log_vars", None)
    if log_vars_all is not None:
        # fixed slots: a missing span loss must not move answerability onto the span slot
        parts, slots = [loss], [0]
        if span_loss is not None:
            parts.append(span_loss)
            slots.append(1)
        if answer_loss is not None:
            parts.append(answer_loss)
            slots.append(2)
        log_vars = log_vars_all[slots]
        loss, weighted = merge_loss(parts, log_vars, gb)
        stats["qa_weighted_ranking_loss"] = weighted[0]
        if span_loss is not None:
            stats["qa_weighted_qa_loss"] = weighted[1]
        stats["mtl_log_var_ranking"] = log_vars[0]
    else:
        qa_total = 0.0
        if span_loss is not None:
            qa_total = qa_total + span_loss
        if answer_loss is not None:
            qa_total = qa_total + answer_loss
        loss = loss + qa_weight * qa_total
    return loss, stats


def make_loss_fn(model, losses: LossBundle, config):
    """``loss_fn(batch) -> (loss, stats)`` with the JAX loss's list branch,
    triple branch (through the model's packed ``forward_triple``),
    passage-loss, selection-loss, term-level distillation, QA, in-batch and
    sparsity branches, in the JAX loss's order."""
    sparsity_weight = config.get("minimize_sparsity_weight", 0.0)
    cache_passage_scores = bool(config.get("submodel_train_cache_path"))
    ib_main_weight = config.get("in_batch_main_weight", 1.0)
    ib_weight = config.get("in_batch_neg_weight", 1.0)
    per_term_weight = config.get("per_term_loss_weight", 0.5)
    qa_weight = config.get("qa_loss_lambda", 0.2)

    def loss_fn(batch, gb: GlobalBatch = LOCAL):
        if "list_doc_ids" in batch:
            return list_loss_fn(model, losses, batch, gb)
        pos_out, neg_out = forward_triple(model, batch, gb)
        pos_score, neg_score = pos_out["score"], neg_out["score"]
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones_like(pos_score)
        t_pos = batch.get("pos_score", torch.zeros_like(pos_score))
        t_neg = batch.get("neg_score", torch.zeros_like(neg_score))
        if losses.use_list_loss:
            scores = torch.stack([pos_score, neg_score], dim=1)
            labels = torch.stack([torch.ones_like(pos_score), torch.zeros_like(neg_score)], dim=1)
            loss = losses.ranking_loss(scores, labels, valid[:, None] * torch.ones_like(scores), gb=gb)
        elif losses.is_passage_loss:
            if "passage_scores" not in pos_out:
                raise ValueError(f"the passage loss {config.get('loss')!r} needs a model with passage scores")
            pos_psg, neg_psg = pos_out["passage_scores"], neg_out["passage_scores"]
            loss = losses.ranking_loss(pos_psg, neg_psg, batch.get("pos_passage_scores", torch.zeros_like(pos_psg)),
                                       batch.get("neg_passage_scores", torch.zeros_like(neg_psg)), valid, gb=gb)
        else:
            loss = losses.ranking_loss(pos_score, neg_score, t_pos, t_neg, valid, gb=gb)
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
            denom = torch.clamp(gb.count(q_mask.sum()), min=1.0)
            pt_loss = (((pos_out["per_term_scores"] - batch["dyn_teacher_pos_per_term"]) ** 2 * q_mask).sum()
                       + ((neg_out["per_term_scores"] - batch["dyn_teacher_neg_per_term"]) ** 2 * q_mask).sum()
                       ) / (2.0 * denom)
            stats["per_term_loss"] = pt_loss
            loss = loss + per_term_weight * pt_loss

        if losses.qa_loss is not None and "qa_logits_start" in pos_out:
            loss, qa_stats = qa_loss_terms(model, losses, batch, pos_out, neg_out, loss, qa_weight, gb)
            stats.update(qa_stats)

        if losses.inbatch_loss is not None and "query_vecs" in pos_out:
            q = pos_out["query_vecs"].float()
            # every process's documents (rank order): the global batch's in-batch negatives
            d_all = torch.cat([gather_rows(pos_out["doc_vecs"].float()), gather_rows(neg_out["doc_vecs"].float())],
                              dim=0)
            if q.dim() == 3:  # ColBERT's token vectors: the all-pairs MaxSim
                d_mask_all = torch.cat([gather_rows(pos_out["doc_vecs_mask"]), gather_rows(neg_out["doc_vecs_mask"])],
                                       dim=0)
                ib_scores = maxsim_all_pairs(q, d_all, pos_out["query_vecs_mask"], d_mask_all)
            else:
                # a plain product, as the JAX package leaves this einsum to XLA
                ib_scores = torch.matmul(q, d_all.t())
            b, g = q.shape[0], d_all.shape[0] // 2
            # each query's positive: its own row of the global batch
            own = torch.zeros((b, g), dtype=torch.bool, device=q.device)
            own[:, process_index() * b:(process_index() + 1) * b] = torch.eye(b, dtype=torch.bool, device=q.device)
            if losses.use_inbatch_list_loss:
                teacher = batch.get("dyn_teacher_matrix")
                if teacher is None:
                    teacher = torch.cat([own.float(), torch.zeros(b, g, device=q.device)], dim=1)
                ib_loss = losses.inbatch_loss(ib_scores, teacher, valid[:, None] * torch.ones_like(ib_scores), gb=gb)
            else:
                # positive = own column; hardest negative over the other
                # in-batch docs and the explicit negatives
                pos_diag = ib_scores[:, :g][own]
                off_diag = ib_scores[:, :g].masked_fill(own, float("-inf"))
                neg_max = torch.maximum(off_diag.amax(dim=1), ib_scores[:, g:].amax(dim=1))
                ib_loss = losses.inbatch_loss(pos_diag, neg_max, t_pos, t_neg, valid, gb=gb)
            stats["inbatch_loss"] = ib_loss
            loss = ib_main_weight * loss + ib_weight * ib_loss

        if sparsity_weight > 0.0 and "sparsity" in pos_out:
            sp = (gb.mean(pos_out["sparsity"].abs()) + gb.mean(neg_out["sparsity"].abs())) / 2.0
            stats["sparsity_loss"] = sp
            loss = loss + sparsity_weight * sp

        stats["loss"] = loss
        n_valid = torch.clamp(gb.valid_count(valid), min=1)
        stats["score_pos_mean"] = (pos_score * valid).sum() / n_valid
        stats["score_neg_mean"] = (neg_score * valid).sum() / n_valid
        return loss, stats

    return loss_fn


# the loss stats that are a process's share of a mean over the global batch:
# the multi-process step sums them over the processes (a stat not named here,
# such as ``mtl_log_var_ranking``, a parameter's value, stays the process's own)
SHARES_OF_A_MEAN = ("loss", "ranking_loss", "selection_loss", "per_term_loss", "qa_span_loss",
                    "qa_answerability_loss", "qa_answerability_loss_neg", "qa_weighted_ranking_loss",
                    "qa_weighted_qa_loss", "inbatch_loss", "sparsity_loss", "score_pos_mean", "score_neg_mean")


def global_batch_of(batch) -> GlobalBatch:
    """``LOCAL`` for one process; under a process group the counts that
    make each process's loss terms its shares of JAX's means over the
    global batch: its valid rows (one all-reduce, before the forward), the
    process count, and an all-reduce for the terms that count valid
    elements (passage labels, query tokens, QA labels, LambdaLoss pairs)."""
    if not is_distributed():
        return LOCAL
    valid = batch.get("valid")
    if valid is None:
        rows = next(v for v in batch.values() if isinstance(v, torch.Tensor)).shape[0]
        valid_rows = torch.tensor(float(rows * process_count()))
    else:
        valid_rows = all_reduce_sum(valid.sum())
    return GlobalBatch(valid_rows=valid_rows, processes=process_count(), count=all_reduce_sum)


def make_train_step(model, losses: LossBundle, optimizer: Optimizer, config):
    """``step(batch) -> stats``: forward, backward, global norm of the
    gradients before clipping (``grad_norm``), update. Parameters and
    optimizer state change in place."""
    loss_fn = make_loss_fn(model, losses, config)

    def step(batch):
        optimizer.zero_grad()
        loss, stats = loss_fn(batch, global_batch_of(batch))
        loss.backward()
        stats = {k: v.detach() for k, v in stats.items()}
        if is_distributed():
            # each process's shares of the global means: the gradients and
            # the stats that are shares summed in one all-reduce
            shares = [k for k in SHARES_OF_A_MEAN if k in stats]
            total = sum_gradients(optimizer.params, torch.stack([stats[k].float() for k in shares]))
            stats.update(zip(shares, total))
        stats["grad_norm"] = optimizer.global_norm()
        optimizer.step(stats["grad_norm"])
        return stats

    return step


# the batch-major outputs of a model (an eval step gathers them over the processes)
_BATCH_MAJOR = ("score", "passage_scores", "qa_logits_start", "qa_logits_end", "answerability_logits")


def _gathered(t: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat(all_gather(t.contiguous()), dim=0)[:rows]


def make_eval_step(model, output_secondary: bool = False):
    """``step(batch, output_secondary=...) -> outputs`` without autograd
    (re-ranking evaluation); ``output_secondary`` asks for the model's
    ``secondary`` tensors, by default as the step was made.

    Under a process group every process calls the step with the same
    batch: its rows are zero-padded to a multiple of the process count,
    each process scores its contiguous slice (``process_shard_bounds``),
    and the batch-major outputs are all-gathered and cut back to the
    batch's rows, so every process returns the whole batch's outputs (JAX's
    multi-process eval step)."""

    def step(batch, output_secondary: bool = output_secondary):
        with torch.inference_mode():
            if not is_distributed():
                return model(batch, output_secondary=output_secondary)
            rows = next(v for v in batch.values() if isinstance(v, torch.Tensor)).shape[0]
            padded = -(-rows // process_count()) * process_count()
            lo, hi = process_shard_bounds(padded)
            local = {}
            for key, v in batch.items():
                if isinstance(v, torch.Tensor):
                    if padded != rows:
                        v = torch.cat([v, v.new_zeros((padded - rows,) + tuple(v.shape[1:]))])
                    v = v[lo:hi]
                local[key] = v
            out = dict(model(local, output_secondary=output_secondary))
            for key in _BATCH_MAJOR:
                if isinstance(out.get(key), torch.Tensor):
                    out[key] = _gathered(out[key], rows)
            if isinstance(out.get("secondary"), dict):
                out["secondary"] = {k: _gathered(v, rows) if isinstance(v, torch.Tensor) and v.dim()
                                    and v.shape[0] == hi - lo else v for k, v in out["secondary"].items()}
            return out

    return step
