"""Listwise losses over (B, N) slates of scores: counterpart of
``matchmaker_tpu/losses/listwise.py``, the same formulas in plain torch.

Every function takes (B, N) score and label matrices and an optional (B, N)
``valid`` mask for padded slate entries.
"""

from __future__ import annotations

from typing import Optional

import torch

from matchmaker_tpu_torch.losses.global_batch import LOCAL

_EPS = 1e-6
_NEG_BIG = -1e9


def _masked_softmax(x, valid, dim=-1):
    if valid is not None:
        x = torch.where(valid > 0, x, torch.full_like(x, _NEG_BIG))
    return torch.softmax(x, dim=dim)


def listnet(y_pred, y_true, valid=None, gb=LOCAL):
    """Cross entropy between the scores' softmax and the labels' softmax."""
    p = _masked_softmax(y_pred, valid) + _EPS
    t = _masked_softmax(y_true, valid)
    return gb.mean(-torch.sum(t * torch.log(p), dim=1))


def kldiv_teacher_list(y_pred, y_true, valid=None, gb=LOCAL):
    """torch KLDivLoss(batchmean)(softmax(scores), softmax(labels)): the
    reference feeds probabilities (not log-probabilities) as the input, so
    this is target * (log(target) - input)."""
    p = _masked_softmax(y_pred, valid)
    t = _masked_softmax(y_true, valid)
    per = t * (torch.log(torch.clamp(t, min=1e-10)) - p)
    return per.sum() / gb.rows(y_pred.shape[0])


def smooth_rank(scores):
    """Differentiable ranks by pairwise sigmoids."""
    diff = scores[..., None, :] - scores[..., :, None]
    return torch.sigmoid(diff).sum(dim=-1) + 0.5


def smooth_mrr(scores, labels, valid=None, gb=LOCAL):
    """1 - max(label / soft rank)."""
    ranks = smooth_rank(scores)
    binary = (labels > 0).to(scores.dtype)
    if valid is not None:
        binary = binary * valid
    rr = binary / ranks
    return gb.mean(1.0 - rr.amax(dim=-1))


def soft_cross_entropy(logits, target, valid=None, gb=LOCAL):
    """Cross entropy with a soft target distribution."""
    logits = logits.reshape(logits.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    if valid is not None:
        logits = torch.where(valid.reshape(valid.shape[0], -1) > 0, logits, torch.full_like(logits, _NEG_BIG))
    logp = torch.log_softmax(logits, dim=1)
    return gb.mean(-torch.sum(target * logp, dim=1))


def _lambda_weights(scheme: str, G, D, mu, true_sorted):
    n = G.shape[1]
    if scheme == "ndcgLoss1":
        return (G / D)[:, :, None]
    if scheme == "ndcgLoss2":
        pos = torch.arange(1, n + 1, device=G.device)
        delta_idx = (pos[:, None] - pos[None, :]).abs()
        # |1/D_{|i-j|}| - |1/D_{|i-j|+1}| with the diagonal zeroed; index
        # -1 wraps to the last entry, as jnp's indexing does
        d_row = D[0]
        deltas = (1.0 / d_row[(delta_idx - 1) % n].abs() - 1.0 / d_row[delta_idx % n].abs()).abs()
        deltas = deltas * (1.0 - torch.eye(n, dtype=G.dtype, device=G.device))
        return deltas[None, :, :] * (G[:, :, None] - G[:, None, :]).abs()
    if scheme == "lambdaRank":
        return (1.0 / D[:, :, None] - 1.0 / D[:, None, :]).abs() * (G[:, :, None] - G[:, None, :]).abs()
    if scheme == "ndcgLoss2PP":
        return mu * _lambda_weights("ndcgLoss2", G, D, mu, true_sorted) + _lambda_weights(
            "lambdaRank", G, D, mu, true_sorted)
    if scheme == "rankNet":
        return torch.ones((1, 1, 1), dtype=G.dtype, device=G.device)
    raise ValueError(f"unknown LambdaLoss scheme '{scheme}'")


def lambda_loss(y_pred, y_true, valid=None, scheme: str = "ndcgLoss2", k: Optional[int] = None,
                sigma: float = 1.0, mu: float = 10.0, eps: float = _EPS, reduction: str = "sum", gb=LOCAL):
    """The LambdaLoss framework with a static slate length, padding by the
    ``valid`` mask."""
    b, n = y_pred.shape
    if valid is None:
        valid = torch.ones_like(y_pred)
    neg_big = torch.full_like(y_pred, _NEG_BIG)
    y_pred_m = torch.where(valid > 0, y_pred, neg_big)
    y_true_m = torch.where(valid > 0, y_true, neg_big)

    # a stable descending order, as jnp.argsort(-x) gives
    order = torch.argsort(-y_pred_m, dim=1, stable=True)
    y_pred_sorted = torch.gather(y_pred_m, 1, order)
    true_sorted_by_preds = torch.gather(y_true_m, 1, order)
    valid_sorted = torch.gather(valid, 1, order)
    y_true_sorted = -torch.sort(-y_true_m, dim=1).values

    true_diffs = true_sorted_by_preds[:, :, None] - true_sorted_by_preds[:, None, :]
    pair_mask = (valid_sorted[:, :, None] * valid_sorted[:, None, :]) > 0
    if scheme != "ndcgLoss1":
        pair_mask = pair_mask & (true_diffs > 0)

    k_eff = k if k is not None else n
    at_k = torch.zeros((n, n), dtype=torch.bool, device=y_pred.device)
    at_k[:k_eff, :k_eff] = True

    zero = torch.zeros((), dtype=y_pred.dtype, device=y_pred.device)
    tsp = torch.clamp(torch.where(valid_sorted > 0, true_sorted_by_preds, zero), min=0.0)
    yts = torch.clamp(torch.where(y_true_sorted > _NEG_BIG / 2, y_true_sorted, zero), min=0.0)

    pos_idx = torch.arange(1, n + 1, dtype=y_pred.dtype, device=y_pred.device)
    D = torch.log2(1.0 + pos_idx)[None, :]
    max_dcg = torch.clamp(((2.0 ** yts - 1.0) / D)[:, :k_eff].sum(dim=-1), min=eps)
    G = (2.0 ** tsp - 1.0) / max_dcg[:, None]

    weights = _lambda_weights(scheme, G, D, mu, true_sorted_by_preds)

    score_diffs = torch.clamp(y_pred_sorted[:, :, None] - y_pred_sorted[:, None, :], -1e4, 1e4)
    weighted_probs = torch.clamp(torch.clamp(torch.sigmoid(sigma * score_diffs), min=eps) ** weights, min=eps)
    losses = torch.log2(weighted_probs)
    masked = losses * pair_mask * at_k[None, :, :]
    if reduction == "sum":
        return -masked.sum()
    return -masked.sum() / torch.clamp(gb.count((pair_mask * at_k[None]).sum()), min=1.0)


def lambda_loss_teacher(y_pred, teacher_scores, valid=None, scheme: str = "ndcgLoss2", **kw):
    """LambdaLossTeacher: teacher scores → softmax, entries > 0.001 raised
    by 2, then LambdaLoss on the result (no gradient through the teacher)."""
    t = _masked_softmax(teacher_scores, valid)
    t = torch.where(t > 0.001, t + 2.0, t)
    return lambda_loss(y_pred, t.detach(), valid=valid, scheme=scheme, **kw)
