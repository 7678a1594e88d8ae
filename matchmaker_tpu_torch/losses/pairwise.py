"""Pairwise (triple) ranking losses: counterpart of
``matchmaker_tpu/losses/pairwise.py``, formula for formula.

Uniform signature ``loss(pos, neg, t_pos, t_neg, valid) -> scalar``:
``t_pos``/``t_neg`` are teacher scores (ignored by teacher-free losses) and
``valid`` is a (B,) 0/1 mask so padded rows of the last batch do not count.
"""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _bce_with_logits(logits, targets, weight=None):
    per = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    return per * weight if weight is not None else per


def margin_mse(pos, neg, t_pos, t_neg, valid):
    """Margin-MSE: mean(((s+ - s-) - (t+ - t-))^2)."""
    return _masked_mean(((pos - neg) - (t_pos - t_neg)) ** 2, valid)


def margin_mse_interpassage(pos_psg, neg_psg, t_pos_psg, t_neg_psg, valid):
    """All-pairs margins across per-passage score matrices (B, P)."""
    p = pos_psg.shape[1]
    margins = pos_psg[:, :, None] - neg_psg[:, None, :]
    t_margins = t_pos_psg[:, :p, None] - t_neg_psg[:, None, :p]
    sq = (margins - t_margins) ** 2
    return _masked_mean(sq.reshape(sq.shape[0], -1).mean(dim=-1), valid)


def mse_teacher_pointwise(pos, neg, t_pos, t_neg, valid):
    """Pointwise MSE against teacher scores."""
    return 0.5 * (_masked_mean((pos - t_pos) ** 2, valid) + _masked_mean((neg - t_neg) ** 2, valid))


def mse_teacher_pointwise_passages(pos_psg, neg_psg, t_pos_psg, t_neg_psg, valid):
    """Per-passage pointwise MSE, masking zero teacher entries."""
    def one_side(scores, labels):
        labels = labels[:, : scores.shape[1]]
        mask = (labels != 0).to(scores.dtype) * valid[:, None]
        return ((scores - labels) ** 2 * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return 0.5 * (one_side(pos_psg, t_pos_psg) + one_side(neg_psg, t_neg_psg))


def kldiv_teacher_pointwise(pos, neg, t_pos, t_neg, valid):
    """Pointwise KLDiv vs teacher scores (target * (log(target) - input))."""
    def kl(inp, tgt):
        return _masked_mean(tgt * (torch.log(torch.clamp(tgt, min=1e-10)) - inp), valid)

    return 0.5 * (kl(pos, t_pos) + kl(neg, t_neg))


def ranknet(pos, neg, t_pos, t_neg, valid):
    """RankNet: BCE on the score difference with target 1."""
    x = pos - neg
    return _masked_mean(_bce_with_logits(x, torch.ones_like(x)), valid)


def ranknet_teacher(pos, neg, t_pos, t_neg, valid):
    """RankNet weighted by the teacher margin."""
    x = pos - neg
    return _masked_mean(_bce_with_logits(x, torch.ones_like(x), weight=t_pos - t_neg), valid)


def mse_ranknet_teacher(pos, neg, t_pos, t_neg, valid):
    """Pointwise MSE + RankNet hybrid."""
    return mse_teacher_pointwise(pos, neg, t_pos, t_neg, valid) + ranknet(pos, neg, t_pos, t_neg, valid)


def margin_ranking(pos, neg, t_pos, t_neg, valid, margin: float = 1.0):
    """Hinge on the margin (MarginRankingLoss(margin=1))."""
    return _masked_mean(torch.clamp(margin - (pos - neg), min=0.0), valid)
