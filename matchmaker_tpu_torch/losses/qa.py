"""Extractive-QA span and answerability losses: counterpart of
``matchmaker_tpu/losses/qa.py``.

Cross entropy of the start / end span logits, averaged over up to S gold
spans a sample (a label of -1 marks no span and is left out; a batch with
no valid label divides by 1), and a separate answerability cross entropy.
The end logits are shared across the span slots when they are 2-D.
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.losses.global_batch import LOCAL, GlobalBatch


def _ce_ignore_index(logits: torch.Tensor, labels: torch.Tensor, gb: GlobalBatch, ignore: int = -1) -> torch.Tensor:
    """Mean cross entropy over the samples whose label is not ``ignore``."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    picked = torch.gather(logp, -1, torch.clamp(labels, min=0)[:, None]).squeeze(-1)
    mask = (labels != ignore).to(logits.dtype)
    return -(picked * mask).sum() / torch.clamp(gb.count(mask.sum()), min=1.0)


def qa_start_end_cross_entropy(start_logits, end_logits, start_labels, end_labels, answerability_logits=None,
                               answerability_labels=None, gb=LOCAL):
    """start (B, L), end (B, L) or (B, S, L) logits, (B, S) labels, optional
    answerability logits (B, C) and labels (B,) → (span_loss,
    answerability_loss); either is None where its inputs are."""
    span_loss = None
    if start_logits is not None:
        starts, ends = [], []
        for s in range(start_labels.shape[1]):
            starts.append(_ce_ignore_index(start_logits, start_labels[:, s], gb))
            end_s = end_logits[:, s] if end_logits.dim() == 3 else end_logits
            ends.append(_ce_ignore_index(end_s, end_labels[:, s], gb))
        span_loss = (torch.stack(starts).mean() + torch.stack(ends).mean()) / 2.0
    answer_loss = None
    if answerability_logits is not None:
        answer_loss = _ce_ignore_index(answerability_logits, answerability_labels, gb)
    return span_loss, answer_loss
