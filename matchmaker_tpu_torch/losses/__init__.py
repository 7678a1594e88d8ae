"""Ranking losses of the port: counterpart of ``matchmaker_tpu/losses``
(the pairwise losses and the dispatch; listwise and QA losses are queued in
ROADMAP.md)."""

from matchmaker_tpu_torch.losses.pairwise import (
    kldiv_teacher_pointwise,
    margin_mse,
    margin_mse_interpassage,
    margin_ranking,
    mse_ranknet_teacher,
    mse_teacher_pointwise,
    mse_teacher_pointwise_passages,
    ranknet,
    ranknet_teacher,
)
from matchmaker_tpu_torch.losses.dispatch import LossBundle, get_loss, merge_loss
