"""Ranking losses of the port: counterpart of ``matchmaker_tpu/losses``
(the pairwise, listwise and QA losses and the dispatch)."""

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
from matchmaker_tpu_torch.losses.listwise import (
    kldiv_teacher_list,
    lambda_loss,
    lambda_loss_teacher,
    listnet,
    smooth_mrr,
    soft_cross_entropy,
)
from matchmaker_tpu_torch.losses.qa import qa_start_end_cross_entropy
from matchmaker_tpu_torch.losses.dispatch import LossBundle, get_loss, merge_loss
