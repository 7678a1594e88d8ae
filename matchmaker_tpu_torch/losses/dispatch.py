"""Loss config dispatch and the uncertainty-weighted multi-loss merge:
counterpart of ``matchmaker_tpu/losses/dispatch.py``, same config names.

The pairwise and passage losses score triples; the top-level listwise
losses (``loss: mrr | listnet | lambdarank``) score the list batches of
``dynamic_sampler: listwise`` (data/list_sampler.py; ``use_list_loss``); the
in-batch listwise losses (``KLDivTeacherList``, ``listnet``,
``lambdarank``) score the B x 2B in-batch matrix; ``train_qa_spans`` adds
the QA span and answerability loss (losses/qa.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from matchmaker_tpu_torch.losses import listwise, pairwise
from matchmaker_tpu_torch.losses.qa import qa_start_end_cross_entropy
from matchmaker_tpu_torch.losses.global_batch import LOCAL, GlobalBatch


@dataclass(frozen=True)
class LossBundle:
    ranking_loss: Callable
    qa_loss: Optional[Callable]
    inbatch_loss: Optional[Callable]
    use_list_loss: bool
    use_inbatch_list_loss: bool
    # loss consumes per-passage score matrices (IDCM/MaxP distillation)
    is_passage_loss: bool = False


_PAIRWISE = {
    "margin-mse": pairwise.margin_mse,
    "MSETeacherPointwise": pairwise.mse_teacher_pointwise,
    "MSETeacherPointwisePassages": pairwise.mse_teacher_pointwise_passages,
    "MarginMSE_InterPassageLoss": pairwise.margin_mse_interpassage,
    "KLDivTeacherPointwise": pairwise.kldiv_teacher_pointwise,
    "RankNetTeacher": pairwise.ranknet_teacher,
    "MSERanknetTeacher": pairwise.mse_ranknet_teacher,
    "ranknet": pairwise.ranknet,
    "margin": pairwise.margin_ranking,
}

_LISTWISE = {
    "mrr": listwise.smooth_mrr,
    "listnet": listwise.listnet,
    "lambdarank": lambda s, t, valid=None, gb=LOCAL: listwise.lambda_loss(s, t, valid, scheme="ndcgLoss2", gb=gb),
}

_INBATCH_PAIRWISE = {
    "ranknet": pairwise.ranknet,
    "margin-mse": pairwise.margin_mse,
}

_INBATCH_LISTWISE = {
    "KLDivTeacherList": listwise.kldiv_teacher_list,
    "listnet": listwise.listnet,
    "lambdarank": lambda s, t, valid=None, gb=LOCAL: listwise.lambda_loss_teacher(s, t, valid, scheme="ndcgLoss2",
                                                                                  gb=gb),
}


def get_loss(config) -> LossBundle:
    name = config["loss"]
    if name in _PAIRWISE:
        ranking = _PAIRWISE[name]
    elif name in _LISTWISE:
        ranking = _LISTWISE[name]
    else:
        raise ValueError(f"Loss not known: {name}")

    qa_loss = None
    if config.get("train_qa_spans", False):
        if config.get("qa_loss") != "StartEndCrossEntropy":
            raise ValueError("qa_loss must be StartEndCrossEntropy when train_qa_spans is set")
        qa_loss = qa_start_end_cross_entropy

    inbatch = None
    use_inbatch_list = False
    if config.get("in_batch_negatives", False):
        ib_name = config.get("in_batch_neg_loss")
        if ib_name in _INBATCH_PAIRWISE:
            inbatch = _INBATCH_PAIRWISE[ib_name]
        elif ib_name in _INBATCH_LISTWISE:
            inbatch = _INBATCH_LISTWISE[ib_name]
            use_inbatch_list = True
        else:
            raise ValueError(f"in_batch_neg_loss not known: {ib_name}")

    return LossBundle(
        ranking_loss=ranking,
        qa_loss=qa_loss,
        inbatch_loss=inbatch,
        use_list_loss=name in _LISTWISE,
        use_inbatch_list_loss=use_inbatch_list,
        is_passage_loss=name in ("MSETeacherPointwisePassages", "MarginMSE_InterPassageLoss"),
    )


def merge_loss(losses: List[torch.Tensor], log_vars: torch.Tensor,
               gb: GlobalBatch = LOCAL) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Uncertainty-weighted multi-task merge: sum(exp(-logvar_i) * loss_i + logvar_i)."""
    weighted = []
    total = 0.0
    for i, loss in enumerate(losses):
        # the log variance once over the global batch (each process adds its share)
        wl = torch.exp(-log_vars[i]) * loss + log_vars[i] * gb.share
        total = total + wl
        weighted.append(wl)
    return total, weighted
