"""Loss config dispatch and the uncertainty-weighted multi-loss merge:
counterpart of ``matchmaker_tpu/losses/dispatch.py``, same config names.

The top-level listwise losses (``loss: mrr | listnet | lambdarank``) train on
list batches, whose sampler and loss branch are not ported yet, and the QA
loss is not ported yet: their names raise ``NotImplementedError`` naming
their ROADMAP.md item instead of falling back. The in-batch listwise losses
(``KLDivTeacherList``, ``listnet``, ``lambdarank``) are ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from matchmaker_tpu_torch.losses import listwise, pairwise


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

_LISTWISE = ("mrr", "listnet", "lambdarank")

_INBATCH_PAIRWISE = {
    "ranknet": pairwise.ranknet,
    "margin-mse": pairwise.margin_mse,
}

_INBATCH_LISTWISE = {
    "KLDivTeacherList": listwise.kldiv_teacher_list,
    "listnet": listwise.listnet,
    "lambdarank": lambda s, t, valid=None: listwise.lambda_loss_teacher(s, t, valid, scheme="ndcgLoss2"),
}


def get_loss(config) -> LossBundle:
    name = config["loss"]
    if name in _LISTWISE:
        raise NotImplementedError(f"listwise loss {name!r}: its list batches (data/list_sampler.py) are not "
                                  "ported yet (ROADMAP.md, queue 1 item 6)")
    if name not in _PAIRWISE:
        raise ValueError(f"Loss not known: {name}")
    if config.get("train_qa_spans", False):
        raise NotImplementedError(f"the QA loss {config.get('qa_loss')!r} is not ported yet "
                                  "(ROADMAP.md, queue 1 item 6)")

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
        ranking_loss=_PAIRWISE[name],
        qa_loss=None,
        inbatch_loss=inbatch,
        use_list_loss=False,
        use_inbatch_list_loss=use_inbatch_list,
        is_passage_loss=name in ("MSETeacherPointwisePassages", "MarginMSE_InterPassageLoss"),
    )


def merge_loss(losses: List[torch.Tensor], log_vars: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Uncertainty-weighted multi-task merge: sum(exp(-logvar_i) * loss_i + logvar_i)."""
    weighted = []
    total = 0.0
    for i, loss in enumerate(losses):
        wl = torch.exp(-log_vars[i]) * loss + log_vars[i]
        total = total + wl
        weighted.append(wl)
    return total, weighted
