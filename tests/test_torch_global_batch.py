"""Each process's share of a loss over a padded global batch
(``losses/global_batch.py``), on the CPU without a process group.

The global batch's rows are split over P simulated processes, as the
loaders stride them; one process holds one valid row, or none. Each
process's loss is computed with a ``GlobalBatch`` that carries the global
batch's valid rows, the process count and, for the terms that count valid
elements, the global count (the sum of every process's own count: a first
pass records them, as the all-reduce would sum them). The shares must add
up to the JAX package's loss on the whole batch (one masked mean over the
global batch): rtol 1e-5, the losses' own bar against JAX
(tests/test_torch_listwise.py). Outside a process group the step takes
``LOCAL``, which leaves one process's losses as they were."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.losses import listwise as jlw
from matchmaker_tpu.losses import qa as jqa
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.losses import listwise as tlw
from matchmaker_tpu_torch.losses import qa as tqa
from matchmaker_tpu_torch.losses.global_batch import LOCAL, GlobalBatch
from matchmaker_tpu_torch.training.train_step import global_batch_of
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

B = 8
# (processes, valid rows of 8): process 1 holds one valid row; processes 2 and 3 none
SPLITS = [(2, 5), (4, 4)]


def _shares(loss, share_args, processes, valid):
    """Every process's share of ``loss`` (``share_args(i)``: process i's
    arguments), summed."""
    valid_rows = torch.tensor(float(valid.sum()))
    counts = []
    for i in range(processes):
        seen = []

        def record(n, seen=seen):
            seen.append(n)
            return n

        loss(*share_args(i), gb=GlobalBatch(valid_rows=valid_rows, processes=processes, count=record))
        counts.append(seen)
    totals = [sum(c) for c in zip(*counts)]
    total = 0.0
    for i in range(processes):
        summed = iter(totals)
        gb = GlobalBatch(valid_rows=valid_rows, processes=processes, count=lambda n, summed=summed: next(summed))
        total = total + loss(*share_args(i), gb=gb)
    return total


def _rows(arrays, i, processes):
    n = B // processes
    return [torch.from_numpy(a[i * n:(i + 1) * n]) for a in arrays]


def _valid(n_valid):
    return (np.arange(B) < n_valid).astype(np.float32)


def _pairwise_inputs(name, n_valid, rng):
    if name in ("MSETeacherPointwisePassages", "MarginMSE_InterPassageLoss"):
        pos, neg = rng.normal(size=(B, 3)), rng.normal(size=(B, 3))
        t_pos, t_neg = rng.normal(size=(B, 4)) * 2, rng.normal(size=(B, 4)) * 2
        t_pos[rng.random((B, 4)) < 0.3] = 0.0
        t_neg[rng.random((B, 4)) < 0.3] = 0.0
    else:
        pos, neg = rng.normal(size=B) * 3, rng.normal(size=B) * 3
        t_pos, t_neg = rng.uniform(0.1, 10, B), rng.uniform(0.1, 5, B)
    return [a.astype(np.float32) for a in (pos, neg, t_pos, t_neg)] + [_valid(n_valid)]


@pytest.mark.parametrize("processes,n_valid", SPLITS)
@pytest.mark.parametrize("name", sorted(tdispatch._PAIRWISE))
def test_pairwise_shares_add_up_to_jax_on_the_global_batch(name, processes, n_valid):
    args = _pairwise_inputs(name, n_valid, np.random.default_rng(len(name)))
    got = _shares(tdispatch._PAIRWISE[name], lambda i: _rows(args, i, processes), processes, args[-1])
    want = jdispatch._PAIRWISE[name](*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def _slates(n_valid, rng, n=6):
    pred = (rng.normal(size=(B, n)) * 3).astype(np.float32)
    labels = rng.integers(0, 4, size=(B, n)).astype(np.float32)
    labels[:, 0] = 3.0
    valid = _valid(n_valid)[:, None] * np.ones((B, n), np.float32)
    valid[0, 4:] = 0.0
    return [pred, labels, valid]


_LISTWISE = {
    **{f"list:{k}": (tdispatch._LISTWISE[k], jdispatch._LISTWISE[k]) for k in sorted(tdispatch._LISTWISE)},
    **{f"inbatch:{k}": (tdispatch._INBATCH_LISTWISE[k], jdispatch._INBATCH_LISTWISE[k])
       for k in sorted(tdispatch._INBATCH_LISTWISE)},
    "lambda_loss:mean": (lambda s, t, valid=None, gb=LOCAL: tlw.lambda_loss(s, t, valid, reduction="mean", gb=gb),
                         lambda s, t, valid=None: jlw.lambda_loss(s, t, valid, reduction="mean")),
    "soft_cross_entropy": (tlw.soft_cross_entropy, jlw.soft_cross_entropy),
}


@pytest.mark.parametrize("processes,n_valid", SPLITS)
@pytest.mark.parametrize("name", sorted(_LISTWISE))
def test_listwise_shares_add_up_to_jax_on_the_global_batch(name, processes, n_valid):
    args = _slates(n_valid, np.random.default_rng(len(name)))
    if name == "soft_cross_entropy":
        args[1] = np.asarray(torch.softmax(torch.from_numpy(args[1]), dim=-1))
    port, jax_loss = _LISTWISE[name]
    got = _shares(lambda *a, gb: port(*a, gb=gb), lambda i: _rows(args, i, processes), processes, args[2][:, 0])
    want = jax_loss(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("processes,n_valid", SPLITS)
def test_qa_shares_add_up_to_jax_on_the_global_batch(processes, n_valid):
    """Span labels of -1 (no span) left out of the count; the padded rows
    carry label -1, as a padded row has no span."""
    rng = np.random.default_rng(5)
    length, spans = 10, 2
    start, end = rng.normal(size=(B, length)).astype(np.float32), rng.normal(size=(B, length)).astype(np.float32)
    s_lab, e_lab = rng.integers(-1, length, size=(B, spans)), rng.integers(-1, length, size=(B, spans))
    s_lab[n_valid:], e_lab[n_valid:] = -1, -1
    ans, ans_lab = rng.normal(size=(B, 2)).astype(np.float32), rng.integers(0, 2, size=B)
    args = [start, end, s_lab, e_lab, ans, ans_lab]

    def both(*a, gb):
        span, answer = tqa.qa_start_end_cross_entropy(*a, gb=gb)
        return span + answer

    got = _shares(both, lambda i: _rows(args, i, processes), processes, _valid(n_valid))
    span, answer = jqa.qa_start_end_cross_entropy(*[jnp.asarray(a) for a in args])
    np.testing.assert_allclose(float(got), float(span + answer), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("processes", [2, 4])
def test_merge_loss_adds_the_log_variances_once(processes):
    """The uncertainty-weighted merge of the processes' shares of each loss:
    every log variance counted once over the global batch."""
    rng = np.random.default_rng(6)
    parts = rng.uniform(0.1, 3, size=(processes, 3)).astype(np.float32)
    log_vars = rng.normal(size=3).astype(np.float32)
    gb = GlobalBatch(processes=processes)
    got = sum(tdispatch.merge_loss(list(torch.from_numpy(p)), torch.from_numpy(log_vars), gb)[0] for p in parts)
    want, _ = jdispatch.merge_loss([jnp.asarray(p) for p in parts.sum(0)], jnp.asarray(log_vars))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_one_process_takes_local_counts():
    """Outside a process group the step's losses divide by the process's
    own counts: ``LOCAL``, whose mean is ``torch.mean`` bit for bit."""
    batch = {"query_ids": torch.zeros(4, 3, dtype=torch.long), "valid": torch.tensor([1.0, 1.0, 0.0, 0.0])}
    assert global_batch_of(batch) is LOCAL
    t = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 5)).astype(np.float32))
    assert torch.equal(LOCAL.mean(t), t.mean())
    assert LOCAL.rows(4) == 4 and LOCAL.share == 1.0
    assert torch.equal(LOCAL.valid_count(batch["valid"]), torch.tensor(2.0))
