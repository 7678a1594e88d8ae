"""The port's listwise losses against the JAX package's on the CPU: each
loss's value and its gradient with respect to the student's scores, from the
same seeded numpy slates with padded entries, and the dispatch of the
in-batch listwise names. JAX's own tolerance for these losses: rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.losses import listwise as jlw
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.losses import listwise as tlw


def _slate(seed, b=5, n=7, graded=False):
    rng = np.random.default_rng(seed)
    pred = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    if graded:
        labels = rng.integers(0, 4, size=(b, n)).astype(np.float32)
        labels[:, 0] = 3.0
    else:
        labels = (rng.normal(size=(b, n)) * 2).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    valid[1, 5:] = 0.0
    valid[3, 2] = 0.0
    return pred, labels, valid


_CASES = {
    "listnet": (jlw.listnet, tlw.listnet, False),
    "kldiv_teacher_list": (jlw.kldiv_teacher_list, tlw.kldiv_teacher_list, False),
    "smooth_mrr": (jlw.smooth_mrr, tlw.smooth_mrr, True),
    "soft_cross_entropy": (jlw.soft_cross_entropy, tlw.soft_cross_entropy, False),
    "lambda_loss_teacher": (jlw.lambda_loss_teacher, tlw.lambda_loss_teacher, False),
}
for _scheme in ("ndcgLoss1", "ndcgLoss2", "lambdaRank", "ndcgLoss2PP", "rankNet"):
    _CASES[f"lambda_loss-{_scheme}"] = (
        lambda p, t, v, s=_scheme: jlw.lambda_loss(p, t, v, scheme=s),
        lambda p, t, v, s=_scheme: tlw.lambda_loss(p, t, v, scheme=s), True)
_CASES["lambda_loss-mean-k3"] = (lambda p, t, v: jlw.lambda_loss(p, t, v, k=3, reduction="mean"),
                                 lambda p, t, v: tlw.lambda_loss(p, t, v, k=3, reduction="mean"), True)


def _soft_target(labels, valid):
    t = np.exp(labels) * valid
    return (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_listwise_loss_and_gradient_match_jax(name, masked):
    jfn, tfn, graded = _CASES[name]
    pred, labels, valid = _slate(len(name) + masked, graded=graded)
    if name == "soft_cross_entropy":
        labels = _soft_target(labels, valid)
    v = valid if masked else None
    want, want_g = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(labels), None if v is None else jnp.asarray(v)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tfn(p, torch.from_numpy(labels), None if v is None else torch.from_numpy(v))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ib", ["KLDivTeacherList", "listnet", "lambdarank"])
def test_inbatch_listwise_dispatch_matches_jax(ib):
    """The in-batch listwise names build the bundle JAX builds, and the
    bundle's loss gives JAX's value on a B x 2B matrix against a teacher
    matrix."""
    config = {"loss": "margin-mse", "in_batch_negatives": True, "in_batch_neg_loss": ib}
    jb, tb = jdispatch.get_loss(config), tdispatch.get_loss(config)
    assert (tb.use_list_loss, tb.use_inbatch_list_loss) == (jb.use_list_loss, jb.use_inbatch_list_loss) == \
        (False, True)
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(4, 8)).astype(np.float32) * 2
    teacher = rng.normal(size=(4, 8)).astype(np.float32) * 4
    valid = np.ones((4, 8), np.float32)
    valid[2] = 0.0
    want = float(jb.inbatch_loss(jnp.asarray(scores), jnp.asarray(teacher), jnp.asarray(valid)))
    got = float(tb.inbatch_loss(*map(torch.from_numpy, (scores, teacher, valid))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_smooth_rank_matches_jax():
    pred, _, _ = _slate(9)
    np.testing.assert_allclose(tlw.smooth_rank(torch.from_numpy(pred)).numpy(),
                               np.asarray(jlw.smooth_rank(jnp.asarray(pred))), rtol=1e-5)
