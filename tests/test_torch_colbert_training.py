"""ColBERT training on the port against the JAX package on the CPU: the
all-pairs MaxSim's gradient (plain autograd against ``jax.grad`` of the jnp
function, with an exact tie and masked doc positions), the model's packed
triple forward and per-term scores from carried-over parameters, and one
train step (Margin-MSE plus the in-batch all-pairs MaxSim loss, pairwise
and listwise), its loss and every gradient.

Tolerances: the MaxSim gradient at JAX's f32 bar for the op (rtol 1e-5,
atol 1e-5 of the largest entry); the model at the encoder tests' (atol 2e-4,
rtol 1e-4); a train step at the port's training parity bar
(tests/test_torch_training.py: the loss at rtol 1e-4; here every gradient
within rtol 1e-4 plus 1e-5 of its tensor's largest entry, the analytically
zero key-bias gradients within 1e-5 of the query bias gradient's scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models.colbert import ColBert as JaxColBert
from matchmaker_tpu.ops.maxsim import maxsim_all_pairs as jax_maxsim_all_pairs
from matchmaker_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models.colbert import ColBert
from matchmaker_tpu_torch.models.weights import flatten_params, flax_to_state_dict
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import maxsim as ms
from matchmaker_tpu_torch.training.train_step import make_loss_fn

# ---- the all-pairs MaxSim's gradient -------------------------------------------


def _maxsim_inputs(seed, bq=3, lq=6, bd=5, ld=9, dim=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bq, lq, dim)).astype(np.float32)
    d = rng.normal(size=(bd, ld, dim)).astype(np.float32)
    q_mask = np.ones((bq, lq), np.float32)
    q_mask[1, 4:] = 0.0
    d_mask = np.ones((bd, ld), np.float32)
    d_mask[0, 6:] = 0.0
    d_mask[2, ::2] = 0.0
    # an exact tie: doc 3 repeats its token 1 at token 4, both on the
    # batch's query direction, so they hold the max of many query tokens
    d[3, 1] = q.sum(axis=(0, 1))
    d[3, 4] = d[3, 1]
    # a masked doc position that would win were it live
    d[2, 0] = q.sum(axis=(0, 1)) * 2
    g = rng.normal(size=(bq, bd)).astype(np.float32)
    return q, d, q_mask, d_mask, g


def test_maxsim_all_pairs_gradient_matches_jax_with_ties_and_masks():
    q, d, qm, dm, g = _maxsim_inputs(0)
    want_q, want_d = jax.grad(lambda a, b: (jax_maxsim_all_pairs(a, b, jnp.asarray(qm), jnp.asarray(dm))
                                            * jnp.asarray(g)).sum(), argnums=(0, 1))(jnp.asarray(q), jnp.asarray(d))
    tq, td = torch.from_numpy(q).requires_grad_(), torch.from_numpy(d).requires_grad_()
    _build.reset_launches()
    (ms.maxsim_all_pairs(tq, td, torch.from_numpy(qm), torch.from_numpy(dm)) * torch.from_numpy(g)).sum().backward()
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU tensors: the plain version
    for got, want in ((tq.grad, want_q), (td.grad, want_d)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    dd = td.grad.numpy()
    # the tie splits evenly; the masked position and the masked query rows get nothing
    assert np.abs(dd[3, 1]).max() > 0 and np.array_equal(dd[3, 1], dd[3, 4])
    assert np.abs(dd[dm == 0]).max() == 0.0
    assert np.abs(tq.grad.numpy()[qm == 0]).max() == 0.0


def test_backward_kernels_plain_versions_match_jax_grad():
    """maxsim_all_pairs_argmax / maxsim_all_pairs_bwd on CPU tensors (the
    plain versions of K14's training form and of the backward kernel):
    the scores, and dq / dd from the saved tokens, against jax.grad."""
    q, d, qm, dm, g = _maxsim_inputs(2)
    want_out = jax_maxsim_all_pairs(*map(jnp.asarray, (q, d, qm, dm)))
    want_q, want_d = jax.grad(lambda a, b: (jax_maxsim_all_pairs(a, b, jnp.asarray(qm), jnp.asarray(dm))
                                            * jnp.asarray(g)).sum(), argnums=(0, 1))(jnp.asarray(q), jnp.asarray(d))
    t = [torch.from_numpy(a) for a in (q, d, qm, dm)]
    out, idx = ms.maxsim_all_pairs_argmax(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    dq, dd = ms.maxsim_all_pairs_bwd(*t, idx, torch.from_numpy(g))
    for got, want in ((dq, want_q), (dd, want_d)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.array_equal(dd[3, 1].numpy(), dd[3, 4].numpy()) and float(dd[3, 1].abs().max()) > 0


def test_maxsim_argmax_reference_marks_fill_and_first_of_ties():
    q, d, qm, dm, _ = _maxsim_inputs(1)
    t = [torch.from_numpy(a) for a in (q, d, qm, dm)]
    out, idx, top1, top2 = ms.reference_maxsim_argmax(*t, with_top2=True)
    torch.testing.assert_close(out, ms.reference_maxsim_all_pairs(*t), rtol=0, atol=0)
    assert idx.shape == (3, 6, 5) and idx.dtype == torch.int32
    assert int((idx[:, :, 3] == 4).sum()) == 0 and int((idx[:, :, 3] == 1).sum()) > 0  # the first of the tie
    assert bool((idx[:, :, 2] != 0).all())  # masked: never the max's token
    assert bool((top1 >= top2).all())
    dm_all = dm.copy()
    dm_all[1] = 0.0
    q_low = -np.abs(q) * 0 - 1.0  # every dot far below the fill
    _, idx2 = ms.reference_maxsim_argmax(torch.from_numpy(q_low), torch.from_numpy(np.abs(d) * 300),
                                            torch.from_numpy(qm), torch.from_numpy(dm_all))
    assert bool((idx2[:, :, 1] == -1).all()) and bool((idx2[:, :, 0] == -1).all())  # the fill wins


# ---- the model -------------------------------------------------------------------

def _triple(seed, b=4, lq=8, ld=20, vocab=900):
    rng = np.random.default_rng(seed)

    def ids_mask(l, short_row):
        ids = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
        mask = np.ones((b, l), np.float32)
        mask[short_row, l // 2:] = 0
        ids[mask == 0] = 0
        return ids, mask

    q, qm = ids_mask(lq, 1)
    p, pm = ids_mask(ld, 2)
    n, nm = ids_mask(ld, 0)
    return {"query_ids": q, "query_mask": qm, "doc_pos_ids": p, "doc_pos_mask": pm, "doc_neg_ids": n,
            "doc_neg_mask": nm, "pos_score": rng.uniform(5, 10, b).astype(np.float32),
            "neg_score": rng.uniform(0, 5, b).astype(np.float32), "valid": np.array([1, 1, 1, 0], np.float32)}


def _models(config, seed=0):
    """A JAX ColBert and the port's from the same config and parameters."""
    jm = JaxColBert.from_config(config)
    batch = _triple(seed)
    params = jm.init(jax.random.PRNGKey(seed), {"query_ids": batch["query_ids"], "query_mask": batch["query_mask"],
                                                "doc_ids": batch["doc_pos_ids"],
                                                "doc_mask": batch["doc_pos_mask"]})["params"]
    tm = ColBert.from_config(config)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, tm


def _colbert_config(**kw):
    return {"model": "colbert", "bert_pretrained_model": "tiny-random", "use_fp16": False,
            "colbert_compression_dim": 24, "in_batch_negatives": True, **kw}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("normalize", [False, True])
def test_colbert_forward_triple_matches_jax(normalize):
    """forward_triple's two halves: scores, per-term scores and vectors."""
    config = _colbert_config(colbert_normalize=normalize, colbert_per_term_scores=True)
    jm, params, tm = _models(config, seed=2)
    batch = _triple(5)
    jpos, jneg = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                          method="forward_triple")
    with torch.no_grad():
        tpos, tneg = tm.forward_triple(_torch_batch(batch))
    for want, got in ((jpos, tpos), (jneg, tneg)):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-4,
                                       err_msg=key)
    if normalize:
        norms = tpos["query_vecs"].norm(dim=-1)
        assert bool(((norms - 1).abs() < 1e-5).all())


def test_colbert_from_config_keys():
    tm = ColBert.from_config(_colbert_config(dynamic_teacher_per_term_scores=True, colbert_normalize=True))
    assert (tm.return_per_term, tm.normalize, tm.return_vecs, tm.compression_dim) == (True, True, True, 24)
    tm = ColBert.from_config(_colbert_config(in_batch_negatives=False))
    assert (tm.return_per_term, tm.normalize, tm.return_vecs) == (False, False, False)
    assert {k for k in flatten_params({"compressor": {"kernel": np.zeros((2, 3)), "bias": np.zeros(3)}})} == \
        {"compressor/kernel", "compressor/bias"}
    assert set(flax_to_state_dict({"compressor": {"kernel": np.zeros((64, 24)), "bias": np.zeros(24)}})) == \
        {"compressor.kernel", "compressor.bias"}


# ---- one train step --------------------------------------------------------------

@pytest.mark.parametrize("ib_loss", ["margin-mse", "ranknet", "KLDivTeacherList"])
def test_colbert_train_step_matches_jax(ib_loss):
    """The loss and every parameter's gradient of one ColBERT step: the
    pairwise Margin-MSE plus the in-batch all-pairs MaxSim loss (pairwise:
    the diagonal against the hardest negative; listwise: against JAX's
    default [I | 0] teacher)."""
    config = _colbert_config(loss="margin-mse", in_batch_neg_loss=ib_loss, colbert_normalize=ib_loss == "ranknet")
    jm, params, tm = _models(config, seed=4)
    batch = _triple(6)
    jloss_fn = jax_make_loss_fn(jm, jdispatch.get_loss(config), config)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tstats = make_loss_fn(tm, tdispatch.get_loss(config), config)(_torch_batch(batch))
    tloss.backward()
    for key in ("loss", "ranking_loss", "inbatch_loss"):
        np.testing.assert_allclose(float(tstats[key].detach()), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(jgrads)
    grads = {name: p.grad for name, p in tm.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        if name.endswith("attention.key.bias"):
            # zero in exact arithmetic (each softmax row's gradient sums to
            # zero): both frameworks' rounding noise, bounded by the query
            # bias gradient's scale
            scale = float(np.abs(want[name.replace("key", "query")].numpy()).max())
            assert max(float(g.abs().max()), float(np.abs(w).max())) <= 1e-5 * scale, name
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * float(np.abs(w).max()), rtol=1e-4, err_msg=name)
    assert max(float(g.abs().max()) for g in grads.values()) > 1e-3
