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


# ---- the training kernels' plans and algorithms (csrc/maxsim_train_kernels.cu) ----


@pytest.mark.parametrize("shape,chunk,resident,slots", [
    ((32, 30, 64, 200, 128), 104, True, 3),  # the ColBERT training step's in-batch shape
    ((128, 30, 256, 200, 128), 104, True, 3),
    ((32, 30, 64, 200, 768), 104, False, 3),  # the public checkpoint's width: the query slab streams
    ((4, 30, 8, 1024, 128), 128, True, 2),
    ((5, 13, 9, 30, 40), 64, True, 4),
    ((7, 30, 21, 77, 128), 104, True, 3),
    ((2, 30, 3, 200, 160), 104, True, 2),
    ((2, 30, 3, 1024, 160), 128, False, 3)])
def test_train_plan_chunks_residency_and_slots(shape, chunk, resident, slots):
    """The training form's plan: the token chunk that pads Ld the least,
    the query tile resident while two ring slots fit beside it, as many
    slots as fit (at most 4), one block an SM over the (row tile, doc)
    items."""
    plan = ms.train_plan(*shape, sms=132)
    assert (plan["chunk"], plan["resident"], plan["slots"]) == (chunk, resident, slots)
    bq, lq, bd, ld, dim = shape
    assert plan["smem"] <= 232448 and plan["slabs"] == -(-dim // 32)
    assert plan["tiles"] == -(-(bq * lq) // 128) and plan["items"] == plan["tiles"] * bd
    assert plan["ctas"] == min(plan["items"], 132)


def test_train_plan_fits_every_accepted_geometry():
    """Every width the kernels take (D % 8 == 0 up to 2048) and doc length
    up to 1024: the launch fits shared memory with 2-4 slots, the chunks
    cover the doc with less than one chunk of padding, and the tile is
    resident at ColBERT's widths."""
    for dim in range(8, 2049, 8):
        for ld in (1, 7, 40, 64, 77, 104, 129, 200, 512, 1000, 1024):
            plan = ms.train_plan(3, 30, 5, ld, dim)
            chunks = -(-ld // plan["chunk"])
            assert 2 <= plan["slots"] <= 4 and plan["smem"] <= 232448, (dim, ld, plan)
            assert chunks * plan["chunk"] - ld < plan["chunk"]
            if dim <= 128:
                assert plan["resident"], (dim, ld)


@pytest.mark.parametrize("shape,parts", [((32, 30, 64, 200, 128), 5), ((128, 30, 256, 200, 128), 5),
                                         ((32, 30, 64, 200, 768), 5), ((4, 30, 8, 1024, 128), 33),
                                         ((2, 4, 1, 1024, 2048), 26), ((3, 5, 2, 3, 8), 3)])
def test_bwd_plan_rows_and_blocks(shape, parts):
    """The backward's plan: each doc's dd rows cut into ranges of at most
    40 rows, with about two blocks an SM, never more ranges than rows."""
    plan = ms.bwd_plan(*shape, sms=132)
    bq, lq, bd, ld, dim = shape
    assert plan["parts"] == parts and plan["rows"] == -(-ld // parts) <= 40
    assert plan["slabs"] == -(-dim // 128) and plan["dd_blocks"] == bd * parts * plan["slabs"]
    assert plan["dq_blocks"] == -(-(bq * lq) // 8) and plan["dd_smem"] <= 232448


def _emulate_train_form(q, d, qm, dm, fill, chunk):
    """(best, argmax) as the training form's kernel walks them, from the
    plain f32 dots: chunk by chunk, lane t of a quad over its tokens 8j +
    2t + e in order keeping a strict maximum, the four lanes merged with the
    lower token on equal values, then the fill where the doc has a masked
    slot and the fill is above every live dot."""
    bq, lq, dim = q.shape
    bd, ld, _ = d.shape
    dots = ms.matmul_f32(q.reshape(-1, dim), d.reshape(-1, dim).T).reshape(bq * lq, bd, ld)
    best = torch.empty(bq * lq, bd)
    idx = torch.empty(bq * lq, bd, dtype=torch.int32)
    for r in range(bq * lq):
        for k in range(bd):
            lanes = [(-float("inf"), -1)] * 4
            dead = False
            for c in range(-(-ld // chunk)):
                for t in range(4):
                    for j in range(chunk // 8):
                        for e in range(2):
                            tok = c * chunk + 8 * j + 2 * t + e
                            if tok >= ld:
                                continue
                            if dm[k, tok] <= 0:
                                dead = True
                            elif float(dots[r, k, tok]) > lanes[t][0]:
                                lanes[t] = (float(dots[r, k, tok]), tok)
            m, i = max(lanes, key=lambda v: (v[0], -(v[1] % 2 ** 32)))
            if dead and fill > m:
                m, i = fill, -1
            best[r, k], idx[r, k] = m, i
    return best.reshape(bq, lq, bd), idx.reshape(bq, lq, bd)


@pytest.mark.parametrize("chunk", [64, 104, 128])
def test_training_form_walk_matches_the_plain_argmax(chunk):
    """The kernel's walk over chunks, lanes and the quad gives the plain
    version's tokens and maxima: the first of an exact tie, -1 where the
    fill wins (docs whose every dot lies below it, and a masked doc), every
    token of every chunk visited once."""
    q, d, qm, dm, _ = _maxsim_inputs(4, bq=2, lq=3, bd=5, ld=chunk + 9, dim=16)
    d[4] = -np.abs(d[4]) * 500  # every live dot below the fill, and a masked slot
    dm[4, 2] = 0.0
    q = np.abs(q)
    dm[1] = 0.0
    t = [torch.from_numpy(a) for a in (q, d, qm, dm)]
    out, want_idx = ms.reference_maxsim_argmax(*t, fill=ms.NEG_FILL)
    best, idx = _emulate_train_form(*t, ms.NEG_FILL, chunk)
    assert torch.equal(idx, want_idx)
    assert bool((idx[:, :, 4] == -1).all()) and bool((idx[:, :, 1] == -1).all())
    torch.testing.assert_close(ms._terms(best, t[2][:, :, None]).sum(dim=1), out, rtol=0, atol=0)


def _emulate_bwd(q, d, qm, dm, argmax, g, parts, list_len=1024, groups=4):
    """(dq, dd) as the backward's kernels compute them: dq a row at a time
    over the docs in order; each doc's classes of bit-equal live rows (the
    first row the lead), its dd rows cut into ``parts`` ranges, each range
    summing w q over the (b, l) whose token's lead lies in it: the (b, l)
    of each ``list_len`` chunk's ``groups`` quarters apart, in order, the
    groups' sums then added in order, and every member of those classes
    written the lead's sum over the class size."""
    bq, lq, dim = q.shape
    bd, ld, _ = d.shape
    qf, am, gf = q.reshape(-1, dim), argmax.reshape(-1, bd), g
    dq = torch.zeros(bq * lq, dim)
    for e in range(bq * lq):
        w = qm.reshape(-1)[e]
        if w != 0:
            for k in range(bd):
                a = int(am[e, k])
                if a >= 0:
                    dq[e] = dq[e] + (gf[e // lq, k] * w) * d[k, a]
    dd = torch.zeros(bd, ld, dim)
    for k in range(bd):
        bits = d[k].view(torch.int32)
        lead = list(range(ld))
        for m in range(ld):
            if dm[k, m] > 0:
                lead[m] = next(m2 for m2 in range(m + 1) if dm[k, m2] > 0 and torch.equal(bits[m2], bits[m]))
        size = [sum(1 for m in range(ld) if dm[k, m] > 0 and lead[m] == c) for c in range(ld)]
        for r in range(parts):
            m0, m1 = r * ld // parts, (r + 1) * ld // parts
            acc = torch.zeros(groups, m1 - m0, dim)
            for e in range(bq * lq):
                a, w = int(am[e, k]), gf[e // lq, k] * qm.reshape(-1)[e]
                grp = (e % list_len) * groups // list_len
                if 0 <= a < ld and w != 0 and size[lead[a]] > 0 and m0 <= lead[a] < m1:
                    acc[grp, lead[a] - m0] = acc[grp, lead[a] - m0] + w * qf[e]
            for m in range(ld):
                if m0 <= lead[m] < m1:
                    total = acc[0, lead[m] - m0]
                    for grp in range(1, groups):
                        total = total + acc[grp, lead[m] - m0]
                    dd[k, m] = total / size[lead[m]] if size[lead[m]] else 0.0
    return dq.reshape(q.shape), dd


@pytest.mark.parametrize("parts", [1, 3, 9])
def test_backward_kernels_algorithm_matches_plain_and_is_independent_of_the_split(parts):
    """The backward's algorithm against reference_maxsim_bwd: an exact tie
    split evenly whichever of its rows the token names, a token on a masked
    slot (no dd), a masked query row (no dq); every split of the rows gives
    the same bits (each row sums its entries in an order fixed by (b, l)
    alone). A list of 8 entries in 4 groups puts the 18 (b, l) in three
    chunks."""
    q, d, qm, dm, g = _maxsim_inputs(5)
    t = [torch.from_numpy(a) for a in (q, d, qm, dm)]
    _, idx = ms.reference_maxsim_argmax(*t)
    idx[0, 0, 3], idx[0, 1, 3] = 4, 1  # either row of the tie
    idx[2, 0, 2] = 0  # a masked slot
    gt = torch.from_numpy(g)
    dq, dd = _emulate_bwd(*t, idx, gt, parts, list_len=8)
    want_q, want_d = ms.reference_maxsim_bwd(*t, idx, gt)
    torch.testing.assert_close(dq, want_q, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dd, want_d, rtol=1e-5, atol=1e-6)
    assert torch.equal(dd[3, 1], dd[3, 4]) and float(dd[3, 1].abs().max()) > 0
    one_q, one_d = _emulate_bwd(*t, idx, gt, 1, list_len=8)
    assert torch.equal(dq, one_q) and torch.equal(dd, one_d)


def test_split_ties_marks_maxima_shared_by_unequal_rows():
    """chip_smoke.py's _split_ties: a max two unequal doc rows share exactly
    (autograd splits it, the kernels give it to the first) is marked; one
    shared by bit-equal rows (split evenly by both), one on a masked slot and
    a fully masked doc are not."""
    import chip_smoke

    q = torch.zeros(1, 3, 8)
    q[0, 0, 0] = q[0, 1, 1] = q[0, 2, 2] = 1.0
    d = torch.full((2, 4, 8), -0.5)
    d[0, 0, 0], d[0, 2, 0], d[0, 2, 5] = 2.0, 2.0, 7.0  # rows 0 and 2 differ, tie for query token 0
    d[0, 1, 1] = d[0, 3, 1] = 3.0
    d[0, 3] = d[0, 1]  # rows 1 and 3 equal: a tie for query token 1
    d[0, 0, 2] = d[0, 1, 2] = 4.0  # a tie for query token 2 with a masked row
    dm = torch.ones(2, 4)
    dm[0, 1] = 0.0
    dm[1] = 0.0
    split = chip_smoke._split_ties(q, d, dm, ms.NEG_FILL)
    assert split.tolist() == [[[True, False], [False, False], [False, False]]]


def test_phase_maxsim_training_rehearses_on_the_cpu():
    """chip_smoke.py's phase 3 for the training kernels at tiny shapes on the
    CPU (the plain versions): every gate, the token agreement, the library
    chains beside each shape."""
    import chip_smoke

    sz = dict(maxsim_train_shapes=[(3, 5, 4, 24, 16, -1000.0, False, False), (3, 5, 7, 13, 16, -1000.0, True, False),
                                   (2, 4, 3, 24, 16, -1000.0, False, True)], reps=1)
    out = chip_smoke.phase_maxsim_training(sz, torch.device("cpu"))
    fwd, bwd = out["maxsim_all_pairs_argmax"], out["maxsim_all_pairs_bwd"]
    assert [a["tokens_agree"] for a in fwd["token_agreement"]] == [1.0, 1.0, 1.0]
    assert len(fwd["timings"]) == len(bwd["timings"]) == 3
    assert all(t["library_ms"] > 0 and t["library_call"] for t in fwd["timings"] + bwd["timings"])
    assert fwd["library_ms"] == fwd["timings"][0]["library_ms"]


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
