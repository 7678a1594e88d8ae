"""The port's MaxSim ops (ops/maxsim.py, the plain version of K14), the exact
rescore of retrieval/colbert_search.py and the standalone attention
(ops/fused_attention.py:fused_mha, the plain version of K13) against the JAX
package on the CPU: the same numpy inputs go to both."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu.ops import maxsim as jms
from matchmaker_tpu.ops.pallas_kernels import maxsim_all_pairs_pallas_v2
from matchmaker_tpu.retrieval import colbert_search as jcs
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import maxsim as tms
from matchmaker_tpu_torch.retrieval import colbert_search as tcs

# the bar of tests/test_perf_ops.py:91 (the Pallas MaxSim against jnp)
RTOL = ATOL = 1e-4


def _maxsim_inputs(seed, bq=3, lq=7, bd=21, ld=13, dim=16):
    """Queries of non-negative entries; every third doc made of large
    negative entries, so its live dots fall below −1000 (raw ColBERT dots
    reach |s| ≈ 7000); masks with zeros, one doc and one query all padding."""
    rng = np.random.default_rng(seed)
    q = (np.abs(rng.normal(size=(bq, lq, dim))) * 5).astype(np.float32)
    d = rng.normal(size=(bd, ld, dim)).astype(np.float32)
    d[::3] = -np.abs(d[::3]) * 40
    q_mask = (rng.random((bq, lq)) > 0.25).astype(np.float32)
    q_mask[:, 0] = 1.0
    q_mask[-1] = 0.0
    d_mask = (rng.random((bd, ld)) > 0.3).astype(np.float32)
    d_mask[:, 0] = 1.0
    d_mask[4] = 0.0
    return q, d, q_mask, d_mask


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_inputs_reach_below_the_fill():
    q, d, _, d_mask = _maxsim_inputs(0)
    dots = np.einsum("qld,kmd->qlkm", q, d)
    best_live = np.where(d_mask[None, None] > 0, dots, -np.inf).max(-1)
    assert (best_live[:, :, ::3][np.isfinite(best_live[:, :, ::3])] < -1000).mean() > 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_maxsim_all_pairs_matches_jax(seed):
    """The plain K14 against JAX's jnp ``maxsim_all_pairs`` and its Pallas
    kernel ``maxsim_all_pairs_pallas_v2`` (interpret mode): odd Bd 21, Ld 13,
    masks with zeros, dots below −1000; rtol = atol = 1e-4."""
    q, d, qm, dm = _maxsim_inputs(seed)
    _build.reset_launches()
    got = tms.maxsim_all_pairs(*_port(q, d, qm, dm)).numpy()
    assert _build.LAUNCHES["maxsim_all_pairs"] == 0  # CPU tensors take the plain version
    want = np.asarray(jms.maxsim_all_pairs(*map(jnp.asarray, (q, d, qm, dm))))
    pallas = np.asarray(maxsim_all_pairs_pallas_v2(*map(jnp.asarray, (q, d, qm, dm)), interpret=True))
    assert got.shape == (3, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    assert (got[-1] == 0).all()  # an all-padding query scores 0


def test_maxsim_fill_reaches_the_result():
    """With fill −1000 a doc whose live dots all lie below −1000 scores
    −1000 per live query token; with fill −inf its true max counts, and an
    all-padding doc's terms are −inf (the rescore zeroes them)."""
    q, d, qm, dm = _maxsim_inputs(2)
    neg = tms.maxsim_all_pairs(*_port(q, d, qm, dm)).numpy()
    exact = tms.maxsim_all_pairs(*_port(q, d, qm, dm), fill=float("-inf")).numpy()
    dots = np.einsum("qld,kmd->qlkm", q.astype(np.float64), d.astype(np.float64))
    best = np.where(dm[None, None] > 0, dots, -np.inf).max(-1)
    want = np.where(qm[:, :, None] > 0, best, 0.0).sum(1)  # masks are 0/1
    finite = np.isfinite(want)
    np.testing.assert_allclose(exact[finite], want[finite], rtol=RTOL, atol=ATOL)
    assert np.isneginf(exact[:-1, 4]).all() and (exact[-1] == 0).all()
    assert (neg[:-1, 4] == -1000.0 * qm[:-1].sum(1)).all()
    assert (neg[:, ::3] > exact[:, ::3] + 1).any()  # the fill changes the score


def test_maxsim_pairwise_matches_jax():
    q, d, qm, dm = _maxsim_inputs(3, bq=21, bd=21)
    got = tms.maxsim_pairwise(*_port(q, d, qm, dm)).numpy()
    want = np.asarray(jms.maxsim_pairwise(*map(jnp.asarray, (q, d, qm, dm))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _token_store(folder, rng, dim=16):
    """An encode folder by hand: docs of 1-9 token vectors in two blocks,
    one doc with no token at all (an all-padding candidate), every third doc
    with large negative vectors."""
    os.makedirs(folder, exist_ok=True)
    blocks, spans, ids = [[], []], [], []
    for i in range(30):
        n = 0 if i == 5 else int(rng.integers(1, 10))
        vecs = rng.normal(size=(n, dim)).astype(np.float16)
        if i % 3 == 0:
            vecs = -np.abs(vecs) * 40
        block = i % 2
        start = sum(len(v) for v in blocks[block])
        blocks[block].append(vecs)
        spans.append((block, start, start + n))
        ids.append(f"d{i}")
    for b, parts in enumerate(blocks):
        np.save(os.path.join(folder, f"token_reps_{b}.npy"), np.concatenate(parts).astype(np.float16))
    np.savez_compressed(os.path.join(folder, "doc_infos.npz"), ids=np.array(ids), spans=np.array(spans))
    with open(os.path.join(folder, "encode_meta.json"), "w") as f:
        json.dump({"dim": dim, "dtype": "float16", "blocks": 2, "sequences": len(ids)}, f)
    return ids


@pytest.mark.parametrize("pad_tokens", [8, 16])
def test_exact_rescore_matches_jax(tmp_path, pad_tokens):
    """exact_rescore against JAX's (``_exact_maxsim``): −inf fill for padded
    doc tokens, 0 for padded query tokens, 0 for a candidate with no token
    (d5), docs truncated to ``pad_tokens``, the same order and scores."""
    rng = np.random.default_rng(4)
    ids = _token_store(str(tmp_path), rng)
    q = (np.abs(rng.normal(size=(9, 16))) * 5).astype(np.float32)
    qm = np.ones(9, np.float32)
    qm[6:] = 0
    cands = [(ids[i], 0.0) for i in rng.permutation(30)[:20]] + [("d5", 0.0)]
    got = tcs.exact_rescore(q, qm, cands, tcs.TokenVectorStore(str(tmp_path)), 12, 24, pad_tokens,
                            device=torch.device("cpu"))
    want = jcs.exact_rescore(q, qm, cands, jcs.TokenVectorStore(str(tmp_path)), 12, 24, pad_tokens)
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=RTOL, atol=ATOL)
    full = tcs.exact_rescore(q, qm, cands, tcs.TokenVectorStore(str(tmp_path)), 30, 24, pad_tokens,
                             device=torch.device("cpu"))
    assert dict(full)["d5"] == 0.0
    assert min(s for _, s in full) < -1000  # the −inf fill keeps a live max below −1000


@pytest.mark.parametrize("bq,lq,dim", [(1, 32, 768), (64, 180, 768), (2, 200, 768), (1, 512, 1024), (3, 7, 8)])
def test_kernel_geometry_takes_wide_and_long_queries(bq, lq, dim):
    """K14's geometry check reads shapes only, so it runs here on CPU
    tensors: ColBERT's default width 768 and query rows past one 128-row
    tile, up to the encoder's 512 positions, are taken."""
    tms.check_kernel_geometry(torch.zeros(bq, lq, dim), torch.zeros(5, 13, dim), torch.ones(bq, lq),
                              torch.ones(5, 13))


@pytest.mark.parametrize("q_shape,d_shape,match", [((1, 32, 12), (5, 13, 12), "D % 8"),
                                                   ((1, 32, 4), (5, 13, 4), "D % 8"),
                                                   ((1, 513, 768), (5, 13, 768), "Lq <= 512"),
                                                   ((1, 32, 768), (5, 13, 128), "do not fit")])
def test_kernel_geometry_refuses_what_the_kernel_cannot_take(q_shape, d_shape, match):
    with pytest.raises(ValueError, match=match):
        tms.check_kernel_geometry(torch.zeros(q_shape), torch.zeros(d_shape), torch.ones(q_shape[:2]),
                                  torch.ones(d_shape[:2]))


def test_exact_rescore_at_768_wide_and_200_query_tokens_matches_jax(tmp_path):
    """The geometry K14 now takes on the card (768-wide token vectors, the
    public ColBERT checkpoint's width; 200 query tokens) through the plain
    path, against JAX's exact rescore: the same order and scores."""
    rng = np.random.default_rng(9)
    ids = _token_store(str(tmp_path), rng, dim=768)
    q = rng.normal(size=(200, 768)).astype(np.float32)
    qm = np.ones(200, np.float32)
    qm[150:] = 0
    cands = [(ids[i], 0.0) for i in rng.permutation(30)[:20]] + [("d5", 0.0)]
    got = tcs.exact_rescore(q, qm, cands, tcs.TokenVectorStore(str(tmp_path)), 21, 24, 16,
                            device=torch.device("cpu"))
    want = jcs.exact_rescore(q, qm, cands, jcs.TokenVectorStore(str(tmp_path)), 21, 24, 16)
    assert [d for d, _ in got] == [d for d, _ in want] and dict(got)["d5"] == 0.0
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=RTOL, atol=ATOL)


def _mha_inputs(seed, b=3, l=13, heads=4, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, l, heads * d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), np.float32)
    mask[1, 9:] = 0  # padded keys
    mask[2, 4:] = 0
    return q, k, v, mask


def test_fused_mha_matches_jax_f32():
    """In f32 the plain K13 equals both JAX functions: the interpreted
    Pallas kernel ``fused_mha`` and ``mha_reference`` (whose logits rounding
    to the input dtype is a no-op in f32); atol 1e-5."""
    q, k, v, mask = _mha_inputs(0)
    _build.reset_launches()
    got = tfa.fused_mha(*_port(q, k, v, mask), 4).numpy()
    assert _build.LAUNCHES["fused_mha"] == 0
    kernel = np.asarray(jfa.fused_mha(*map(jnp.asarray, (q, k, v, mask)), 4, interpret=True))
    ref = np.asarray(jfa.mha_reference(*map(jnp.asarray, (q, k, v, mask)), 4))
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_fused_mha_matches_jax_kernel_bf16():
    """In bf16 the plain K13 follows JAX's kernel ``fused_mha`` (f32 logits,
    probabilities rounded to bf16 before P·V): >= 99 % of the bf16 outputs
    bit-identical (all of them on this CPU) and the rest within two bf16
    ulps. Probabilities kept f32 into P·V leave about 61 % identical, and
    JAX's ``mha_reference``, which also rounds the logits to bf16, 60-67 %."""
    for seed in (1, 2):
        q, k, v, mask = _mha_inputs(seed)
        bf = torch.bfloat16
        got = tfa.fused_mha(*[t.to(bf) for t in _port(q, k, v)], torch.from_numpy(mask), 4)
        assert got.dtype == bf
        got = got.float().numpy()
        jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
        kernel = np.asarray(jfa.fused_mha(jq, jk, jv, jnp.asarray(mask), 4, interpret=True).astype(jnp.float32))
        ref = np.asarray(jfa.mha_reference(jq, jk, jv, jnp.asarray(mask), 4).astype(jnp.float32))
        assert (got == kernel).mean() >= 0.99, (got == kernel).mean()
        assert np.abs(got - kernel).max() <= 2 * 2.0 ** -8 * np.abs(kernel).max()
        assert (got == ref).mean() < 0.9
