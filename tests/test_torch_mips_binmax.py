"""The port's binmax scan (matchmaker_tpu_torch/ops/mips_binmax.py) and exact
scans against the JAX package on the CPU.

JAX runs its plain reference (``binmax_candidates_jnp`` /
``use_pallas=False``, bit-exact on the CPU) and, for one geometry, its
Pallas kernels in interpret mode. Level-1 comparisons use dyadic inputs
(multiples of 1/8 in bf16) so every f32 score is exact whatever the
summation order, and the packed candidates can be compared bit for bit,
ties included; the end-to-end top-k uses random floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips_binmax as jmb
from matchmaker_tpu.ops.mips import blocked_topk_scores as jax_blocked_topk
from matchmaker_tpu.ops.mips_f16 import f16_scan_topk as jax_f16_scan_topk
from matchmaker_tpu_torch.ops import mips_binmax as tmb
from matchmaker_tpu_torch.ops.mips import blocked_topk_scores
from matchmaker_tpu_torch.ops.mips_f16 import f16_scan_topk


def _dyadic(rng, n, d):
    return (rng.integers(-4, 5, size=(n, d)) / 8.0).astype(np.float32)


def _clustered(rng, n, d, n_clusters=16):
    centers = rng.normal(size=(n_clusters, d))
    vecs = centers[np.sort(rng.integers(0, n_clusters, size=n))] + 0.4 * rng.normal(size=(n, d))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same(a, b):
    return float(np.mean(_bits(a) == _bits(b)))


def test_padding_grain_matches_jax():
    for tile in (1024, 2048, 4096):
        for per_bin in (1, 2, 4, 8):
            assert tmb.padding_grain(tile, per_bin) == jmb.padding_grain(tile, per_bin)


@pytest.mark.parametrize("per_bin", [2, 4, 8])
def test_level1_candidates_match_jax(per_bin):
    rng = np.random.default_rng(per_bin)
    n, d = 5000, 32  # ragged: padded to the grain, tail masked by n_valid
    corpus, queries = _dyadic(rng, n, d), _dyadic(rng, 20, d)
    want = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=n, per_bin=per_bin)
    got = tmb.binmax_candidates(torch.from_numpy(queries), torch.from_numpy(corpus), n_valid=n, per_bin=per_bin)
    assert got.shape == want.shape
    assert _same(got.numpy(), want) >= 0.999


def test_level1_candidates_match_jax_pallas_interpret():
    rng = np.random.default_rng(9)
    n, d = 3000, 32
    corpus, queries = _dyadic(rng, n, d), _dyadic(rng, 12, d)
    want = jmb.binmax_candidates(jnp.asarray(queries), jnp.asarray(corpus), n_valid=n, per_bin=2,
                                 interpret=True)
    got = tmb.binmax_candidates(torch.from_numpy(queries), torch.from_numpy(corpus), n_valid=n, per_bin=2)
    assert _same(got.numpy(), want) >= 0.999


def test_topk_per_bin_t_matches_jax():
    rng = np.random.default_rng(4)
    scores = _dyadic(rng, 512, 24) * 3
    for base, n_valid in ((0, 512), (0, 300), (1024, 1200)):
        want = jmb._topk_per_bin_t(jnp.asarray(scores), base, n_valid, 4, use_argmax=True)
        got = tmb._topk_per_bin_t(torch.from_numpy(scores), base, n_valid, 4)
        assert _same(got.numpy(), want) == 1.0


@pytest.mark.parametrize("width", [tmb.L2_MID, tmb.L2_WIDE])
def test_level2_matches_jax(width):
    rng = np.random.default_rng(width)
    corpus, queries = _clustered(rng, 9000, 32), _clustered(rng, 16, 32)
    raw = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=9000, per_bin=8)
    want = jmb._level2_reduce(raw.T, interpret=False, use_pallas=False, bin_width=width).T
    got = tmb._level2_reduce(torch.from_numpy(np.array(raw)), width)
    assert got.shape == want.shape
    assert _same(got.numpy(), want) >= 0.999


@pytest.mark.parametrize("level2", [None, tmb.L2_MID, tmb.L2_WIDE])
def test_unpack_matches_jax(level2):
    rng = np.random.default_rng(5)
    corpus, queries = _clustered(rng, 9000, 32), _clustered(rng, 16, 32)
    packed = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=9000, per_bin=4,
                                       level2=level2)
    top = np.sort(np.asarray(packed), axis=1)[:, ::-1][:, :50].copy()
    pos = np.argsort(-np.asarray(packed), axis=1, kind="stable")[:, :50].astype(np.int32)
    wv, wi = jmb.unpack_candidates(jnp.asarray(top), jnp.asarray(pos), 2048, 4, level2=level2)
    gv, gi = tmb.unpack_candidates(torch.from_numpy(top), torch.from_numpy(pos).long(), 2048, 4, level2)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert _same(gv.numpy(), wv) == 1.0


# (rows, k, per_bin): no tournament, keep-8/32 and keep-8/128
GEOMETRIES = [(5000, 10, 2), (5000, 10, 8), (24_576, 10, 8)]


@pytest.mark.parametrize("n,k,per_bin", GEOMETRIES)
def test_binmax_scan_topk_matches_jax(n, k, per_bin):
    rng = np.random.default_rng(n + per_bin)
    corpus, queries = _clustered(rng, n, 48), _clustered(rng, 24, 48)
    wv, wi = jmb.binmax_scan_topk(jnp.asarray(queries), jnp.asarray(corpus, jnp.bfloat16), k, n_valid=n,
                                  per_bin=per_bin, use_pallas=False)
    gv, gi = tmb.binmax_scan_topk(torch.from_numpy(queries), torch.from_numpy(corpus).to(torch.bfloat16),
                                  k, n_valid=n, per_bin=per_bin)
    wi, gi = np.asarray(wi), gi.numpy()
    overlap = min(len(set(a) & set(b)) / k for a, b in zip(wi, gi))  # per query
    assert overlap >= 0.999, overlap
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=2e-3)


def test_f16_fallback_matches_jax():
    rng = np.random.default_rng(6)
    n, k = 3000, 25
    corpus = _clustered(rng, n, 48).astype(np.float16)
    queries = _clustered(rng, 10, 48)
    padded = np.concatenate([corpus, np.zeros((96, 48), np.float16)])
    wv, wi = jax_f16_scan_topk(jnp.asarray(queries), jnp.asarray(padded), k, approx=False, n_valid=n)
    gv, gi = f16_scan_topk(torch.from_numpy(queries), torch.from_numpy(padded), k, n_valid=n)
    assert (gi.numpy() < n).all()
    overlap = min(len(set(a) & set(b)) / k for a, b in zip(np.asarray(wi), gi.numpy()))
    assert overlap >= 0.999, overlap
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)


def test_exact_blocked_scan_matches_jax():
    rng = np.random.default_rng(8)
    corpus, queries = _clustered(rng, 5000, 32), _clustered(rng, 7, 32)
    wv, wi = jax_blocked_topk(jnp.asarray(queries), jnp.asarray(corpus), 30, block_size=2048)
    gv, gi = blocked_topk_scores(torch.from_numpy(queries), torch.from_numpy(corpus), 30, block_size=2048)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
