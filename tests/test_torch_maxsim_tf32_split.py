"""K14's split-TF32 arithmetic (matchmaker_tpu_torch/csrc/maxsim_kernels.cu),
emulated in numpy on the CPU and held to the plain f32 MaxSim
(``ops/maxsim.py:reference_maxsim_all_pairs``) within the bar of
tests/test_perf_ops.py:91, rtol = atol = 1e-4.

The kernel rounds each f32 operand to TF32 with ``cvt.rna.tf32.f32``'s
rounding (10 mantissa bits, nearest, ties away from zero), by adding half
of the dropped 13 bits and masking them off, as here; it splits x = hi +
lo with lo the TF32 of x - hi, and adds q_lo.d_hi, q_hi.d_lo, q_hi.d_hi into f32 accumulators,
eight of K an ``mma.sync`` (m16n8k8): the eight products are exact and their
sum with the accumulator is rounded to f32 once (here in f64, then f32).
Float16 tokens are exact in TF32, so their lo is 0 and the kernel skips
that product. At ColBERT's magnitudes (raw dots up to about 7,000) the
split meets the bar at D 128 and 768 with f16 and f32 tokens; TF32 alone
(one product) misses it per (query token, doc) term, which is why the
kernel splits.
"""

import numpy as np
import pytest
import torch

from matchmaker_tpu_torch.ops import maxsim as tms

RTOL = ATOL = 1e-4


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 by bit masking: the nearest value with 10 mantissa
    bits, ties away from zero (the sign bit stays out of the sum)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna((x.astype(np.float32) - hi).astype(np.float32))


def emulated_dots(q: np.ndarray, d: np.ndarray, terms: str) -> np.ndarray:
    """(R, D) x (N, D) -> (R, N) f32 dots as the kernel forms them: per k8
    step the products of ``terms`` ("split": lo.hi, hi.lo, hi.hi, the last
    skipped where d_lo is zero; "tf32": hi.hi alone), each an exact sum of
    eight products added to the f32 accumulator and rounded once."""
    qh, ql = split(q)
    dh, dl = split(d)
    pairs = [(qh, dh)] if terms == "tf32" else [(ql, dh)] + ([(qh, dl)] if dl.any() else []) + [(qh, dh)]
    acc = np.zeros((q.shape[0], d.shape[0]), dtype=np.float32)
    for k0 in range(0, q.shape[1], 8):
        for a, b in pairs:
            part = a[:, k0:k0 + 8].astype(np.float64) @ b[:, k0:k0 + 8].astype(np.float64).T
            acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def emulated_maxsim(q, d, q_mask, d_mask, fill, terms):
    """(Bq, Lq, Bd) masked maxima and (Bq, Bd) sums, the sum over query
    tokens in order l = 0..Lq-1 in f32 as the kernel's one thread a query."""
    bq, lq, dim = q.shape
    bd, ld, _ = d.shape
    dots = emulated_dots(q.reshape(-1, dim), d.reshape(-1, dim), terms).reshape(bq, lq, bd, ld)
    best = np.where(d_mask[None, None] > 0, dots, np.float32(fill)).max(-1)
    out = np.zeros((bq, bd), dtype=np.float32)
    with np.errstate(invalid="ignore"):  # -inf * 0 of a masked query token, discarded
        for l in range(lq):
            w = q_mask[:, l:l + 1]
            out = np.where(w != 0, (out + best[:, l] * w).astype(np.float32), out)
    return best, out


def _colbert_inputs(seed, dim, f16_tokens, bq=3, lq=32, bd=8, ld=40):
    """Token vectors scaled so the largest raw dots reach about 7,000 (raw
    ColBERT dots); masks with zeros."""
    rng = np.random.default_rng(seed)
    scale = np.sqrt(7000.0 / (4.0 * np.sqrt(dim)))
    q = (rng.normal(size=(bq, lq, dim)) * scale).astype(np.float32)
    d = (rng.normal(size=(bd, ld, dim)) * scale).astype(np.float32)
    if f16_tokens:
        d = d.astype(np.float16).astype(np.float32)
    q_mask = (rng.random((bq, lq)) > 0.2).astype(np.float32)
    d_mask = (rng.random((bd, ld)) > 0.2).astype(np.float32)
    q_mask[:, 0] = d_mask[:, 0] = 1.0
    return q, d, q_mask, d_mask


def _plain_terms(q, d, d_mask, fill):
    dots = torch.matmul(torch.from_numpy(q).reshape(-1, q.shape[-1]), torch.from_numpy(d).reshape(-1, d.shape[-1]).T)
    dots = dots.reshape(q.shape[0], q.shape[1], d.shape[0], d.shape[1])
    return torch.where(torch.from_numpy(d_mask)[None, None] > 0, dots, fill).amax(-1).numpy()


def test_tf32_rounding_by_masking():
    """Nearest with ties away from zero; TF32 values are fixed points; f16
    values are exact in TF32 (so the kernel's f16 tokens have lo = 0)."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -20, -(1 + ulp / 2), 1 + 3 * ulp / 2, 3.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), np.array([1 + ulp, one, -(1 + ulp), 1 + 2 * ulp, 3.0], np.float32))
    rng = np.random.default_rng(0)
    h = (rng.normal(size=4096) * 300).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(tf32_rna(h), h)
    hi, lo = split(rng.normal(size=4096).astype(np.float32))
    assert (tf32_rna(hi) == hi).all() and (tf32_rna(lo) == lo).all()


@pytest.mark.parametrize("dim", [128, 768])
@pytest.mark.parametrize("f16_tokens", [True, False])
@pytest.mark.parametrize("fill", [tms.NEG_FILL, float("-inf")])
def test_split_tf32_meets_the_bar_at_colbert_magnitudes(dim, f16_tokens, fill):
    """The kernel's split against the plain f32 version: every (query
    token, doc) maximum and every score within rtol = atol = 1e-4; the same
    inputs through TF32 alone miss it."""
    q, d, q_mask, d_mask = _colbert_inputs(dim + int(f16_tokens), dim, f16_tokens)
    want = tms.reference_maxsim_all_pairs(*(torch.from_numpy(a) for a in (q, d, q_mask, d_mask)), fill).numpy()
    want_terms = _plain_terms(q, d, d_mask, fill)
    assert np.abs(want_terms).max() > 5000  # raw ColBERT magnitudes
    terms, got = emulated_maxsim(q, d, q_mask, d_mask, fill, "split")
    np.testing.assert_allclose(terms, want_terms, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    tf32_terms, _ = emulated_maxsim(q, d, q_mask, d_mask, fill, "tf32")
    assert not np.allclose(tf32_terms, want_terms, rtol=RTOL, atol=ATOL)


def test_split_tf32_keeps_fill_and_masked_query_tokens():
    """A doc whose live dots all lie below -1000 scores the fill per live
    query token with fill -1000 and its true maxima with -inf; an all-padding
    doc scores -inf; a masked query token adds exactly 0."""
    q, d, q_mask, d_mask = _colbert_inputs(5, 128, True, bd=4)
    q = np.abs(q)
    d[1] = -np.abs(d[1])
    d_mask[3] = 0.0
    q_mask[2] = 0.0
    for fill in (tms.NEG_FILL, float("-inf")):
        _, got = emulated_maxsim(q, d, q_mask, d_mask, fill, "split")
        want = tms.reference_maxsim_all_pairs(*(torch.from_numpy(a) for a in (q, d, q_mask, d_mask)), fill).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
        assert (got[2] == 0).all()
    _, neg = emulated_maxsim(q, d, q_mask, d_mask, tms.NEG_FILL, "split")
    np.testing.assert_array_equal(neg[:2, 1], -1000.0 * q_mask[:2].sum(1))
