"""The rounding of the card's attention core (K1's, K10's and K13's,
matchmaker_tpu_torch/csrc/encoder_kernels.cu:attention_core_kernel), emulated
in plain torch on the CPU and held against the JAX package's Pallas kernels
run in interpret mode and against the port's plain versions, under the bars
the card's kernel is held to.

The kernel walks the keys in 64-key tiles twice. Pass 1 keeps each row's
running max and sum of exp(s - max), the sum rescaled when the max grows;
pass 2 forms the normalised p = exp(s - max) / sum and adds P.V tile by tile
into one f32 accumulator. K13 rounds the normalised p to bf16 before P.V
(as its TPU kernel does); K1 enters p as a bf16 hi + lo pair, K10 (whose f32
output is re-quantized) as hi + mid + lo. Keys past L (up to a multiple of
64) take p = 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_int8 as tfi
from matchmaker_tpu_torch.ops import matmul_codes, matmul_f32

KT = 64  # keys a tile
N_HEADS, HEAD_DIM = 2, 64
HID = N_HEADS * HEAD_DIM


def _bf16(t):
    return t.to(torch.bfloat16).float()


def kernel_core(q, k, v, mask, scale, terms, tiles=None):
    """The card's attention core on (B, H, L, D) q, k, v: f32 output; p
    enters P.V as ``terms`` bf16 terms (1: p rounded to bf16, K13; 2: hi +
    lo, K1; 3: hi + mid + lo, K10). ``tiles``: walk only the first this
    many key tiles (as the kernel does past an example's last unmasked key)."""
    l = q.shape[2]
    tiles = tiles or -(-l // KT)
    pad = -(-l // KT) * KT - l
    neg = F.pad((mask.float() - 1.0) * 1e9, (0, pad), value=float("-inf"))[:, None, None, :]
    kp, vp = (F.pad(t.float(), (0, 0, 0, pad)) for t in (k, v))

    def scores(t):
        keys = slice(t * KT, (t + 1) * KT)
        return matmul_f32(q, kp[:, :, keys].transpose(-1, -2)) * scale + neg[..., keys]

    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    den = torch.zeros_like(m)
    for t in range(tiles):  # pass 1
        s = scores(t)
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        den = den * torch.exp(m - mx) + torch.exp(s - mx).sum(dim=-1, keepdim=True)
        m = mx
    o = torch.zeros(q.shape, dtype=torch.float32)
    for t in range(tiles):  # pass 2
        r = torch.exp(scores(t) - m) / den
        vt = vp[:, :, t * KT:(t + 1) * KT]
        part = torch.zeros_like(o)
        for _ in range(terms):
            term = _bf16(r)
            part = part + matmul_f32(term, vt)
            r = r - term
        o = o + part
    return o


def _split(t, b, l):  # (B, L, H*D) -> (B, H, L, D)
    return t.reshape(b, l, N_HEADS, HEAD_DIM).transpose(1, 2)


def _merge(t, b, l):
    return t.transpose(1, 2).reshape(b * l, HID)


def emulated_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, ln_scale, ln_bias):
    """K1: the plain version's projections, casts and LayerNorm around the
    card's core."""
    b, l, _ = x.shape
    cd = x.dtype
    x2 = x.reshape(b * l, HID)
    q, k, v = (_split((matmul_f32(x2, w) + bias.float()).to(cd), b, l) for w, bias in ((wq, bq), (wk, bk), (wv, bv)))
    a = _merge(kernel_core(q, k, v, mask, HEAD_DIM ** -0.5, terms=2).to(cd), b, l)
    acc = x2.float() + bo.float() + matmul_f32(a, wo)
    return tfa._finish(acc, ln_scale, ln_bias, 1e-12, cd, (b, l, HID), False)


def emulated_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask, ln_scale, ln_bias):
    """K10: the plain int8 version (group of two heads, its quantizations
    in its order) around the card's core, whose f32 output is quantized."""
    b, l, _ = x.shape
    xf = x.float().reshape(b * l, HID)
    acc = xf + bo.float()
    xq, rs = tfi._quant_rows(xf)  # one group: both heads

    def proj(wq_, s_, b_):
        h = (matmul_codes(xq, wq_) * (rs * s_.float()) + b_.float()).to(x.dtype)
        return _split(h, b, l)

    a = _merge(kernel_core(proj(wqq, sq, bq), proj(wkq, sk, bk), proj(wvq, sv, bv), mask, HEAD_DIM ** -0.5,
                           terms=3), b, l)
    aq, as_ = tfi._quant_rows(a)
    acc = acc + matmul_codes(aq, woq) * (as_ * so.float())
    return tfa._layer_norm_f32(acc, ln_scale, ln_bias, 1e-12).to(x.dtype).reshape(b, l, HID)


def emulated_mha(q, k, v, mask):
    """K13: bf16 q, k, v (B, L, H*D), the normalised p rounded to bf16."""
    b, l, _ = q.shape
    o = kernel_core(_split(q, b, l), _split(k, b, l), _split(v, b, l), mask, HEAD_DIM ** -0.5, terms=1)
    return _merge(o.to(q.dtype), b, l).reshape(b, l, HID)


def _mask(b, l, all_masked):
    """Ragged key masks: a long and a short example, one live key, a full
    one, and (all_masked) an example without a live key."""
    mask = np.ones((b, l), np.float32)
    mask[0, l // 2 + 1:] = 0
    mask[1, max(1, l // 5):] = 0
    mask[2, 1:] = 0
    if all_masked:
        mask[4] = 0
    return mask


def _attention_inputs(seed, l, all_masked=False):
    rng = np.random.default_rng(seed)
    b = 5 if all_masked else 4
    x = (rng.normal(size=(b, l, HID)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(HID, HID)) * HID ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(HID,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(HID,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(HID,)) * 0.1).astype(np.float32)
    return x, ws, bs, _mask(b, l, all_masked), g, be


LENGTHS = [30, 77, 128]


@pytest.mark.parametrize("l", LENGTHS)
def test_k1_k10_core_rounding_holds_atol_against_jax_kernel(l):
    """In f32 the emulated block with K1's hi + lo p (K10's three terms are
    closer still) stays within atol 2e-4 of JAX's interpreted
    _block_kernel, the bar of tests/test_torch_fused_attention.py, and of
    the port's plain version."""
    x, ws, bs, mask, g, be = _attention_inputs(10 + l, l)
    want = np.asarray(jfa.fused_attention_block(jnp.asarray(x), *map(jnp.asarray, ws), *map(jnp.asarray, bs),
                                                jnp.asarray(mask), N_HEADS, jnp.asarray(g), jnp.asarray(be),
                                                interpret=True))
    t = torch.from_numpy
    got = emulated_attention_block(t(x), *map(t, ws), *map(t, bs), t(mask), t(g), t(be)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    plain = tfa.reference_attention_block(t(x), *map(t, ws), *map(t, bs), t(mask), N_HEADS, t(g), t(be)).numpy()
    np.testing.assert_allclose(got, plain, atol=2e-4)


def _mha_inputs(seed, l, all_masked=False):
    rng = np.random.default_rng(seed)
    b = 5 if all_masked else 4
    q, k, v = (rng.normal(size=(b, l, HID)).astype(np.float32) for _ in range(3))
    return q, k, v, _mask(b, l, all_masked)


@pytest.mark.parametrize("l", LENGTHS)
def test_k13_core_rounding_matches_jax_kernel_bf16(l):
    """In bf16 the emulated K13 follows JAX's interpreted fused_mha (f32
    logits, normalised probabilities rounded to bf16): >= 99 % of the
    outputs bit-identical and the rest within two bf16 ulps, the bar of
    tests/test_torch_maxsim.py; the same against the port's plain version."""
    for seed in (1, 2):
        q, k, v, mask = _mha_inputs(100 * seed + l, l)
        bf = torch.bfloat16
        tq, tk, tv = (torch.from_numpy(a).to(bf) for a in (q, k, v))
        got = emulated_mha(tq, tk, tv, torch.from_numpy(mask))
        assert got.dtype == bf
        got = got.float().numpy()
        jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
        kernel = np.asarray(jfa.fused_mha(jq, jk, jv, jnp.asarray(mask), N_HEADS, interpret=True)
                            .astype(jnp.float32))
        plain = tfa.mha_reference(tq, tk, tv, torch.from_numpy(mask), N_HEADS).float().numpy()
        for want in (kernel, plain):
            assert (got == want).mean() >= 0.99, (got == want).mean()
            assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * np.abs(want).max()


def online_core_rounded(q, k, v, mask, scale):
    """A one-pass (online) softmax over the same 64-key tiles, the design the
    kernel does not take: the unnormalised p = exp(s - running max) is
    rounded to bf16 into P.V, and the sum divides at the end."""
    l = q.shape[2]
    pad = -(-l // KT) * KT - l
    neg = F.pad((mask.float() - 1.0) * 1e9, (0, pad), value=float("-inf"))[:, None, None, :]
    kp, vp = (F.pad(t.float(), (0, 0, 0, pad)) for t in (k, v))
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    den = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=torch.float32)
    for t in range(-(-l // KT)):
        keys = slice(t * KT, (t + 1) * KT)
        s = matmul_f32(q, kp[:, :, keys].transpose(-1, -2)) * scale + neg[..., keys]
        mx = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - mx)
        den = den * torch.exp(m - mx) + p.sum(dim=-1, keepdim=True)
        o = o * torch.exp(m - mx) + matmul_f32(_bf16(p), vp[:, :, keys])
        m = mx
    return o / den


def test_a_one_pass_softmax_would_miss_k13s_bar():
    """Why the kernel walks the keys twice: rounding the unnormalised p of a
    one-pass softmax leaves under 70 % of K13's outputs bit-identical to
    JAX's interpreted fused_mha, far below the 99 % bar the two passes meet."""
    for l in LENGTHS:
        q, k, v, mask = _mha_inputs(100 + l, l)
        bf = torch.bfloat16
        tq, tk, tv = (torch.from_numpy(a).to(bf) for a in (q, k, v))
        b = q.shape[0]
        o = online_core_rounded(_split(tq, b, l), _split(tk, b, l), _split(tv, b, l), torch.from_numpy(mask),
                                HEAD_DIM ** -0.5)
        got = _merge(o.to(bf), b, l).reshape(b, l, HID).float().numpy()
        jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
        kernel = np.asarray(jfa.fused_mha(jq, jk, jv, jnp.asarray(mask), N_HEADS, interpret=True)
                            .astype(jnp.float32))
        assert (got == kernel).mean() < 0.7, (l, (got == kernel).mean())


@pytest.mark.parametrize("l", LENGTHS)
def test_k10_core_rounding_holds_the_int8_bar_against_plain(l):
    """The int8 attention half around the emulated core against the port's
    plain version (whose core keeps exact f32 p): mean |d| <= 5e-5, K10's
    bar on the card, and row cosine >= 0.999, with an all-masked example."""
    x, ws, bs, mask, g, be = _attention_inputs(20 + l, l, all_masked=True)
    t = torch.from_numpy
    quant = [tfi.quantize_weights_per_col(t(w)) for w in ws]
    codes = [c for pair in quant for c in pair]
    xb = t(x).to(torch.bfloat16)
    got = emulated_attention_int8_block(xb, *codes, *map(t, bs), t(mask), t(g), t(be)).float()
    want = tfi.reference_attention_int8_block(xb, *codes, *map(t, bs), t(mask), N_HEADS, t(g), t(be)).float()
    assert float((got - want).abs().mean()) <= 5e-5
    cos = F.cosine_similarity(got.reshape(-1, HID), want.reshape(-1, HID), dim=-1)
    assert float(cos.min()) >= 0.999


@pytest.mark.parametrize("l", LENGTHS)
def test_core_rounding_with_an_all_masked_example_matches_plain(l):
    """An example without a live key: every key takes the same -1e9 logit,
    so the kernel, as the plain versions, averages V over the L keys (not
    over the padding to 64); K1 in f32 within 2e-4, K13 in bf16 at its bar."""
    x, ws, bs, mask, g, be = _attention_inputs(30 + l, l, all_masked=True)
    t = torch.from_numpy
    got = emulated_attention_block(t(x), *map(t, ws), *map(t, bs), t(mask), t(g), t(be))
    want = tfa.reference_attention_block(t(x), *map(t, ws), *map(t, bs), t(mask), N_HEADS, t(g), t(be))
    torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
    q, k, v, mask = _mha_inputs(40 + l, l, all_masked=True)
    bf = torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(bf) for a in (q, k, v))
    got = emulated_mha(tq, tk, tv, t(mask)).float()
    want = tfa.mha_reference(tq, tk, tv, t(mask), N_HEADS).float()
    assert float((got == want).float().mean()) >= 0.99
    assert float((got - want).abs().max()) <= 2 * 2.0 ** -8 * float(want.abs().max())
    # the all-masked example: the mean of V over its L keys
    mean_v = tv[4].float().mean(dim=0)
    torch.testing.assert_close(got[4], mean_v.to(bf).float().expand(l, HID), atol=2 * 2.0 ** -8, rtol=0)


def test_emulation_rounds_only_where_the_kernel_does():
    """The hi + lo pair stays within 2^-16 of the plain f32 softmax core
    relative to |V|, hi + mid + lo within f32 rounding of it, and the bf16
    p moves it by far more."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 150, 64)).astype(np.float32)) for _ in range(3))
    mask = torch.ones(2, 150)
    mask[1, 70:] = 0
    s = matmul_f32(q, k.transpose(-1, -2)) * 0.125 + ((mask - 1.0) * 1e9)[:, None, None, :]
    exact = matmul_f32(torch.softmax(s, dim=-1), v)
    rounded, hilo, three = (kernel_core(q, k, v, mask, 0.125, terms=n) for n in (1, 2, 3))
    vmax = float(v.abs().max())
    assert float((three - exact).abs().max()) <= 2.0 ** -21 * vmax
    assert float((hilo - exact).abs().max()) <= 2.0 ** -16 * vmax
    assert float((hilo - exact).abs().max()) > 8 * float((three - exact).abs().max())
    assert float((rounded - exact).abs().max()) > 8 * float((hilo - exact).abs().max())


def test_skipping_the_masked_tail_tiles_changes_nothing():
    """The kernel skips the key tiles past an example's last unmasked key
    when it has a key of mask 1: those keys take p = exp(-1e9 + ...) = 0
    exactly, so both passes give the same values without them."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 200, 64)).astype(np.float32)) for _ in range(3))
    mask = torch.zeros(1, 200)
    mask[0, :57] = 1
    for terms in (1, 2, 3):
        full = kernel_core(q, k, v, mask, 0.125, terms)
        assert torch.equal(kernel_core(q, k, v, mask, 0.125, terms, tiles=1), full)
        assert not torch.equal(kernel_core(q, k, v, torch.ones(1, 200), 0.125, terms, tiles=1),
                               kernel_core(q, k, v, torch.ones(1, 200), 0.125, terms))
