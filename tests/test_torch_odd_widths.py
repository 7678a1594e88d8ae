"""Heads, hidden widths and FF chunks the card's kernels are not instanced
for, as the port runs them: heads narrower than 16, 32 or 64 zero-padded to
the next instance (ops/fused_attention.py:pad_attention_heads, the int8
codes by ops/fused_int8.py:pad_int8_attention), the int8 products'
contractions padded with zero codes to whole 64-code steps
(pad_int8_mlp). The padding is exact on the plain versions (the
transform itself), and the port's padded layers match the JAX package's
fused halves run in interpret mode on the CPU at tests/test_fused_encoder.py's
tolerances: TinyBERT-General-4L-312D's widths (hidden 312, 12 heads of 26,
FF 1,200) among them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.ops import fused_backward as jfb
from matchmaker_tpu.ops import fused_int8 as jf
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_backward as tfb
from matchmaker_tpu_torch.ops import fused_int8 as tf

# (hidden, heads): heads of 26 (TinyBERT's), 24, 8 and 48
ODD_HEADS = [(52, 2), (96, 4), (48, 6), (384, 8)]


def _attention_params(seed, hid, b=3, l=13):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32))
    wqkv = torch.from_numpy((rng.normal(size=(hid, 3 * hid)) * hid ** -0.5).astype(np.float32))
    bqkv = torch.from_numpy((rng.normal(size=(3 * hid,)) * 0.05).astype(np.float32))
    wo = torch.from_numpy((rng.normal(size=(hid, hid)) * hid ** -0.5).astype(np.float32))
    bo = torch.from_numpy((rng.normal(size=(hid,)) * 0.05).astype(np.float32))
    g = torch.from_numpy((rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32))
    be = torch.from_numpy((rng.normal(size=(hid,)) * 0.1).astype(np.float32))
    mask = torch.ones(b, l)
    mask[1, 9:] = 0
    cot = torch.from_numpy(rng.normal(size=(b, l, hid)).astype(np.float32))
    return x, wqkv, bqkv, wo, bo, g, be, mask, cot


@pytest.mark.parametrize("hid,heads", ODD_HEADS)
def test_head_padding_is_exact_on_the_plain_versions(hid, heads):
    """The attention half's plain forward on zero-padded heads with the
    true scale 1/sqrt(d) equals the unpadded one, and autograd through the
    padding gives the unpadded gradients (the padded columns' own are
    exactly zero in the plain backward); the padded widths are the next
    instanced ones."""
    d = hid // heads
    x, wqkv, bqkv, wo, bo, g, be, mask, cot = _attention_params(hid + heads, hid)
    width = tfa.kernel_head_dim("test", hid, heads)
    assert width == {26: 32, 24: 32, 8: 16, 48: 64}[d]
    leaves = [t.clone().requires_grad_() for t in (x, wqkv, bqkv, wo)]
    outs, grads = [], []
    for pad in (False, True):
        lx, lw, lb, lo = [t.detach().clone().requires_grad_() for t in leaves]
        w, bias, o = tfa.pad_attention_heads(lw, lb, lo, heads) if pad else (lw, lb, lo)
        if pad:
            assert tuple(w.shape) == (hid, 3 * heads * width) and tuple(o.shape) == (heads * width, hid)
        out = tfa.fused_attention_block_qkv(lx, w, bias, o, bo, mask, heads, g, be, head_dim=d)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in (lx, lw, lb, lo)])
    torch.testing.assert_close(outs[1], outs[0], atol=1e-6, rtol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    # the plain backward on the padded weights: zero gradients in the padding
    w, bias, o = tfa.pad_attention_heads(wqkv, bqkv, wo, heads)
    out, saved = tfb.attention_block_fwd(x, w, bias, o, bo, mask, heads, g, be, head_dim=d)
    _, dw, db, dwo, *_ = tfb.attention_block_bwd(x, w, bias, o, mask, heads, g, cot, saved, head_dim=d)
    pad_cols = (torch.arange(3 * heads * width) % width) >= d
    assert torch.equal(dw[:, pad_cols], torch.zeros_like(dw[:, pad_cols]))
    assert torch.equal(db[pad_cols], torch.zeros_like(db[pad_cols]))
    assert torch.equal(dwo[pad_cols[:heads * width]], torch.zeros_like(dwo[pad_cols[:heads * width]]))


def test_only_heads_wider_than_64_are_refused():
    """The card's head-width limit, since the 128-wide instance of the
    attention cores: every head width from 1 to 128 runs (on the next
    instance of 16, 32, 64, 128), a head wider than 128 is refused with
    the reason, and a width that does not split into the heads is too."""
    for d in range(1, 129):
        want = next(w for w in (16, 32, 64, 128) if d <= w)
        assert tfa.kernel_head_dim("k", 4 * d, 4) == want
    for hid, heads in [(312, 12), (64, 8), (192, 3), (768, 12), (20, 1), (768, 6), (130, 2), (1536, 12)]:
        assert tfa.kernel_head_dim("k", hid, heads) >= hid // heads
    for hid, heads in [(1548, 12), (258, 2), (129, 1), (4096, 16)]:
        with pytest.raises(ValueError, match="head widths up to 128"):
            tfa.kernel_head_dim("k", hid, heads)
    with pytest.raises(ValueError, match="head widths up to 128"):
        tfa.kernel_head_dim("k", 64, 3)


def test_ln_backward_takes_every_multiple_of_8_up_to_1024():
    """The LayerNorm backward's width limit: every width from 1 to 8,192
    (multiples of 8 up to 1,024 on the warp-a-row kernel as before, the
    rest run at the next multiple of 8, past 1,024 on the block-a-row
    kernel); past 8,192 refused with the reason."""
    for width in (8, 64, 128, 312, 392, 1000, 1024, 256, 768, 1, 12, 100, 1030, 1032, 1536, 2048, 4096, 8191, 8192):
        tfb.check_ln_bwd_width("k", width)
    for width in (0, -8, 8193, 16384):
        with pytest.raises(ValueError, match="1 to 8192 columns"):
            tfb.check_ln_bwd_width("k", width)


def _encoder_grads_jax(cfg_kw, ids, mask, monkeypatch):
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    m = JaxEncoder(JaxEncoderConfig.tiny(dropout=0.0, fused_attention=True, **cfg_kw), jnp.float32)
    params = m.init(jax.random.PRNGKey(0), ids, mask)["params"]

    def loss(p):
        out = m.apply({"params": p}, ids, mask)
        return (out * out).sum(), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return params, np.asarray(out), flax_to_state_dict(grads)


@pytest.mark.parametrize("hid,heads", [(52, 2), (96, 4)])
def test_fused_encoder_at_odd_head_widths_matches_jax(hid, heads, monkeypatch):
    """A fused encoder of heads of 26 (hidden 52) and of 24 (hidden 96),
    f32, its heads padded to 32 at packing, against the JAX encoder's fused
    halves with their Pallas forward and backward kernels in interpret
    mode: forward atol 2e-4, every gradient atol/rtol 1e-2."""
    rng = np.random.default_rng(hid)
    ids = rng.integers(2, 900, size=(2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.float32)
    mask[1, 7:] = 0
    kw = dict(hidden_size=hid, num_heads=heads, intermediate_size=2 * hid, num_layers=1)
    params, want_out, want = _encoder_grads_jax(kw, ids, mask, monkeypatch)
    tm = TransformerEncoderLM(EncoderConfig.tiny(dropout=0.0, fused_attention=True, **kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    assert tm.layer_0._fused_weights()[2].shape == (heads * 32, hid)
    _build.reset_launches()
    out = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-4)
    (out * out).sum().backward()
    assert all(v == 0 for v in _build.LAUNCHES.values())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-2, rtol=1e-2, err_msg=name)


def _row_cosine(a, b):
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min()


def _int8_layer(seed, hid, ff, b=2, l=9):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * hid ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    w1 = (rng.normal(size=(hid, ff)) * hid ** -0.5).astype(np.float32)
    w2 = (rng.normal(size=(ff, hid)) * ff ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(ff,)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(hid,)) * 0.05).astype(np.float32)
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[1, 6:] = 0
    return dict(x=x, ws=ws, bs=bs, w1=w1, w2=w2, b1=b1, b2=b2, g=g, be=be, mask=mask)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quantized(w):
    """The JAX package's codes and scales of a weight, as numpy."""
    return [np.asarray(a) for a in jf.quantize_weights_per_col(jnp.asarray(w))]


def test_int8_padding_is_exact_on_the_plain_versions():
    """TinyBERT's MLP (312 -> 1,200 in four chunks of 300) on codes padded
    to 320 and chunks of 320: bit for bit the unpadded plain version (zero
    codes add nothing to exact integer sums; gelu(0) = 0 leaves every
    chunk's amax). The attention half with heads of 26 padded to 32 and
    its Wo groups to 64 codes: within 1e-5 (the f32 core sums over the
    zero columns in another order)."""
    p = _int8_layer(3, 312, 1200)
    x = _t(p["x"])
    (w1q, s1), (w2q, s2) = tf.quantize_weights_per_col(_t(p["w1"])), tf.quantize_weights_per_col(_t(p["w2"]))
    ln = (_t(p["g"]), _t(p["be"]))
    want = tf.reference_mlp_int8_block(x, w1q, s1, _t(p["b1"]), w2q, s2, _t(p["b2"]), *ln)
    w1_t, ps1, pb1, w2_t = tf.pad_int8_mlp(tf.kmajor_codes(w1q), s1, _t(p["b1"]), tf.kmajor_codes(w2q))
    assert tuple(w1_t.shape) == (1280, 320) and tuple(w2_t.shape) == (312, 1280)
    assert torch.equal(tf.pad_int8_mlp(w1_t, ps1, pb1, w2_t)[0], w1_t)  # padding padded codes: a no-op
    got = tf.fused_mlp_int8_block_kmajor(x, w1_t, ps1, pb1, w2_t, s2, _t(p["b2"]), *ln)
    assert torch.equal(got, want)

    q = [tf.quantize_weights_per_col(_t(w)) for w in p["ws"]]
    bq, bk, bv, bo = map(_t, p["bs"])
    mask = _t(p["mask"])
    want = tf.reference_attention_int8_block(x, *q[0], *q[1], *q[2], *q[3], bq, bk, bv, bo, mask, 12, *ln)
    wqkv_t, sqkv, bqkv, wo_t, so, _ = tf.kmajor_attention_weights(*q[0], *q[1], *q[2], *q[3], bq, bk, bv, bo)
    padded = tf.pad_int8_attention(wqkv_t, sqkv, bqkv, wo_t, 12)
    assert tuple(padded[0].shape) == (3 * 12 * 32, 320) and tuple(padded[3].shape) == (312, 6 * 64)
    assert all(torch.equal(a, b) for a, b in zip(tf.pad_int8_attention(*padded, 12), padded))
    got = tf.fused_attention_int8_block_qkv_kmajor(x, padded[0], padded[1], padded[2], padded[3], so, bo, mask, 12,
                                                   *ln, head_dim=26)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hid,heads,ff", [(312, 12, 1200), (96, 4, 384)])
def test_int8_halves_at_odd_widths_match_jax(hid, heads, ff):
    """The int8 halves, their codes padded for the card, against the JAX
    package's int8 Pallas kernels in interpret mode at hidden widths that
    are not a multiple of 64 (TinyBERT's 312 with heads of 26 and chunks of
    300; 96 with heads of 24): row cosine > 0.999."""
    p = _int8_layer(hid, hid, ff)
    (w1q, s1), (w2q, s2) = (_quantized(p["w1"]), _quantized(p["w2"]))
    ln = (p["g"], p["be"])
    want = jf.fused_mlp_int8_block(*map(jnp.asarray, (p["x"], w1q, s1, p["b1"], w2q, s2, p["b2"], *ln)))
    padded = tf.pad_int8_mlp(tf.kmajor_codes(_t(w1q)), _t(s1), _t(p["b1"]), tf.kmajor_codes(_t(w2q)))
    got = tf.fused_mlp_int8_block_kmajor(_t(p["x"]), *padded[:3], padded[3], _t(s2), _t(p["b2"]),
                                         *map(_t, ln))
    assert _row_cosine(got.numpy(), np.asarray(want)) > 0.999

    q = [_quantized(w) for w in p["ws"]]
    flat = [a for pair in q for a in pair]
    want = jf.fused_attention_int8_block(*map(jnp.asarray, (p["x"], *flat, *p["bs"], p["mask"])), heads,
                                         *map(jnp.asarray, ln))
    kmajor = tf.kmajor_attention_weights(*map(_t, flat), *map(_t, p["bs"]))
    wqkv_t, sqkv, bqkv, wo_t = tf.pad_int8_attention(*kmajor[:4], heads)
    got = tf.fused_attention_int8_block_qkv_kmajor(_t(p["x"]), wqkv_t, sqkv, bqkv, wo_t, kmajor[4], kmajor[5],
                                                   _t(p["mask"]), heads, *map(_t, ln), head_dim=hid // heads)
    assert _row_cosine(got.numpy(), np.asarray(want)) > 0.999


def test_int8_encoder_at_tinybert_widths_matches_flax():
    """A one-layer int8 encoder at TinyBERT-General-4L-312D's widths
    (hidden 312, 12 heads of 26, FF 1,200), its codes padded at packing:
    per-token cosine >= 0.9999 against JAX's int8 encoder."""
    kw = dict(hidden_size=312, num_heads=12, intermediate_size=1200, num_layers=1, fused_attention=True,
              int8_mlp=True, int8_attention=True)
    rng = np.random.default_rng(9)
    ids = rng.integers(2, 900, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.float32)
    mask[0, 8:] = 0
    jm = JaxEncoder(JaxEncoderConfig.tiny(**kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = TransformerEncoderLM(EncoderConfig.tiny(**kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert tuple(tm.layer_0._int8_cache[1]["w1_t"].shape) == (1280, 320)
    assert _row_cosine(got, want) >= 0.9999
