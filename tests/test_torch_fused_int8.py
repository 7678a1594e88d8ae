"""The port's int8 encoder halves (matchmaker_tpu_torch/ops/fused_int8.py) and
the int8 encoder against the JAX package.

On CPU tensors the port's wrappers run their plain versions, which repeat
the CUDA kernels' arithmetic; the JAX side runs its Pallas kernels in
interpret mode. Sizes and tolerances are the JAX tests' own
(tests/test_fused_encoder.py: B 4, L 24, HID 64, FF 128, 4 heads, a padded
mask row; atol 2e-4, rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.ops import fused_int8 as jf
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.ops import _build, matmul_codes
from matchmaker_tpu_torch.ops import fused_int8 as tf

B, L, HID, FF, NH = 4, 24, 64, 128, 4


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, L, HID)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(HID, HID)) * 0.1).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(HID,)) * 0.05).astype(np.float32) for _ in range(4)]
    w1 = (rng.normal(size=(HID, FF)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(FF, HID)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(FF,)) * 0.05).astype(np.float32)
    b2 = (rng.normal(size=(HID,)) * 0.05).astype(np.float32)
    g = (rng.normal(size=(HID,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(HID,)) * 0.1).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[2, 18:] = 0
    return dict(x=x, ws=ws, bs=bs, w1=w1, w2=w2, b1=b1, b2=b2, g=g, be=be, mask=mask)


def _quantized(w):
    """The JAX package's codes and scales of a weight, as numpy."""
    return [np.asarray(a) for a in jf.quantize_weights_per_col(jnp.asarray(w))]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,scale", [((64, 128), 0.1), ((768, 96), 0.02), ((32, 16), 0.0)])
def test_quantize_weights_per_col_bit_identical(shape, scale):
    """Codes and scales from the f32 weights equal the JAX package's bit for
    bit (a zero weight takes the 1e-12 scale floor)."""
    w = (np.random.default_rng(5).normal(size=shape) * scale).astype(np.float32)
    jq, js = _quantized(w)
    tq, ts = tf.quantize_weights_per_col(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))


@pytest.mark.parametrize("ff_chunks", [2, 4])
def test_mlp_int8_block_matches_jax_kernel(ff_chunks):
    """K9's plain version against the interpreted Pallas kernel."""
    p = _layer_inputs(2)
    w1q, s1 = _quantized(p["w1"])
    w2q, s2 = _quantized(p["w2"])
    args = (p["x"], w1q, s1, p["b1"], w2q, s2, p["b2"], p["g"], p["be"])
    want = np.asarray(jf.fused_mlp_int8_block(*_j(args), ff_chunks=ff_chunks))
    _build.reset_launches()
    got = tf.fused_mlp_int8_block(*_t(args), ff_chunks=ff_chunks)
    assert _build.LAUNCHES["fused_mlp_int8_block"] == 0  # CPU tensor → plain version
    assert got.shape == (B, L, HID) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_attention_int8_block_matches_jax_kernel(packed):
    """K10's plain version (unpacked and Q/K/V-packed entry points) against
    the interpreted Pallas kernel, with a padded example."""
    p = _layer_inputs(4)
    quant = [_quantized(w) for w in p["ws"]]
    qargs = [a for pair in quant for a in pair]
    want = np.asarray(jf.fused_attention_int8_block(
        *_j([p["x"], *qargs, *p["bs"], p["mask"]]), NH, jnp.asarray(p["g"]), jnp.asarray(p["be"])))
    _build.reset_launches()
    x, mask, g, be = _t([p["x"], p["mask"], p["g"], p["be"]])
    if packed:
        wqkv = torch.from_numpy(np.concatenate([quant[i][0] for i in range(3)], axis=1))
        sqkv = torch.from_numpy(np.concatenate([quant[i][1] for i in range(3)]))
        bqkv = torch.from_numpy(np.concatenate(p["bs"][:3]))
        got = tf.fused_attention_int8_block_qkv(x, wqkv, sqkv, bqkv, *_t(quant[3]), torch.from_numpy(p["bs"][3]),
                                                mask, NH, g, be)
    else:
        got = tf.fused_attention_int8_block(x, *_t(qargs), *_t(p["bs"]), mask, NH, g, be)
    assert _build.LAUNCHES["fused_attention_int8_block"] == 0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


def test_int8_dot_refuses_an_inexact_depth():
    """Past depth 1,040 an f32 product of int8 codes would round its sums
    on the way (127² · 2,047 > 2²⁴): the product runs in f64 instead, and
    each exact integer sum is rounded once to f32, as the card's kernels
    convert their int32 sums (BERT-large-wide int8 halves: hidden 1,536)."""
    rng = np.random.default_rng(0)
    a = rng.choice([127, 125, 123], size=(3, 2047)).astype(np.int8)
    b = rng.choice([127, 121], size=(2047, 5)).astype(np.int8)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(exact).min() > 1 << 24 and (exact.astype(np.float32).astype(np.int64) != exact).any()
    got = matmul_codes(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(exact).float())


def _ids_mask(seed, b=4, l=24, vocab=900):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[1, 15:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _token_cosine(a, b):
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min()


@pytest.mark.parametrize("flags", [dict(int8_mlp=True), dict(int8_mlp=True, int8_attention=True)])
def test_int8_encoder_matches_flax(flags):
    """A tiny int8 encoder with the JAX parameters carried across by
    models/weights.py: per-token cosine >= 0.9999 against JAX's."""
    kw = dict(fused_attention=True, **flags)
    ids, mask = _ids_mask(0)
    jm = JaxEncoder(JaxEncoderConfig.tiny(**kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = TransformerEncoderLM(EncoderConfig.tiny(**kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert _token_cosine(got, want) >= 0.9999
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_int8_encoder_refuses_autograd_and_caches_codes():
    """The int8 halves are forward-only: with autograd on the layer raises.
    Without it the codes are quantized once from the f32 parameters and
    rebuilt after the parameters are written."""
    ids, mask = _ids_mask(3)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    tm = TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True, int8_mlp=True, int8_attention=True),
                              torch.float32)
    g = torch.Generator().manual_seed(0)
    tm.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.1 for k, v in tm.state_dict().items()})
    with pytest.raises(NotImplementedError, match="forward-only"):
        tm(ids, mask)
    with torch.no_grad():
        first = tm(ids, mask)
        cached = tm.layer_0._int8_cache[1]
        assert tm.layer_0._int8_weights() is cached
        w1q, s1 = tf.quantize_weights_per_col(tm.layer_0.mlp_in.kernel)
        w1_t, s1, b1, _ = tf.pad_int8_mlp(w1q.t(), s1, tm.layer_0.mlp_in.bias, w1q.t().t())
        assert torch.equal(cached["w1_t"], w1_t) and torch.equal(cached["s1"], s1)
        assert torch.equal(cached["b1"], b1)
        tm.load_state_dict({k: v * 0.5 for k, v in tm.state_dict().items()})
        second = tm(ids, mask)
        assert tm.layer_0._int8_cache[1] is not cached
    assert not torch.allclose(first, second)


def _mlp_int8_per_row_gelu_codes(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias, ff_chunks=4):
    """The int8 MLP half with one gelu scale per row over all FF chunks: the
    wrong granularity (the kernel scales per row and chunk)."""
    b, l, hid = x.shape
    xf = x.float().reshape(b * l, hid)
    xq, rs = tf._quant_rows(xf)
    ch = w1q.shape[1] // ff_chunks
    chunks = [slice(c * ch, (c + 1) * ch) for c in range(ff_chunks)]
    gelu = [tf._gelu_poly_fma(matmul_codes(xq, w1q[:, sl]) * (rs * s1[sl]) + b1[sl]) for sl in chunks]
    _, hs = tf._quant_rows(torch.cat(gelu, dim=1))
    acc = xf + b2
    for sl, h in zip(chunks, gelu):
        hq = torch.clamp(torch.round(h / hs), -127, 127).to(torch.int8)
        acc = acc + matmul_codes(hq, w2q[sl, :]) * (hs * s2)
    return tf._layer_norm_f32(acc, ln_scale, ln_bias, 1e-12).to(x.dtype).reshape(b, l, hid)


@pytest.mark.parametrize("half", ["mlp", "attention"])
def test_card_bar_catches_a_wrong_scale_granularity(half):
    """The card checks hold K9/K10 to a mean |d| <= 5e-5 against their plain
    versions, beside K1/K2's row cosine >= 0.999 and max |d| <= 0.1. At
    DistilBERT width a wrong scale granularity (gelu codes per row instead
    of per row and FF chunk; attention codes per row instead of per group of
    2 heads) passes the cosine and max bars but not the mean one."""
    hid, ff, heads, b, l = 768, 3072, 12, 4, 30
    rng = np.random.default_rng(11)

    def q(rows, cols):
        return tf.quantize_weights_per_col(torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)
                                                            * rows ** -0.5))

    def v(n, std, mean=0.0):
        return torch.from_numpy((rng.normal(size=n) * std + mean).astype(np.float32))

    x = torch.from_numpy(rng.normal(size=(b, l, hid)).astype(np.float32)).to(torch.bfloat16)
    ln = (v(hid, 0.1, 1.0), v(hid, 0.1))
    if half == "mlp":
        mlp = (*q(hid, ff), v(ff, 0.05), *q(ff, hid), v(hid, 0.05))
        right, wrong = tf.reference_mlp_int8_block(x, *mlp, *ln), _mlp_int8_per_row_gelu_codes(x, *mlp, *ln)
    else:
        mask = torch.ones(b, l)
        mask[0, l // 2:] = 0.0
        attn = (*q(hid, hid), *q(hid, hid), *q(hid, hid), *q(hid, hid), *(v(hid, 0.05) for _ in range(4)), mask,
                heads)
        right = tf.reference_attention_int8_block(x, *attn, *ln)
        wrong = tf.reference_attention_int8_block(x, *attn, *ln, group_heads=heads)
    d = (wrong.float() - right.float()).abs()
    cos = torch.nn.functional.cosine_similarity(wrong.float().reshape(-1, hid), right.float().reshape(-1, hid), dim=-1)
    print(f"{half}: min row cosine {float(cos.min())}, max |d| {float(d.max())}, mean |d| {float(d.mean())}")
    assert float(cos.min()) >= 0.999 and float(d.max()) <= 0.1
    assert float(d.mean()) >= 20 * 5e-5


# ---- the K-major entry points, the encoder's K-major cache, the card's geometry ----

@pytest.mark.parametrize("ff_chunks", [2, 4])
def test_mlp_int8_block_kmajor_matches_jax_kernel(ff_chunks):
    """The encoder's K-major entry point (codes transposed, (OUT, IN)) on the
    CPU against the interpreted Pallas kernel, at the public function's
    tolerance, and equal to the public function bit for bit."""
    p = _layer_inputs(2)
    w1q, s1 = _quantized(p["w1"])
    w2q, s2 = _quantized(p["w2"])
    args = (p["x"], w1q, s1, p["b1"], w2q, s2, p["b2"], p["g"], p["be"])
    want = np.asarray(jf.fused_mlp_int8_block(*_j(args), ff_chunks=ff_chunks))
    x, w1q_, s1_, b1, w2q_, s2_, b2, g, be = _t(args)
    _build.reset_launches()
    got = tf.fused_mlp_int8_block_kmajor(x, tf.kmajor_codes(w1q_), s1_, b1, tf.kmajor_codes(w2q_), s2_, b2, g, be,
                                         ff_chunks=ff_chunks)
    assert _build.LAUNCHES["fused_mlp_int8_block"] == 0  # CPU tensor → plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    assert torch.equal(got, tf.fused_mlp_int8_block(*_t(args), ff_chunks=ff_chunks))


def test_attention_int8_block_qkv_kmajor_matches_jax_kernel():
    """The encoder's K-major attention entry point (Q/K/V codes packed and
    transposed, Wo's transposed) on the CPU against the interpreted Pallas
    kernel, with a padded example, and equal to the packed public function
    bit for bit."""
    p = _layer_inputs(4)
    quant = [_quantized(w) for w in p["ws"]]
    qargs = [a for pair in quant for a in pair]
    want = np.asarray(jf.fused_attention_int8_block(
        *_j([p["x"], *qargs, *p["bs"], p["mask"]]), NH, jnp.asarray(p["g"]), jnp.asarray(p["be"])))
    x, mask, g, be = _t([p["x"], p["mask"], p["g"], p["be"]])
    wqkv = torch.from_numpy(np.concatenate([quant[i][0] for i in range(3)], axis=1))
    sqkv = torch.from_numpy(np.concatenate([quant[i][1] for i in range(3)]))
    bqkv = torch.from_numpy(np.concatenate(p["bs"][:3]))
    woq, so = _t(quant[3])
    bo = torch.from_numpy(p["bs"][3])
    _build.reset_launches()
    got = tf.fused_attention_int8_block_qkv_kmajor(x, tf.kmajor_codes(wqkv), sqkv, bqkv, tf.kmajor_codes(woq), so, bo,
                                                   mask, NH, g, be)
    assert _build.LAUNCHES["fused_attention_int8_block"] == 0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    assert torch.equal(got, tf.fused_attention_int8_block_qkv(x, wqkv, sqkv, bqkv, woq, so, bo, mask, NH, g, be))


def test_encoder_int8_cache_holds_kmajor_transposes_of_jax_codes():
    """The int8 encoder's cached codes are the transposes of the JAX
    package's quantize_weights_per_col codes of the same f32 parameters, bit
    for bit ((OUT, IN), contiguous, Q/K/V packed along OUT), and the scales
    are JAX's, padded for the card (pad_int8_attention, pad_int8_mlp) with
    zero codes of scale 1."""
    kw = dict(fused_attention=True, int8_mlp=True, int8_attention=True)
    ids, mask = _ids_mask(5)
    jm = JaxEncoder(JaxEncoderConfig.tiny(**kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(7), ids, mask)["params"]
    tm = TransformerEncoderLM(EncoderConfig.tiny(**kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    layer = tm.layer_0
    cached = layer._int8_cache[1]
    prefix = next(k for k in state if k.endswith("attention.query.kernel")).rsplit("attention.query.kernel", 1)[0]

    def jax_codes(name):
        return _quantized(state[prefix + name])

    q, k, v = (jax_codes(f"attention.{n}.kernel") for n in ("query", "key", "value"))
    want = {"wqkv_t": (np.concatenate([q[0], k[0], v[0]], axis=1).T, np.concatenate([q[1], k[1], v[1]])),
            "wo_t": jax_codes("attention.out.kernel"), "w1_t": jax_codes("mlp_in.kernel"),
            "w2_t": jax_codes("mlp_out.kernel")}
    want["wo_t"], want["w1_t"], want["w2_t"] = ((c.T, s) for c, s in (want["wo_t"], want["w1_t"], want["w2_t"]))
    # the card's padding (heads of 16 as they are; FF chunks of 32 and head
    # groups of 32 codes padded with zero codes of scale 1 to 64)
    t = {name: (torch.from_numpy(np.array(c)), torch.from_numpy(np.array(s))) for name, (c, s) in want.items()}
    hid, heads = state[prefix + "attention.out.kernel"].shape[1], tm.cfg.num_heads
    wqkv_t, sqkv, _, wo_t = tf.pad_int8_attention(t["wqkv_t"][0], t["wqkv_t"][1], torch.zeros(3 * hid),
                                                  t["wo_t"][0], heads)
    w1_t, s1, _, w2_t = tf.pad_int8_mlp(t["w1_t"][0], t["w1_t"][1], torch.zeros(t["w1_t"][0].shape[0]),
                                        t["w2_t"][0])
    want = {"wqkv_t": (wqkv_t.numpy(), sqkv.numpy()), "wo_t": (wo_t.numpy(), want["wo_t"][1]),
            "w1_t": (w1_t.numpy(), s1.numpy()), "w2_t": (w2_t.numpy(), want["w2_t"][1])}
    assert want["w1_t"][0].shape == (256, 64) and want["wo_t"][0].shape == (64, 128)
    for name, scale in (("wqkv_t", "sqkv"), ("wo_t", "so"), ("w1_t", "s1"), ("w2_t", "s2")):
        codes = cached[name]
        assert codes.dtype == torch.int8 and codes.is_contiguous(), name
        np.testing.assert_array_equal(codes.numpy(), want[name][0], err_msg=name)
        np.testing.assert_array_equal(cached[scale].numpy().view(np.int32), want[name][1].view(np.int32),
                                      err_msg=scale)


def _seed_mlp_rule(hid, ff, ff_chunks):
    """The card path's MLP geometry as the earlier wmma kernels took it:
    chunk % 64 == 0, K % chunk == 0 and N % 16 == 0 for both products."""
    ch = ff // ff_chunks
    return hid % 64 == 0 and ff % 16 == 0 and ch % 64 == 0 and ff % ch == 0 and hid % 16 == 0


def _seed_attention_rule(hid, n_heads, group_heads, length):
    """The earlier card path's rule (head width 64), widened to the head
    widths 16 and 32 the attention core is now instanced for, where a head
    group's Wo chunk must still be whole 64-code steps."""
    d = hid // n_heads if hid % n_heads == 0 else 0
    return (d in (16, 32, 64) and n_heads % group_heads == 0 and (group_heads * d) % 64 == 0
            and 1 <= length <= 512 and hid % 64 == 0)


def _padded_mlp_rule(hid, ff, ff_chunks):
    """The card path's MLP geometry since the codes are padded to whole
    64-code steps (ops/fused_int8.py:pad_int8_mlp) and a hidden width that
    is not a multiple of 8 runs at the next one: any hidden width, FF in
    equal chunks."""
    return ff_chunks > 0 and hid > 0 and ff % ff_chunks == 0


def _padded_attention_rule(hid, n_heads, group_heads, length):
    """Since heads narrower than an instance are zero-padded to it and each
    head group's Wo codes to whole 64-code steps, with the 128-wide
    instance: heads at most 128 wide, any hidden width; since the core
    keeps a window of the mask row, any L."""
    d = hid // n_heads if hid % n_heads == 0 else 0
    return (0 < d <= 128 and n_heads % group_heads == 0 and length >= 1 and hid > 0)


def _accepts(check, *args):
    try:
        check(*args)
    except ValueError as e:
        assert "CUDA kernel" in str(e) or "positive" in str(e), str(e)
        return False
    return True


def test_mlp_int8_card_geometry_accepts_what_the_earlier_kernels_took():
    """check_mlp_int8_geometry (the card path's own check, callable on any
    machine) accepts every layer the earlier card path took, over a grid of
    widths, FF sizes and chunk counts: the card path did not shrink. It
    accepts exactly the padded path's rule, TinyBERT's 312 / 1,200 in four
    chunks of 300 among them. Every refusal says why."""
    seen = {True: 0, False: 0}
    for hid in (32, 64, 96, 128, 192, 256, 312, 320, 768, 1024):
        for ff in (64, 128, 192, 256, 384, 512, 768, 1024, 1200, 1536, 3072, 4096):
            for ff_chunks in range(1, 9):
                if ff_chunks > ff:
                    continue
                want = _padded_mlp_rule(hid, ff, ff_chunks)
                got = _accepts(tf.check_mlp_int8_geometry, hid, ff, ff_chunks)
                assert got == want and (got or not _seed_mlp_rule(hid, ff, ff_chunks)), (hid, ff, ff_chunks)
                seen[want] += 1
    assert seen[True] > 50 and seen[False] > 50 and _accepts(tf.check_mlp_int8_geometry, 312, 1200, 4)


def test_attention_int8_card_geometry_accepts_what_the_earlier_kernels_took():
    """Every layer the earlier card path took is taken, and exactly the
    padded path's rule: heads up to 128 wide (TinyBERT's 12 of 26 and
    BERT-large's 16 of 64 included), hidden widths that are not a multiple
    of 8 among them."""
    seen = {True: 0, False: 0}
    for hid in (64, 100, 128, 192, 312, 384, 512, 768, 1024, 1536):
        for n_heads in (1, 2, 3, 4, 6, 8, 12, 16):
            for group_heads in (1, 2, 3, 4):
                for length in (1, 5, 512, 513):
                    want = _padded_attention_rule(hid, n_heads, group_heads, length)
                    got = _accepts(tf.check_attention_int8_geometry, hid, n_heads, group_heads, length)
                    assert got == want and (got or not _seed_attention_rule(hid, n_heads, group_heads, length)), \
                        (hid, n_heads, group_heads, length)
                    seen[want] += 1
    assert seen[True] > 20 and seen[False] > 100


@pytest.mark.parametrize("check,args,match", [
    (tf.check_mlp_int8_geometry, (768, 3072, 4), None),  # DistilBERT: chunks of 768, one W1 pass
    (tf.check_mlp_int8_geometry, (1024, 4096, 4), None),  # BERT-large: chunks of 1,024, two W1 passes
    (tf.check_mlp_int8_geometry, (64, 256, 4), None),  # chunks of 64: half a stage
    (tf.check_mlp_int8_geometry, (768, 3072, 8), None),  # chunks of 384: half a W1 pass
    (tf.check_mlp_int8_geometry, (768, 3072, 5), "equal chunks"),  # chunks of 614.4
    (tf.check_mlp_int8_geometry, (768, 3072, 0), "positive"),
    (tf.check_mlp_int8_geometry, (96, 384, 4), None),  # chunks of 96, padded to 128
    (tf.check_mlp_int8_geometry, (312, 1200, 4), None),  # TinyBERT: chunks of 300, HID 312 padded to 320
    (tf.check_mlp_int8_geometry, (300, 1200, 4), None),  # HID 300 run at 304
    (tf.check_mlp_int8_geometry, (1200, 37, 4), "equal chunks"),  # JAX's fused MLP drops FF 37's last column
    (tf.check_attention_int8_geometry, (768, 12, 2, 128), None),
    (tf.check_attention_int8_geometry, (768, 12, 1, 1), None),  # Wo chunks of one head: 64 codes
    (tf.check_attention_int8_geometry, (768, 24, 2, 128), None),  # heads of 32: Wo chunks of 64 codes
    (tf.check_attention_int8_geometry, (384, 12, 2, 230), None),  # MiniLM-L6: 12 heads of 32
    (tf.check_attention_int8_geometry, (256, 16, 4, 128), None),  # heads of 16, four a group
    (tf.check_attention_int8_geometry, (384, 12, 1, 128), None),  # one head of 32 a group, padded to 64
    (tf.check_attention_int8_geometry, (312, 12, 2, 128), None),  # TinyBERT: heads of 26, padded to 32
    (tf.check_attention_int8_geometry, (768, 6, 2, 128), None),  # heads of 128
    (tf.check_attention_int8_geometry, (1536, 6, 2, 128), "head widths"),  # heads of 256
    (tf.check_attention_int8_geometry, (768, 12, 5, 128), "whole head groups"),
    (tf.check_attention_int8_geometry, (768, 12, 0, 128), "whole head groups"),
    (tf.check_attention_int8_geometry, (768, 12, 2, 513), None),  # past 512: the mask row in windows
    (tf.check_attention_int8_geometry, (768, 12, 2, 0), "L >= 1"),
])
def test_int8_card_geometry_check_runs_on_the_cpu(check, args, match):
    """The card path's geometry checks are plain functions of the shapes: on
    a machine without a card they accept the encoder layers the kernels
    take and refuse the others with a message naming the rule."""
    if match is None:
        check(*args)
    else:
        with pytest.raises(ValueError, match=match):
            check(*args)
