"""The encoder widths the card's kernels took last: heads of 128 (the
attention cores' 128-wide instance) and heads of 65 to 127 zero-padded to
it, LayerNorm-backward rows wider than 1,024, hidden and FF widths that are
not a multiple of 8 (the card's products run them at the next one,
ops/fused_attention.py:card_width), and K14 at D that is not a multiple of
8. The port's plain versions (what the wrappers run on the CPU) are held to
the JAX package's fused halves and MaxSim kernel, run in interpret mode on
the CPU, at tests/test_fused_encoder.py's tolerances: forwards atol 2e-4,
the attention half's gradients atol/rtol 1e-2, the MLP half's 2e-3; the
paddings are shown exact on the plain versions. Where JAX's fused MLP
drops the FF columns past the last whole chunk (an FF that ``ff_chunks``
does not divide), the port is held to JAX's unfused encoder instead. Last,
a shape-only check that every card geometry check takes BERT-large's
widths as the port reads them from a ``config.json``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu.ops import fused_backward as jfb
from matchmaker_tpu.ops.pallas_kernels import maxsim_all_pairs_pallas_v2
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.hf_import import load_hf_encoder_config
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_backward as tfb
from matchmaker_tpu_torch.ops import fused_int8 as tf
from matchmaker_tpu_torch.ops import maxsim as tms

# bert-large-uncased's config.json: 24 layers, hidden 1,024 in 16 heads of
# 64, FF 4,096, 512 positions, 2 token types
BERT_LARGE = {"architectures": ["BertForMaskedLM"], "attention_probs_dropout_prob": 0.1, "hidden_act": "gelu",
              "hidden_dropout_prob": 0.1, "hidden_size": 1024, "initializer_range": 0.02,
              "intermediate_size": 4096, "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
              "model_type": "bert", "num_attention_heads": 16, "num_hidden_layers": 24, "pad_token_id": 0,
              "type_vocab_size": 2, "vocab_size": 30522}


def _attention_inputs(seed, hid, b=2, l=9):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * hid ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[1, 6:] = 0
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, ws, bs, mask, g, be, cot


def _mlp_inputs(seed, hid, ff, b=2, l=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(hid, ff)) * hid ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(ff,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(ff, hid)) * ff ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(hid,)) * 0.05).astype(np.float32)
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, w1, b1, w2, b2, g, be, cot


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _attention_vs_jax(hid, heads, seed, monkeypatch):
    """The port's attention half (plain forward and backward) against JAX's
    interpreted Pallas forward and backward kernels."""
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    x, ws, bs, mask, g, be, cot = _attention_inputs(seed, hid)
    j = [jnp.asarray(a) for a in (x, *ws, *bs, mask, g, be)]
    want_out = np.asarray(jfa.fused_attention_block(*j[:10], heads, *j[10:], interpret=True))

    def loss(x, ws, bs, g, be):
        return (jfb.fused_attention_block_train(x, *ws, *bs, jnp.asarray(mask), heads, g, be) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(j[0], j[1:5], j[5:9], j[10], j[11])
    tx, tg, tbe = _leaves([x, g, be])
    tws, tbs = _leaves(ws), _leaves(bs)
    _build.reset_launches()
    out = tfb.fused_attention_block_train(tx, *tws, *tbs, torch.from_numpy(mask), heads, tg, tbe)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    assert all(v == 0 for v in _build.LAUNCHES.values())
    got = [tx.grad, *[w.grad for w in tws], *[v.grad for v in tbs], tg.grad, tbe.grad]
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-2, rtol=1e-2)


def _mlp_vs_jax(hid, ff, ff_chunks, seed, monkeypatch):
    """The port's MLP half (plain forward and backward) against JAX's
    interpreted Pallas forward and backward kernels."""
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    x, w1, b1, w2, b2, g, be, cot = _mlp_inputs(seed, hid, ff)
    j = [jnp.asarray(a) for a in (x, w1, b1, w2, b2, g, be)]
    want_out = np.asarray(jfa.fused_mlp_block(*j, ff_chunks=ff_chunks, interpret=True))

    def loss(*args):
        return (jfb.fused_mlp_block_train(*args, ff_chunks=ff_chunks) * cot).sum()

    want = jax.grad(loss, argnums=tuple(range(7)))(*j)
    leaves = _leaves([x, w1, b1, w2, b2, g, be])
    out = tfb.fused_mlp_block_train(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-4)
    (out * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("hid,heads", [(256, 2), (160, 2)])
def test_attention_half_at_heads_of_128_and_80_matches_jax(hid, heads, monkeypatch):
    """Heads of 128 (the card's 128-wide instance) and of 80 (run padded to
    128 on the card): the plain forward at atol 2e-4 and every gradient at
    atol/rtol 1e-2 against JAX's interpreted kernels."""
    assert tfa.kernel_head_dim("test", hid, heads) == 128
    _attention_vs_jax(hid, heads, seed=hid, monkeypatch=monkeypatch)


@pytest.mark.parametrize("hid,heads", [(160, 2), (195, 3), (254, 2)])
def test_head_padding_to_128_is_exact_on_the_plain_versions(hid, heads):
    """Heads of 80, 65 and 127 zero-padded to 128 with the true scale
    1/sqrt(d): the plain forward equals the unpadded one, autograd through
    the padding gives the unpadded gradients, and the plain backward on
    the padded weights leaves the padded columns' gradients exactly zero."""
    d = hid // heads
    x, ws, bs, mask, g, be, cot = (torch.from_numpy(np.asarray(a)) if not isinstance(a, list) else
                                   [torch.from_numpy(w) for w in a] for a in _attention_inputs(hid + 1, hid))
    wqkv, bqkv, wo, bo = torch.cat(ws[:3], dim=1), torch.cat(bs[:3]), ws[3], bs[3]
    outs, grads = [], []
    for pad in (False, True):
        leaves = [t.detach().clone().requires_grad_() for t in (x, wqkv, bqkv, wo)]
        lx, lw, lb, lo = leaves
        w, bias, o = tfa.pad_attention_heads(lw, lb, lo, heads) if pad else (lw, lb, lo)
        if pad:
            assert tuple(w.shape) == (hid, 3 * heads * 128) and tuple(o.shape) == (heads * 128, hid)
        out = tfa.fused_attention_block_qkv(lx, w, bias, o, bo, mask, heads, g, be, head_dim=d)
        (out * cot).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.testing.assert_close(outs[1], outs[0], atol=1e-6, rtol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    w, bias, o = tfa.pad_attention_heads(wqkv, bqkv, wo, heads)
    _, saved = tfb.attention_block_fwd(x, w, bias, o, bo, mask, heads, g, be, head_dim=d)
    _, dw, db, dwo, *_ = tfb.attention_block_bwd(x, w, bias, o, mask, heads, g, cot, saved, head_dim=d)
    pad_cols = (torch.arange(3 * heads * 128) % 128) >= d
    assert not dw[:, pad_cols].any() and not db[pad_cols].any() and not dwo[pad_cols[:heads * 128]].any()


@pytest.mark.parametrize("hid,heads", [(1032, 12), (1536, 12)])
def test_ln_backward_at_wide_rows_matches_jax(hid, heads, monkeypatch):
    """The LayerNorm backward past 1,024 columns (the card's block-a-row
    kernel): K12's plain version at 1,032 (12 heads of 86) and 1,536 (12 of
    128) and K11's against JAX's interpreted backward kernels."""
    for w in (hid, hid - 7):
        tfb.check_ln_bwd_width("test", w)
    _attention_vs_jax(hid, heads, seed=hid + 2, monkeypatch=monkeypatch)
    _mlp_vs_jax(hid, 128, 2, seed=hid + 3, monkeypatch=monkeypatch)


@pytest.mark.parametrize("hid,heads,ff", [(100, 4, 400), (32, 4, 36)])
def test_odd_hidden_and_ff_widths_match_jax(hid, heads, ff, monkeypatch):
    """Hidden 100 (4 heads of 25) with FF 400 and hidden 32 (4 heads of 8)
    with FF 36: both halves' plain forward and backward against JAX's
    interpreted kernels (FF in 4 whole chunks, as JAX's default)."""
    _attention_vs_jax(hid, heads, seed=hid + 4, monkeypatch=monkeypatch)
    _mlp_vs_jax(hid, ff, 4, seed=hid + 5, monkeypatch=monkeypatch)


@pytest.mark.parametrize("hid,heads,ff", [(100, 4, 400), (32, 4, 36), (36, 4, 37)])
def test_hidden_padding_is_exact_on_the_plain_versions(hid, heads, ff):
    """What the card does with a hidden or FF width that is not a multiple
    of 8, on the plain versions: x and the weights zero-padded to
    card_width (x's rows, wqkv's rows, wo's and w2's columns, w1's rows and
    columns, the biases), the pre-LN sums then equal the unpadded ones in
    the true columns and are exactly zero in the padded ones, so the
    LayerNorm over the true width (the card's mm_layernorm_ld) is the
    unpadded output."""
    hp, fp = tfa.card_width(hid), tfa.card_width(ff)
    assert hp % 8 == 0 and fp % 8 == 0 and hp - hid < 8 and fp - ff < 8
    x, ws, bs, mask, g, be, _ = (torch.from_numpy(np.asarray(a)) if not isinstance(a, list) else
                                 [torch.from_numpy(w) for w in a] for a in _attention_inputs(hid + 6, hid))
    want, want_acc = tfa.reference_attention_block(x, *ws, *bs, mask, heads, g, be, save_acc=True)
    wqkv, wo = tfa.pad_attention_hidden(torch.cat(ws[:3], dim=1), ws[3], hp)
    bo, gp, bep = tfa.pad_vectors(hp, bs[3], g, be)
    xp = tfa.pad_groups(x, 1, hp, -1)
    _, acc = tfa.reference_attention_block(xp, *wqkv.chunk(3, dim=1), wo, *bs[:3], bo, mask, heads, gp, bep,
                                           save_acc=True, head_dim=hid // heads)
    torch.testing.assert_close(acc[..., :hid], want_acc, atol=1e-5, rtol=1e-5)
    assert not acc[..., hid:].any()
    torch.testing.assert_close(tfa._layer_norm_f32(acc[..., :hid], g, be, 1e-12), want, atol=1e-5, rtol=1e-5)

    x, w1, b1, w2, b2, g, be, _ = map(torch.from_numpy, _mlp_inputs(hid + 7, hid, ff))
    want, want_acc = tfa.reference_mlp_block(x, w1, b1, w2, b2, g, be, save_acc=True)
    pw1, pw2 = tfa.pad_mlp_hidden(w1, w2, hp, fp)
    assert tuple(pw1.shape) == (hp, fp) and tuple(pw2.shape) == (fp, hp)
    assert tfa.pad_mlp_hidden(pw1, pw2, hp, fp)[0] is pw1  # padding padded weights: a no-op
    (pb1,), (pb2, gp, bep) = tfa.pad_vectors(fp, b1), tfa.pad_vectors(hp, b2, g, be)
    _, acc = tfa.reference_mlp_block(tfa.pad_groups(x, 1, hp, -1), pw1, pb1, pw2, pb2, gp, bep, save_acc=True)
    torch.testing.assert_close(acc[..., :hid], want_acc, atol=1e-5, rtol=1e-5)
    assert not acc[..., hid:].any()
    torch.testing.assert_close(tfa._layer_norm_f32(acc[..., :hid], g, be, 1e-12), want, atol=1e-5, rtol=1e-5)


def test_jax_fused_mlp_drops_the_ff_remainder_and_the_port_follows_the_unfused_encoder():
    """At FF 37 in JAX's default 4 chunks of 9, JAX's fused MLP (interpret
    mode) computes over the first 36 FF columns only: it matches the
    formula over 36 columns and misses the one over 37. The port's MLP half
    takes all 37, as JAX's unfused encoder does: a one-layer fused port
    encoder at hidden 32, FF 37 against JAX's unfused one, atol 2e-4."""
    x, w1, b1, w2, b2, g, be, _ = _mlp_inputs(37, 32, 37)
    fused = np.asarray(jfa.fused_mlp_block(*map(jnp.asarray, (x, w1, b1, w2, b2, g, be)), ff_chunks=4,
                                           interpret=True))
    t = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g, be)]
    over_36 = tfa.reference_mlp_block(t[0], t[1][:, :36], t[2][:36], t[3][:36], *t[4:]).numpy()
    over_37 = tfa.reference_mlp_block(*t).numpy()
    np.testing.assert_allclose(fused, over_36, atol=2e-4)
    assert np.abs(fused - over_37).max() > 1e-2
    with pytest.raises(ValueError, match="equal chunks"):
        tf.check_mlp_int8_geometry(32, 37, 4)

    kw = dict(hidden_size=32, num_heads=4, intermediate_size=37, num_layers=1)
    rng = np.random.default_rng(11)
    ids = rng.integers(2, 900, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0
    jm = JaxEncoder(JaxEncoderConfig.tiny(dropout=0.0, **kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = TransformerEncoderLM(EncoderConfig.tiny(dropout=0.0, fused_attention=True, **kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_maxsim_at_d_100_matches_jax():
    """K14's plain version at D = 100 against JAX's jnp MaxSim and its
    Pallas kernel (interpret mode), rtol = atol = 1e-4, and the card's
    padding of D to 104 exact on the plain version (forward and the
    gradients through it)."""
    rng = np.random.default_rng(100)
    q = rng.normal(size=(3, 16, 100)).astype(np.float32)
    d = rng.normal(size=(5, 21, 100)).astype(np.float32)
    qm = (rng.random((3, 16)) > 0.2).astype(np.float32)
    dm = (rng.random((5, 21)) > 0.2).astype(np.float32)
    qm[:, 0] = dm[:, 0] = 1.0
    tms.check_kernel_geometry(*map(torch.from_numpy, (q, d, qm, dm)))
    got = tms.maxsim_all_pairs(*map(torch.from_numpy, (q, d, qm, dm))).numpy()
    pallas = np.asarray(maxsim_all_pairs_pallas_v2(*map(jnp.asarray, (q, d, qm, dm)), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    tq, td = (torch.from_numpy(a).requires_grad_() for a in (q, d))
    pq, pd = (tms._pad_dim(t) for t in (tq, td))
    assert pq.shape[-1] == pd.shape[-1] == 104
    padded = tms.reference_maxsim_all_pairs(pq, pd, torch.from_numpy(qm), torch.from_numpy(dm))
    np.testing.assert_allclose(padded.detach().numpy(), got, rtol=1e-6, atol=1e-5)
    padded.sum().backward()
    uq, ud = (torch.from_numpy(a).requires_grad_() for a in (q, d))
    tms.reference_maxsim_all_pairs(uq, ud, torch.from_numpy(qm), torch.from_numpy(dm)).sum().backward()
    torch.testing.assert_close(tq.grad, uq.grad)
    torch.testing.assert_close(td.grad, ud.grad)


def test_card_geometry_checks_take_bert_large_and_the_new_widths(tmp_path):
    """Shapes only: BERT-large's widths, read through the port's
    load_hf_encoder_config from a directory holding only its config.json,
    pass every card geometry check (the attention cores at heads of 64, the
    products' K and N, the LayerNorm backward at 1,024, the int8 halves,
    K14 at its width), and so do the new widths: heads of 128 at hidden
    1,024 and 1,536, heads of 80 at 640, hidden 100 and 32."""
    (tmp_path / "config.json").write_text(json.dumps(BERT_LARGE))
    cfg = load_hf_encoder_config(str(tmp_path))
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, cfg.num_layers) == (1024, 16, 4096, 24)
    assert (cfg.max_position_embeddings, cfg.type_vocab_size, cfg.layer_norm_eps) == (512, 2, 1e-12)
    cases = [(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, 64), (1024, 8, 4096, 128),
             (1536, 12, 6144, 128), (640, 8, 2560, 128), (100, 4, 400, 32), (32, 4, 36, 16)]
    for hid, heads, ff, width in cases:
        assert tfa.kernel_head_dim("test", hid, heads) == width
        tfa._check_gemm_dims("test", tfa.card_width(hid), tfa.card_width(ff))
        tfa._check_gemm_dims("test", tfa.card_width(hid), 3 * heads * width)
        tfb.check_ln_bwd_width("test", hid)
        tf.check_mlp_int8_geometry(hid, ff, 4)
        tf.check_attention_int8_geometry(hid, heads, 2, cfg.max_position_embeddings)
        z = torch.zeros(2, 30, hid)
        tms.check_backward_geometry(z, torch.zeros(3, 200, hid), torch.ones(2, 30), torch.ones(3, 200))
    assert tfa.card_width(1024) == 1024 and tfa.card_width(100) == 104 and tfa.card_width(36) == 40
