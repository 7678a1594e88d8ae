"""Sequences past 512 tokens. The card's attention cores keep a 512-key
window of the mask row and refill it every eighth key tile, K14 sums a
long query's rows in passes of 512, and the MaxSim backward sizes its tie
classes by the doc's length, so every wrapper takes any L, Lq and Ld. On
the CPU the wrappers run their plain versions; here those are held to the
JAX package past 512 tokens: JAX's fused halves and ``fused_mha`` (their
Pallas kernels in interpret mode) at L 520 and 600, at the tolerances of
tests/test_fused_encoder.py (forwards atol 2e-4, the attention half's
gradients atol/rtol 1e-2, the int8 half's row cosine > 0.999); the fused
encoder with 1,024 positions at L 600 from JAX's parameters; MaxSim at Lq
600 against JAX's Pallas kernel and its backward at Ld 1,100 against
``jax.grad`` of JAX's jnp all-pairs MaxSim (rtol = atol = 1e-4). Then a
checkpoint of 2,048 positions through both packages' imports, the loaders
at ``max_doc_length`` 2,000, and a shape-only check that every card
geometry check and launch plan takes L 513, 2,048 and 8,192."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.data import loaders as jax_loaders
from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu.ops import fused_backward as jfb
from matchmaker_tpu.ops import fused_int8 as jf
from matchmaker_tpu.ops import maxsim as jms
from matchmaker_tpu.ops.pallas_kernels import maxsim_all_pairs_pallas_v2
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

from matchmaker_tpu_torch.data import loaders
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.models import hf_import
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_backward as tfb
from matchmaker_tpu_torch.ops import fused_int8 as tf
from matchmaker_tpu_torch.ops import maxsim as tms

LONG = (513, 2048, 8192)


def _long_mask(b, l, seed):
    """Example 0 live up to a key past 512, example 1 without a live key,
    example 2 (where there is one) with random holes."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, l), np.float32)
    mask[0, 512 + (l - 512) // 2 + 1:] = 0
    mask[1] = 0
    if b > 2:
        mask[2] = rng.random(l) > 0.3
        mask[2, 0] = 1
    return mask


def _attention_inputs(seed, hid, b, l):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * hid ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, ws, bs, _long_mask(b, l, seed), g, be, cot


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _row_cosine(a, b):
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return ((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min()


@pytest.mark.parametrize("hid,heads,l", [(64, 4, 520), (64, 4, 600), (256, 2, 600)])
def test_attention_half_past_512_matches_jax(hid, heads, l, monkeypatch):
    """The attention half at L 520 and 600 (heads of 16, and of 128), one
    example live up to a key past 512 and one without a live key: the
    plain forward at atol 2e-4 and every gradient at atol/rtol 1e-2
    against JAX's interpreted Pallas forward and backward kernels."""
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)
    x, ws, bs, mask, g, be, cot = _attention_inputs(l + hid, hid, 2, l)
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


def test_int8_attention_half_at_600_matches_jax():
    """The int8 attention half at L 600 (hidden 64, 4 heads, three examples
    of _long_mask) against JAX's interpreted int8 Pallas kernel: row
    cosine > 0.999."""
    x, ws, bs, mask, g, be, _ = _attention_inputs(6, 64, 3, 600)
    q = [[np.asarray(a) for a in jf.quantize_weights_per_col(jnp.asarray(w))] for w in ws]
    flat = [a for pair in q for a in pair]
    want = jf.fused_attention_int8_block(*map(jnp.asarray, (x, *flat, *bs, mask)), 4, jnp.asarray(g),
                                         jnp.asarray(be), interpret=True)
    got = tf.fused_attention_int8_block(*(torch.from_numpy(a) for a in (x, *flat, *bs, mask)), 4,
                                        torch.from_numpy(g), torch.from_numpy(be))
    assert _row_cosine(got.numpy(), np.asarray(want)) > 0.999


def test_fused_mha_at_600_matches_jax():
    """K13's plain version at L 600 (4 heads of 16, three examples of
    _long_mask) against JAX's interpreted ``fused_mha``: atol 2e-4."""
    rng = np.random.default_rng(600)
    q, k, v = (rng.normal(size=(3, 600, 64)).astype(np.float32) for _ in range(3))
    mask = _long_mask(3, 600, 1)
    want = np.asarray(jfa.fused_mha(*map(jnp.asarray, (q, k, v, mask)), 4, interpret=True))
    got = tfa.fused_mha(*(torch.from_numpy(a) for a in (q, k, v, mask)), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_fused_encoder_with_1024_positions_at_600_matches_jax():
    """A one-layer fused encoder of 1,024 positions (hidden 64, 4 heads),
    JAX's parameters carried across by ``flax_to_state_dict``, at L 600
    with one sequence past 512 tokens: atol 2e-4 against JAX's fused
    encoder (its Pallas kernels in interpret mode)."""
    kw = dict(num_layers=1, max_position_embeddings=1024, dropout=0.0, fused_attention=True)
    rng = np.random.default_rng(1024)
    ids = rng.integers(2, 900, size=(2, 600)).astype(np.int32)
    mask = np.ones((2, 600), np.float32)
    mask[1, 300:] = 0
    jm = JaxEncoder(JaxEncoderConfig.tiny(**kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = TransformerEncoderLM(EncoderConfig.tiny(**kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    assert tm.position_embeddings.embedding.shape[0] == 1024
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def _maxsim_inputs(bq, lq, bd, ld, dim, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bq, lq, dim)).astype(np.float32)
    d = rng.normal(size=(bd, ld, dim)).astype(np.float32)
    qm = (rng.random((bq, lq)) > 0.2).astype(np.float32)
    dm = (rng.random((bd, ld)) > 0.2).astype(np.float32)
    qm[:, 0] = dm[:, 0] = 1.0
    return q, d, qm, dm


def test_maxsim_at_600_query_tokens_matches_jax():
    """``maxsim_all_pairs`` at Lq 600 (the card's sums in two passes)
    against JAX's MaxSim Pallas kernel in interpret mode, rtol = atol =
    1e-4."""
    q, d, qm, dm = _maxsim_inputs(2, 600, 5, 40, 32, 600)
    got = tms.maxsim_all_pairs(*map(torch.from_numpy, (q, d, qm, dm))).numpy()
    want = np.asarray(maxsim_all_pairs_pallas_v2(*map(jnp.asarray, (q, d, qm, dm)), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_maxsim_backward_at_1100_doc_tokens_matches_jax_grad():
    """The training form and the MaxSim backward (the plain versions of the
    card's kernels) at Ld 1,100 with an exact tie (token 1,050 repeats
    token 7 in every doc) against ``jax.grad`` of JAX's jnp all-pairs
    MaxSim: the forward and dq, dd at rtol = atol = 1e-4, the tie's
    gradient split evenly as JAX's max splits it."""
    q, d, qm, dm = _maxsim_inputs(3, 30, 4, 1100, 32, 1100)
    d[:, 7] = q.sum(axis=(0, 1))
    d[:, 1050] = d[:, 7]
    dm[:, 7] = dm[:, 1050] = 1.0
    g = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)

    def loss(q, d):
        return (jms.maxsim_all_pairs(q, d, jnp.asarray(qm), jnp.asarray(dm)) * g).sum()

    want_out = np.asarray(jms.maxsim_all_pairs(*map(jnp.asarray, (q, d, qm, dm))))
    want_dq, want_dd = (np.asarray(a) for a in jax.grad(loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(d)))
    tq, td, tqm, tdm = map(torch.from_numpy, (q, d, qm, dm))
    tms.check_backward_geometry(tq, td, tqm, tdm)
    out, argmax = tms.maxsim_all_pairs_argmax(tq, td, tqm, tdm)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-4, atol=1e-4)
    assert bool((argmax == 7).any())
    dq, dd = tms.maxsim_all_pairs_bwd(tq, td, tqm, tdm, argmax, torch.from_numpy(g))
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dd.numpy(), want_dd, rtol=1e-4, atol=1e-4)
    assert np.abs(want_dd[:, 7]).max() > 0 and np.array_equal(dd[:, 7].numpy(), dd[:, 1050].numpy())


def test_a_checkpoint_of_2048_positions_loads_through_both_packages(tmp_path):
    """A seeded DistilBERT checkpoint of 2,048 positions: the port's import
    and JAX's (through ``transformers``) give the same config and, through
    ``flax_to_state_dict``, the same tensors bit for bit; the port's
    encoder built from it runs a 2,000-token sequence."""
    from matchmaker_tpu.models.hf_import import load_hf_encoder as jax_load_hf_encoder

    cfg = EncoderConfig(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                        max_position_embeddings=2048, type_vocab_size=0)
    config, state = hf_import.seeded_distilbert_checkpoint(cfg, seed=5)
    hf_import.save_hf_checkpoint(str(tmp_path), config, state, safetensors=True)
    got_cfg, got = hf_import.load_hf_encoder(str(tmp_path))
    jcfg, jparams = jax_load_hf_encoder(str(tmp_path))
    assert got_cfg.max_position_embeddings == jcfg.max_position_embeddings == 2048
    want = flax_to_state_dict(jparams)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    enc = TransformerEncoderLM(got_cfg, torch.float32)
    enc.load_state_dict(got)
    ids = torch.randint(1, 120, (1, 2000))
    with torch.inference_mode():
        out = enc(ids, torch.ones(1, 2000))
    assert out.shape == (1, 2000, 32) and bool(torch.isfinite(out).all())


def test_loaders_keep_2000_token_documents_as_jax_does(tmp_path):
    """The port's loaders at ``max_doc_length`` 2,000 (the long-document
    configs' length) with the hash tokenizer: documents of 2,500 words come
    out 2,000 tokens wide with 2,000 live tokens, shorter ones padded to
    2,000, nothing cut at 512, and every array equal to JAX's loader's."""
    rng = np.random.default_rng(2000)
    words = [f"w{i}" for i in range(5000)]

    def text(n):
        return " ".join(rng.choice(words, size=n))

    docs = [text(2500), text(700), text(1999)]
    with open(tmp_path / "docs.tsv", "w") as f:
        for i, doc in enumerate(docs):
            f.write(f"{i}\t{doc}\n")
    with open(tmp_path / "triples.tsv", "w") as f:
        f.write(f"{text(12)}\t{docs[0]}\t{docs[1]}\n{text(9)}\t{docs[2]}\t{docs[0]}\n")
    config = {"max_doc_length": 2000, "max_query_length": 30, "batch_size_inference": 4, "batch_size_train": 2,
              "bert_pretrained_model": "tiny-random", "model": "bert_dot"}
    tok, jtok = build_tokenizer(config), jax_build_tokenizer(config)
    (got, ids), = list(loaders.single_sequence_loader(config, tok, str(tmp_path / "docs.tsv"), "doc"))
    (want, jids), = list(jax_loaders.single_sequence_loader(config, jtok, str(tmp_path / "docs.tsv"), "doc"))
    assert ids == jids and got["seq_ids"].shape == (4, 2000)
    assert list(got["seq_mask"].sum(axis=1)[:3]) == [2000, 702, 2000]
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    got, = list(loaders.triple_training_loader(config, tok, str(tmp_path / "triples.tsv")))
    want, = list(jax_loaders.triple_training_loader(config, jtok, str(tmp_path / "triples.tsv")))
    assert set(got) == set(want) and got["doc_pos_ids"].shape == (2, 2000)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("length", LONG)
def test_card_checks_and_plans_take_long_sequences(length):
    """Shape-only: the int8 attention half's geometry check, K14's and the
    training kernels' geometry checks and their launch plans take L, Lq and
    Ld of 513, 2,048 and 8,192 (past 8,192 doc tokens the backward's tie
    classes move to a global workspace, past 32,767 a row's class lead and
    size to two planes); the attention wrappers keep no length cap."""
    tf.check_attention_int8_geometry(768, 12, 2, length)
    tf.check_attention_int8_geometry(1024, 8, 2, length)
    for name in ("fused_attention", "fused_backward", "fused_int8"):
        assert not hasattr({"fused_attention": tfa, "fused_backward": tfb, "fused_int8": tf}[name], "_KERNEL_MAX_LEN")
    z = torch.zeros
    tms.check_kernel_geometry(z(2, length, 128), z(3, 77, 128), z(2, length), z(3, 77))
    tms.check_backward_geometry(z(2, 30, 128), z(3, length, 128), z(2, 30), z(3, length))
    tp = tms.train_plan(16, length, 32, length, 128)
    assert tp["chunk"] in (64, 104, 128) and tp["slots"] >= 2 and tp["smem"] <= 232448
    bp = tms.bwd_plan(16, 30, 32, length, 128)
    assert bp["rows"] <= 40 and bp["info_planes"] == 1 and bp["dd_smem"] <= 232448
    assert bp["class_ws"] == 0 and bp["class_bytes"] <= 232448
    past = tms.bwd_plan(16, 30, 32, length + 8192, 128)
    assert past["class_ws"] == 32 * past["class_bytes"] and past["dd_smem"] <= 232448
    wide = tms.bwd_plan(4, 30, 2, 32768 + length, 128)
    assert wide["info_planes"] == 2 and wide["class_ws"] > 0 and wide["dd_smem"] <= 232448
    with pytest.raises(ValueError, match="Lq >= 1"):
        tms.check_kernel_geometry(z(2, 0, 128), z(3, 77, 128), z(2, 0), z(3, 77))
    with pytest.raises(ValueError, match="L >= 1"):
        tf.check_attention_int8_geometry(768, 12, 2, 0)
