"""The port's encoder, BERT_DOT models and weights against the JAX package
(tiny config, f32): the same params go through the flax modules and, after
``flax_to_state_dict``, through the port."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
from matchmaker_tpu.models.bert_dot import BertDotDualEncoder as JaxBertDotDual
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.models.encoder import encoder_config_from_model_name as jax_cfg_from_name
from matchmaker_tpu_torch.data.loaders import device_prefetch
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.models.bert_dot import BertDot, BertDotDualEncoder
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name
from matchmaker_tpu_torch.models.weights import flatten_params, flax_to_state_dict, load_npz, save_npz
from matchmaker_tpu_torch.training.trainer import _refuse_unported


def _ids_mask(seed, b=4, l=24, vocab=900):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[1, 15:] = 0
    mask[3, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("type_vocab", [0, 2])
def test_encoder_matches_flax(fused, type_vocab):
    kw = dict(fused_attention=fused, type_vocab_size=type_vocab)
    ids, mask = _ids_mask(0)
    jm = JaxEncoder(JaxEncoderConfig.tiny(**kw), jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), ids, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, ids, mask))
    tm = TransformerEncoderLM(EncoderConfig.tiny(**kw), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params))
    got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_fused_weights_cached_until_parameters_change():
    """Without autograd the fused layer packs and casts its weights once; a
    load_state_dict invalidates the cache and the output follows the new
    weights. With autograd nothing is cached."""
    ids, mask = _ids_mask(7)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    tm = TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True), torch.float32)
    other = TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True), torch.float32)
    for m, seed in ((tm, 0), (other, 1)):
        g = torch.Generator().manual_seed(seed)
        m.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.1 for k, v in m.state_dict().items()})
    with torch.inference_mode():
        first = tm(ids, mask)
        cached = tm.layer_0._fused_cache[1]
        assert tm.layer_0._fused_weights() is cached
        tm.load_state_dict(other.state_dict())
        got = tm(ids, mask)
        assert tm.layer_0._fused_cache[1] is not cached
        want = other(ids, mask)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.allclose(got, first)
    tm.layer_1._fused_cache = None
    tm(ids, mask)
    assert tm.layer_1._fused_cache is None


def _bert_dot_config(**kw):
    return {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
            "in_batch_negatives": True, **kw}


@pytest.mark.parametrize("options", [{}, {"bert_dot_compress_dim": 16},
                                     {"bert_dot_normalize": True, "encoder_fused_attention": True}])
def test_bert_dot_matches_flax(options):
    config = _bert_dot_config(**options)
    q_ids, q_mask = _ids_mask(1, l=12)
    d_ids, d_mask = _ids_mask(2, l=30)
    batch = {"query_ids": q_ids, "query_mask": q_mask, "doc_ids": d_ids, "doc_mask": d_mask}
    jm = JaxBertDot.from_config(config)
    params = jm.init(jax.random.PRNGKey(3), batch)["params"]
    want = jm.apply({"params": params}, batch)
    want_doc = jm.apply({"params": params}, d_ids, d_mask, "doc", method=JaxBertDot.encode)
    tm = BertDot.from_config(config)
    tm.load_state_dict(flax_to_state_dict(params))
    tb = {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = tm(tb)
        got_doc = tm.encode(tb["doc_ids"], tb["doc_mask"], "doc")
    np.testing.assert_allclose(got_doc.numpy(), np.asarray(want_doc), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got["query_vecs"].numpy(), np.asarray(want["query_vecs"]), atol=2e-4, rtol=1e-4)


def test_dual_encoder_matches_flax():
    config = _bert_dot_config(model="bert_dot_dualencoder")
    q_ids, q_mask = _ids_mask(4, l=10)
    d_ids, d_mask = _ids_mask(5, l=20)
    batch = {"query_ids": q_ids, "query_mask": q_mask, "doc_ids": d_ids, "doc_mask": d_mask}
    jm = JaxBertDotDual.from_config(config)
    params = jm.init(jax.random.PRNGKey(4), batch)["params"]
    want = jm.apply({"params": params}, batch)
    tm = BertDotDualEncoder.from_config(config)
    tm.load_state_dict(flax_to_state_dict(params))
    tb = {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        got = tm(tb)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), atol=1e-3, rtol=1e-4)


def test_state_dict_names_follow_flax_paths(tmp_path):
    config = _bert_dot_config()
    jm = JaxBertDot.from_config(config)
    ids, mask = _ids_mask(6)
    batch = {"query_ids": ids, "query_mask": mask, "doc_ids": ids, "doc_mask": mask}
    params = jm.init(jax.random.PRNGKey(5), batch)["params"]
    sd = flax_to_state_dict(params)
    tm = BertDot.from_config(config)
    assert set(sd) == set(tm.state_dict())
    assert set(k.replace("/", ".") for k in flatten_params(params)) == set(sd)
    assert sd["encoder.layer_0.attention.query.kernel"].shape == (64, 64)
    assert sd["encoder.layer_0.attention.query.bias"].shape == (64,)
    assert sd["encoder.layer_1.attention.out.kernel"].shape == (64, 64)
    path = os.path.join(tmp_path, "best-model.npz")
    save_npz(path, sd)
    with np.load(path) as f:
        assert "encoder/layer_0/attention/query/kernel" in f.files
    back = load_npz(path)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_init_params_draws_the_jax_distributions():
    config = _bert_dot_config(bert_pretrained_model="distilbert-tiny-random")
    model = get_model(config, build_tokenizer(config))
    sd = init_params(model, config, torch.Generator().manual_seed(0))
    again = init_params(get_model(config, build_tokenizer(config)), config, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)  # the generator alone decides
    k = sd["encoder.layer_0.mlp_in.kernel"]  # (64, 128), lecun normal, |w| ≤ 2 std
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert abs(float(k.std()) - (1 / 64) ** 0.5) < 0.1 * (1 / 64) ** 0.5
    assert float(k.abs().max()) <= 2 * std + 1e-6
    emb = sd["encoder.word_embeddings.embedding"]
    assert abs(float(emb.std()) - (1 / 64) ** 0.5) < 0.05 * (1 / 64) ** 0.5
    assert float(sd["encoder.layer_0.mlp_in.bias"].abs().max()) == 0.0
    assert float(sd["encoder.embeddings_norm.scale"].min()) == 1.0


@pytest.mark.parametrize("name", ["distilbert-base-uncased", "bert-base-uncased", "tiny", "mini-lm"])
def test_config_from_model_name_matches_jax(name):
    config = {"bert_pretrained_model": name, "encoder_fused_attention": True, "encoder_bf16_norms": True}
    assert dataclasses.asdict(encoder_config_from_model_name(config)) == \
        dataclasses.asdict(jax_cfg_from_name(config))


def test_unported_models_raise():
    tok = build_tokenizer(_bert_dot_config())
    for model in ("knrm", "bert_cat", "maxP->bert_dot"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(_bert_dot_config(model=model), tok)
    # ColBERT serves and trains on the port; listwise dynamic sampling is refused
    _refuse_unported(_bert_dot_config(model="colbert"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _refuse_unported(_bert_dot_config(model="colbert", dynamic_sampler="listwise"))
    # the int8 halves are ported for inference; under autograd they are refused
    enc = TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True, int8_mlp=True))
    ids, mask = _ids_mask(2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))


def test_device_prefetch_keeps_order_and_raises():
    items = [({"a": np.full(3, i, np.int32)}, [f"id{i}"]) for i in range(5)]
    out = list(device_prefetch(iter(items), "cpu"))
    assert [int(b["a"][0]) for b, _ in out] == list(range(5))
    assert isinstance(out[0][0]["a"], torch.Tensor) and out[4][1] == ["id4"]

    def broken():
        yield items[0]
        raise RuntimeError("reader failed")

    with pytest.raises(RuntimeError, match="reader failed"):
        list(device_prefetch(broken(), "cpu"))
