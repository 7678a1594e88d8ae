"""The contextual token embedders of the port against the JAX package on
the CPU.

``bert_vectors``: TK and KNRM over a tiny f32 transformer's vectors
(``ContextualVectorsAdapter``), both factories building from one config,
the port loaded from JAX-initialised parameters (strict): scores at rtol =
atol = 1e-5, then one ranknet step frozen (``train_embedding: false``: no
gradient reaches the encoder, its parameters move only by the weight
decay, as under JAX's ``stop_gradient``) and trainable, every parameter
after the step at 1e-5 (TK, the model the card runs over it).

``bert_embedding``: JAX's ``get_model`` raises "Model not known" (its
branch overwrites the model's name with the checkpoint's, ROADMAP.md §3);
the port builds KNRM and TK with the local checkpoint's word-embedding
table as their table and its width as theirs, the table equal to the
checkpoint's after ``init_params``, and scores as JAX's KNRM built with
that table as ``pretrained`` (what the JAX branch means to build)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models import get_model as jax_get_model
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.models.bert_vectors import ContextualVectorsAdapter
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_loss_fn, make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, LQ, LD = 1000, 8, 24
TOK = type("Tok", (), {"vocab_size": VOCAB})()
BASE = {"bert_pretrained_model": "tiny-random", "use_fp16": False, "max_query_length": LQ, "max_doc_length": LD,
        "tk_att_heads": 4, "tk_att_ff_dim": 32, "loss": "ranknet", "lr_schedule": "constant",
        "optimizer_warmup_steps": 0, "param_group0_learning_rate": 1e-3, "param_group1_learning_rate": 1e-3,
        "embedding_optimizer_learning_rate": 1e-3, "gradient_clip_norm": 5.0, "weight_decay": 0.01,
        "adam_eps": 1e-2}
_PARAMS = {}


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)

    def ids_mask(length, short):
        ids = rng.integers(2, VOCAB, size=(b, length)).astype(np.int32)
        mask = np.ones((b, length), np.float32)
        mask[short, length // 3:] = 0
        ids[mask == 0] = 0
        return ids, mask

    q, qm = ids_mask(LQ, 1)
    p, pm = ids_mask(LD, 2)
    n, nm = ids_mask(LD, 0)
    p[0, 3] = q[0, 1]
    return {"query_ids": q, "query_mask": qm, "doc_pos_ids": p, "doc_pos_mask": pm, "doc_neg_ids": n,
            "doc_neg_mask": nm, "valid": np.array([1, 1, 0], np.float32)[:b]}


def _pair(batch):
    return {"query_ids": batch["query_ids"], "query_mask": batch["query_mask"], "doc_ids": batch["doc_pos_ids"],
            "doc_mask": batch["doc_pos_mask"]}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


def _vectors_models(model, trainable):
    config = dict(BASE, model=model, token_embedder_type="bert_vectors", train_embedding=trainable)
    jm, tm = jax_get_model(config, TOK), get_model(config, TOK)
    if model not in _PARAMS:
        _PARAMS[model] = jax.jit(jm.init)(jax.random.PRNGKey(1), {k: jnp.asarray(v)
                                                                  for k, v in _pair(_batch(0)).items()})["params"]
    tm.load_state_dict(flax_to_state_dict(_PARAMS[model]), strict=True)
    return config, jm, tm, _PARAMS[model]


@pytest.mark.parametrize("model", ["tk", "knrm"])
def test_bert_vectors_scores_match_jax(model):
    config, jm, tm, params = _vectors_models(model, False)
    assert isinstance(tm, ContextualVectorsAdapter) and not hasattr(tm.inner, "embedder")
    assert tm.encoder_cfg.hidden_size == 64 and "encoder.word_embeddings.embedding" in tm.state_dict()
    batch = _pair(_batch(3))
    want = jax.jit(lambda p, b: jm.apply({"params": p}, b, True))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm(_torch(batch), output_secondary=True)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-5, atol=1e-5)
    for key, value in want["secondary"].items():
        np.testing.assert_allclose(got["secondary"][key].numpy(), np.asarray(value), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("model", ["tk"])
def test_bert_vectors_train_step_matches_jax(model, trainable):
    """One ranknet step: the loss, its gradient norm and every parameter
    after the update at 1e-5. Frozen, the backward leaves every encoder
    parameter without a gradient and the step moves it by the decay alone;
    trainable, the encoder's parameters get gradients and move."""
    config, jm, tm, params = _vectors_models(model, trainable)
    batch = _batch(5)
    start = flax_to_state_dict(params)
    loss_fn = make_loss_fn(tm, tdispatch.get_loss(config), config)
    loss_fn(_torch(batch))[0].backward()
    encoder_grads = [p.grad for n, p in tm.named_parameters() if n.startswith("encoder.")]
    assert all((g is None) != trainable for g in encoder_grads)
    tm.zero_grad(set_to_none=True)
    tx = joptim.build_optimizer(config, params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    new_params, _, jstats = jstep(params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    tstats = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)(
        _torch(batch))
    for key in ("loss", "ranking_loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    want = flax_to_state_dict(new_params)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    emb = "encoder.word_embeddings.embedding"
    decayed = start[emb] * (1.0 - 1e-3 * 0.01)
    assert torch.allclose(tm.state_dict()[emb], decayed, atol=1e-9) != trainable


def test_bert_vectors_needs_score_embeddings():
    for factory in (jax_get_model, get_model):
        with pytest.raises(ValueError, match="score_embeddings"):
            factory(dict(BASE, model="conv_knrm", token_embedder_type="bert_vectors"), TOK)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from matchmaker_tpu_torch.models import hf_import
    from matchmaker_tpu_torch.models.encoder import EncoderConfig

    path = str(tmp_path_factory.mktemp("ckpt"))
    config, sd = hf_import.seeded_distilbert_checkpoint(EncoderConfig.tiny(vocab_size=300, hidden_size=48), seed=5)
    hf_import.save_hf_checkpoint(path, config, sd, True)
    return path, sd["embeddings.word_embeddings.weight"]


@pytest.mark.parametrize("model", ["knrm", "tk"])
def test_bert_embedding_jax_raises_and_the_port_builds(checkpoint, model):
    from matchmaker_tpu.models.knrm import KNRM as JaxKNRM

    path, table = checkpoint
    tok = type("Tok", (), {"vocab_size": 300})()
    config = dict(BASE, model=model, token_embedder_type="bert_embedding", bert_pretrained_model=path,
                  tk_att_heads=4)
    with pytest.raises(ValueError, match="Model not known"):
        jax_get_model(config, tok)
    tm = get_model(config, tok)
    init_params(tm, config, torch.Generator().manual_seed(0))
    torch.testing.assert_close(tm.embedder.token_embedding.embedding.detach(), table, atol=0, rtol=0)
    if model == "knrm":
        jm = JaxKNRM.from_config(dict(config, _vocab_size=300, token_embedding_size=48), table.numpy())
        batch = _pair(_batch(6))
        for k in ("query_ids", "doc_ids"):
            batch[k] = batch[k] % 300
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jm.init(jax.random.PRNGKey(2), jb)["params"]
        np.testing.assert_array_equal(np.asarray(params["embedder"]["token_embedding"]["embedding"]), table.numpy())
        tm.load_state_dict(flax_to_state_dict(params), strict=True)
        with torch.no_grad():
            got = tm(_torch(batch))["score"]
        np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply({"params": params}, jb)["score"]), rtol=1e-5,
                                   atol=1e-5)


def test_a_checkpoint_directory_without_a_vocabulary_takes_the_hash_tokenizer(checkpoint, monkeypatch):
    """``build_tokenizer`` on a checkpoint directory with no vocabulary file
    gives the hash tokenizer sized to the checkpoint's vocabulary, even
    where ``transformers`` would build a tokenizer of the five special
    tokens there (as the card machine's does: every word [UNK])."""
    from matchmaker_tpu_torch.data import tokenization

    path, table = checkpoint

    class SpecialTokensOnly:
        vocab_size = 5

        def __init__(self, name):
            pass

    monkeypatch.setattr(tokenization, "HuggingfaceTokenizer", SpecialTokensOnly)
    tok = tokenization.build_tokenizer({"token_embedder_type": "bert_embedding", "bert_pretrained_model": path})
    assert isinstance(tok, tokenization.HashBertTokenizer) and tok.vocab_size == table.shape[0] == 300
    assert isinstance(tokenization.build_tokenizer({"bert_pretrained_model": "some-hub-name"}), SpecialTokensOnly)
