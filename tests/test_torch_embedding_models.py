"""The port's vocabulary-embedding models against the JAX package on the
CPU: KNRM, Conv-KNRM, TK (diff posencoding and hybrid mixing each on and
off) and TK-Sparse (TKL: tests/test_torch_tkl.py, with these helpers), each
built by both packages' ``from_config`` from one config at the model zoo's
tiny size (tests/test_model_zoo.py: vocabulary 200, dim 32, 4 heads, FF 32,
queries of 8 and documents of 64 tokens) and loaded from JAX-initialised
parameters through ``flax_to_state_dict`` (strict). Scores and secondary
outputs at rtol = atol = 1e-5 on a batch with padded queries and documents
and an empty document; one ``make_train_step`` step (ranknet; TK-Sparse
with its sparsity loss) against JAX's: the loss and every parameter after
the step at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models import conv_knrm as jconv_knrm
from matchmaker_tpu.models import knrm as jknrm
from matchmaker_tpu.models import tk as jtk
from matchmaker_tpu.models import tk_sparse as jtk_sparse
from matchmaker_tpu.models import tkl as jtkl
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import conv_knrm, knrm, tk, tk_sparse, tkl
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, init_parameters
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, LQ, LD = 200, 8, 64
BASE = {"_vocab_size": VOCAB, "token_embedding_size": 32, "tk_att_heads": 4, "tk_att_ff_dim": 32,
        "max_query_length": LQ, "max_doc_length": LD, "tkl_chunk_size": 16, "tkl_overlap": 4,
        "tkl_sliding_window_size": 8, "conv_knrm_conv_out_dim": 16}
MODELS = {
    "knrm": (jknrm.KNRM, knrm.KNRM, {}),
    "conv_knrm": (jconv_knrm.ConvKNRM, conv_knrm.ConvKNRM, {}),
    "tk": (jtk.TK, tk.TK, {}),
    "tk-same_positions": (jtk.TK, tk.TK, {"tk_use_diff_posencoding": False}),
    "tk-no_hybrid": (jtk.TK, tk.TK, {"tk_mix_hybrid_context": False}),
    "tk-neither": (jtk.TK, tk.TK, {"tk_use_diff_posencoding": False, "tk_mix_hybrid_context": False}),
    "tk_sparse": (jtk_sparse.TKSparse, tk_sparse.TKSparse, {}),
    "tkl-log": (jtkl.TKL, tkl.TKL, {"tkl_saturation": "log"}),
    "tkl-idf": (jtkl.TKL, tkl.TKL, {"tkl_saturation": "idf"}),
    "tkl-embedding": (jtkl.TKL, tkl.TKL, {"tkl_saturation": "embedding"}),
}
# Adam's first update is lr·g/(|g| + eps): with a small eps it is lr·sign(g),
# which turns rounding noise in a gradient that is zero in exact arithmetic
# (the pairwise loss's gradient cancels wherever the positive and the
# negative pass move alike, as the exact-match kernel's weight does) into a
# full step. eps 1e-2 keeps the update proportional to the gradient, so the
# parameters after the step compare the gradients.
STEP_CONFIG = {"loss": "ranknet", "lr_schedule": "constant", "optimizer_warmup_steps": 0,
               "param_group0_learning_rate": 1e-3, "param_group1_learning_rate": 1e-3,
               "embedding_optimizer_learning_rate": 1e-3, "gradient_clip_norm": 5.0, "weight_decay": 0.01,
               "adam_eps": 1e-2}
_PARAMS = {}
_APPLY = {}


def _ids_mask(rng, b, length, short=(), empty=()):
    ids = rng.integers(2, VOCAB, size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.float32)
    for row in short:
        mask[row, length // 3:] = 0
    for row in empty:
        mask[row] = 0
    ids[mask == 0] = 0
    return ids, mask


def _pair_batch(seed, b=3):
    """A (query, doc) batch: a short query, a short and an empty document,
    query idfs, a document token repeating a query token (an exact match)."""
    rng = np.random.default_rng(seed)
    q, qm = _ids_mask(rng, b, LQ, short=(1,))
    d, dm = _ids_mask(rng, b, LD, short=(2,), empty=(1,))
    d[0, 5] = q[0, 2]
    idfs = rng.uniform(0.0, 5.0, size=(b, LQ)).astype(np.float32) * qm
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm, "query_idfs": idfs}


def _triple_batch(seed, b=3, full_docs=False):
    pos, neg = _pair_batch(seed, b), _pair_batch(seed + 100, b)
    if full_docs:
        for side in (pos, neg):
            side["doc_mask"][:] = 1.0
            side["doc_ids"][side["doc_ids"] == 0] = 5
    return {"query_ids": pos["query_ids"], "query_mask": pos["query_mask"], "query_idfs": pos["query_idfs"],
            "doc_pos_ids": pos["doc_ids"], "doc_pos_mask": pos["doc_mask"], "doc_neg_ids": neg["doc_ids"],
            "doc_neg_mask": neg["doc_mask"], "valid": np.array([1, 1, 0], np.float32)[:b]}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


def _models(name):
    """(JAX model, port model, JAX parameters): the parameters from a
    jitted init (eager flax init of TKL takes seconds), kept for the file,
    as each model's jitted apply is: the suite runs six files at a time,
    and every JAX compile there takes cores from the others."""
    jcls, tcls, extra = MODELS[name]
    config = dict(BASE, **extra)
    jm, tm = jcls.from_config(config, None), tcls.from_config(config, None)
    if name not in _PARAMS:
        batch = {k: jnp.asarray(v) for k, v in _pair_batch(0).items()}
        _PARAMS[name] = jax.jit(jm.init)(jax.random.PRNGKey(1), batch)["params"]
    params = _PARAMS[name]
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, tm, params


def compare_outputs(name, batch):
    """The port's scores, secondary outputs and sparsity against JAX's on
    ``batch`` at 1e-5, NaN where JAX's are NaN; whether JAX's scores are
    all finite."""
    jm, tm, params = _models(name)
    if name not in _APPLY:  # one compile a model for every batch of its shapes
        _APPLY[name] = jax.jit(lambda p, b: jm.apply({"params": p}, b, True))
    want = _APPLY[name](params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm(_torch(batch), output_secondary=True)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-5, atol=1e-5)
    assert set(got["secondary"]) == set(want["secondary"])
    for key, value in want["secondary"].items():
        g, w = got["secondary"][key].numpy(), np.asarray(value)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=key)
    if "sparsity" in want:
        np.testing.assert_allclose(got["sparsity"].numpy(), np.asarray(want["sparsity"]), rtol=1e-5, atol=1e-5)
    init_parameters(tm, torch.Generator().manual_seed(0))  # the port's initialisers cover every parameter
    return bool(np.isfinite(np.asarray(want["score"])).all())


@pytest.mark.parametrize("name", ["knrm", "conv_knrm", "tk", "tk-same_positions", "tk-no_hybrid", "tk-neither",
                                  "tk_sparse"])
def test_model_matches_jax(name):
    """Scores and every secondary output from the same flax parameters."""
    assert compare_outputs(name, _pair_batch(3))


def compare_train_step(name, full_docs=False):
    """One ranknet step from the same parameters (TK-Sparse with the
    sparsity loss at weight 0.4): the loss and its parts, then every
    parameter after the update at 1e-5; the step moved the parameters."""
    jm, tm, params = _models(name)
    config = dict(STEP_CONFIG, minimize_sparsity_weight=0.4 if name == "tk_sparse" else 0.0)
    batch = _triple_batch(5, full_docs=full_docs)
    start = flax_to_state_dict(params)
    tx = joptim.build_optimizer(config, params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    params, _, jstats = jstep(params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)
    tstats = tstep(_torch(batch))
    keys = ("loss", "ranking_loss", "grad_norm") + (("sparsity_loss",) if name == "tk_sparse" else ())
    assert set(keys) <= set(tstats) and set(keys) <= set(jstats)
    for key in keys:
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    want = flax_to_state_dict(params)
    moved = 0.0
    for pname, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[pname].numpy(), rtol=1e-5, atol=1e-5, err_msg=pname)
        moved = max(moved, float((p - start[pname]).abs().max()))
    assert moved > 1e-4


@pytest.mark.parametrize("name", ["knrm", "conv_knrm", "tk", "tk-neither", "tk_sparse"])
def test_train_step_matches_jax(name):
    compare_train_step(name)


def test_reanimate_gate_bias_and_the_factory():
    """``reanimate_gate_bias`` raises TK-Sparse's gate bias as JAX's does;
    ``get_model`` builds each vocabulary model with a table sized to the
    tokenizer's vocabulary and the pretrained matrix in it."""
    from matchmaker_tpu_torch.data.tokenization import Vocabulary, VocabTokenizer
    from matchmaker_tpu_torch.models import get_model, init_params

    jm, tm, params = _models("tk_sparse")
    want = jtk_sparse.reanimate_gate_bias(params, 0.25)["stop_word_reducer2"]["bias"]
    tk_sparse.reanimate_gate_bias(tm, 0.25)
    np.testing.assert_array_equal(tm.stop_word_reducer2.bias.detach().numpy(), np.asarray(want))

    tok = VocabTokenizer(Vocabulary([f"w{i}" for i in range(40)]))
    for name, cls in (("knrm", knrm.KNRM), ("conv_knrm", conv_knrm.ConvKNRM), ("tk", tk.TK), ("tkl", tkl.TKL),
                      ("tk_sparse", tk_sparse.TKSparse)):
        config = dict(BASE, model=name, token_embedder_type="embedding")
        model = get_model(config, tok)
        assert type(model) is cls
        init_params(model, config, torch.Generator().manual_seed(0))
        assert model.embedder.token_embedding.embedding.shape == (42, 32)
