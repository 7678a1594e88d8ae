"""The port's classic interaction models against the JAX package on the CPU:
PACRR, CO-PACRR, DRMM, MatchPyramid and Duet, each built by both packages'
``from_config`` from one config at the model zoo's tiny size
(tests/test_model_zoo.py: vocabulary 200, dim 32, queries of 8 and
documents of 64 tokens, MatchPyramid's two 8-channel layers pooled to 6 x
20 and 3 x 10) and loaded from JAX-initialised parameters through
``flax_to_state_dict`` (strict). Scores and secondary outputs at rtol =
atol = 1e-5 (tests/test_model_zoo.py:157's tolerance) on a batch with a
short query, a short and an empty document, query idfs and an exact match;
one ranknet step against JAX's ``make_train_step``: the loss, the gradient
norm and every parameter after the update at 1e-5. DRMM's histogram bins
equal JAX's except where a cosine lies within 1e-6 of a bin edge, and an
exact match (cosine 1.0) in the last bin. The factory builds each model,
``maxP->pacrr`` and ``maxP->duet`` (held to JAX's adapter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models import drmm as jdrmm
from matchmaker_tpu.models import duet as jduet
from matchmaker_tpu.models import get_model as jax_get_model
from matchmaker_tpu.models import matchpyramid as jmatchpyramid
from matchmaker_tpu.models import pacrr as jpacrr
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import drmm, duet, get_model, matchpyramid, pacrr
from matchmaker_tpu_torch.models.adapters import ChunkPoolAdapter
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, init_parameters
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

VOCAB, LQ, LD = 200, 8, 64
BASE = {"_vocab_size": VOCAB, "token_embedding_size": 32, "max_query_length": LQ, "max_doc_length": LD,
        "match_pyramid_conv_output_size": [8, 8], "match_pyramid_conv_kernel_size": [[3, 3], [3, 3]],
        "match_pyramid_adaptive_pooling_size": [[6, 20], [3, 10]], "drmm_bins": 30}
MODELS = {
    "pacrr": (jpacrr.PACRR, pacrr.PACRR),
    "co_pacrr": (jpacrr.CoPACRR, pacrr.CoPACRR),
    "drmm": (jdrmm.DRMM, drmm.DRMM),
    "matchpyramid": (jmatchpyramid.MatchPyramid, matchpyramid.MatchPyramid),
    "duet": (jduet.Duet, duet.Duet),
}
STEP_CONFIG = {"loss": "ranknet", "lr_schedule": "constant", "optimizer_warmup_steps": 0,
               "param_group0_learning_rate": 1e-3, "param_group1_learning_rate": 1e-3,
               "embedding_optimizer_learning_rate": 1e-3, "gradient_clip_norm": 5.0, "weight_decay": 0.01,
               "adam_eps": 1e-2}
# Duet's score starts near 0 (its combination kernels start U(0, 0.01)),
# so its gradients are small: Adam's eps 1e-8 makes the step lr-sized
STEP_EXTRA = {"duet": {"adam_eps": 1e-8}}
_PARAMS = {}


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
    rng = np.random.default_rng(seed)
    q, qm = _ids_mask(rng, b, LQ, short=(1,))
    d, dm = _ids_mask(rng, b, LD, short=(2,), empty=(1,))
    d[0, 5] = q[0, 2]  # an exact match
    idfs = rng.uniform(0.0, 5.0, size=(b, LQ)).astype(np.float32) * qm
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm, "query_idfs": idfs}


def _triple_batch(seed, b=3):
    pos, neg = _pair_batch(seed, b), _pair_batch(seed + 100, b)
    return {"query_ids": pos["query_ids"], "query_mask": pos["query_mask"], "query_idfs": pos["query_idfs"],
            "doc_pos_ids": pos["doc_ids"], "doc_pos_mask": pos["doc_mask"], "doc_neg_ids": neg["doc_ids"],
            "doc_neg_mask": neg["doc_mask"], "valid": np.array([1, 1, 0], np.float32)[:b]}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _models(name):
    """(JAX model, port model, JAX parameters from a jitted init, kept for the file)."""
    jcls, tcls = MODELS[name]
    jm, tm = jcls.from_config(BASE, None), tcls.from_config(BASE, None)
    if name not in _PARAMS:
        _PARAMS[name] = jax.jit(jm.init)(jax.random.PRNGKey(1), _jax(_pair_batch(0)))["params"]
    tm.load_state_dict(flax_to_state_dict(_PARAMS[name]), strict=True)
    return jm, tm, _PARAMS[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    """Scores and every secondary output from the same flax parameters; the
    port's initialisers cover every parameter."""
    jm, tm, params = _models(name)
    batch = _pair_batch(3)
    want = jax.jit(lambda p, b: jm.apply({"params": p}, b, True))(params, _jax(batch))
    with torch.no_grad():
        got = tm(_torch(batch), output_secondary=True)
    assert np.isfinite(np.asarray(want["score"])).all()
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-5, atol=1e-5)
    assert set(got["secondary"]) == set(want["secondary"])
    for key, value in want["secondary"].items():
        np.testing.assert_allclose(got["secondary"][key].numpy(), np.asarray(value), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    init_parameters(tm, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_matches_jax(name):
    """One ranknet step from the same parameters: the loss, its gradient
    norm and every parameter after the update (so every gradient) at 1e-5;
    the step moved the parameters."""
    jm, tm, params = _models(name)
    batch = _triple_batch(5)
    start = flax_to_state_dict(params)
    config = dict(STEP_CONFIG, **STEP_EXTRA.get(name, {}))
    tx = joptim.build_optimizer(config, params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    new_params, _, jstats = jstep(params, tx.init(params), _jax(batch))
    tstep = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)
    tstats = tstep(_torch(batch))
    for key in ("loss", "ranking_loss", "grad_norm", "score_pos_mean", "score_neg_mean"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    want = flax_to_state_dict(new_params)
    moved = 0.0
    for pname, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[pname].numpy(), rtol=1e-5, atol=1e-5, err_msg=pname)
        moved = max(moved, float((p - start[pname]).abs().max()))
    assert moved > 1e-4


def _bins_off_edges(match, bins):
    """Bin of each cosine and whether it lies within 1e-6 of a bin edge."""
    scaled = (np.asarray(match, np.float64) + 1.0) * bins / 2.0
    return np.abs(scaled - np.round(scaled)) > 1e-6


def test_drmm_histograms_equal_off_the_bin_edges():
    """The port's histogram against JAX's on the same embeddings: each
    cosine's bin equal except within 1e-6 of an edge (none here at the
    exact match, which both put in the last bin), counts over the live
    document terms only."""
    jm, tm, params = _models("drmm")
    batch = _pair_batch(7)
    emb = np.asarray(params["embedder"]["token_embedding"]["embedding"])
    q = emb[batch["query_ids"]] * batch["query_mask"][..., None]
    d = emb[batch["doc_ids"]] * batch["doc_mask"][..., None]
    d[0, 5] = q[0, 2]
    from matchmaker_tpu.ops.kernel_pooling import cosine_match_matrix as jcos
    from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix as tcos

    jmatch = np.asarray(jcos(jnp.asarray(q), jnp.asarray(d)))
    tmatch = tcos(torch.from_numpy(q), torch.from_numpy(d))
    want_bins = np.clip(np.floor((jmatch + 1.0) * 15.0).astype(np.int64), 0, 29)
    got_bins = drmm.histogram_bins(tmatch, 30).numpy()
    # compared: every cosine off an edge, and those the two packages compute
    # equal (the padded positions' exact 0 sits on an edge)
    compared = _bins_off_edges(jmatch, 30) | (jmatch == tmatch.numpy())
    assert compared.mean() > 0.99
    np.testing.assert_array_equal(got_bins[compared], want_bins[compared])
    assert got_bins[0, 2, 5] == 29 and abs(float(tmatch[0, 2, 5]) - 1.0) < 1e-6
    want_hist = np.asarray(jm.apply({"params": params}, jnp.asarray(jmatch), jnp.asarray(batch["doc_mask"]),
                                    method=jm._histogram))
    got_hist = tm.histogram(tmatch, torch.from_numpy(batch["doc_mask"])).numpy()
    moved = np.abs(got_hist - want_hist).sum()
    assert moved <= 2 * (~compared).sum()
    assert got_hist[1].sum() == 0  # the empty document counts nothing


@pytest.mark.parametrize("model", sorted(MODELS) + ["maxP->pacrr", "maxP->duet"])
def test_factory_builds_the_classic_models(model):
    """``get_model`` builds each model (a chunk adapter around PACRR and
    Duet, Duet's widths from the chunk length) over a vocabulary tokenizer,
    the token table sized to it; the adapters score as JAX's do from the
    same parameters."""
    tok = type("Tok", (), {"vocab_size": VOCAB})()
    config = dict(BASE, model=model, token_embedder_type="embedding", idcm_chunk_size=16, idcm_overlap=4,
                  model_input_type="independent")
    m = get_model(config, tok)
    inner = m.inner if isinstance(m, ChunkPoolAdapter) else m
    assert type(inner) is MODELS[model.split("->")[-1]][1]
    assert inner.embedder.token_embedding.embedding.shape == (VOCAB, 32)
    if "->" in model:
        jm = jax_get_model(config, tok)
        params = jax.jit(jm.init)(jax.random.PRNGKey(2), _jax(_pair_batch(0)))["params"]
        m.load_state_dict(flax_to_state_dict(params), strict=True)
        batch = _pair_batch(4)
        batch["doc_mask"][0, 40:] = 0
        want = jax.jit(lambda p, b: jm.apply({"params": p}, b))(params, _jax(batch))["score"]
        with torch.no_grad():
            got = m(_torch(batch))["score"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
