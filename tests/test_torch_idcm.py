"""The port's IDCM against the JAX package on the CPU, at the model zoo's
tiny size (the ``tiny-test`` encoder, f32, queries of 8 and documents of 64
tokens, chunks of 16 with overlap 4: four chunks of 24), from the same flax
parameters (``flax_to_state_dict``, strict), at the BERT_CAT bar of
tests/test_torch_rerankers.py (atol 2e-4, rtol 1e-4): the ``ck``,
``ck-small`` and ``tk`` samplers in the cascade (``sample_n`` 2), the full
path (``sample_n`` -1), the four selection losses, BERT's chunk scores
replayed from ``bert_part_cached``, documents with fewer live chunks than
``sample_n`` (the sentinel ties, which JAX's ``top_k`` breaks by index),
``idcm_inference_only``; one stage-1 step with each passage loss against
JAX's; and the replay caches: the ``Trainer`` writing then replaying
``submodel_train_cache_path`` (the replay never calls ``_bert_chunk_scores``)
and ``evaluate_model`` writing then replaying
``submodel_validation_cache_path``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models import idcm as jidcm
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.config import auto_fill
from matchmaker_tpu_torch.evaluation import evaluate_model
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import get_model, idcm
from matchmaker_tpu_torch.models.weights import flax_to_state_dict
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_eval_step, make_train_step
from matchmaker_tpu_torch.training.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

LQ, LD, VOCAB = 8, 64, 1000
BASE = {"bert_pretrained_model": "tiny-test", "use_fp16": False, "max_query_length": LQ, "max_doc_length": LD,
        "idcm_chunk_size": 16, "idcm_overlap": 4, "idcm_sample_n": 2, "idcm_top_k_chunks": 3}
_PARAMS = {}


def _pair_batch(seed, b=4):
    """Queries (one short) and documents: full, two live chunks, one live
    chunk (fewer than ``sample_n``: the sentinels tie) and empty."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2, VOCAB, size=(b, LQ)).astype(np.int32)
    qm = np.ones((b, LQ), np.float32)
    qm[1, 5:] = 0
    d = rng.integers(2, VOCAB, size=(b, LD)).astype(np.int32)
    dm = np.ones((b, LD), np.float32)
    dm[1, 30:] = 0
    dm[2, 9:] = 0
    dm[3] = 0
    q[qm == 0] = 0
    d[dm == 0] = 0
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


def _models(**kw):
    config = dict(BASE, **kw)
    jm, tm = jidcm.IDCM.from_config(config), idcm.IDCM.from_config(config)
    key = config.get("idcm_sample_context", "ck")
    if key not in _PARAMS:  # the parameters depend on the sampler only
        batch = {k: jnp.asarray(v) for k, v in _pair_batch(0).items()}
        _PARAMS[key] = jax.jit(jm.init)(jax.random.PRNGKey(1), batch)["params"]
    params = _PARAMS[key]
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, tm, params, config


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=2e-4, rtol=1e-4,
                               err_msg=what)


def _compare(batch, want=None, **kw):
    """The port's outputs on ``batch`` against JAX's (``want``, or JAX's
    jitted apply)."""
    jm, tm, params, _ = _models(**kw)
    if want is None:
        want = jax.jit(lambda p, b: jm.apply({"params": p}, b, True))(params, {k: jnp.asarray(v)
                                                                              for k, v in batch.items()})
    with torch.no_grad():
        got = tm(_torch(batch), output_secondary=True)
    assert set(got) == set(want) and set(got["secondary"]) == set(want["secondary"])
    for key in ("score", "passage_scores", "sampling_scores", "selection_loss"):
        if key in want:
            _close(got[key].numpy(), want[key], key)
    for key, value in want["secondary"].items():
        _close(got["secondary"][key].numpy(), value, key)
    return got, want


@pytest.mark.parametrize("context,sample_n", [("ck", 2), ("ck-small", 2), ("tk", 2), ("ck", -1), ("ck", 3)])
def test_idcm_matches_jax(context, sample_n):
    """The cascade with each sampler (``sample_n`` 2 and 3: the document
    with one live chunk ties two and three sentinels) and the full path."""
    got, _ = _compare(_pair_batch(3), idcm_sample_context=context, idcm_sample_n=sample_n)
    assert torch.isfinite(got["score"]).all()
    assert float(got["score"][3]) == 0.0  # an empty document: every chunk at the sentinel


@pytest.mark.parametrize("loss", ["mseloss", "kldivloss", "crossentropy", "lambdaloss"])
def test_idcm_selection_losses_match_jax(loss):
    """Stage 2 (``idcm_train_selection``): BERT on every chunk without
    gradient, each selection loss against JAX's, value and gradient of the
    sampler's parameters."""
    batch = _pair_batch(4)
    kw = dict(idcm_train_selection=True, idcm_sample_train_type=loss)
    jm, tm, params, _ = _models(**kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def selection_loss(p):
        out = jm.apply({"params": p}, jb, True)
        return out["selection_loss"], out

    (_, want), jgrad = jax.jit(jax.value_and_grad(selection_loss, has_aux=True))(params)
    _compare(batch, want, **kw)
    jgrad = flax_to_state_dict(jgrad)
    tm.zero_grad()
    tm(_torch(batch))["selection_loss"].backward()
    for name, p in tm.named_parameters():
        if name.startswith("encoder.") or name.startswith("classification_layer."):
            assert p.grad is None, name  # the target's gradient is stopped
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(g.numpy(), jgrad[name].numpy(), name)


def test_idcm_bert_part_cached_and_inference_only_match_jax():
    """BERT's chunk scores handed in as ``bert_part_cached`` (stage 2's
    replay): scores, selection loss from them; ``idcm_inference_only`` is
    the cascade."""
    batch = _pair_batch(5)
    cached = np.random.default_rng(6).normal(size=(4, 4)).astype(np.float32)
    got, _ = _compare(dict(batch, bert_part_cached=cached), idcm_train_selection=True)
    np.testing.assert_array_equal(got["passage_scores"].numpy(), cached * got["secondary"]["packed_indices"].numpy())
    config = auto_fill(dict(BASE, model="idcm_inference_only"))
    tok = type("Tok", (), {"vocab_size": VOCAB})()
    model = get_model(config, tok)
    assert type(model) is idcm.IDCMInferenceOnly
    _, tm, params, _ = _models()
    model.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(model(_torch(batch))["score"].numpy(), tm(_torch(batch))["score"].numpy())


def test_top_indices_breaks_ties_by_index():
    x = torch.tensor([[1.0, -9000.0, 3.0, -9000.0, -9000.0], [-9000.0] * 5])
    assert idcm.top_indices(x, 3).tolist() == [[2, 0, 1], [0, 1, 2]]
    want = jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]
    np.testing.assert_array_equal(idcm.top_indices(x, 3).numpy(), np.asarray(want))


@pytest.mark.parametrize("loss", ["MSETeacherPointwisePassages", "MarginMSE_InterPassageLoss"])
def test_idcm_stage1_step_matches_jax(loss):
    """Stage 1 (``sample_n`` -1): BERT trained on every chunk by a passage
    loss against teacher passage scores; the loss, the gradient norm and
    every parameter after one step (the BERT_CAT step's bar: rtol 1e-4,
    atol 1e-5)."""
    step_config = {"loss": loss, "lr_schedule": "constant", "optimizer_warmup_steps": 0,
                   "param_group0_learning_rate": 1e-3, "param_group1_learning_rate": 1e-2,
                   "gradient_clip_norm": 5.0, "weight_decay": 0.01, "adam_eps": 1e-4}
    jm, tm, params, _ = _models(idcm_sample_n=-1)
    pos, neg = _pair_batch(7), _pair_batch(8)
    rng = np.random.default_rng(9)
    batch = {"query_ids": pos["query_ids"], "query_mask": pos["query_mask"], "doc_pos_ids": pos["doc_ids"],
             "doc_pos_mask": pos["doc_mask"], "doc_neg_ids": neg["doc_ids"], "doc_neg_mask": neg["doc_mask"],
             "pos_passage_scores": rng.normal(size=(4, 4)).astype(np.float32),
             "neg_passage_scores": rng.normal(size=(4, 4)).astype(np.float32),
             "valid": np.array([1, 1, 1, 0], np.float32)}
    start = flax_to_state_dict(params)
    tx = joptim.build_optimizer(step_config, params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(step_config), tx, step_config)
    new_params, _, jstats = jstep(params, tx.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tm, tdispatch.get_loss(step_config), toptim.build_optimizer(step_config, tm),
                            step_config)
    tstats = tstep(_torch(batch))
    for key in ("loss", "ranking_loss", "grad_norm"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(new_params)
    moved = 0.0
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-3


# ---- the replay caches -----------------------------------------------------------

def _write_data(root):
    rng = np.random.default_rng(9)
    train = os.path.join(root, "train.tsv")
    with open(train, "w") as f:
        for i in range(16):
            pos = " ".join(f"w{rng.integers(40)}" for _ in range(int(rng.integers(8, 40))))
            neg = " ".join(f"n{rng.integers(40)}" for _ in range(int(rng.integers(8, 40))))
            f.write(f"query topic{i % 4}\t{pos}\t{neg}\n")
    tuples = os.path.join(root, "tuples.tsv")
    with open(tuples, "w") as f:
        for q in range(3):
            for d in range(5):
                doc = " ".join(f"w{rng.integers(40)}" for _ in range(int(rng.integers(0, 50))))
                f.write(f"q{q}\td{q}_{d}\tquery topic{q}\t{doc}\n")
    return train, tuples


def _trainer_config(root, train, **kw):
    return auto_fill(dict(BASE, model="idcm", device="cpu", idcm_train_selection=True, batch_size_train=8,
                          batch_size_eval=4, max_doc_length=48, epochs=1, loss="ranknet",
                          param_group0_learning_rate=1e-3, param_group1_learning_rate=1e-3, lr_schedule="constant",
                          optimizer_warmup_steps=0, validate_every_n_batches=-1, random_seed=3,
                          enable_tensorboard=False, train_tsv=train, **kw))


def _count_bert_calls(monkeypatch):
    calls = []
    original = idcm.IDCM._bert_chunk_scores

    def counted(self, *args):
        calls.append(1)
        return original(self, *args)

    monkeypatch.setattr(idcm.IDCM, "_bert_chunk_scores", counted)
    return calls


def test_trainer_writes_then_replays_the_submodel_train_cache(tmp_path, monkeypatch):
    """Run 1 writes IDCM's chunk scores of every train batch (its BERT part
    runs); run 2, the same data and seed, replays them: the BERT part is
    never called, the selection loss is trained on the same scores, and the
    two runs end at the same parameters."""
    train, _ = _write_data(str(tmp_path))
    cache = str(tmp_path / "train_cache")
    calls = _count_bert_calls(monkeypatch)
    runs = []
    for name in ("write", "replay"):
        folder = tmp_path / name
        folder.mkdir()
        calls.clear()
        trainer = Trainer(_trainer_config(str(tmp_path), train, submodel_train_cache_path=cache), str(folder))
        trainer.train()
        assert trainer.global_step == 2
        runs.append((len(calls), {k: v.clone() for k, v in trainer.model.state_dict().items()}))
        assert os.path.exists(os.path.join(cache, "cache-meta.json"))
    (written_calls, written), (replayed_calls, replayed) = runs
    assert written_calls == 4 and replayed_calls == 0  # two passes a step while writing, none in the replay
    for name, value in written.items():
        np.testing.assert_allclose(replayed[name].numpy(), value.numpy(), atol=1e-6, err_msg=name)


def test_evaluate_model_writes_then_replays_the_validation_cache(tmp_path, monkeypatch):
    """``submodel_validation_cache_path``: the first pass writes each
    batch's chunk scores, the second replays them without the BERT part
    and gives the same scores."""
    train, tuples = _write_data(str(tmp_path))
    config = _trainer_config(str(tmp_path), train, submodel_validation_cache_path=str(tmp_path / "val_cache"))
    trainer = Trainer(config, str(tmp_path))
    trainer.model.eval()
    step = make_eval_step(trainer.model)
    calls = _count_bert_calls(monkeypatch)
    first = evaluate_model(step, config, trainer.tokenizer, tuples, torch.device("cpu"))
    assert len(calls) == 4  # 15 pairs, batches of 4
    calls.clear()
    second = evaluate_model(step, config, trainer.tokenizer, tuples, torch.device("cpu"))
    assert not calls and first.keys() == second.keys()
    for qid in first:
        assert [d for d, _ in first[qid]] == [d for d, _ in second[qid]]
        np.testing.assert_allclose([s for _, s in second[qid]], [s for _, s in first[qid]], atol=1e-6)
