"""The port's transformer re-rankers against the JAX package on the CPU:
BERT_CAT, PreTTR, PARADE (tf and max), the maxP / meanP chunk adapters, the
small transformer of modules/transformer.py and modules/pooling.py, from
the same numpy inputs and the same flax parameters (``flax_to_state_dict``),
f32 at atol 2e-4 / rtol 1e-4 (the encoder tests' bar); one BERT_CAT ranknet
step at the training parity bar; and the cross-encoder path end to end on
the CPU: the Trainer with secondary outputs and a warm start, teacher
scoring, and a Margin-MSE student on the teacher's file."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models.adapters import ChunkPoolAdapter as JaxChunkPoolAdapter
from matchmaker_tpu.models.bert_cat import BertCat as JaxBertCat
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.parade import Parade as JaxParade
from matchmaker_tpu.models.prettr import PreTTR as JaxPreTTR
from matchmaker_tpu.modules import pooling as jpooling
from matchmaker_tpu.modules.transformer import TransformerEncoder as JaxTransformerEncoder
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.cli.score_teacher import score_triples
from matchmaker_tpu_torch.config import auto_fill
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import example_batch, get_model
from matchmaker_tpu_torch.models.adapters import ChunkPoolAdapter
from matchmaker_tpu_torch.models.bert_cat import BertCat
from matchmaker_tpu_torch.models.encoder import EncoderConfig
from matchmaker_tpu_torch.models.parade import Parade
from matchmaker_tpu_torch.models.prettr import PreTTR
from matchmaker_tpu_torch.models.weights import flatten_params, flax_to_state_dict, init_parameters
from matchmaker_tpu_torch.modules import pooling as tpooling
from matchmaker_tpu_torch.modules.transformer import TransformerEncoder
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_eval_step, make_train_step
from matchmaker_tpu_torch.training.trainer import Trainer
from tests.make_tiny_dataset import make_tiny_dataset

TINY = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=128)
LQ, LD, CHUNK, OVERLAP = 8, 24, 8, 2


def _ids_mask(rng, b, l, short=(), empty=()):
    ids = rng.integers(2, 1000, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    for row in short:
        mask[row, l // 3:] = 0
    for row in empty:
        mask[row] = 0
    ids[mask == 0] = 0
    return ids, mask


def _pair_batch(seed, b=3, empty_doc=False):
    """An independent (query, doc) batch: a short query, a short document
    and, with ``empty_doc``, a document with no live token."""
    rng = np.random.default_rng(seed)
    q, qm = _ids_mask(rng, b, LQ, short=(1,))
    d, dm = _ids_mask(rng, b, LD, short=(2,), empty=(1,) if empty_doc else ())
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm}


def _concatenated(batch):
    """[query ‖ doc] with type id 1 on the document's live tokens."""
    return {"seq_ids": np.concatenate([batch["query_ids"], batch["doc_ids"]], axis=1),
            "seq_mask": np.concatenate([batch["query_mask"], batch["doc_mask"]], axis=1),
            "seq_type_ids": np.concatenate([np.zeros_like(batch["query_ids"]),
                                            (batch["doc_mask"] > 0).astype(np.int32)], axis=1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}


def _models(name, fused=False, type_vocab=0):
    """(JAX model, port model, concatenated input) of a re-ranker at the tiny size."""
    jcfg = JaxEncoderConfig(**TINY, type_vocab_size=type_vocab, fused_attention=fused)
    tcfg = EncoderConfig(**TINY, type_vocab_size=type_vocab, fused_attention=fused)
    f32 = dict(compute_dtype=jnp.float32)
    if name == "bert_cat":
        return JaxBertCat(jcfg, **f32), BertCat(tcfg, torch.float32), True
    if name == "prettr":
        return JaxPreTTR(jcfg, join_layer_idx=1, **f32), PreTTR(tcfg, 1, torch.float32), False
    if name.startswith("parade"):
        agg = name.split("-")[1]
        return (JaxParade(jcfg, aggregate_type=agg, aggregate_layers=2, chunk_size=CHUNK, overlap=OVERLAP, **f32),
                Parade(tcfg, agg, 2, CHUNK, OVERLAP, torch.float32), False)
    pool = name.split("->")[0].lower()[:-1]
    jinner, tinner = JaxBertCat(jcfg, **f32), BertCat(tcfg, torch.float32)
    return (JaxChunkPoolAdapter(inner=jinner, inner_input="concatenated", chunk_size=CHUNK, overlap=OVERLAP,
                                pool=pool),
            ChunkPoolAdapter(tinner, "concatenated", CHUNK, OVERLAP, pool), False)


@pytest.mark.parametrize("name,fused,type_vocab", [
    ("bert_cat", False, 2), ("bert_cat", True, 0), ("prettr", False, 0), ("prettr", True, 2),
    ("parade-tf", False, 0), ("parade-max", False, 0), ("maxP->bert_cat", False, 2), ("meanP->bert_cat", False, 0)])
def test_reranker_matches_jax(name, fused, type_vocab):
    """Scores and secondary outputs from the same flax parameters (a strict
    load: the port's parameter set is JAX's). PARADE and the adapters get a
    document with no live token: PARADE-max's score is not finite there, as
    JAX's is not (the max over no chunk is -inf)."""
    jm, tm, concatenated = _models(name, fused, type_vocab)
    pairs = _pair_batch(0, empty_doc=not concatenated and name != "prettr")
    batch = _concatenated(pairs) if concatenated else pairs
    params = jm.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()}, True)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = tm(_torch_batch(batch), output_secondary=True)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), atol=2e-4, rtol=1e-4)
    assert set(got["secondary"]) == set(want["secondary"])
    for key, value in want["secondary"].items():
        np.testing.assert_allclose(got["secondary"][key].float().numpy(), np.asarray(value, np.float32),
                                   atol=2e-4, rtol=1e-4, err_msg=key)
    if name == "parade-max":
        assert not np.isfinite(got["score"][1].item())
    else:
        assert np.isfinite(got["score"].numpy()).all()


def test_adapter_passage_scores_and_chunk_encode_match_jax():
    """maxP's per-chunk scores (empty chunks 0) and the chunk-wise encode of
    a bi-encoder inner model (maxP->bert_dot) against JAX's."""
    from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
    from matchmaker_tpu_torch.models.bert_dot import BertDot

    jm, tm, _ = _models("maxP->bert_cat")
    batch = _pair_batch(2, empty_doc=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jm.init(jax.random.PRNGKey(2), jb)["params"]
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        got = tm.passage_scores(_torch_batch(batch))
    want = jm.apply({"params": params}, jb, method=JaxChunkPoolAdapter.passage_scores)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    assert (got.numpy()[1] == 0).all()

    jcfg, tcfg = JaxEncoderConfig(**TINY), EncoderConfig(**TINY)
    jdot = JaxChunkPoolAdapter(inner=JaxBertDot(encoder_cfg=jcfg, compute_dtype=jnp.float32), chunk_size=CHUNK,
                               overlap=OVERLAP)
    tdot = ChunkPoolAdapter(BertDot(tcfg, compute_dtype=torch.float32), "independent", CHUNK, OVERLAP)
    params = jdot.init(jax.random.PRNGKey(3), jb)["params"]
    tdot.load_state_dict(flax_to_state_dict(params), strict=True)
    for seq_type, ids, mask in (("doc", "doc_ids", "doc_mask"), ("query", "query_ids", "query_mask")):
        want = jdot.apply({"params": params}, jb[ids], jb[mask], seq_type, method=JaxChunkPoolAdapter.encode)
        with torch.inference_mode():
            got = tdot.encode(_torch_batch(batch)[ids], _torch_batch(batch)[mask], seq_type)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4, err_msg=seq_type)


def test_transformer_module_matches_flax_with_a_fully_masked_row():
    """modules/transformer.py against flax: separate projections with
    biases, LayerNorm epsilon 1e-6, ReLU; a row whose keys are all masked
    attends uniformly (finite) in both."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[1, 2:] = 0
    mask[2] = 0
    jm = JaxTransformerEncoder(num_layers=2, dim=32, num_heads=4, ff_dim=64)
    params = jm.init(jax.random.PRNGKey(5), x, mask)["params"]
    want = np.asarray(jm.apply({"params": params}, x, mask))
    tm = TransformerEncoder(2, 32, 4, 64)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("fn", ["masked_softmax", "topk_values", "adaptive_max_pool_2d", "sliding_window_max",
                                "sliding_window_mean", "unfold_chunks"])
def test_pooling_matches_jax(fn):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 11, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 11, 3)) > 0.3).astype(np.float32)
    calls = {
        "masked_softmax": lambda m, a: m.masked_softmax(a(x), a(mask), 1),
        "topk_values": lambda m, a: m.topk_values(a(x), 4, 1),
        "adaptive_max_pool_2d": lambda m, a: m.adaptive_max_pool_2d(a(x[..., None].repeat(2, -1)), (3, 2)),
        "sliding_window_max": lambda m, a: m.sliding_window_max(a(x), 3, 2),
        "sliding_window_mean": lambda m, a: m.sliding_window_mean(a(x), 4),
        "unfold_chunks": lambda m, a: m.unfold_chunks(a(x), 4, 2),
    }
    want = np.asarray(calls[fn](jpooling, jnp.asarray))
    got = calls[fn](tpooling, torch.from_numpy).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_weights_map_the_new_parameters():
    """The aggregator's DenseGeneral kernels are stored (out, in); the port's
    initialisers cover every parameter of the re-rankers (agg_cls normal
    with std 0.02)."""
    jm, tm, _ = _models("parade-tf")
    batch = _pair_batch(7)
    params = jm.init(jax.random.PRNGKey(8), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    flat = flatten_params(params)
    sd = flax_to_state_dict(params)
    q = flat["aggregator/layer_0/self_attention/query/kernel"]  # (D, h, d)
    np.testing.assert_array_equal(sd["aggregator.layer_0.self_attention.query.kernel"].numpy(),
                                  q.reshape(32, -1).T)
    o = flat["aggregator/layer_1/self_attention/out/kernel"]  # (h, d, D)
    np.testing.assert_array_equal(sd["aggregator.layer_1.self_attention.out.kernel"].numpy(), o.reshape(-1, 32).T)
    assert sd["score_reduction.kernel"].shape == (32, 1) and sd["agg_cls"].shape == (1, 1, 32)
    init_parameters(tm, torch.Generator().manual_seed(0))
    assert 0.01 < float(tm.agg_cls.detach().std()) < 0.04 and float(tm.score_reduction.bias.detach().abs().max()) == 0.0
    for name in ("bert_cat", "prettr", "maxP->bert_cat"):
        init_parameters(_models(name)[1], torch.Generator().manual_seed(0))


def test_factory_builds_the_rerankers_and_their_example_batches():
    tok = type("Tok", (), {"vocab_size": 900})()
    base = {"bert_pretrained_model": "tiny-random", "use_fp16": False, "max_query_length": LQ,
            "max_doc_length": LD}
    for model, cls in (("bert_cat", BertCat), ("prettr", PreTTR), ("parade", Parade),
                       ("maxP->bert_cat", ChunkPoolAdapter), ("meanP->bert_cat", ChunkPoolAdapter)):
        config = auto_fill(dict(base, model=model))
        m = get_model(config, tok)
        assert type(m) is cls
        shapes = {k: v.shape for k, v in example_batch(config).items()}
        want = {"seq_ids": (2, LQ + LD)} if model == "bert_cat" else {"query_ids": (2, LQ), "doc_ids": (2, LD)}
        assert all(shapes[k] == s for k, s in want.items())
    assert get_model(auto_fill(dict(base, model="meanP->bert_cat")), tok).pool == "mean"
    # the QA heads are ported since the model-zoo slice
    qa = get_model(auto_fill(dict(base, model="bert_cat", train_qa_spans=True)), tok)
    assert type(qa) is BertCat and qa.qa_head and tuple(qa.mtl_log_vars.shape) == (3,)
    assert tuple(qa.qa_span_layer.kernel.shape) == (qa.encoder_cfg.hidden_size, 2)
    with pytest.raises(NotImplementedError, match="not a dense encoder"):
        BertCat(EncoderConfig(**TINY)).encode(torch.zeros(1, 4, dtype=torch.long), torch.ones(1, 4))


def test_bert_cat_ranknet_step_matches_jax():
    """Two ranknet steps of a tiny f32 BERT_CAT on concatenated triples from
    the same parameters, each through two passes (pos, neg): loss and
    grad_norm rtol 1e-4, parameters atol 1e-5 (the BERT_DOT step's bar)."""
    config = {"model": "bert_cat", "use_fp16": False, "loss": "ranknet", "param_group0_learning_rate": 1e-3,
              "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 1, "max_training_steps": 10,
              "lr_schedule": "cosine", "gradient_clip_norm": 5.0, "weight_decay": 0.01, "adam_eps": 1e-4}
    jm, tm, _ = _models("bert_cat", type_vocab=2)
    batches = []
    for seed in range(2):
        pos, neg = _concatenated(_pair_batch(10 + seed)), _concatenated(_pair_batch(20 + seed))
        batches.append({"pos_ids": pos["seq_ids"], "pos_mask": pos["seq_mask"], "pos_type_ids": pos["seq_type_ids"],
                        "neg_ids": neg["seq_ids"], "neg_mask": neg["seq_mask"],
                        "neg_type_ids": neg["seq_type_ids"], "valid": np.array([1, 0, 1], np.float32)})
    params = jm.init(jax.random.PRNGKey(9), {"seq_ids": batches[0]["pos_ids"], "seq_mask": batches[0]["pos_mask"],
                                             "seq_type_ids": batches[0]["pos_type_ids"]})["params"]
    start = flax_to_state_dict(params)
    tm.load_state_dict(start)
    tx = joptim.build_optimizer(config, params)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    tstep = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)
    for batch in batches:
        params, opt_state, jstats = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        tstats = tstep({k: torch.from_numpy(v).long() if "ids" in k else torch.from_numpy(v)
                        for k, v in batch.items()})
        for key in ("loss", "grad_norm", "ranking_loss"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(params)
    moved = 0.0
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-3


# ---- the cross-encoder path end to end on the CPU -----------------------------

@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    return make_tiny_dataset(str(tmp_path_factory.mktemp("rerank_tiny")))


def _rerank_config(paths, model, **kw):
    return auto_fill({
        "model": model, "bert_pretrained_model": "tiny-random", "use_fp16": False, "encoder_fused_attention": True,
        "loss": "ranknet", "batch_size_train": 8, "batch_size_eval": 16, "max_query_length": 8,
        "max_doc_length": 24, "epochs": 1, "param_group0_learning_rate": 1e-4, "param_group1_learning_rate": 1e-3,
        "optimizer_warmup_steps": 2, "max_training_steps": 100, "validate_every_n_batches": 3,
        "max_training_batches": 3, "random_seed": 3, "device": "cpu", "train_tsv": paths["train_tsv"],
        "enable_tensorboard": False, "idcm_chunk_size": CHUNK, "idcm_overlap": OVERLAP,
        "prettr_join_layer_idx": 1,
        "validation_cont": {"tsv": paths["val_tsv"], "qrels": paths["qrels"], "binarization_point": 1},
        "test": {"tiny": {"tsv": paths["val_tsv"], "qrels": paths["qrels"], "binarization_point": 1,
                          "save_secondary_output": True}},
        **kw})


def _train(config, folder):
    trainer = Trainer(config, str(folder))
    trainer.train()
    return trainer


@pytest.fixture(scope="module")
def bert_cat_run(tiny_data, tmp_path_factory):
    """(Trainer, run folder) of a BERT_CAT trained for three steps with
    secondary outputs on: the run checked below and the teacher scored
    after it."""
    folder = tmp_path_factory.mktemp("bert_cat_run")
    return _train(_rerank_config(tiny_data, "bert_cat"), folder), folder


@pytest.mark.parametrize("model", ["bert_cat", "prettr", "parade", "maxP->bert_cat"])
def test_trainer_runs_the_rerankers_with_secondary_outputs(tiny_data, tmp_path, model, request):
    """Three steps through the Trainer, validation and the test pass by
    re-ranking, the secondary outputs of each query's top pairs saved with
    the model's small parameters."""
    if model == "bert_cat":
        trainer, tmp_path = request.getfixturevalue("bert_cat_run")
    else:
        trainer = _train(_rerank_config(tiny_data, model), tmp_path)
    assert trainer.global_step == 3
    for rel in ("validation-metrics-cont.csv", "best-model.npz", "test-tiny-output.txt", "test-tiny-metrics.csv",
                "test-tiny-secondary.npz"):
        assert os.path.isfile(tmp_path / rel), rel
    with np.load(tmp_path / "test-tiny-secondary.npz") as f:
        pairs = {k.split("::")[0] for k in f.files if not k.startswith("model::")}
        assert all("<->" in p for p in pairs) and (model == "prettr") == (not pairs)  # PreTTR's secondary is empty
        if model == "bert_cat":
            assert all(f[f"{p}::cls_vector"].shape == (64,) for p in pairs)
            assert "model::score_layer/kernel" in f.files


def test_teacher_scores_feed_a_margin_mse_student(tiny_data, tmp_path, bert_cat_run):
    """The BERT_CAT trained through the Trainer scores the training triples
    (score_triples, its config handed over: no YAML), the 5-column file
    equals the teacher's eval-step scores of the same pairs, and a BERT_DOT
    student trains with Margin-MSE on it; then the teacher's weights
    warm-start a second run (warmstart_model_path)."""
    teacher, teacher_folder = bert_cat_run
    teacher_config = _rerank_config(tiny_data, "bert_cat", test=None)
    for folder in ("student", "warm"):
        os.makedirs(tmp_path / folder)
    out = str(tmp_path / "scores.tsv")
    n = score_triples(str(teacher_folder), tiny_data["train_tsv"], out, batch_size=16, config=teacher_config,
                      device="cpu")
    with open(tiny_data["train_tsv"]) as f:
        triples = [line.rstrip("\n").split("\t") for line in f]
    with open(out) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert n == len(triples) == len(rows) and all(r[2:] == t for r, t in zip(rows, triples))
    tok = teacher.tokenizer
    step = make_eval_step(teacher.model)
    for row in rows[:5]:
        for col, doc in ((0, row[3]), (1, row[4])):
            ids, mask, types = tok.encode_pair(row[2], doc, 8, 24)
            want = step({"seq_ids": torch.from_numpy(ids[None]).long(), "seq_mask": torch.from_numpy(mask[None]),
                         "seq_type_ids": torch.from_numpy(types[None]).long()})["score"]
            assert float(row[col]) == pytest.approx(float(want[0]), rel=1e-5, abs=1e-5)

    student_config = _rerank_config(tiny_data, "bert_dot", loss="margin-mse", train_pairwise_distillation=True,
                                    train_tsv=out, test=None)
    student = Trainer(student_config, str(tmp_path / "student"))
    losses = []
    step_fn = student.train_step

    def recording_step(batch):
        stats = step_fn(batch)
        losses.append(float(stats["loss"]))
        return stats

    student.train_step = recording_step
    student.train()
    assert student.global_step == 3 and len(losses) == 3 and np.isfinite(losses).all()

    warm = Trainer(dict(teacher_config, warmstart_model_path=str(teacher_folder / "best-model.npz")),
                   str(tmp_path / "warm"))
    for name, p in warm.model.state_dict().items():
        assert torch.equal(p, teacher.model.state_dict()[name]), name


def test_entry_points_default_to_the_card(tiny_data, tmp_path):
    """Without a ``device`` key the Trainer, teacher scoring and dense
    retrieval go to ``cuda``: here, without a card, they fail instead of
    running on the CPU."""
    from matchmaker_tpu_torch.cli import dense_retrieval

    config = _rerank_config(tiny_data, "bert_cat")
    del config["device"]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        Trainer(config, str(tmp_path))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        score_triples(str(tmp_path), tiny_data["train_tsv"], str(tmp_path / "s.tsv"), config=config)
    retrieval = dict(config, model="bert_dot", collection_tsv=tiny_data["train_tsv"])
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        dense_retrieval.run("encode+index+search", retrieval, str(tmp_path / "dense"))
    assert not (tmp_path / "dense").exists()
