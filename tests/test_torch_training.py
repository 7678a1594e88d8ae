"""The port's training runtime against the JAX package on the CPU: losses,
the optimizer chain, the train step, and the trainer end to end.

The same numpy inputs and the same initial parameters (``flax_to_state_dict``)
go to both packages; tolerances are stated per test."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from matchmaker_tpu_torch.experiment import EarlyStopping, read_best_info, save_best_info
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models.bert_dot import BertDot
from matchmaker_tpu_torch.models.weights import flatten_params, flax_to_state_dict, load_npz
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.parallel.multihost import maybe_initialize_distributed
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.train_step import make_train_step
from matchmaker_tpu_torch.training.trainer import Trainer
from tests.make_tiny_dataset import make_tiny_dataset
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

PAIRWISE = sorted(jdispatch._PAIRWISE)
PASSAGE = ("MSETeacherPointwisePassages", "MarginMSE_InterPassageLoss")


def _loss_inputs(name, seed):
    rng = np.random.default_rng(seed)
    shape = (6, 4) if name in PASSAGE else (6,)
    arrs = [rng.normal(size=shape).astype(np.float32) * 3 for _ in range(2)]
    teacher = [np.abs(rng.normal(size=shape)).astype(np.float32) for _ in range(2)]
    if name in PASSAGE:
        teacher[0][0, 1] = 0.0  # a masked (zero) teacher entry
    valid = np.array([1, 1, 1, 1, 0, 1], np.float32)
    return arrs + teacher + [valid]


@pytest.mark.parametrize("name", PAIRWISE)
def test_pairwise_loss_matches_jax(name):
    """Value and gradients w.r.t. the student scores; rtol 1e-5."""
    args = _loss_inputs(name, PAIRWISE.index(name))
    jloss = jdispatch._PAIRWISE[name]
    want = float(jloss(*map(jnp.asarray, args)))
    want_g = jax.grad(lambda p, n: jloss(p, n, *map(jnp.asarray, args[2:])), argnums=(0, 1))(
        jnp.asarray(args[0]), jnp.asarray(args[1]))
    pos, neg = (torch.from_numpy(a).requires_grad_() for a in args[:2])
    got = tdispatch._PAIRWISE[name](pos, neg, *map(torch.from_numpy, args[2:]))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5, atol=1e-6)
    for t, g in zip((pos, neg), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss,ib", [("margin-mse", "margin-mse"), ("ranknet", "ranknet"),
                                     ("MarginMSE_InterPassageLoss", None), ("margin-mse", "KLDivTeacherList"),
                                     ("ranknet", "listnet")])
def test_get_loss_dispatch_matches_jax(loss, ib):
    config = {"loss": loss, "in_batch_negatives": ib is not None, "in_batch_neg_loss": ib}
    jb, tb = jdispatch.get_loss(config), tdispatch.get_loss(config)
    assert tb.ranking_loss.__name__ == jb.ranking_loss.__name__
    assert (tb.inbatch_loss is None) == (jb.inbatch_loss is None)
    if ib:
        assert tb.inbatch_loss.__name__ == jb.inbatch_loss.__name__
    assert (tb.use_list_loss, tb.use_inbatch_list_loss, tb.is_passage_loss) == \
        (jb.use_list_loss, jb.use_inbatch_list_loss, jb.is_passage_loss)


def test_merge_loss_matches_jax():
    parts = [np.float32(1.5), np.float32(0.25), np.float32(3.0)]
    log_vars = np.array([0.1, -0.4, 0.7], np.float32)
    want, want_w = jdispatch.merge_loss([jnp.asarray(p) for p in parts], jnp.asarray(log_vars))
    got, got_w = tdispatch.merge_loss([torch.tensor(p) for p in parts], torch.from_numpy(log_vars))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose([float(w) for w in got_w], [float(w) for w in want_w], rtol=1e-5, atol=1e-7)


def test_unported_losses_raise():
    # the top-level listwise losses and the QA loss are ported since the model-zoo slice
    for config in ({"loss": "listnet"}, {"loss": "mrr"}, {"loss": "lambdarank"},
                   {"loss": "margin-mse", "train_qa_spans": True, "qa_loss": "StartEndCrossEntropy"}):
        jb, tb = jdispatch.get_loss(config), tdispatch.get_loss(config)
        assert (tb.use_list_loss, tb.qa_loss is None) == (jb.use_list_loss, jb.qa_loss is None)
    with pytest.raises(ValueError, match="not known"):
        tdispatch.get_loss({"loss": "no-such-loss"})


# ---- optimizer ---------------------------------------------------------------

_OPT_TREE = {
    "encoder": {"layer_0": {"kernel": (6, 5), "bias": (5,)}, "word_embeddings": {"embedding": (7, 6)}},
    "compressor": {"kernel": (6, 3), "bias": (3,)},
    "token_embedding": {"embedding": (9, 4)},
}

OPT_CONFIGS = {
    "cosine_warmup_clip_wd": dict(lr_schedule="cosine", optimizer_warmup_steps=2, max_training_steps=6,
                                  gradient_clip_norm=1.5, weight_decay=0.01),
    "constant_no_warmup": dict(lr_schedule="constant", optimizer_warmup_steps=0),
    "constant_warmup_group1_names": dict(lr_schedule="constant", optimizer_warmup_steps=3, weight_decay=0.1,
                                         param_group1_names=["layer_0"]),
    "cosine_no_warmup_clip_inactive": dict(lr_schedule="cosine", optimizer_warmup_steps=0, max_training_steps=4,
                                           gradient_clip_norm=1e6),
}


@pytest.mark.parametrize("name", sorted(OPT_CONFIGS))
def test_optimizer_matches_optax_chain(name):
    """Five steps of the port's optimizer on fixed gradients against the
    JAX package's optax chain (groups, schedules from the pre-step count,
    clipping, weight decay); atol 1e-6. The learning rates are a few 1e-3:
    optax takes Adam's bias correction 1 - 0.999**t in f32, 1.3e-5 off in
    relative terms at t = 1, where PyTorch computes it in f64, so parameters
    part by about 1e-5 of the learning rate a step."""
    config = {"param_group0_learning_rate": 0.002, "param_group1_learning_rate": 0.005,
              "embedding_optimizer_learning_rate": 0.003, **OPT_CONFIGS[name]}
    rng = np.random.default_rng(sorted(OPT_CONFIGS).index(name))
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in flatten_shapes(_OPT_TREE).items()}
    jparams = unflatten({p: jnp.asarray(a) for p, a in init.items()})
    tx = joptim.build_optimizer(config, jparams)
    state = tx.init(jparams)
    tparams = {p: torch.nn.Parameter(torch.from_numpy(a.copy())) for p, a in init.items()}
    opt = toptim.Optimizer([(p.replace("/", "."), t) for p, t in tparams.items()], config)
    assert {g["label"] for g in opt.adamw.param_groups} == {"embedding", "encoder", "head"}
    for _ in range(5):
        grads = {p: rng.normal(size=a.shape).astype(np.float32) * 2 for p, a in init.items()}
        updates, state = tx.update(unflatten({p: jnp.asarray(g) for p, g in grads.items()}), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, t in tparams.items():
            t.grad = torch.from_numpy(grads[p])
        opt.step()
    for p, want in flatten_params(jparams).items():
        np.testing.assert_allclose(tparams[p].detach().numpy(), np.asarray(want), atol=1e-6, err_msg=p)
        assert np.abs(np.asarray(want) - init[p]).max() > 1e-3  # every group moved


def flatten_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten_shapes(v, path) if isinstance(v, dict) else {path: v})
    return out


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def test_optimizer_labels_and_warmup_step_zero():
    """Word embeddings under an encoder tower are "encoder" (only a
    token_embedding path is "embedding"); a warmup's first step has lr 0."""
    assert toptim.label_for("encoder.word_embeddings.embedding", {}) == "encoder"
    assert toptim.label_for("query_encoder.layer_0.mlp_in.kernel", {}) == "encoder"
    assert toptim.label_for("token_embedding.embedding", {}) == "embedding"
    assert toptim.label_for("compressor.kernel", {}) == "head"
    assert toptim.label_for("encoder.layer_0.mlp_in.kernel", {"param_group1_names": ["mlp_in"]}) == "head"
    sched = toptim.schedule(1e-3, 10, 100, "cosine")
    assert sched(0) == 0.0 and sched(5) == pytest.approx(5e-4) and sched(100) == pytest.approx(1e-5)
    # gradient accumulation (optax.MultiSteps, k = 2): the first micro-step leaves the weights, the second moves them
    lin = torch.nn.Linear(2, 2)
    opt = toptim.build_optimizer({"gradient_accumulation_steps": 2, "optimizer_warmup_steps": 0,
                                  "lr_schedule": "constant"}, lin)
    start = lin.weight.detach().clone()
    for moved in (False, True):
        opt.zero_grad()
        lin(torch.ones(1, 2)).sum().backward()
        assert opt.step() is moved and torch.equal(lin.weight, start) is not moved
    assert (opt.count, opt.mini_step) == (1, 0)


# ---- train step parity ---------------------------------------------------------

def _triple_batch(seed, b=4, lq=8, ld=24, vocab=900):
    rng = np.random.default_rng(seed)

    def ids_mask(l, short_row):
        ids = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
        mask = np.ones((b, l), np.float32)
        mask[short_row, l // 2:] = 0
        ids[mask == 0] = 0
        return ids, mask

    q, qm = ids_mask(lq, 1)
    p, pm = ids_mask(ld, 2)
    n, nm = ids_mask(ld, 0)
    return {"query_ids": q, "query_mask": qm, "doc_pos_ids": p, "doc_pos_mask": pm, "doc_neg_ids": n,
            "doc_neg_mask": nm, "pos_score": rng.uniform(5, 10, b).astype(np.float32),
            "neg_score": rng.uniform(0, 5, b).astype(np.float32), "valid": np.array([1, 1, 1, 0], np.float32)}


@pytest.mark.parametrize("fused", [False, True])
def test_train_steps_match_jax(fused):
    """Three Margin-MSE + in-batch-negative steps of a tiny f32 BERT_DOT from
    the same parameters: loss and grad_norm rtol 1e-4, parameters atol 1e-5.
    adam_eps is 1e-4: the key-bias gradients are zero in exact arithmetic
    (each softmax row's gradient sums to zero), and with a tiny eps Adam
    would blow their rounding noise, which differs between the frameworks,
    up to full learning-rate steps of either sign."""
    config = {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
              "encoder_fused_attention": fused, "loss": "margin-mse", "in_batch_negatives": True,
              "in_batch_neg_loss": "margin-mse", "param_group0_learning_rate": 1e-3,
              "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 1, "max_training_steps": 10,
              "lr_schedule": "cosine", "gradient_clip_norm": 5.0, "weight_decay": 0.01, "adam_eps": 1e-4}
    batches = [_triple_batch(s) for s in range(3)]
    jm = JaxBertDot.from_config(config)
    params = jm.init(jax.random.PRNGKey(0), {"query_ids": batches[0]["query_ids"],
                                             "query_mask": batches[0]["query_mask"],
                                             "doc_ids": batches[0]["doc_pos_ids"],
                                             "doc_mask": batches[0]["doc_pos_mask"]})["params"]
    tm = BertDot.from_config(config)
    start = flax_to_state_dict(params)
    tm.load_state_dict(start)
    tx = joptim.build_optimizer(config, params)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    tstep = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)
    for batch in batches:
        params, opt_state, jstats = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        tstats = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "ranking_loss", "inbatch_loss"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(params)
    moved = 0.0
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-3


# ---- trainer -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scored(tmp_path_factory):
    """The planted-relevance tiny dataset with teacher scores on its triples."""
    out = tmp_path_factory.mktemp("tiny_scored")
    paths = make_tiny_dataset(str(out))
    rng = random.Random(0)
    scored = os.path.join(str(out), "train_scored.tsv")
    with open(paths["train_tsv"]) as f, open(scored, "w") as g:
        for line in f:
            q, p, n = line.rstrip("\n").split("\t")
            g.write(f"{rng.uniform(5, 10):.3f}\t{rng.uniform(0, 5):.3f}\t{q}\t{p}\t{n}\n")
    return dict(paths, scored=scored)


def _trainer_config(paths, **kw):
    return {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
            "encoder_fused_attention": True, "loss": "margin-mse", "train_pairwise_distillation": True,
            "in_batch_negatives": True, "in_batch_neg_loss": "margin-mse", "batch_size_train": 8,
            "batch_size_eval": 16, "max_query_length": 8, "max_doc_length": 24, "epochs": 1,
            "param_group0_learning_rate": 1e-4, "param_group1_learning_rate": 1e-3, "optimizer_warmup_steps": 2,
            "max_training_steps": 100, "validate_every_n_batches": 5, "random_seed": 3, "device": "cpu",
            "train_tsv": paths["scored"], "enable_tensorboard": False, "gradient_clip_norm": 1.0,
            "validation_cont": {"tsv": paths["val_tsv"], "qrels": paths["qrels"], "binarization_point": 1},
            **kw}


def test_trainer_end_to_end_feeds_dense_retrieval(tiny_scored, tmp_path):
    """cli.train's Trainer on the CPU: validation, best checkpoint, test pass,
    and the port's dense retrieval on the saved best-model.npz."""
    run = str(tmp_path / "run")
    os.makedirs(run)
    config = _trainer_config(
        tiny_scored, test={"tiny": {"tsv": tiny_scored["val_tsv"], "qrels": tiny_scored["qrels"]}},
        run_dense_retrieval_eval=True, collection_tsv=tiny_scored["collection"], faiss_index_type="flat",
        query_sets={"dev": {"queries_tsv": tiny_scored["queries"], "qrels": tiny_scored["qrels"], "top_n": 10}})
    _build.reset_launches()
    trainer = Trainer(config, run)
    trainer.train()
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU tensors: plain versions only
    assert trainer.global_step == 15  # 120 triples / 8
    for name in ("validation-metrics-cont.csv", "best-model.npz", "best-info.csv", "efficiency-metrics.json",
                 "test-tiny-output.txt", "test-tiny-metrics.csv", "dense-retrieval/dev-output.txt",
                 "dense-retrieval/dev-metrics.csv"):
        assert os.path.isfile(os.path.join(run, name)), name
    with open(os.path.join(run, "validation-metrics-cont.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 3 + 1  # header, steps 5/10/15, epoch end
    metric, value, _, step = read_best_info(run)
    assert metric == "MRR@10" and 0.0 < value <= 1.0 and step in (5, 10, 15)
    best = load_npz(os.path.join(run, "best-model.npz"))
    assert set(best) == set(trainer.model.state_dict())
    with open(os.path.join(run, "dense-retrieval", "dev-output.txt")) as f:
        assert len({line.split()[0] for line in f}) == 12  # every validation query searched


def test_trainer_loss_csv_every_100_steps(tiny_scored, tmp_path):
    run = str(tmp_path / "run")
    os.makedirs(run)
    config = _trainer_config(tiny_scored, epochs=7, validate_every_n_batches=-1, validation_cont=None,
                             max_training_batches=100)
    trainer = Trainer(config, run)
    trainer.train()
    assert trainer.global_step == 100
    with open(os.path.join(run, "training-loss.csv")) as f:
        rows = f.read().strip().splitlines()
    assert rows[0].split(",")[:2] == ["epoch", "step"] and "grad_norm" in rows[0] and "inbatch_loss" in rows[0]
    assert len(rows) == 2 and rows[1].split(",")[1] == "100"


def test_trainer_resume_continues_exactly(tiny_scored, tmp_path):
    """4 steps straight equal 2 steps, a train-state save, a new Trainer's
    resume (model, optimizer, step and data cursor) and 2 more steps."""
    straight = str(tmp_path / "straight")
    split = str(tmp_path / "split")
    os.makedirs(straight)
    os.makedirs(split)
    base = dict(validate_every_n_batches=-1, validation_cont=None, save_train_state=True)
    t0 = Trainer(_trainer_config(tiny_scored, max_training_batches=4, **base), straight)
    t0.train()
    t1 = Trainer(_trainer_config(tiny_scored, max_training_batches=2, **base), split)
    t1.train()
    t2 = Trainer(_trainer_config(tiny_scored, max_training_batches=4, **base), split)
    assert t2.resume_from_train_state()
    assert (t2.global_step, t2._epoch, t2._epoch_batch, t2.optimizer.count) == (2, 0, 2, 2)
    t2.train()
    assert t2.global_step == 4
    want = t0.model.state_dict()
    for name, p in t2.model.state_dict().items():
        torch.testing.assert_close(p, want[name], atol=0, rtol=0, msg=name)


def test_unported_trainer_options_raise(tiny_scored, tmp_path, monkeypatch):
    # a JAX checkpoint as the warm start is read (a missing one is a missing file, not a refusal)
    with pytest.raises(FileNotFoundError, match="model.flax"):
        Trainer(_trainer_config(tiny_scored, warmstart_model_path="model.flax"), str(tmp_path))
    # listwise dynamic sampling is ported since the model-zoo slice (tests/test_torch_listwise.py trains with it)
    Trainer(_trainer_config(tiny_scored, dynamic_sampler="listwise", loss="listnet"), str(tmp_path))
    # gradient accumulation and hub teachers are ported (tests/test_torch_jax_runs.py trains with both)
    assert Trainer(_trainer_config(tiny_scored, gradient_accumulation_steps=4), str(tmp_path)).optimizer.accumulate == 4
    # the sparsity loss and the submodel train cache are ported (the kernel-pooling slice)
    assert callable(make_train_step(None, tdispatch.get_loss({"loss": "margin-mse"}), None,
                                    {"minimize_sparsity_weight": 0.1, "submodel_train_cache_path": "cache"}))
    # multi-process launches are ported (tests/test_torch_multiprocess.py): the launch
    # variables alone join no group (the CLIs join it), so the Trainer runs as one process
    monkeypatch.setenv("MATCHMAKER_COORDINATOR", "localhost:1234")
    assert Trainer(_trainer_config(tiny_scored), str(tmp_path)).n_processes == 1
    monkeypatch.setenv("MATCHMAKER_MULTIHOST", "tpu_pod")  # a TPU pod's launch means nothing on a GPU machine
    with pytest.raises(ValueError, match="tpu_pod"):
        maybe_initialize_distributed()


def test_early_stopping_and_best_info(tmp_path):
    es = EarlyStopping(patience=1, mode="max")
    assert [es.step(v) for v in (0.3, 0.5, 0.4, 0.45)] == [False, False, False, True]
    assert EarlyStopping().step(float("nan"))
    save_best_info(str(tmp_path), "MRR@10", 0.42, 1, 300)
    assert read_best_info(str(tmp_path)) == ("MRR@10", 0.42, 1, 300)
