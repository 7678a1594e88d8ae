"""The port's listwise losses against the JAX package's on the CPU: each
loss's value and its gradient with respect to the student's scores, from the
same seeded numpy slates with padded entries, and the dispatch of the
in-batch listwise names. JAX's own tolerance for these losses: rtol 1e-5.

Listwise training (``dynamic_sampler: listwise``): the list sampler's
batches equal JAX's for the same seed; two list-batch steps of a tiny f32
BERT_DOT under each top-level listwise loss (``listnet``, ``lambdarank``,
``mrr``) against JAX's ``make_train_step`` at the tolerance of
tests/test_torch_training.py::test_train_steps_match_jax (loss, stats and
gradient norm rtol 1e-4, every parameter after the steps atol 1e-5); a
list batch refused without a listwise loss; the ``Trainer`` on the CPU
with the list sampler."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.losses import listwise as jlw
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.losses import listwise as tlw
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _slate(seed, b=5, n=7, graded=False):
    rng = np.random.default_rng(seed)
    pred = (rng.normal(size=(b, n)) * 3).astype(np.float32)
    if graded:
        labels = rng.integers(0, 4, size=(b, n)).astype(np.float32)
        labels[:, 0] = 3.0
    else:
        labels = (rng.normal(size=(b, n)) * 2).astype(np.float32)
    valid = np.ones((b, n), np.float32)
    valid[1, 5:] = 0.0
    valid[3, 2] = 0.0
    return pred, labels, valid


_CASES = {
    "listnet": (jlw.listnet, tlw.listnet, False),
    "kldiv_teacher_list": (jlw.kldiv_teacher_list, tlw.kldiv_teacher_list, False),
    "smooth_mrr": (jlw.smooth_mrr, tlw.smooth_mrr, True),
    "soft_cross_entropy": (jlw.soft_cross_entropy, tlw.soft_cross_entropy, False),
    "lambda_loss_teacher": (jlw.lambda_loss_teacher, tlw.lambda_loss_teacher, False),
}
for _scheme in ("ndcgLoss1", "ndcgLoss2", "lambdaRank", "ndcgLoss2PP", "rankNet"):
    _CASES[f"lambda_loss-{_scheme}"] = (
        lambda p, t, v, s=_scheme: jlw.lambda_loss(p, t, v, scheme=s),
        lambda p, t, v, s=_scheme: tlw.lambda_loss(p, t, v, scheme=s), True)
_CASES["lambda_loss-mean-k3"] = (lambda p, t, v: jlw.lambda_loss(p, t, v, k=3, reduction="mean"),
                                 lambda p, t, v: tlw.lambda_loss(p, t, v, k=3, reduction="mean"), True)


def _soft_target(labels, valid):
    t = np.exp(labels) * valid
    return (t / t.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_listwise_loss_and_gradient_match_jax(name, masked):
    jfn, tfn, graded = _CASES[name]
    pred, labels, valid = _slate(len(name) + masked, graded=graded)
    if name == "soft_cross_entropy":
        labels = _soft_target(labels, valid)
    v = valid if masked else None
    want, want_g = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(labels), None if v is None else jnp.asarray(v)))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tfn(p, torch.from_numpy(labels), None if v is None else torch.from_numpy(v))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ib", ["KLDivTeacherList", "listnet", "lambdarank"])
def test_inbatch_listwise_dispatch_matches_jax(ib):
    """The in-batch listwise names build the bundle JAX builds, and the
    bundle's loss gives JAX's value on a B x 2B matrix against a teacher
    matrix."""
    config = {"loss": "margin-mse", "in_batch_negatives": True, "in_batch_neg_loss": ib}
    jb, tb = jdispatch.get_loss(config), tdispatch.get_loss(config)
    assert (tb.use_list_loss, tb.use_inbatch_list_loss) == (jb.use_list_loss, jb.use_inbatch_list_loss) == \
        (False, True)
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(4, 8)).astype(np.float32) * 2
    teacher = rng.normal(size=(4, 8)).astype(np.float32) * 4
    valid = np.ones((4, 8), np.float32)
    valid[2] = 0.0
    want = float(jb.inbatch_loss(jnp.asarray(scores), jnp.asarray(teacher), jnp.asarray(valid)))
    got = float(tb.inbatch_loss(*map(torch.from_numpy, (scores, teacher, valid))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_smooth_rank_matches_jax():
    pred, _, _ = _slate(9)
    np.testing.assert_allclose(tlw.smooth_rank(torch.from_numpy(pred)).numpy(),
                               np.asarray(jlw.smooth_rank(jnp.asarray(pred))), rtol=1e-5)


# ---- listwise training: the list sampler and the list-batch step ---------------

@pytest.fixture(scope="module")
def list_data(tmp_path_factory):
    """The tiny dataset with a candidate run: each validation query's own
    documents in file order."""
    from tests.make_tiny_dataset import make_tiny_dataset

    out = str(tmp_path_factory.mktemp("list_data"))
    paths = make_tiny_dataset(out)
    run = os.path.join(out, "candidates.txt")
    with open(paths["val_tsv"]) as f, open(run, "w") as g:
        rank = {}
        for line in f:
            qid, did = line.split("\t")[:2]
            rank[qid] = rank.get(qid, 0) + 1
            g.write(f"{qid} {did} {rank[qid]} {1.0 / rank[qid]}\n")
    return dict(paths, candidates=run)


def _samplers(paths, list_size=6, qpb=3, seed=3):
    from matchmaker_tpu.data.list_sampler import ListwiseDynamicSampler as JaxSampler
    from matchmaker_tpu_torch.data.list_sampler import ListwiseDynamicSampler

    kw = dict(collection_file=paths["collection"], query_file=paths["queries"], qrels_file=paths["qrels"],
              candidate_file=paths["candidates"], list_size=list_size, queries_per_batch=qpb, seed=seed)
    return JaxSampler(**kw), ListwiseDynamicSampler(**kw)


def _list_config(paths, **kw):
    # the dataset's vocabulary tokenizer (ids below the tiny encoder's 1,000)
    return {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
            "token_embedder_type": "embedding", "vocab_path": paths["vocab"],
            "encoder_fused_attention": False, "max_query_length": 8, "max_doc_length": 24,
            "param_group0_learning_rate": 1e-3, "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 1,
            "max_training_steps": 10, "lr_schedule": "cosine", "gradient_clip_norm": 5.0, "weight_decay": 0.01,
            "adam_eps": 1e-4, **kw}


def test_list_sampler_batches_equal_jax(list_data):
    """Both samplers from one seed: the same lists (positive, candidates,
    random documents), tokenized into the same fixed-shape batches."""
    from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer

    jax_sampler, sampler = _samplers(list_data)
    assert sampler.candidates == jax_sampler.candidates and sampler.query_ids == jax_sampler.query_ids
    config = _list_config(list_data)
    want = list(jax_sampler.batches(config, jax_build_tokenizer(config), max_batches=4))
    got = list(sampler.batches(config, build_tokenizer(config), max_batches=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"query_ids", "query_mask", "list_doc_ids", "list_doc_mask", "list_labels",
                                    "valid"}
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]["list_doc_ids"].shape == (3, 6, 24)


@pytest.mark.parametrize("loss", ["listnet", "lambdarank", "mrr"])
def test_list_train_step_matches_jax(list_data, loss):
    """Two list-batch steps (3 queries x 6 documents: all 18 pairs in one
    forward) of a tiny f32 BERT_DOT from the same parameters: loss, stats
    and gradient norm rtol 1e-4, every parameter after the steps atol 1e-5."""
    from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
    from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
    from matchmaker_tpu.training import optim as joptim
    from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
    from matchmaker_tpu_torch.models.bert_dot import BertDot
    from matchmaker_tpu_torch.models.weights import flax_to_state_dict
    from matchmaker_tpu_torch.training import optim as toptim
    from matchmaker_tpu_torch.training.train_step import make_train_step

    config = _list_config(list_data, loss=loss)
    jax_sampler, _ = _samplers(list_data)
    batches = list(jax_sampler.batches(config, jax_build_tokenizer(config), max_batches=2))
    jm = JaxBertDot.from_config(config)
    params = jm.init(jax.random.PRNGKey(0), {"query_ids": batches[0]["query_ids"],
                                             "query_mask": batches[0]["query_mask"],
                                             "doc_ids": batches[0]["list_doc_ids"][:, 0],
                                             "doc_mask": batches[0]["list_doc_mask"][:, 0]})["params"]
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
        for key in ("loss", "ranking_loss", "grad_norm", "score_pos_mean", "score_neg_mean"):
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(params)
    moved = 0.0
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-4  # step 0 of the warmup runs at lr 0


def test_list_batch_needs_a_listwise_loss(list_data):
    """A list batch under a pairwise loss raises, as in JAX; the top-level
    listwise names build the list bundle JAX builds."""
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer
    from matchmaker_tpu_torch.models.bert_dot import BertDot
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    config = _list_config(list_data, loss="margin-mse")
    _, sampler = _samplers(list_data)
    batch = next(iter(sampler.batches(config, build_tokenizer(config), max_batches=1)))
    loss_fn = make_loss_fn(BertDot.from_config(config), tdispatch.get_loss(config), config)
    with pytest.raises(ValueError, match="listwise loss"):
        loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("listnet", "lambdarank", "mrr"):
        jb, tb = jdispatch.get_loss({"loss": name}), tdispatch.get_loss({"loss": name})
        assert tb.use_list_loss and jb.use_list_loss and not tb.use_inbatch_list_loss
        rng = np.random.default_rng(len(name))
        scores = rng.normal(size=(3, 6)).astype(np.float32)
        labels = np.array([[3, 1, 1, 0, 0, 0]] * 3, np.float32)
        np.testing.assert_allclose(float(tb.ranking_loss(torch.from_numpy(scores), torch.from_numpy(labels),
                                                         torch.ones(3, 6))),
                                   float(jb.ranking_loss(jnp.asarray(scores), jnp.asarray(labels), jnp.ones((3, 6)))),
                                   rtol=1e-5)


def test_trainer_trains_on_list_batches(list_data, tmp_path):
    """cli.train's Trainer on the CPU with ``dynamic_sampler: listwise``:
    ``tas_batches_per_epoch`` list steps, a finite loss, a validation and
    the best checkpoint."""
    from matchmaker_tpu_torch.training.trainer import Trainer

    run = str(tmp_path / "run")
    os.makedirs(run)
    config = _list_config(
        list_data, loss="listnet", dynamic_sampler="listwise", dynamic_sampler_collection=list_data["collection"],
        dynamic_sampler_queries=list_data["queries"], dynamic_sampler_qrels=list_data["qrels"],
        dynamic_sampler_candidates=list_data["candidates"], list_size=6, queries_per_batch=3,
        tas_batches_per_epoch=4, epochs=1, validate_every_n_batches=-1, batch_size_eval=16, device="cpu",
        enable_tensorboard=False, random_seed=3, encoder_fused_attention=True,
        validation_cont={"tsv": list_data["val_tsv"], "qrels": list_data["qrels"], "binarization_point": 1})
    trainer = Trainer(config, run)
    losses = []
    step = trainer.train_step
    trainer.train_step = lambda batch: losses.append(step(batch)) or losses[-1]
    trainer.train()
    assert trainer.global_step == 4 and len(losses) == 4
    assert all(np.isfinite(float(s["loss"])) for s in losses)
    assert {"ranking_loss", "score_pos_mean", "score_neg_mean", "grad_norm"} <= set(losses[0])
    for rel in ("validation-metrics-cont.csv", "best-model.npz"):
        assert os.path.isfile(os.path.join(run, rel)), rel
