"""The QA multi-task path of the port against the JAX package on the CPU:
the span and answerability loss (ignored labels, shared and per-span end
logits, a batch without a valid label) and its gradients at rtol 1e-5;
BERT_CAT's QA heads from the same flax parameters at 1e-5; two
``make_train_step`` steps of a tiny f32 BERT_CAT on QA triples with and
without the uncertainty weighting at the tolerance of
tests/test_torch_training.py::test_train_steps_match_jax (loss and stats
rtol 1e-4, every parameter after the steps, ``mtl_log_vars`` included,
atol 1e-5); ``qa_evaluate`` on tests/test_qa.py's inputs (its scripted
eval step and a real model) giving JAX's predictions and EM/F1; the
``Trainer`` on the CPU with ``train_qa_spans`` and QA answer evaluation,
``mtl_log_vars`` kept in the snapshots and restored on resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.losses import qa as jqa
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.losses import qa as tqa
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, load_npz
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

QA_TRIPLES = ("0,10\twhat is alpha\talpha thing is here described\tnothing relevant words\n"
              "\twhat is beta\tbeta text body\tother words entirely\n"
              "6,15\twhere is gamma\tthe gamma lies in the north\tsome other text\n"
              "0,4\twho is delta\tdelta was a river god\tunrelated passage here\n")
TUPLES = ("q1\td1\twhat is alpha\talpha is the answer here\n"
          "q1\td2\twhat is alpha\tbeta gamma delta words\n")


def _config(**kw):
    from matchmaker_tpu_torch.config import auto_fill

    return auto_fill({"model": "bert_cat", "model_input_type": "auto", "token_embedder_type": "auto",
                      "bert_pretrained_model": "tiny-test", "use_fp16": False, "train_qa_spans": True,
                      "qa_loss": "StartEndCrossEntropy", "loss": "ranknet", "max_query_length": 8,
                      "max_doc_length": 16, "batch_size_train": 4, "param_group0_learning_rate": 1e-3,
                      "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 1, "max_training_steps": 10,
                      "lr_schedule": "cosine", "gradient_clip_norm": 5.0, "weight_decay": 0.01, "adam_eps": 1e-4,
                      **kw})


@pytest.mark.parametrize("case", ["shared_end", "per_span_end", "no_valid_label"])
def test_qa_loss_matches_jax(case):
    """Span loss, answerability loss and their gradients w.r.t. the logits."""
    rng = np.random.default_rng(len(case))
    b, s, l = 4, 3, 11
    start = rng.normal(size=(b, l)).astype(np.float32) * 2
    end = rng.normal(size=(b, s, l) if case == "per_span_end" else (b, l)).astype(np.float32) * 2
    starts = rng.integers(0, l, size=(b, s)).astype(np.int32)
    ends = rng.integers(0, l, size=(b, s)).astype(np.int32)
    starts[1, 1:] = ends[1, 1:] = -1
    starts[3] = ends[3] = -1
    if case == "no_valid_label":
        starts[:] = ends[:] = -1
    answer = rng.normal(size=(b, 2)).astype(np.float32)
    has = np.array([1, 0, 1, -1], np.int32)

    def jloss(st, en, an):
        span, ans = jqa.qa_start_end_cross_entropy(st, en, jnp.asarray(starts), jnp.asarray(ends), an,
                                                   jnp.asarray(has))
        return span + 2.0 * ans, (span, ans)

    (_, (jspan, jans)), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(answer))
    ts, te, ta = (torch.from_numpy(a).requires_grad_() for a in (start, end, answer))
    span, ans = tqa.qa_start_end_cross_entropy(ts, te, torch.from_numpy(starts), torch.from_numpy(ends), ta,
                                               torch.from_numpy(has))
    (span + 2.0 * ans).backward()
    np.testing.assert_allclose(float(span.detach()), float(jspan), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ans.detach()), float(jans), rtol=1e-5, atol=1e-6)
    for t, g in zip((ts, te, ta), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6)
    if case == "no_valid_label":
        assert float(span) == 0.0


def test_get_loss_builds_the_qa_loss():
    for config in ({"loss": "ranknet", "train_qa_spans": True, "qa_loss": "StartEndCrossEntropy"},
                   {"loss": "margin-mse", "train_qa_spans": True, "qa_loss": "StartEndCrossEntropy"}):
        assert tdispatch.get_loss(config).qa_loss is tqa.qa_start_end_cross_entropy
        assert jdispatch.get_loss(config).qa_loss is not None
    for module in (tdispatch, jdispatch):
        with pytest.raises(ValueError, match="StartEndCrossEntropy"):
            module.get_loss({"loss": "ranknet", "train_qa_spans": True, "qa_loss": "other"})


def _models(config):
    """(JAX BERT_CAT, the port's, JAX parameters; ``mtl_log_vars`` zeros as
    the JAX trainer adds them when the config asks for the weighting)."""
    from matchmaker_tpu.models.bert_cat import BertCat as JaxBertCat
    from matchmaker_tpu_torch.models import get_model

    jm = JaxBertCat.from_config(config)
    length = config["max_query_length"] + config["max_doc_length"]
    params = jm.init(jax.random.PRNGKey(0), {"seq_ids": np.zeros((2, length), np.int32),
                                             "seq_mask": np.ones((2, length), np.float32),
                                             "seq_type_ids": np.zeros((2, length), np.int32)})["params"]
    if config.get("qa_uncertainty_weighting", True):
        params = dict(params, mtl_log_vars=jnp.zeros(3, jnp.float32))
    tok = type("Tok", (), {"vocab_size": 1000})()
    tm = get_model(config, tok)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, tm, params


def _qa_batches(tmp_path, config):
    from matchmaker_tpu_torch.data.loaders import triple_training_loader
    from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer

    triples = tmp_path / "qa_triples.tsv"
    triples.write_text(QA_TRIPLES * 2)
    tokenizer = HashBertTokenizer(1000)  # build_tokenizer's for "tiny-test" without a local checkpoint
    return list(triple_training_loader(config, tokenizer, str(triples))), tokenizer


def test_bert_cat_qa_heads_match_jax(tmp_path):
    config = _config()
    jm, tm, params = _models(config)
    batch, _ = _qa_batches(tmp_path, config)
    seq = {"seq_ids": batch[0]["pos_ids"], "seq_mask": batch[0]["pos_mask"], "seq_type_ids": batch[0]["pos_type_ids"]}
    seq["seq_mask"][1, 12:] = 0.0
    want = jm.apply({"params": {k: v for k, v in params.items() if k != "mtl_log_vars"}},
                    {k: jnp.asarray(v) for k, v in seq.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in seq.items()})
    assert set(got) == set(want) == {"score", "qa_logits_start", "qa_logits_end", "answerability_logits"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5, err_msg=key)
    assert float(got["qa_logits_start"][1, -1]) < -1e8  # a padded position


@pytest.mark.parametrize("weighting", [True, False])
def test_qa_train_step_matches_jax(tmp_path, weighting):
    """Two ranknet + QA steps from the same parameters: the loss and every
    QA stat, then every parameter (the heads and ``mtl_log_vars``)."""
    from matchmaker_tpu.training import optim as joptim
    from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
    from matchmaker_tpu_torch.training import optim as toptim
    from matchmaker_tpu_torch.training.train_step import make_train_step

    config = _config(qa_uncertainty_weighting=weighting, qa_loss_lambda=0.3)
    jm, tm, params = _models(config)
    batches, _ = _qa_batches(tmp_path, config)
    start = flax_to_state_dict(params)
    tx = joptim.build_optimizer(config, params)
    opt_state = tx.init(params)
    jstep = jax_make_train_step(jm, jdispatch.get_loss(config), tx, config)
    tstep = make_train_step(tm, tdispatch.get_loss(config), toptim.build_optimizer(config, tm), config)
    keys = {"loss", "ranking_loss", "grad_norm", "qa_span_loss", "qa_answerability_loss",
            "qa_answerability_loss_neg", "score_pos_mean", "score_neg_mean"}
    if weighting:
        keys |= {"qa_weighted_ranking_loss", "qa_weighted_qa_loss", "mtl_log_var_ranking"}
    for batch in batches:
        params, opt_state, jstats = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        tstats = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tstats) == set(jstats) == keys
        for key in keys:
            np.testing.assert_allclose(float(tstats[key]), float(jstats[key]), rtol=1e-4, atol=1e-6, err_msg=key)
    want = flax_to_state_dict(params)
    assert ("mtl_log_vars" in want) == weighting
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
    if weighting:
        assert float(tm.mtl_log_vars.abs().sum()) > 0.0  # the merge is differentiated
    for name in ("qa_span_layer.kernel", "answerability_layer.kernel"):
        assert float((tm.state_dict()[name] - start[name]).abs().max()) > 1e-4


def _scripted_eval_step(numpy_out):
    """tests/test_qa.py's scripted step: the span at document tokens 3..4
    ("the answer" of d1), d1 answerable, every later document not."""
    def step(*args, **kwargs):
        step.calls += 1
        batch = args[-1] if not numpy_out else args[1]
        length = batch["seq_ids"].shape[1]
        start = np.full((1, length), -1e4, np.float32)
        end = np.full((1, length), -1e4, np.float32)
        start[0, 8 + 3] = 10.0
        end[0, 8 + 4] = 10.0
        answerable = np.array([[0.0, 5.0]] if step.calls == 1 else [[5.0, 0.0]], np.float32)
        out = {"score": np.zeros(1, np.float32), "qa_logits_start": start, "qa_logits_end": end,
               "answerability_logits": answerable}
        return out if numpy_out else {k: torch.from_numpy(v) for k, v in out.items()}

    step.calls = 0
    return step


def test_qa_evaluate_matches_jax(tmp_path):
    """On tests/test_qa.py's tuples and answers: the scripted step's walk
    (the first answerable document's span, stopping there), and a real
    tiny BERT_CAT from the same parameters, over the ranking and over the
    file order: the same predictions and EM/F1 as JAX's."""
    from matchmaker_tpu.data.tokenization import HashBertTokenizer as JaxHashTokenizer
    from matchmaker_tpu.evaluation import qa_evaluate as jax_qa_evaluate
    from matchmaker_tpu.training.train_step import make_eval_step as jax_make_eval_step
    from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
    from matchmaker_tpu_torch.evaluation import qa_evaluate
    from matchmaker_tpu_torch.training.train_step import make_eval_step

    tuples = tmp_path / "tuples.tsv"
    tuples.write_text(TUPLES)
    gold = {"q1": ["the answer"]}
    config = {"max_query_length": 8, "max_doc_length": 16}
    cpu = torch.device("cpu")
    jstep, tstep = _scripted_eval_step(True), _scripted_eval_step(False)
    want = jax_qa_evaluate(jstep, None, config, JaxHashTokenizer(30522), str(tuples), gold, {"q1": ["d1", "d2"]})
    got = qa_evaluate(tstep, config, HashBertTokenizer(30522), str(tuples), gold, cpu, {"q1": ["d1", "d2"]})
    assert got == want and got[1]["q1"] == "the answer" and got[0]["QA_EM"] == 1.0 and tstep.calls == 1

    qa_config = _config()
    jm, tm, params = _models(qa_config)
    params = {k: v for k, v in params.items() if k != "mtl_log_vars"}
    jtok, ttok = JaxHashTokenizer(1000), HashBertTokenizer(1000)
    for ranked in ({"q1": ["d2", "d1"]}, None):
        want = jax_qa_evaluate(jax_make_eval_step(jm), params, qa_config, jtok, str(tuples), gold, ranked)
        got = qa_evaluate(make_eval_step(tm.eval()), qa_config, ttok, str(tuples), gold, cpu, ranked)
        assert got == want


def test_trainer_runs_qa_multitask(tmp_path):
    """cli.train's Trainer on the CPU with ``train_qa_spans``: the QA stats
    in the loss CSV's step, QA EM/F1 in the validation and test metrics,
    ``last-qa-output.tsv`` and ``test-qa-qa-output.tsv``, ``mtl_log_vars``
    trained and kept in ``best-model.npz`` and the train state, and a resume
    restoring it."""
    from matchmaker_tpu_torch.training.trainer import Trainer

    triples = tmp_path / "qa_triples.tsv"
    triples.write_text(QA_TRIPLES * 3)
    tuples = tmp_path / "tuples.tsv"
    tuples.write_text(TUPLES)
    (tmp_path / "qrels.txt").write_text("q1 0 d1 1\n")
    (tmp_path / "answers.tsv").write_text("q1\tthe answer\n")
    val = {"tsv": str(tuples), "qrels": str(tmp_path / "qrels.txt"), "qa_answers": str(tmp_path / "answers.tsv"),
           "binarization_point": 1}
    base = dict(train_tsv=str(triples), epochs=1, device="cpu", enable_tensorboard=False, batch_size_eval=4,
                random_seed=3, validate_every_n_batches=-1, save_train_state=True, validation_cont=val)
    run = str(tmp_path / "run")
    os.makedirs(run)
    trainer = Trainer(_config(**base, test={"qa": dict(val)}), run)
    assert tuple(trainer.model.mtl_log_vars.shape) == (3,) and float(trainer.model.mtl_log_vars.abs().sum()) == 0
    stats = []
    step = trainer.train_step
    trainer.train_step = lambda batch: stats.append(step(batch)) or stats[-1]
    trainer.train()
    assert trainer.global_step == 3
    assert {"qa_span_loss", "qa_answerability_loss", "qa_weighted_qa_loss"} <= set(stats[-1])
    for rel in ("last-qa-output.tsv", "test-qa-qa-output.tsv", "validation-metrics-cont.csv", "best-model.npz"):
        assert os.path.isfile(os.path.join(run, rel)), rel
    with open(os.path.join(run, "validation-metrics-cont.csv")) as f:
        header = f.readline()
    assert "QA/ExactMatch_TopRanked" in header and "QA/F1_TopRanked" in header
    learned = trainer.model.mtl_log_vars.detach().clone()
    assert float(learned.abs().sum()) > 0
    torch.testing.assert_close(load_npz(os.path.join(run, "best-model.npz"))["mtl_log_vars"], learned)
    resumed = Trainer(_config(**base), run)
    assert resumed.resume_from_train_state()
    torch.testing.assert_close(resumed.model.mtl_log_vars.detach(), learned)
