"""The port's copies of the JAX package's host code against the originals on
the same seeded inputs: tokenizer ids, the three loaders' batches, the IR
metrics, the YAML config merge, the run-folder helpers and the scalar
writer."""

import os

import numpy as np
import pytest

from matchmaker_tpu import config as jconfig
from matchmaker_tpu import experiment as jexperiment
from matchmaker_tpu.data import loaders as jloaders
from matchmaker_tpu.data.tokenization import HashBertTokenizer as JaxHashBertTokenizer
from matchmaker_tpu.metrics import calculate_metrics_along_candidate_depth as jax_depth_metrics
from matchmaker_tpu.metrics import calculate_metrics_plain as jax_metrics
from matchmaker_tpu.obs.scalars import ScalarWriter as JaxScalarWriter
from matchmaker_tpu_torch import config as tconfig
from matchmaker_tpu_torch import experiment as texperiment
from matchmaker_tpu_torch.data import loaders as tloaders
from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
from matchmaker_tpu_torch.metrics import calculate_metrics_along_candidate_depth, calculate_metrics_plain
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.obs.scalars import ScalarWriter

_WORDS = [f"w{i}" for i in range(300)] + ["Hello,", "world!", "a.b", "x-y", "über"]


def _text(rng, lo, hi):
    return " ".join(rng.choice(_WORDS, size=int(rng.integers(lo, hi))))


def test_hash_bert_tokenizer_ids_equal():
    rng = np.random.default_rng(0)
    texts = [_text(rng, 0, 60) for _ in range(40)]
    for vocab in (30522, 1000):
        j, t = JaxHashBertTokenizer(vocab), HashBertTokenizer(vocab)
        for text in texts[:10]:
            for a, b in zip(j.encode(text, 32), t.encode(text, 32)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(j.encode_pair(text, texts[-1], 8, 24), t.encode_pair(text, texts[-1], 8, 24)):
                np.testing.assert_array_equal(a, b)
            assert j.encode_with_offsets(text, 16)[2] == t.encode_with_offsets(text, 16)[2]
        for a, b in zip(j.encode_batch(texts, 48), t.encode_batch(texts, 48)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(1)
    paths = {k: str(root / f) for k, f in (("triples", "triples.tsv"), ("rerank", "rerank.tsv"),
                                            ("collection", "collection.tsv"))}
    with open(paths["triples"], "w") as f:
        for _ in range(37):
            f.write(f"{rng.uniform(0, 9):.3f}\t{rng.uniform(0, 9):.3f}\t{_text(rng, 2, 8)}\t"
                    f"{_text(rng, 10, 50)}\t{_text(rng, 10, 50)}\n")
    with open(paths["rerank"], "w") as f:
        for qi in range(6):
            for di in range(7):
                f.write(f"q{qi}\td{qi}_{di}\t{_text(rng, 2, 8)}\t{_text(rng, 5, 70)}\n")
    with open(paths["collection"], "w") as f:
        for i in range(53):
            f.write(f"{i}\t{_text(rng, 3, 40)}\n")
    return paths


def _assert_batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k])
        elif isinstance(x, tuple):
            _assert_batches_equal(list(x), list(y))
        else:
            assert x == y


@pytest.mark.parametrize("loader", ["triple", "reranking", "single"])
def test_loaders_give_equal_batches(files, loader):
    """The three loaders of the copy yield the JAX originals' batches: same
    keys, dtypes, values, ids and padding of the last batch."""
    tok = HashBertTokenizer(1000)
    config = {"batch_size_train": 8, "batch_size_eval": 10, "batch_size_inference": 16, "max_query_length": 12,
              "max_doc_length": 40, "train_pairwise_distillation": True, "eval_length_buckets": [16]}
    calls = {
        "triple": lambda m: m.triple_training_loader(config, tok, files["triples"]),
        "reranking": lambda m: m.reranking_inference_loader(config, tok, files["rerank"]),
        "single": lambda m: m.single_sequence_loader(config, tok, files["collection"], "doc"),
    }
    _assert_batches_equal(list(calls[loader](tloaders)), list(calls[loader](jloaders)))


def test_metrics_equal_to_full_precision():
    rng = np.random.default_rng(2)
    qrels = {f"q{q}": {f"d{d}": int(rng.integers(0, 4)) for d in rng.choice(200, 12, replace=False)}
             for q in range(30)}
    ranking = {f"q{q}": [f"d{d}" for d in rng.permutation(200)[:150]] for q in range(30)}
    for bp in (1, 2):
        assert calculate_metrics_plain(ranking, qrels, bp) == jax_metrics(ranking, qrels, bp)
    cs = {q: {d: r + 1 for r, d in enumerate(rng.permutation(ranking[q]))} for q in ranking}
    assert calculate_metrics_along_candidate_depth(ranking, qrels, cs, [10, 50], 1) == \
        jax_depth_metrics(ranking, qrels, cs, [10, 50], 1)


def test_get_config_merges_yaml_equally(tmp_path):
    """Two YAML files merged in order, overwrites, the 7e-5 float rule and
    the auto-fill: equal dicts; save_config round-trips."""
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text("model: bert_dot\nlr: 7e-5\nnested: {x: 1, y: [1, 2]}\nquery_sets: {dev: {top_n: 100}}\n")
    b.write_text("lr: 3.0e-6\nnested: {y: [3], z: text}\nmodel_input_type: auto\n")
    over = "batch_size_train: 16,nested.z: other"
    want = jconfig.get_config([str(a), str(b)], over)
    got = tconfig.get_config([str(a), str(b)], over)
    assert dict(got) == dict(want) and isinstance(got["lr"], float)
    assert dict(tconfig.get_config_single(str(a))) == dict(jconfig.get_config_single(str(a)))
    tconfig.save_config(got, str(tmp_path / "out" / "config.yaml"))
    assert dict(tconfig.get_config([str(tmp_path / "out" / "config.yaml")])) == dict(want)


def test_prepare_experiment_and_parser(tmp_path):
    """The run folder of the copy holds what the JAX original writes."""
    config = {"model": "bert_dot", "lr": 1e-5}
    folders = [m.prepare_experiment(str(tmp_path / name), "run", config)
               for name, m in (("jax", jexperiment), ("torch", texperiment))]
    assert [sorted(os.listdir(f)) for f in folders] == [["config.yaml", "run-info.json", "source-snapshot.zip"]] * 2
    args = ["--config-file", "a.yaml", "b.yaml", "--run-name", "r", "--config-overwrites", "k: v"]
    assert vars(texperiment.get_parser().parse_args(args)) == vars(jexperiment.get_parser().parse_args(args))


def test_scalar_writer_and_perf_monitor(tmp_path):
    for name, writer in (("jax", JaxScalarWriter), ("torch", ScalarWriter)):
        os.makedirs(tmp_path / name)
        w = writer(str(tmp_path / name), enable_tensorboard=False)
        w.write({"loss": 1.5, "lr": np.float32(2e-5), "skip": "text"}, step=3)
        w.write({"mrr": 0.25}, step=4, prefix="validation")
        w.close()
    for csv_name in ("train-scalars.csv", "validation-scalars.csv"):
        assert (tmp_path / "torch" / csv_name).read_text() == (tmp_path / "jax" / csv_name).read_text()
    perf = PerformanceMonitor()
    perf.start_block("encode")
    perf.stop_block("encode", instances=10)
    perf.save_summary(str(tmp_path / "efficiency-metrics.json"))
    stats = perf.summary()["encode"]
    assert stats["instances"] == 10 and stats["calls"] == 1 and stats["items_per_second"] > 0


@pytest.mark.parametrize("module", ["data/mlm.py", "data/synthetic.py", "data/tas_balanced.py"])
def test_verbatim_copies_differ_only_in_imports(module):
    """The MLM loader, the planted corpora and the TAS-Balanced sampler are
    the JAX package's modules with only ``matchmaker_tpu.`` imports turned
    into ``matchmaker_tpu_torch.`` ones (their behaviour is held to the
    originals in tests/test_torch_tasb.py)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "matchmaker_tpu", module), encoding="utf-8") as f:
        original = f.read().replace("matchmaker_tpu.", "matchmaker_tpu_torch.")
    with open(os.path.join(repo, "matchmaker_tpu_torch", module), encoding="utf-8") as f:
        assert f.read() == original
