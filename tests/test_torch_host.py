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


@pytest.mark.parametrize("module", ["data/mlm.py", "data/synthetic.py", "data/tas_balanced.py",
                                    "distillation/score_files.py", "utils/replay_cache.py", "data/list_sampler.py",
                                    "utils/ensemble.py"])
def test_verbatim_copies_differ_only_in_imports(module):
    """The MLM loader, the planted corpora, the TAS-Balanced sampler, the
    teacher score files' utilities, the replay cache, the list sampler and
    the run fusion are the JAX package's modules with only
    ``matchmaker_tpu.`` imports turned into ``matchmaker_tpu_torch.`` ones
    (the first three are held to the originals' behaviour in
    tests/test_torch_tasb.py, the score files in test_score_files_equal, the
    replay cache in test_replay_cache_writes_and_replays_as_the_original,
    the list sampler in tests/test_torch_listwise.py, the fusion in
    tests/test_torch_hf_export.py)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "matchmaker_tpu", module), encoding="utf-8") as f:
        original = f.read().replace("matchmaker_tpu.", "matchmaker_tpu_torch.")
    with open(os.path.join(repo, "matchmaker_tpu_torch", module), encoding="utf-8") as f:
        assert f.read() == original


def test_score_files_equal(tmp_path):
    """distillation/score_files.py: the mean ensemble of two teachers' files
    (a row only one of them scored dropped) and the text <-> id conversions
    write the originals' bytes."""
    from matchmaker_tpu.distillation import score_files as jsf
    from matchmaker_tpu_torch.distillation import score_files as tsf

    rng = np.random.default_rng(3)
    queries = {f"q{i}": _text(rng, 2, 6) for i in range(5)}
    docs = {f"d{i}": _text(rng, 5, 12) for i in range(9)}
    for name, table in (("queries.tsv", queries), ("collection.tsv", docs)):
        (tmp_path / name).write_text("".join(f"{k}\t{v}\n" for k, v in table.items()))
    rows = [(f"q{i % 5}", f"d{i % 9}", f"d{(i * 4 + 1) % 9}") for i in range(12)]
    for t in range(2):
        lines = [f"{rng.uniform(0, 9):.4f}\t{rng.uniform(0, 9):.4f}\t{queries[q]}\t{docs[p]}\t{docs[n]}\n"
                 for q, p, n in rows[: 12 - t]]
        (tmp_path / f"teacher{t}.tsv").write_text("".join(lines) + "malformed line\n")
    teachers = [str(tmp_path / f"teacher{t}.tsv") for t in range(2)]
    args = (str(tmp_path / "queries.tsv"), str(tmp_path / "collection.tsv"))
    for pkg in ("jax", "torch"):
        sf = jsf if pkg == "jax" else tsf
        assert sf.ensemble_score_files(teachers, str(tmp_path / f"{pkg}_ens.tsv")) == 11
        assert sf.text_scores_to_ids(str(tmp_path / f"{pkg}_ens.tsv"), *args, str(tmp_path / f"{pkg}_ids.tsv")) == 11
        assert sf.id_scores_to_text(str(tmp_path / f"{pkg}_ids.tsv"), *args, str(tmp_path / f"{pkg}_text.tsv")) == 11
    for out in ("ens", "ids", "text"):
        assert (tmp_path / f"torch_{out}.tsv").read_bytes() == (tmp_path / f"jax_{out}.tsv").read_bytes()


def _vocab_files(tmp_path):
    words = [f"w{i}" for i in range(120)] + ["hello", "world", ",", "!"]
    vocab_path, idf_path = str(tmp_path / "vocab.txt"), str(tmp_path / "idf.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("@@PADDING@@\n" + "\n".join(words) + "\n\n")
    rng = np.random.default_rng(7)
    with open(idf_path, "w", encoding="utf-8") as f:
        for w in words[::3] + ["absent"]:
            f.write(f"{w} {rng.uniform(0, 9):.5f}\n")
        f.write("malformed line here\n")
    return vocab_path, idf_path


@pytest.mark.parametrize("mask_oov,with_idf", [(False, False), (True, True)])
def test_vocab_tokenizer_equals_the_original(tmp_path, mask_oov, with_idf):
    """Vocabulary (file, reserved ids, save round trip) and VocabTokenizer
    (ids, masks with and without ``mask_oov``, offsets, the idf table) built
    by both ``build_tokenizer``s from the same files: equal."""
    from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
    from matchmaker_tpu_torch.data.tokenization import Vocabulary, VocabTokenizer, build_tokenizer

    vocab_path, idf_path = _vocab_files(tmp_path)
    config = {"token_embedder_type": "embedding", "vocab_directory": vocab_path, "mask_oov": mask_oov,
              **({"idf_path": idf_path} if with_idf else {})}
    j, t = jax_build_tokenizer(config), build_tokenizer(config)
    assert isinstance(t, VocabTokenizer) and t.vocab.token_to_id == j.vocab.token_to_id
    assert t.vocab_size == j.vocab_size == 126 and t.pad_id == j.pad_id == 0
    if with_idf:
        np.testing.assert_array_equal(t.idf_lookup, j.idf_lookup)
    else:
        assert t.idf_lookup is None and j.idf_lookup is None
    rng = np.random.default_rng(8)
    texts = [_text(rng, 0, 40) + " hello, World! unknownword" for _ in range(12)]
    for text in texts:
        for a, b in zip(j.encode(text, 32), t.encode(text, 32)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert j.encode_with_offsets(text, 16)[2] == t.encode_with_offsets(text, 16)[2]
    for a, b in zip(j.encode_batch(texts, 48), t.encode_batch(texts, 48)):
        np.testing.assert_array_equal(a, b)
    t.vocab.save(str(tmp_path / "saved.txt"))
    assert Vocabulary.from_file(str(tmp_path / "saved.txt")).token_to_id == t.vocab.token_to_id
    with pytest.raises(ValueError, match="vocab_path"):
        build_tokenizer({"token_embedder_type": "embedding"})


def test_triple_loader_with_idfs_gives_equal_batches(files, tmp_path):
    """The triple loader with a vocabulary tokenizer and an idf table hands
    both packages' batches the same ``query_idfs`` (TKL's idf saturation)."""
    from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
    from matchmaker_tpu_torch.data.tokenization import build_tokenizer

    vocab_path, idf_path = _vocab_files(tmp_path)
    tok_config = {"token_embedder_type": "embedding", "vocab_directory": vocab_path, "idf_path": idf_path}
    config = {"batch_size_train": 8, "max_query_length": 12, "max_doc_length": 40}
    got = list(tloaders.triple_training_loader(config, build_tokenizer(tok_config), files["triples"]))
    want = list(jloaders.triple_training_loader(config, jax_build_tokenizer(tok_config), files["triples"]))
    assert "query_idfs" in got[0]
    _assert_batches_equal(got, want)


def test_replay_cache_writes_and_replays_as_the_original(tmp_path):
    """CrossExperimentReplayCache: arrays of changing shapes written by the
    copy replay in order through the original and the other way round, past
    a block's end; RunningAverage's means equal."""
    from matchmaker_tpu.utils import replay_cache as jrc
    from matchmaker_tpu_torch.utils import replay_cache as trc

    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=(int(rng.integers(1, 5)), int(rng.integers(1, 7)))).astype(np.float32)
              for _ in range(9)]
    for writer, reader in ((trc, jrc), (jrc, trc)):
        path = str(tmp_path / writer.__name__.split(".")[0])
        w = writer.CrossExperimentReplayCache(path, write=True)
        w._current = np.zeros(40, np.float32)  # a small block: the arrays span three
        for a in arrays:
            if w.offset + a.size > 40:
                w._flush_block()
                w._current = np.zeros(40, np.float32)
            w.cache(a)
        w.finish()
        r = reader.CrossExperimentReplayCache(path, write=False)
        for a in arrays:
            np.testing.assert_array_equal(r.get_next(), a)
        assert r.get_next() is None
    ja, ta = jrc.RunningAverage(4), trc.RunningAverage(4)
    for v in (1.0, 3.0, 2.5, -1.0, 7.0, 0.5):
        assert ta.add(v) == ja.add(v)
    assert trc.RunningAverage(3).mean() == 0.0
