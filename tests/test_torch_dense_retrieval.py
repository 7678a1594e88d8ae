"""The port's serving slice against the JAX package, end to end on the CPU:
``run("encode+index+search", ...)`` of both CLIs on the same seeded
collection, queries, qrels and weights (tiny encoder, f32, fused layers,
float16 storage with the binmax search at per_bin 8)."""

import csv
import os
import shutil

import numpy as np
import pytest

from matchmaker_tpu.cli.dense_retrieval import run as jax_run
from matchmaker_tpu.training.checkpoints import save_params

from matchmaker_tpu_torch.cli.dense_retrieval import run as torch_run
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.models import get_model
from matchmaker_tpu_torch.models.encoder import encoder_config_from_model_name
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, save_npz
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.retrieval.encode import load_encoded

N_PASSAGES, N_QUERIES, TOP_N = 2048, 48, 10


def _write_data(root, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(600)]
    passages = [" ".join(rng.choice(words, size=rng.integers(12, 40))) for _ in range(N_PASSAGES)]
    with open(os.path.join(root, "collection.tsv"), "w") as f:
        for i, p in enumerate(passages):
            f.write(f"{1000 + i}\t{p}\n")
    targets = rng.choice(N_PASSAGES, size=N_QUERIES, replace=False)
    with open(os.path.join(root, "queries.tsv"), "w") as fq, open(os.path.join(root, "qrels.txt"), "w") as fr:
        for qi, t in enumerate(targets):
            toks = passages[t].split()
            fq.write(f"q{qi}\t{' '.join(rng.choice(toks, size=4))}\n")
            fr.write(f"q{qi} 0 {1000 + t} 1\n")


def _config(root):
    return {
        "model": "bert_dot",
        "bert_pretrained_model": "bert-tiny-random",
        "use_fp16": False,
        "encoder_fused_attention": True,
        "faiss_index_type": "flat",
        "mips_quantization": "float16",
        "token_dtype": "float16",
        "token_block_size": 1000,  # three blocks
        "collection_tsv": os.path.join(root, "collection.tsv"),
        "collection_batch_size": 256,
        "query_batch_size": 32,
        "max_doc_length": 48,
        "max_query_length": 16,
        "random_seed": 3,
        "trained_model": os.path.join(root, "model"),
        "device": "cpu",
        "query_sets": {"dev": {"queries_tsv": os.path.join(root, "queries.tsv"),
                               "qrels": os.path.join(root, "qrels.txt"),
                               "top_n": TOP_N, "binarization_point": 1}},
    }


def _flax_shape(path, shape, heads):
    """The JAX param tree's shape of a port parameter (models/weights.py
    reshapes the attention projections to 2-D)."""
    *_, block, proj, leaf = ("", "", "") + tuple(path.split("/"))
    hid = shape[-1]
    if block != "attention" or (proj == "out" and leaf == "bias"):
        return shape
    if proj == "out":
        return (heads, hid // heads, hid)
    if leaf == "kernel":
        return (shape[0], heads, hid // heads)
    return (heads, hid // heads)


def _seeded_params(config, seed=7):
    """Weights drawn with numpy from a seed, as the JAX package's nested param
    tree: every parameter of the model, biases and LayerNorms included.
    LayerNorm scales near 0.5 keep the output vectors below 2 in magnitude,
    where one float16 ulp of the stored vectors is under the 1e-3 atol."""
    rng = np.random.default_rng(seed)
    heads = encoder_config_from_model_name(config).num_heads
    tree = {}
    for name, p in get_model(config, build_tokenizer(config)).state_dict().items():
        path = name.replace(".", "/")
        leaf = path.rsplit("/", 1)[-1]
        shape = tuple(p.shape)
        if leaf == "kernel":
            arr = rng.normal(size=shape) * shape[0] ** -0.5
        elif leaf == "embedding":
            arr = rng.normal(size=shape) * shape[1] ** -0.5
        elif leaf == "scale":
            arr = 0.5 + 0.05 * rng.normal(size=shape)
        else:
            arr = 0.02 * rng.normal(size=shape)
        node = tree
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32).reshape(_flax_shape(path, shape, heads))
    return tree


def _ranking(path):
    out = {}
    with open(path) as f:
        for line in f:
            qid, did, _, _ = line.split()
            out.setdefault(qid, []).append(did)
    return out


def _metrics(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return dict(zip(rows[0], map(float, rows[1])))


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder) for d, _, fs in os.walk(folder) for f in fs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    _write_data(root)
    config = _config(root)
    # one set of weights, written for both packages
    params = _seeded_params(config)
    os.makedirs(config["trained_model"])
    save_params(os.path.join(config["trained_model"], "best-model.flax"), params)
    save_npz(os.path.join(config["trained_model"], "best-model.npz"), flax_to_state_dict(params))

    folders = {}
    for name, fn in (("jax", jax_run), ("torch", torch_run)):
        folders[name] = os.path.join(root, name)
        os.makedirs(folders[name])
        _build.reset_launches()
        assert fn("encode+index+search", dict(config), folders[name]) == 0
    # CPU tensors take the plain versions: no kernel was launched
    assert not any(_build.LAUNCHES.values())
    return folders


def test_slice_writes_the_same_files(runs):
    assert _files(runs["torch"]) == _files(runs["jax"])


def test_slice_encoded_vectors_match(runs):
    vj, ij = load_encoded(os.path.join(runs["jax"], "encoded"))
    vt, it = load_encoded(os.path.join(runs["torch"], "encoded"))
    assert vt.dtype == vj.dtype == np.float16
    assert (it == ij).all()
    np.testing.assert_allclose(vt.astype(np.float32), vj.astype(np.float32), atol=1e-3)


def test_slice_rankings_and_metrics_match(runs):
    rj = _ranking(os.path.join(runs["jax"], "dev-output.txt"))
    rt = _ranking(os.path.join(runs["torch"], "dev-output.txt"))
    assert rj.keys() == rt.keys() and len(rt) == N_QUERIES
    assert all(len(v) == TOP_N for v in rt.values())
    overlap = np.mean([len(set(rj[q]) & set(rt[q])) / TOP_N for q in rj])
    assert overlap >= 0.9, overlap
    mj = _metrics(os.path.join(runs["jax"], "dev-metrics.csv"))
    mt = _metrics(os.path.join(runs["torch"], "dev-metrics.csv"))
    assert abs(mj["MRR@10"] - mt["MRR@10"]) <= 0.02, (mj["MRR@10"], mt["MRR@10"])


@pytest.mark.parametrize("mode", ["index+search", "search"])
def test_slice_reruns_from_saved_artifacts(runs, tmp_path, mode):
    """The two continue modes reuse the run folder's encoded blocks / saved
    index and reproduce the ranking."""
    folder = str(tmp_path / "again")
    shutil.copytree(runs["torch"], folder)
    os.remove(os.path.join(folder, "dev-output.txt"))
    config = _config(os.path.dirname(runs["torch"]))
    if mode == "search":
        shutil.rmtree(os.path.join(folder, "encoded"))  # only the saved index is read
    assert torch_run(mode, config, folder) == 0
    assert _ranking(os.path.join(folder, "dev-output.txt")) == _ranking(os.path.join(runs["torch"], "dev-output.txt"))


def test_missing_trained_model_raises(runs, tmp_path):
    config = dict(_config(os.path.dirname(runs["torch"])), trained_model=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="best-model.npz"):
        torch_run("search", config, runs["torch"])


def test_slice_serves_a_jax_run_folder(runs, tmp_path):
    """``trained_model`` naming a JAX run folder (its ``best-model.flax``
    alone) serves the JAX weights: the encoded vectors and the ranking equal
    bit for bit those of the ``.npz`` of the same parameters, so they match
    the JAX run's as the slice's do."""
    root = os.path.dirname(runs["torch"])
    jax_model = str(tmp_path / "jax_model")
    os.makedirs(jax_model)
    shutil.copy(os.path.join(root, "model", "best-model.flax"), jax_model)
    folder = str(tmp_path / "served")
    os.makedirs(folder)
    assert torch_run("encode+index+search", dict(_config(root), trained_model=jax_model), folder) == 0
    vf, jf = load_encoded(os.path.join(folder, "encoded"))
    vt, jt = load_encoded(os.path.join(runs["torch"], "encoded"))
    assert (jf == jt).all() and np.array_equal(vf, vt)
    assert _ranking(os.path.join(folder, "dev-output.txt")) == _ranking(os.path.join(runs["torch"], "dev-output.txt"))


# ---- the other index kinds through both CLIs -----------------------------------

# IVF probing every list (exact, so the packages' independent k-means give the
# same ranking) and the streaming index over the encode folder's blocks
_INDEX_KINDS = {"ivf": {"faiss_index_type": "ivf", "faiss_ivf_list_count": 16, "faiss_ivf_nprobe": 16},
                "streaming": {"faiss_index_type": "streaming"}}


# the exact FlatIndex route that scores as each kind does: IVF the 16-bit rows
# and the query rounded to bf16, streaming the stored rows and the query in f32
_EXACT_OF = {"ivf": {"faiss_index_type": "flat", "mips_quantization": "float16", "mips_kernel": "scan"},
             "streaming": {"faiss_index_type": "flat", "mips_quantization": "none", "token_dtype": "float32"}}


@pytest.fixture(scope="module")
def index_runs(runs, tmp_path_factory):
    """index+search of each CLI with each kind on a copy of the JAX run's
    folder: both search the same encoded corpus (each package encodes its
    own queries)."""
    root = str(tmp_path_factory.mktemp("index_kinds"))
    config = _config(os.path.dirname(runs["jax"]))
    folders = {}
    for kind, extra in _INDEX_KINDS.items():
        for name, fn in (("jax", jax_run), ("torch", torch_run)):
            folder = os.path.join(root, kind, name)
            shutil.copytree(runs["jax"], folder)
            shutil.rmtree(os.path.join(folder, "index"))
            os.remove(os.path.join(folder, "dev-output.txt"))
            _build.reset_launches()
            assert fn("index+search", dict(config, **extra), folder) == 0
            assert not any(_build.LAUNCHES.values())
            folders[kind, name] = folder
    return config, folders


@pytest.mark.parametrize("kind", sorted(_INDEX_KINDS))
def test_index_kinds_match_the_jax_cli(index_runs, kind):
    """The same index files; the same top-10 for >= 90 % of the places and
    MRR@10 within 0.02, the bar of the flat slice above (each package
    encodes its own queries; 0.977 and 1.0 measured)."""
    _, folders = index_runs
    assert _files(folders[kind, "torch"]) == _files(folders[kind, "jax"])
    rj = _ranking(os.path.join(folders[kind, "jax"], "dev-output.txt"))
    rt = _ranking(os.path.join(folders[kind, "torch"], "dev-output.txt"))
    assert rj.keys() == rt.keys() and all(len(v) == TOP_N for v in rt.values())
    overlap = np.mean([len(set(rj[q]) & set(rt[q])) / TOP_N for q in rj])
    assert overlap >= 0.9, overlap
    mj = _metrics(os.path.join(folders[kind, "jax"], "dev-metrics.csv"))
    mt = _metrics(os.path.join(folders[kind, "torch"], "dev-metrics.csv"))
    assert abs(mj["MRR@10"] - mt["MRR@10"]) <= 0.02, (mj["MRR@10"], mt["MRR@10"])


@pytest.mark.parametrize("kind", sorted(_INDEX_KINDS))
def test_index_kinds_search_from_the_saved_index(index_runs, kind, tmp_path):
    """``search`` reloads the kind's index from the run folder (streaming:
    the encode folder it names) and ranks as index+search did. The ranking
    is the exact FlatIndex's that scores as the kind does: every query for
    streaming (f32), >= 95 % of the queries for IVF probing every list (bf16
    operands summed in f32 in another order, so a near-tie may swap; all
    of them measured)."""
    config, folders = index_runs
    folder = str(tmp_path / "again")
    shutil.copytree(folders[kind, "torch"], folder)
    os.remove(os.path.join(folder, "dev-output.txt"))
    assert torch_run("search", dict(config, **_INDEX_KINDS[kind]), folder) == 0
    ranking = _ranking(os.path.join(folder, "dev-output.txt"))
    assert ranking == _ranking(os.path.join(folders[kind, "torch"], "dev-output.txt"))
    exact = str(tmp_path / "exact")
    shutil.copytree(folders[kind, "torch"], exact)
    shutil.rmtree(os.path.join(exact, "index"))
    assert torch_run("index+search", dict(config, **_EXACT_OF[kind]), exact) == 0
    flat = _ranking(os.path.join(exact, "dev-output.txt"))
    same = np.mean([ranking[q] == flat[q] for q in flat])
    assert same >= (1.0 if kind == "streaming" else 0.95), same
