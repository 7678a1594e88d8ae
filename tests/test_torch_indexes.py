"""The port's index layer against the JAX package on the CPU: the two-stage
scan (ops/mips_twostage.py), FlatIndex's two scan routes (float16 + scan,
int8 + scan + mips_twostage), IVFIndex, ScaNN's tree-AH, the streaming index
and the native HNSW graph, and build_index's dispatch.

Where both packages must hold the same index state (IVF, tree-AH, HNSW),
the JAX index is built and saved and the port loads its folder: the port's
k-means draws from a ``torch.Generator``, JAX's from ``jax.random``, so
clusters built apart differ. The port's own builds are held to the recall
floors of tests/test_retrieval.py. Ids are compared exactly, except that two
hits whose scores agree within the tolerance may swap (the packages sum the
f32 products in different orders)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips_quant as jq
from matchmaker_tpu.ops import mips_twostage as jt
from matchmaker_tpu.retrieval import indexes as ji
from matchmaker_tpu.retrieval.hnsw import HNSWIndex as JaxHNSWIndex
from matchmaker_tpu.retrieval.scann_tree_ah import ScaNNTreeAHIndex as JaxTreeAH
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import mips_twostage as tt
from matchmaker_tpu_torch.retrieval import hnsw as th
from matchmaker_tpu_torch.retrieval import indexes as ti
from matchmaker_tpu_torch.retrieval.encode import encode_corpus, load_encoded
from matchmaker_tpu_torch.retrieval.scann_tree_ah import ScaNNTreeAHIndex, ah_codes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def assert_same_hits(got, want, rtol=1e-5, atol=1e-6):
    """(scores, ids) of two searches: scores within rtol / atol place by
    place, ids equal except at places whose scores tie within that
    tolerance with a neighbour (a near-tie may swap, or trade the last
    place)."""
    (gv, gi), (wv, wi) = got, want
    gv, wv = np.asarray(gv, np.float64), np.asarray(wv, np.float64)
    assert gv.shape == wv.shape and np.shape(gi) == np.shape(wi)
    finite = np.isfinite(wv)
    assert (np.isfinite(gv) == finite).all()
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(wv)
    with np.errstate(invalid="ignore"):  # -inf - -inf in the padded places
        gap = np.abs(np.diff(wv, axis=1))
    near = np.zeros_like(finite)
    near[:, 1:] |= gap <= tol[:, 1:]
    near[:, :-1] |= gap <= tol[:, :-1]
    differ = np.asarray(gi) != np.asarray(wi)
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]


def _normed(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _clustered(rng, n, d, n_centers, scale=3.0, noise=1.0):
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * scale
    assign = rng.integers(0, n_centers, n)
    return (centers[assign] + noise * rng.normal(size=(n, d))).astype(np.float32)


# ---- the two-stage scan --------------------------------------------------------

@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("rescore", ["int8", "float16"])
@pytest.mark.parametrize("k", [10, 300])
def test_twostage_exact_topk_matches_jax(per_row, rescore, k):
    """Per-row and one global scale, the rescore against the codes or
    float16 rows, k above the block size (tests/test_perf_ops.py:148), a
    masked tail: JAX's ids and scores."""
    rng = np.random.default_rng(21)
    corpus = _normed(rng, 3000, 32)
    queries = rng.normal(size=(6, 32)).astype(np.float32)
    values, scales = jq.quantize_corpus(corpus, per_row)
    rows = corpus.astype(np.float16) if rescore == "float16" else None
    want = jt.twostage_exact_topk(jnp.asarray(queries), jnp.asarray(values), jnp.asarray(scales), k,
                                  block_size=256, n_valid=2900,
                                  rescore_corpus=None if rows is None else jnp.asarray(rows))
    got = tt.twostage_exact_topk(torch.from_numpy(queries), torch.from_numpy(values),
                                 torch.from_numpy(np.asarray(scales)), k, block_size=256, n_valid=2900,
                                 rescore_corpus=None if rows is None else torch.from_numpy(rows))
    assert_same_hits((got[0].numpy(), got[1].numpy()), tuple(map(np.asarray, want)))
    assert got[1].max() < 2900 and (np.diff(got[0].numpy(), axis=1) <= 0).all()


# ---- FlatIndex's scan routes ---------------------------------------------------

_SCAN_ROUTES = {
    "float16-scan": {"mips_quantization": "float16", "mips_kernel": "scan"},
    "float16-scan-blocked": {"mips_quantization": "float16", "mips_kernel": "scan", "mips_block_size": 1024},
    "int8-twostage-int8": {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True},
    "int8-twostage-float16": {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True,
                              "mips_rescore_dtype": "float16"},
    "int8-global-twostage-int8": {"mips_quantization": "int8-global", "mips_kernel": "scan",
                                  "mips_twostage": True, "mips_block_size": 1024},
    "int8-global-twostage-float16": {"mips_quantization": "int8-global", "mips_kernel": "scan",
                                     "mips_twostage": True, "mips_rescore_dtype": "float16"},
}


@pytest.mark.parametrize("route", sorted(_SCAN_ROUTES))
def test_flat_index_scan_routes_match_jax(route):
    """The same hits as the JAX FlatIndex: ids equal, scores to rtol 1e-5 /
    atol 1e-6; self-retrieval on top."""
    rng = np.random.default_rng(23)
    n, d, k = 3000, 32, 20
    vectors = _normed(rng, n, d)
    ids = np.array([f"d{i}" for i in range(n)])
    config = {"token_dtype": "float16", **_SCAN_ROUTES[route]}
    queries = vectors[[3, 1500, n - 5]]
    hits = []
    for index in (ji.FlatIndex(config), ti.FlatIndex(config, CPU)):
        index.prepare(d)
        index.index(ids, vectors)
        hits.append(index.search(queries, k))
    (js, jids), (ts, tids) = hits
    assert list(tids[:, 0]) == ["d3", "d1500", f"d{n - 5}"]
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)


# ---- IVF and tree-AH: JAX's saved index in the port ----------------------------

_SHARED_INDEXES = {
    "ivf-float16": (ji.IVFIndex, ti.IVFIndex, {"faiss_ivf_list_count": 12, "faiss_ivf_nprobe": 3}),
    "ivf-float32": (ji.IVFIndex, ti.IVFIndex, {"faiss_ivf_list_count": 12, "faiss_ivf_nprobe": 3,
                                               "token_dtype": "float32"}),
    "ivf-budget": (ji.IVFIndex, ti.IVFIndex, {"faiss_ivf_list_count": 12, "faiss_ivf_nprobe": 6,
                                              "ivf_candidate_rows": 256}),
    "tree_ah": (JaxTreeAH, ScaNNTreeAHIndex, {"scann_num_leaves": 12, "scann_leaves_to_search": 3,
                                              "scann_reorder_mult": 4}),
}


@pytest.mark.parametrize("kind", sorted(_SHARED_INDEXES))
def test_jax_saved_index_searches_the_same_in_the_port(kind, tmp_path):
    """A JAX-built, JAX-saved IVF / tree-AH index loaded by the port: search
    and search_rows equal to JAX's (top_n past the budget pads with -1 / -inf
    in both), storage_bytes equal."""
    jax_cls, torch_cls, config = _SHARED_INDEXES[kind]
    rng = np.random.default_rng(5)
    vectors = _clustered(rng, 2000, 32, 12)
    queries = vectors[:24] + 0.1 * rng.normal(size=(24, 32)).astype(np.float32)
    index = jax_cls(config)
    index.prepare(32)
    index.index(np.arange(2000) + 7, vectors)
    index.save(str(tmp_path))
    port = torch_cls(config, CPU)
    port.load(str(tmp_path))
    assert port.storage_bytes() == index.storage_bytes()
    for top_n in (15, 300):
        assert_same_hits(port.search(queries, top_n), index.search(queries, top_n))
        assert_same_hits(port.search_rows(queries, top_n), index.search_rows(queries, top_n))
    np.testing.assert_array_equal(port.row_ids, index.row_ids)


def test_ah_codes_equal_jax_given_its_leaves():
    """Given the JAX build's leaves, the port's residual codes and
    anisotropic scales are JAX's bit for bit (np.rint: half to even)."""
    rng = np.random.default_rng(8)
    vectors = _clustered(rng, 1500, 48, 10)
    index = JaxTreeAH({"scann_num_leaves": 10})
    index.prepare(48)
    index.index(np.arange(1500), vectors)
    codes, scales = ah_codes(vectors[index._sorted_rows], index._centroids, index._leaf_of_row, 0.2)
    np.testing.assert_array_equal(codes, index._codes)
    np.testing.assert_array_equal(scales.view(np.int32), index._scales.view(np.int32))


# ---- the port's own builds: the recall floors of tests/test_retrieval.py -------

def test_port_ivf_recall_on_well_separated_clusters():
    """tests/test_retrieval.py:74: 10 lists, 5 probed; >= 4 of the exact top 5."""
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(10, 16)).astype(np.float32) * 5
    vectors = np.concatenate([c + rng.normal(scale=0.3, size=(40, 16)).astype(np.float32) for c in centers])
    ids = np.array([f"d{i}" for i in range(len(vectors))])
    index = ti.IVFIndex({"faiss_ivf_list_count": 10, "faiss_ivf_nprobe": 5, "token_dtype": "float32"}, CPU)
    index.prepare(16)
    index.index(ids, vectors)
    q = vectors[[5, 250]]
    _, got = index.search(q, 5)
    exact_top = np.argsort(-(q @ vectors.T), axis=1)[:, :5]
    for qi in range(2):
        assert len({f"d{i}" for i in exact_top[qi]} & set(got[qi])) >= 4, (qi, got[qi])


def test_port_ivf_csr_footprint_recall_and_roundtrip(tmp_path):
    """tests/test_retrieval.py:252: half the corpus in one cluster; CSR under
    2x the flat footprint, top-1 agreement >= 0.9 and recall@10 >= 0.8
    against the exact FlatIndex, save / load unchanged; f32 storage scores
    in f32 (tests/test_retrieval.py:228: self-score first, scores to 1e-5)."""
    rng = np.random.default_rng(42)
    n, d = 20000, 32
    centers = rng.normal(size=(64, d)).astype(np.float32) * 3
    assign = np.concatenate([np.zeros(n // 2, np.int64), rng.integers(1, 64, n - n // 2)])
    vectors = (centers[assign] + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)
    ids = np.arange(n)
    config = {"faiss_ivf_list_count": 64, "faiss_ivf_nprobe": 16, "token_dtype": "float32", "ivf_train_iters": 5}
    index = ti.IVFIndex(config, CPU)
    index.prepare(d)
    index.index(ids, vectors)
    assert index.storage_bytes() < 2 * vectors.nbytes
    queries = vectors[rng.integers(0, n, 32)] + 0.01 * rng.normal(size=(32, d)).astype(np.float32)
    scores, out_ids = index.search(queries, top_n=10)
    exact = ti.FlatIndex({"token_dtype": "float32"}, CPU)
    exact.prepare(d)
    exact.index(ids, vectors)
    exact_scores, exact_ids = exact.search(queries, top_n=10)
    assert np.mean(out_ids[:, 0] == exact_ids[:, 0]) >= 0.9
    assert np.mean([len(set(out_ids[i]) & set(exact_ids[i])) / 10 for i in range(32)]) >= 0.8
    index.save(str(tmp_path))
    again = ti.IVFIndex(config, CPU)
    again.load(str(tmp_path))
    np.testing.assert_array_equal(again.search(queries, top_n=10)[1], out_ids)
    hit = out_ids[:, 0] == exact_ids[:, 0]
    np.testing.assert_allclose(scores[hit, 0], exact_scores[hit, 0], rtol=1e-5)


def test_port_ivf_budget_overflow_drops_worst_probes():
    """tests/test_retrieval.py:303: every list probed into a 640-row budget
    (balanced ~250-row clusters): the query's own, best-ranked cluster
    survives, so its true top 5 do."""
    local = np.random.default_rng(11)
    n, d, n_centers = 2000, 16, 8
    centers = local.normal(size=(n_centers, d)).astype(np.float32) * 6
    assign = np.repeat(np.arange(n_centers), n // n_centers)
    vectors = (centers[assign] + local.normal(size=(n, d))).astype(np.float32)
    index = ti.IVFIndex({"faiss_ivf_list_count": n_centers, "faiss_ivf_nprobe": n_centers, "token_dtype": "float32",
                         "ivf_train_iters": 8, "ivf_candidate_rows": 640}, CPU)
    index.prepare(d)
    index.index(np.arange(n), vectors)
    queries = vectors[:4]
    _, out_ids = index.search(queries, top_n=5)
    exact = np.argsort(-(queries @ vectors.T), axis=1)[:, :5]
    for i in range(4):
        assert int(out_ids[i][0]) == int(exact[i][0])
        assert len(set(map(int, out_ids[i])) & set(map(int, exact[i]))) >= 4


def test_port_tree_ah_recall_footprint_and_roundtrip(tmp_path):
    """tests/test_retrieval.py:645 through build_index: recall@10 >= 0.9,
    the reorder's exact scores, codes + scales + leaves on top of the rows,
    save / load unchanged."""
    rng = np.random.default_rng(42)
    n, d, n_centers = 4096, 32, 16
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * 4
    vectors = (centers[np.repeat(np.arange(n_centers), n // n_centers)] + rng.normal(size=(n, d))).astype(np.float32)
    ids = np.arange(n) + 10
    config = {"faiss_index_type": "scann", "scann_backend": "tree_ah", "scann_num_leaves": n_centers,
              "scann_leaves_to_search": 6, "scann_reorder_mult": 4, "token_dtype": "float16"}
    index = ti.build_index(config, CPU)
    assert isinstance(index, ScaNNTreeAHIndex)
    index.prepare(d)
    index.index(ids, vectors)
    assert index.storage_bytes() > vectors.astype(np.float16).nbytes
    queries = vectors[rng.integers(0, n, 32)] + 0.05 * rng.normal(size=(32, d)).astype(np.float32)
    scores, out_ids = index.search(queries, top_n=10)
    exact = np.argsort(-(queries @ vectors.T), axis=1)[:, :10]
    recall = np.mean([len(set(out_ids[i]) & set(ids[exact[i]])) / 10 for i in range(32)])
    assert recall >= 0.9, recall
    best = queries[0] @ vectors[out_ids[0][0] - 10].astype(np.float16).astype(np.float32)
    assert abs(scores[0][0] - best) <= 1e-4 * abs(best)
    index.save(str(tmp_path))
    again = ScaNNTreeAHIndex(config, CPU)
    again.load(str(tmp_path))
    np.testing.assert_array_equal(again.search(queries[:4], top_n=10)[1], out_ids[:4])


def test_port_tree_ah_anisotropic_scale_reduces_parallel_error():
    """tests/test_retrieval.py:692: gamma shrinks the score-direction error
    of the codes by > 10 % against plain absmax / 127 scales."""
    rng = np.random.default_rng(42)
    n, d = 1024, 64
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    index = ScaNNTreeAHIndex({"scann_num_leaves": 8, "token_dtype": "float16"}, CPU)
    index.prepare(d)
    index.index(np.arange(n), vectors)
    r = vectors[index._sorted_rows] - index._centroids[index._leaf_of_row]
    rr = np.maximum(np.einsum("nd,nd->n", r, r), 1e-12)

    def parallel_error(scale):
        err = r - index._codes.astype(np.float32) * scale[:, None]
        return (np.abs(np.einsum("nd,nd->n", err, r)) / rr).mean()

    plain = np.maximum(np.abs(r).max(axis=1) / 127.0, 1e-12)
    assert parallel_error(index._scales) < 0.9 * parallel_error(plain)


# ---- the streaming index -------------------------------------------------------

def _token_encode(table):
    def encode(ids, mask):
        v = table[ids.long()] * mask[..., None]
        return v.sum(1) / mask.sum(1, keepdim=True).clamp(min=1)
    return encode


@pytest.fixture(scope="module")
def encoded_folder(tmp_path_factory):
    """A corpus the port's encode_corpus wrote: 150 passages of a seeded
    vocabulary, mean token vectors (16-d, float16 blocks of 40 rows, the last
    one short)."""
    root = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(300)]
    with open(root / "collection.tsv", "w") as f:
        for i in range(150):
            f.write(f"p{i}\t{' '.join(rng.choice(words, size=rng.integers(3, 12)))}\n")
    config = {"bert_pretrained_model": "bert-tiny-random", "max_doc_length": 16, "batch_size_inference": 32,
              "token_dtype": "float16", "token_block_size": 40}
    tok = build_tokenizer(config)
    table = torch.from_numpy(np.random.default_rng(4).normal(size=(tok.vocab_size, 16)).astype(np.float32))
    encode_corpus(_token_encode(table), config, tok, str(root / "collection.tsv"), str(root / "enc"), CPU)
    return str(root / "enc")


@pytest.mark.parametrize("top_n", [7, 100, 200])
def test_streaming_index_equals_exact_search(encoded_folder, top_n):
    """Over the folder's 4 blocks: the exact f32 search of the stored rows
    (tests/test_retrieval.py:160), top_n wider than a block (:191) and than
    the corpus (padded with -1 / -inf); JAX's StreamingFlatIndex gives the
    same."""
    vectors, row_ids = load_encoded(encoded_folder)
    assert vectors.dtype == np.float16
    queries = np.random.default_rng(9).normal(size=(5, 16)).astype(np.float32)
    index = ti.StreamingFlatIndex({}, CPU)
    index.index_from_folder(encoded_folder)
    got = index.search(queries, top_n)
    scores = queries.astype(np.float64) @ vectors.astype(np.float64).T
    order = np.argsort(-scores, axis=1, kind="stable")[:, :top_n]
    want_v = np.take_along_axis(scores, order, axis=1)
    want_i = row_ids[order]
    width = min(top_n, len(vectors))
    assert_same_hits((got[0][:, :width], got[1][:, :width]), (want_v, want_i))
    assert (got[1][:, width:] == "").all() and np.isneginf(got[0][:, width:]).all()
    jax_index = ji.StreamingFlatIndex({})
    jax_index.index_from_folder(encoded_folder)
    assert_same_hits(got, jax_index.search(queries, top_n))


def test_streaming_index_saves_the_folder_and_searches_in_memory(encoded_folder, tmp_path):
    """save / load keep the encode folder's path (streaming_meta.json, read
    by both packages); the in-memory ``index`` is one block."""
    index = ti.StreamingFlatIndex({"encode_folder": encoded_folder}, CPU)
    index.save(str(tmp_path))
    again = ti.StreamingFlatIndex({}, CPU)
    again.load(str(tmp_path))
    jax_again = ji.StreamingFlatIndex({})
    jax_again.load(str(tmp_path))
    queries = np.random.default_rng(10).normal(size=(3, 16)).astype(np.float32)
    assert_same_hits(again.search(queries, 12), jax_again.search(queries, 12))
    vectors, row_ids = load_encoded(encoded_folder)
    memory = ti.StreamingFlatIndex({}, CPU)
    memory.index(row_ids, vectors)
    assert_same_hits(memory.search(queries, 12), again.search(queries, 12))


def test_streaming_search_fetches_once_whatever_the_blocks(encoded_folder, monkeypatch):
    """No host sync inside the block loop: the device results come back by
    the same two ``.cpu()`` calls for 4 blocks as for 1, and nothing calls
    ``.item()``."""
    calls = {"cpu": 0, "item": 0}
    for name in calls:
        original = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _original=original, **kw):
            calls[_name] += 1
            return _original(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    queries = np.random.default_rng(11).normal(size=(4, 16)).astype(np.float32)
    vectors, row_ids = load_encoded(encoded_folder)
    counts = []
    for blocks in (1, 4):
        index = ti.StreamingFlatIndex({}, CPU)
        if blocks == 1:
            index.index(row_ids, vectors)
        else:
            index.index_from_folder(encoded_folder)
        assert len(index._blocks) == blocks
        calls.update(cpu=0, item=0)
        index.search(queries, 50)
        counts.append(dict(calls))
    assert counts[0] == counts[1] == {"cpu": 2, "item": 0}, counts


# ---- HNSW ----------------------------------------------------------------------

def test_hnsw_jax_graph_searches_the_same_in_the_port(tmp_path):
    """A graph JAX built and saved (hnsw_graph.bin + hnsw_ids.npy), loaded
    by the port: identical scores and ids. The port's library is built from
    native/hnsw.cpp under build/native/."""
    rng = np.random.default_rng(2)
    vectors = _normed(rng, 3000, 32)
    index = JaxHNSWIndex({"faiss_hnsw_graph_neighbors": 16, "hnsw_ef_search": 64})
    index.index(np.arange(3000) + 5, vectors)
    index.save(str(tmp_path))
    port = th.HNSWIndex({"hnsw_ef_search": 64}, CPU)
    port.load(str(tmp_path))
    for got, want in zip(port.search(vectors[:50], 10), index.search(vectors[:50], 10)):
        np.testing.assert_array_equal(got, want)
    path = th.library_path()
    assert path.parent == th.BUILD_DIR and path.parent.parts[-2:] == ("build", "native") and path.exists()
    assert port._lib._name == str(path)


def test_hnsw_port_build_recall_and_roundtrip(tmp_path):
    """tests/test_retrieval.py:332 with the port's own graph: top-1 >= 0.95
    and recall@10 >= 0.85 against exact search, save / load unchanged."""
    rng = np.random.default_rng(42)
    n, d = 5000, 32
    vectors = _normed(rng, n, d)
    index = ti.build_index({"faiss_index_type": "hnsw", "faiss_hnsw_graph_neighbors": 16, "hnsw_ef_search": 128,
                            "token_dtype": "float32"}, CPU)
    assert isinstance(index, th.HNSWIndex)
    index.prepare(d)
    index.index(np.arange(n), vectors)
    queries = vectors[rng.integers(0, n, 64)]
    _, out_ids = index.search(queries, top_n=10)
    exact = np.argsort(-(queries @ vectors.T), axis=1)[:, :10]
    assert np.mean(out_ids[:, 0] == exact[:, 0]) >= 0.95
    assert np.mean([len(set(out_ids[i]) & set(exact[i])) / 10 for i in range(64)]) >= 0.85
    index.save(str(tmp_path))
    again = th.HNSWIndex({"hnsw_ef_search": 128}, CPU)
    again.load(str(tmp_path))
    np.testing.assert_array_equal(again.search(queries, top_n=10)[1], out_ids)


def test_hnsw_never_opens_the_prebuilt_library():
    """In a fresh interpreter the port builds (or finds) its own library and
    searches, and native/libmmhnsw.so is never mapped into the process."""
    code = ("import numpy as np\n"
            "from matchmaker_tpu_torch.retrieval.hnsw import HNSWIndex\n"
            "i = HNSWIndex({}, 'cpu'); v = np.eye(8, dtype=np.float32); i.index(np.arange(8), v)\n"
            "assert list(i.search(v[:2], 1)[1][:, 0]) == [0, 1]\n"
            "print(open('/proc/self/maps').read())\n")
    maps = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True,
                          env=dict(os.environ, PYTHONPATH=REPO)).stdout
    assert "build/native/libmmhnsw_" in maps
    assert os.path.join("native", "libmmhnsw.so") not in maps


def test_hnsw_raises_when_the_library_cannot_be_built(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile makes HNSWIndex and
    build_index raise (the JAX factory would build an IVF index)."""
    bad = tmp_path / "hnsw.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(th, "SOURCE", bad)
    monkeypatch.setattr(th, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(th, "_lib", None)
    with pytest.raises(RuntimeError, match="could not be built"):
        th.HNSWIndex({}, CPU)
    with pytest.raises(RuntimeError, match="could not be built"):
        ti.build_index({"faiss_index_type": "hnsw"}, CPU)
    assert not list((tmp_path / "build").glob("*.so"))


# ---- the factory -----------------------------------------------------------------

@pytest.mark.parametrize("kind,extra,cls", [
    ("flat", {}, "FlatIndex"), ("exact", {}, "FlatIndex"), ("full", {}, "FlatIndex"),
    ("scann", {}, "FlatIndex"), ("scann", {"scann_backend": "tree_ah"}, "ScaNNTreeAHIndex"),
    ("ivf", {}, "IVFIndex"), ("hnsw", {}, "HNSWIndex"), ("streaming", {}, "StreamingFlatIndex"),
    ("sharded_ondisk", {}, "StreamingFlatIndex"), ("dynamic", {}, "DynamicClusterIndex")])
def test_build_index_dispatches_every_kind(kind, extra, cls):
    """Every faiss_index_type of the JAX factory (the mesh aside), to the
    same class; scann's binmax default keeps float16 + binmax."""
    config = {"faiss_index_type": kind, **extra}
    index = ti.build_index(config, CPU)
    assert type(index).__name__ == cls == type(ji.build_index(config)).__name__
    assert index.device == CPU
    if kind == "scann" and not extra:
        assert index.f16_scan and index.binmax


def test_build_index_defaults_to_the_card_and_refuses_unknown_kinds():
    assert ti.build_index({"faiss_index_type": "ivf"}).device.type == "cuda"
    with pytest.raises(ValueError, match="unknown faiss_index_type"):
        ti.build_index({"faiss_index_type": "annoy"}, CPU)
    with pytest.raises(ValueError, match="unknown mips_quantization"):
        ti.FlatIndex({"mips_quantization": "int4"}, CPU)
    assert not any(_build.LAUNCHES.values())


def test_encoded_folder_meta_is_the_jax_format(encoded_folder):
    with open(os.path.join(encoded_folder, "encode_meta.json")) as f:
        meta = json.load(f)
    assert meta == {"dim": 16, "dtype": "float16", "blocks": 4, "sequences": 150}


@pytest.mark.parametrize("n", [1, 9000, 12289])
def test_row_parallel_host_codes_equal_the_serial_ones(n):
    """The host quantizers and tree-AH's residual codes by blocks of 4,096
    rows (of whole bins) on a thread pool equal one serial pass bit for
    bit: the JAX package's quantizers (codes, scales, the global scale) and
    the serial ``ah_codes``; 9,000 and 12,289 rows span three and four
    blocks, the last one partial."""
    from matchmaker_tpu.ops import mips_quant as jq
    from matchmaker_tpu_torch.ops import mips_quant as tq
    from matchmaker_tpu_torch.retrieval.scann_tree_ah import ah_codes_parallel

    rng = np.random.default_rng(n)
    v = (rng.normal(size=(n, 24)) * rng.uniform(0.1, 3.0, size=(n, 1))).astype(np.float32)
    for threaded, serial in ((tq.quantize_corpus(v, True), jq.quantize_corpus(v, True)),
                             (tq.quantize_corpus(v, False), jq.quantize_corpus(v, False)),
                             (tq.quantize_corpus_binwise(v), jq.quantize_corpus_binwise(v))):
        np.testing.assert_array_equal(threaded[0], serial[0])
        np.testing.assert_array_equal(np.asarray(threaded[1]).view(np.int32), np.asarray(serial[1]).view(np.int32))
    centroids = rng.normal(size=(5, 24)).astype(np.float32)
    rows = rng.permutation(n)
    leaf = np.sort(rng.integers(0, 5, size=n)).astype(np.int32)
    want = ah_codes(v[rows], centroids, leaf, 0.2)
    got = ah_codes_parallel(v, rows, centroids, leaf, 0.2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
