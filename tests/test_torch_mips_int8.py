"""The port's int8 search (ops/mips_quant.py, the int8 and mixed modes of
ops/mips_binmax.py, FlatIndex's int8 routes) against the JAX package, and
the int8 serving slice end to end through both CLIs.

On CPU tensors the port runs the plain versions of its kernels (K7, K8, K4,
K6); the JAX side runs its jnp references (``use_pallas=False``), which the
JAX package's own tests hold to its Pallas kernels. Corpora and tolerances
follow tests/test_perf_ops.py: identical ids, values to rtol 1e-6."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips_binmax as jb
from matchmaker_tpu.ops import mips_quant as jq
from matchmaker_tpu.retrieval.indexes import FlatIndex as JaxFlatIndex
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import mips_binmax as tb
from matchmaker_tpu_torch.ops import mips_quant as tq
from matchmaker_tpu_torch.retrieval.indexes import FlatIndex


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n,d", [(500, 32), (3000, 24)])
def test_quantizers_bit_identical(n, d):
    """quantize_corpus (per row, global) and quantize_corpus_binwise give
    the JAX package's codes and scales bit for bit."""
    v = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    for per_row in (True, False):
        (jv, js), (tv, ts) = jq.quantize_corpus(v, per_row), tq.quantize_corpus(v, per_row)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(_bits(ts), _bits(js))
    (jv, js), (tv, ts) = jq.quantize_corpus_binwise(v), tq.quantize_corpus_binwise(v)
    assert tv.shape[0] % 128 == 0 and ts.shape == (tv.shape[0] // 128, 1)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def _binwise_corpus(seed, n=3000, d=32, q=7):
    rng = np.random.default_rng(seed)
    corpus_f = rng.normal(size=(n, d)).astype(np.float32)
    values, bscales = jq.quantize_corpus_binwise(corpus_f)  # pads to 3072
    queries = rng.normal(size=(q, d)).astype(np.float32)
    return corpus_f, values, bscales, queries


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("level2", [None, jb.L2_MID])
def test_int8_candidates_match_jnp(mixed, level2):
    """K7 (int8 queries) and K8 (bf16 queries) plain candidates against
    binmax_candidates_jnp on the padding path (3000 rows): identical ids,
    values to rtol 1e-6."""
    n = 3000
    _, values, bscales, queries_f = _binwise_corpus(21 if not mixed else 31)
    if mixed:
        queries, qs = queries_f, None
    else:
        q_scale = np.maximum(np.abs(queries_f).max(axis=1, keepdims=True) / 127.0, 1e-10)
        queries = np.clip(np.round(queries_f / q_scale), -127, 127).astype(np.int8)
        qs = q_scale.astype(np.float32)
    want = jb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(values), tile_rows=512, n_valid=n,
                                    corpus_scales=jnp.asarray(bscales),
                                    query_scales=None if mixed else jnp.asarray(qs), level2=level2)
    _build.reset_launches()
    got = tb.binmax_candidates(torch.from_numpy(queries), torch.from_numpy(values), n_valid=n, tile_rows=512,
                               level2=level2, corpus_scales=torch.from_numpy(bscales),
                               query_scales=None if mixed else torch.from_numpy(qs))
    assert not any(_build.LAUNCHES.values())
    assert got.shape == want.shape
    cols = np.broadcast_to(np.arange(got.shape[1]), got.shape)
    wv, wi = map(np.asarray, jb.unpack_candidates(want, jnp.asarray(cols), 512, 2, level2=level2))
    gv, gi = tb.unpack_candidates(got, torch.from_numpy(np.ascontiguousarray(cols)).long(), 512, 2, level2)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-6)


@pytest.mark.parametrize("mixed", [False, True])
def test_int8_scan_topk_matches_jax(mixed):
    """binmax_scan_topk over an int8 corpus (queries quantized inside, or
    kept bf16): identical ids and values as the JAX package's."""
    n, k = 3000, 8
    _, values, bscales, queries = _binwise_corpus(22)
    wv, wi = jb.binmax_scan_topk(jnp.asarray(queries), jnp.asarray(values), k, tile_rows=512, n_valid=n,
                                 use_pallas=False, corpus_scales=jnp.asarray(bscales), mixed_queries=mixed)
    gv, gi = tb.binmax_scan_topk(torch.from_numpy(queries), torch.from_numpy(values), k, n_valid=n, tile_rows=512,
                                 corpus_scales=torch.from_numpy(bscales), mixed_queries=mixed)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)


@pytest.mark.parametrize("rescore_rows", [False, True])
def test_rescore_topk_matches_jax(rescore_rows):
    """binmax_rescore_topk (int8 scan + exact rescore, against the codes or
    16-bit rows) on test_perf_ops.py's corpus: identical ids."""
    rng = np.random.default_rng(21)
    n, d, k = 8192, 64, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.normal(size=(6, d)).astype(np.float32)
    v8, bs = jq.quantize_corpus_binwise(corpus)
    rows = corpus.astype(np.float16) if rescore_rows else None
    wv, wi = jb.binmax_rescore_topk(jnp.asarray(queries), jnp.asarray(v8), jnp.asarray(bs), k, oversample=4,
                                    tile_rows=512, use_pallas=False,
                                    rescore_corpus=None if rows is None else jnp.asarray(rows))
    gv, gi = tb.binmax_rescore_topk(torch.from_numpy(queries), torch.from_numpy(v8), torch.from_numpy(bs), k,
                                    oversample=4, tile_rows=512,
                                    rescore_corpus=None if rows is None else torch.from_numpy(rows))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
    assert (np.diff(gv.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("per_row", [True, False])
def test_quantized_blocked_topk_matches_jax(per_row):
    """The exact int8 scan (approx=False), per-row and one global scale,
    with a masked tail: identical ids and values."""
    rng = np.random.default_rng(7)
    c = rng.normal(size=(500, 32)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    values, scales = jq.quantize_corpus(c, per_row)
    wv, wi = jq.quantized_blocked_topk(jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=10,
                                       block_size=128, approx=False, n_valid=450)
    gv, gi = tq.quantized_blocked_topk(torch.from_numpy(q), torch.from_numpy(values),
                                       torch.from_numpy(np.asarray(scales)), k=10, block_size=128, n_valid=450)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)
    assert gi.max() < 450


_ROUTES = {
    "int8-binmax": {"mips_quantization": "int8"},
    "mixed": {"mips_quantization": "int8", "mips_int8_queries": "float"},
    "twostage-int8": {"mips_quantization": "int8", "mips_twostage": True},
    "twostage-float16": {"mips_quantization": "int8", "mips_twostage": True, "mips_rescore_dtype": "float16"},
    "int8-scan": {"mips_quantization": "int8", "mips_kernel": "scan"},
    "int8-global-scan": {"mips_quantization": "int8-global", "mips_kernel": "scan"},
    "int8-scan-twostage": {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True},
    "int8-global-scan-twostage-float16": {"mips_quantization": "int8-global", "mips_kernel": "scan",
                                          "mips_twostage": True, "mips_rescore_dtype": "float16"},
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("n", [160, 8 * 2048])
def test_flat_index_int8_routes_match_jax(route, n):
    """FlatIndex's int8 routes on tests/test_perf_ops.py's corpora: the same
    hits as the JAX FlatIndex (self-retrieval on top), the binmax routes at
    160 rows through the exact int8 fallback and at 16,384 through the
    binmax scans, the scan routes (the two-stage rescore included) through
    the exact int8 scan at both."""
    rng = np.random.default_rng(23)
    d, k = 24, 5
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    ids = np.array([f"d{i}" for i in range(n)])
    config = {"token_dtype": "float16", "mips_kernel": "binmax", **_ROUTES[route]}
    q = vectors[[3, n - 5]]
    hits = []
    for index in (JaxFlatIndex(config), FlatIndex(config, "cpu")):
        index.prepare(d)
        index.index(ids, vectors)
        hits.append(index.search(q, k))
    (js, jids), (ts, tids) = hits
    assert np.isfinite(ts).all()
    assert tids[0][0] == "d3" and tids[1][0] == f"d{n - 5}", tids
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)


# ---- the int8 serving slice through both CLIs --------------------------------

from test_torch_dense_retrieval import _config, _ranking, _seeded_params, _write_data  # noqa: E402

from matchmaker_tpu.cli.dense_retrieval import run as jax_run  # noqa: E402
from matchmaker_tpu.training.checkpoints import save_params  # noqa: E402
from matchmaker_tpu_torch.cli.dense_retrieval import run as torch_run  # noqa: E402
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, save_npz  # noqa: E402

_SEARCH_MODES = {"mixed": {"mips_int8_queries": "float"},
                 "int8-twostage": {"mips_int8_queries": "int8", "mips_twostage": True}}


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    """encode+index+search with encoder_int8 and an int8 index, searched
    with mips_int8_queries: float; then index+search of a copy of each run
    folder with int8 queries and the two-stage rescore."""
    root = str(tmp_path_factory.mktemp("int8_slice"))
    _write_data(root)
    config = dict(_config(root), encoder_int8=True, mips_quantization="int8", mips_kernel="binmax")
    params = _seeded_params(config)
    os.makedirs(config["trained_model"])
    save_params(os.path.join(config["trained_model"], "best-model.flax"), params)
    save_npz(os.path.join(config["trained_model"], "best-model.npz"), flax_to_state_dict(params))
    folders = {}
    for name, fn in (("jax", jax_run), ("torch", torch_run)):
        first = os.path.join(root, name, "mixed")
        os.makedirs(first)
        _build.reset_launches()
        assert fn("encode+index+search", dict(config, **_SEARCH_MODES["mixed"]), first) == 0
        second = os.path.join(root, name, "int8-twostage")
        shutil.copytree(first, second)
        assert fn("index+search", dict(config, **_SEARCH_MODES["int8-twostage"]), second) == 0
        folders[name] = {"mixed": first, "int8-twostage": second}
    assert not any(_build.LAUNCHES.values())  # CPU tensors: plain versions only
    return folders


@pytest.mark.parametrize("mode", sorted(_SEARCH_MODES))
def test_int8_slice_rankings_match_jax(int8_runs, mode):
    """The int8-encoded, int8-indexed run files of the two CLIs overlap by
    >= 0.99 at top-10."""
    rj = _ranking(os.path.join(int8_runs["jax"][mode], "dev-output.txt"))
    rt = _ranking(os.path.join(int8_runs["torch"][mode], "dev-output.txt"))
    assert rj.keys() == rt.keys() and all(len(v) == 10 for v in rt.values())
    overlap = np.mean([len(set(rj[q]) & set(rt[q])) / 10 for q in rj])
    assert overlap >= 0.99, overlap
