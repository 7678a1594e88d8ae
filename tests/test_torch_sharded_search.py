"""The port's sharded searches on an 8-entry CPU mesh against the JAX
package's on its 8 virtual CPU devices (tests/conftest.py): each sharded op,
every FlatIndex route, the two-axis ("dcn", "ici") mesh, the sharded IVF
search on a JAX-saved index (skewed clusters too), and tree-AH, whose JAX
search raises under a mesh while the port's routes to IVF's sharded search.

Ids equal, scores to rtol 1e-5 / atol 1e-6 (tests/test_torch_indexes.py's
``assert_same_hits``: two hits whose scores tie within the tolerance may
swap). Corpora that leave the last shards wholly or partly padded check the
local validity bounds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips as jmips
from matchmaker_tpu.ops import mips_binmax as jbm
from matchmaker_tpu.ops import mips_f16 as jf16
from matchmaker_tpu.ops import mips_quant as jq
from matchmaker_tpu.ops import mips_twostage as jt
from matchmaker_tpu.parallel import mesh as jmesh
from matchmaker_tpu.retrieval import indexes as ji
from matchmaker_tpu.retrieval.scann_tree_ah import ScaNNTreeAHIndex as JaxTreeAH
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_indexes import _clustered, _normed, assert_same_hits

from matchmaker_tpu_torch.ops import mips as tmips
from matchmaker_tpu_torch.ops import mips_binmax as tbm
from matchmaker_tpu_torch.ops import mips_f16 as tf16
from matchmaker_tpu_torch.ops import mips_quant as tq
from matchmaker_tpu_torch.ops import mips_twostage as tt
from matchmaker_tpu_torch.parallel import mesh as tmesh
from matchmaker_tpu_torch.retrieval import indexes as ti
from matchmaker_tpu_torch.retrieval.scann_tree_ah import ScaNNTreeAHIndex

CPU = torch.device("cpu")


def _meshes(shape=None):
    """(JAX mesh over the 8 virtual devices, port mesh of 8 CPU entries)."""
    assert len(jax.devices()) == 8
    if shape is None:
        return jmesh.make_mesh(), tmesh.make_mesh(devices=[CPU] * 8)
    names = ("dcn", "ici")
    return jmesh.make_mesh(names, shape=shape), tmesh.make_mesh(names, devices=[CPU] * 8, shape=shape)


def _pair(v, j):
    return np.asarray(v), np.asarray(j)


def _jit(fn, **static):
    """A JAX sharded op jitted with its static arguments bound (an eager
    shard_map dispatches its per-shard ops one by one)."""
    return jax.jit(functools.partial(fn, **static))


# ---- the sharded ops -----------------------------------------------------------

def test_sharded_topk_mips_matches_jax():
    """f32 blocked scan a shard, ids offset by the shard, one merge."""
    rng = np.random.default_rng(1)
    jm, tm = _meshes()
    corpus = rng.normal(size=(8 * 48, 16)).astype(np.float32)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    want = _pair(*_jit(jmips.sharded_topk_mips, k=30, mesh=jm, block_size=32)(q, corpus))
    got = tmips.sharded_topk_mips(torch.from_numpy(q), tmesh.shard_rows(tm, corpus), 30, tm, block_size=32)
    assert_same_hits(_pair(*got), want)


@pytest.mark.parametrize("n_valid", [8 * 64, 5 * 64 + 17])
def test_sharded_f16_scan_matches_jax(n_valid):
    """A padded tail shard (n_valid inside shard 5, shards 6-7 all padding):
    its rows never enter, its -inf slots carry -1."""
    rng = np.random.default_rng(2)
    jm, tm = _meshes()
    corpus = np.zeros((8 * 64, 24), np.float16)
    corpus[:n_valid] = _normed(rng, n_valid, 24)
    q = _normed(rng, 4, 24)
    want = _pair(*_jit(jf16.sharded_f16_scan_topk, k=40, mesh=jm, n_valid=n_valid, approx=False)(q, corpus))
    got = tf16.sharded_f16_scan_topk(torch.from_numpy(q), tmesh.shard_rows(tm, corpus), 40, tm, n_valid=n_valid)
    assert_same_hits(_pair(*got), want)
    assert (got[1].numpy() < n_valid).all()


@pytest.mark.parametrize("scale", ["per_row", "global"])
def test_sharded_quantized_and_twostage_match_jax(scale):
    rng = np.random.default_rng(3)
    jm, tm = _meshes()
    n_valid = 8 * 40 - 45
    vectors = np.zeros((8 * 40, 32), np.float32)
    vectors[:n_valid] = _normed(rng, n_valid, 32)
    values, scales = jq.quantize_corpus(vectors, per_row=scale == "per_row")
    q = _normed(rng, 6, 32)
    t_scales = tmesh.shard_rows(tm, scales) if np.ndim(scales) else torch.from_numpy(np.asarray(scales))
    t_values = tmesh.shard_rows(tm, values)
    want = _pair(*_jit(jq.sharded_quantized_topk, k=25, mesh=jm, block_size=16, approx=False,
                            n_valid=n_valid)(q, values, scales))
    got = tq.sharded_quantized_topk(torch.from_numpy(q), t_values, t_scales, 25, tm, block_size=16, n_valid=n_valid)
    assert_same_hits(_pair(*got), want)
    rescore = vectors.astype(np.float16)
    want = _pair(*_jit(jt.sharded_twostage_topk, k=12, mesh=jm, n_valid=n_valid, block_size=16,
                            oversample=2)(q, values, scales, rescore_corpus=rescore))
    got = tt.sharded_twostage_topk(torch.from_numpy(q), t_values, t_scales, 12, tm,
                                   rescore_corpus=tmesh.shard_rows(tm, rescore), n_valid=n_valid, block_size=16,
                                   oversample=2)
    assert_same_hits(_pair(*got), want)


_BINMAX_OPS = {
    "bf16": {},
    "int8": {"int8": True},
    "mixed": {"int8": True, "mixed_queries": True},
    "rescore": {"int8": True, "rescore": True},
}


@pytest.mark.parametrize("n_valid", [8 * 2048, 5 * 2048 + 700])
@pytest.mark.parametrize("op", sorted(_BINMAX_OPS))
def test_sharded_binmax_matches_jax(op, n_valid):
    """One scan a shard with its local bound (valid_bound), the gate on the
    fullest shard's fill, the id filter; shards of 2048 rows, per_bin 8
    (grain 2048), level 2 off (the pool of 128 candidates a shard is below
    16k): every shard full, or shard 5 partly and shards 6-7 wholly padded,
    whose padded bins leave -inf, not ids."""
    spec = _BINMAX_OPS[op]
    rng = np.random.default_rng(4)
    jm, tm = _meshes()
    n, d, k = 8 * 2048, 32, 10
    vectors = np.zeros((n, d), np.float32)
    vectors[:n_valid] = _clustered(rng, n_valid, d, 16)
    q = vectors[rng.integers(0, n_valid, 6)] + 0.05 * rng.normal(size=(6, d)).astype(np.float32)
    tq_ = torch.from_numpy(q)
    if spec.get("int8"):
        values, bin_scales = jq.quantize_corpus_binwise(vectors)
        tv, ts = tmesh.shard_rows(tm, values), tmesh.shard_rows(tm, bin_scales)
        if spec.get("rescore"):
            want = _jit(jbm.sharded_binmax_rescore_topk, k=k, mesh=jm, n_valid=n_valid, per_bin=8,
                        oversample=4)(q, values, bin_scales)
            got = tbm.sharded_binmax_rescore_topk(tq_, tv, ts, k, tm, n_valid=n_valid, per_bin=8, oversample=4)
        else:
            mixed = spec.get("mixed_queries", False)
            want = _jit(jbm.sharded_binmax_topk, k=k, mesh=jm, n_valid=n_valid, per_bin=8,
                        mixed_queries=mixed)(q, values, corpus_scales=bin_scales)
            got = tbm.sharded_binmax_topk(tq_, tv, k, tm, n_valid=n_valid, per_bin=8, corpus_scales=ts,
                                          mixed_queries=mixed)
    else:
        corpus = vectors.astype(jnp.bfloat16)
        want = _jit(jbm.sharded_binmax_topk, k=k, mesh=jm, n_valid=n_valid, per_bin=8)(q, corpus)
        got = tbm.sharded_binmax_topk(tq_, tmesh.shard_rows(tm, vectors, torch.bfloat16), k, tm, n_valid=n_valid,
                                      per_bin=8)
    assert_same_hits(_pair(*got), _pair(*want))
    assert (got[1].numpy() < n_valid).all()


@pytest.mark.parametrize("level2", [True, False])
def test_valid_bound_masks_the_columns_jax_masks(level2):
    """The candidate columns' bin starts: the port's layout arithmetic
    against JAX's, level 2 (keep 8 of 32) and level 1."""
    width = 1024 if level2 else 512
    want = np.asarray(jbm._column_bin_starts(width, 2048, 4, jbm.L2_MID if level2 else None))
    got = tbm._column_bin_starts(width, 2048, 4, tbm.L2_MID if level2 else None, CPU)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- every FlatIndex route -----------------------------------------------------

_ROUTES = {
    "none": {"mips_quantization": "none", "token_dtype": "float32", "mips_block_size": 512},
    "float16-binmax": {"mips_quantization": "float16", "mips_kernel": "binmax"},
    "float16-binmax-exact-fallback": {"mips_quantization": "float16", "mips_kernel": "binmax", "k": 200},
    "float16-scan": {"mips_quantization": "float16", "mips_kernel": "scan", "mips_block_size": 1024},
    "int8-binmax": {"mips_quantization": "int8", "mips_kernel": "binmax"},
    "int8-binmax-mixed": {"mips_quantization": "int8", "mips_kernel": "binmax", "mips_int8_queries": "float"},
    "int8-binmax-rescore": {"mips_quantization": "int8", "mips_kernel": "binmax", "mips_twostage": True},
    "int8-binmax-rescore-float16": {"mips_quantization": "int8", "mips_kernel": "binmax", "mips_twostage": True,
                                    "mips_rescore_dtype": "float16"},
    "int8-binmax-exact-fallback": {"mips_quantization": "int8", "mips_kernel": "binmax", "k": 200},
    "int8-scan": {"mips_quantization": "int8", "mips_kernel": "scan"},
    "int8-global-scan-twostage": {"mips_quantization": "int8-global", "mips_kernel": "scan",
                                  "mips_twostage": True, "mips_rescore_dtype": "float16"},
    "int8-scan-twostage": {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True},
}


def _flat_pair(config, vectors, ids, shape=None):
    jm, tm = _meshes(shape)
    pair = []
    for index in (ji.FlatIndex(config, jm), ti.FlatIndex(config, CPU, tm)):
        index.prepare(vectors.shape[1])
        index.index(ids, vectors)
        pair.append(index)
    return pair


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_flat_index_routes_on_the_mesh_match_jax(route):
    """Each route over 8 shards against the JAX FlatIndex on 8 devices: 3,000
    rows, so the binmax routes' 8 x 8,192 padded rows leave shard 0 partly
    and shards 1-7 wholly padded; search and search_rows alike."""
    config = {"token_dtype": "float16", "mips_per_bin": 2, **_ROUTES[route]}
    k = config.pop("k", 20)
    rng = np.random.default_rng(6)
    n = 3000
    vectors = _clustered(rng, n, 32, 12)
    ids = np.array([f"d{i}" for i in range(n)])
    queries = vectors[[3, 1500, n - 5, 77]] + 0.05 * rng.normal(size=(4, 32)).astype(np.float32)
    jax_index, port = _flat_pair(config, vectors, ids)
    assert port.n_shards == 8
    assert_same_hits(port.search_rows(queries, k), jax_index.search_rows(queries, k))
    js, jid = jax_index.search(queries, k)
    ts, tid = port.search(queries, k)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    assert (tid == jid).mean() > 0.95


def test_flat_index_binmax_with_a_partial_tail_shard_matches_jax():
    """15,000 rows over 8 shards of 2,048 (per_bin 8 sets the grain at
    2,048): shards 0-6 full, the tail shard 664 real rows and 1,384 padded,
    on the float16 and int8 binmax routes."""
    rng = np.random.default_rng(7)
    n = 15_000
    vectors = _clustered(rng, n, 32, 24)
    ids = np.arange(n)
    queries = vectors[rng.integers(0, n, 5)] + 0.05 * rng.normal(size=(5, 32)).astype(np.float32)
    for quant in ("float16", "int8"):
        config = {"token_dtype": "float16", "mips_quantization": quant, "mips_kernel": "binmax", "mips_per_bin": 8}
        jax_index, port = _flat_pair(config, vectors, ids)
        got, want = port.search_rows(queries, 12), jax_index.search_rows(queries, 12)
        assert_same_hits(got, want)
        stored = port._device_vectors[0] if quant == "int8" else port._device_vectors
        assert stored.rows == 2048 and len(stored.parts) == 8


@pytest.mark.parametrize("route", ["none", "float16-binmax"])
def test_two_axis_dcn_ici_mesh_matches_jax(route):
    """tests/test_retrieval.py:533's ("dcn", "ici") = (2, 4) mesh: rows over
    all eight entries, the merge across both axes."""
    rng = np.random.default_rng(8)
    n, d = 8 * 64, 32
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(4, d)).astype(np.float32)
    config = dict(_ROUTES[route], **({"mips_block_size": 64} if route == "none" else {}))
    config.setdefault("token_dtype", "float16")
    jax_index, port = _flat_pair(config, corpus, np.arange(n), shape=(2, 4))
    assert tmesh.corpus_axes(port.mesh) == ("dcn", "ici") and tmesh.axis_size(port.mesh, ("dcn", "ici")) == 8
    assert_same_hits(port.search(queries, 5), jax_index.search(queries, 5))


# ---- IVF and tree-AH over the mesh ---------------------------------------------

def _skewed(rng, n, d):
    """Half of the rows in one tight cluster: the largest list sets the
    per-shard budget's floor."""
    centers = rng.normal(size=(16, d)).astype(np.float32) * 3
    assign = np.concatenate([np.zeros(n // 2, int), rng.integers(1, 16, n - n // 2)])
    return (centers[assign] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)


_IVF_CASES = {
    "float16": (lambda rng: _clustered(rng, 2400, 32, 24), {"faiss_ivf_list_count": 24, "faiss_ivf_nprobe": 6}),
    "float32-budget": (lambda rng: _clustered(rng, 2400, 32, 24),
                       {"faiss_ivf_list_count": 24, "faiss_ivf_nprobe": 6, "token_dtype": "float32",
                        "ivf_candidate_rows": 256}),
    "skewed": (lambda rng: _skewed(rng, 2000, 16),
               {"faiss_ivf_list_count": 16, "faiss_ivf_nprobe": 4, "token_dtype": "float32", "ivf_train_iters": 6}),
}


@pytest.mark.parametrize("case", sorted(_IVF_CASES))
def test_sharded_ivf_on_a_jax_saved_index_matches_jax(case, tmp_path):
    """The JAX IVF index built on one device and saved, searched by JAX on
    its 8-device mesh and by the port on its 8-entry mesh: the same cluster
    cuts, per-shard CSR, budget and merge."""
    make, config = _IVF_CASES[case]
    rng = np.random.default_rng(9)
    vectors = make(rng)
    queries = vectors[:16] + 0.1 * rng.normal(size=(16, vectors.shape[1])).astype(np.float32)
    built = ji.IVFIndex(config)
    built.prepare(vectors.shape[1])
    built.index(np.arange(len(vectors)) + 3, vectors)
    built.save(str(tmp_path))
    jm, tm = _meshes()
    jax_index, port = ji.IVFIndex(config, jm), ti.IVFIndex(config, CPU, tm)
    jax_index.load(str(tmp_path))
    port.load(str(tmp_path))
    for top_n in (10, 400):
        assert_same_hits(port.search_rows(queries, top_n), jax_index.search_rows(queries, top_n))
        assert_same_hits(port.search(queries, top_n), jax_index.search(queries, top_n))


def test_tree_ah_on_the_mesh_routes_to_the_sharded_ivf_search(tmp_path):
    """JAX's tree-AH search raises under a mesh (it calls a
    ``_search_sharded`` its IVF parent lacks); the port's equals JAX's
    sharded IVF search over the same leaves, probing the tree's leaves."""
    rng = np.random.default_rng(10)
    vectors = _clustered(rng, 2000, 32, 12)
    queries = vectors[:12] + 0.1 * rng.normal(size=(12, 32)).astype(np.float32)
    config = {"scann_num_leaves": 12, "scann_leaves_to_search": 4}
    built = JaxTreeAH(config)
    built.prepare(32)
    built.index(np.arange(2000), vectors)
    built.save(str(tmp_path))
    jm, tm = _meshes()
    jax_tree = JaxTreeAH(config, jm)
    jax_tree.load(str(tmp_path))
    with pytest.raises(AttributeError, match="_search_sharded"):
        jax_tree.search(queries, 10)
    port = ScaNNTreeAHIndex(config, CPU, tm)
    port.load(str(tmp_path))
    jax_ivf = ji.IVFIndex({"faiss_ivf_nprobe": 4}, jm)
    jax_ivf.load(str(tmp_path))
    assert_same_hits(port.search(queries, 10), jax_ivf.search(queries, 10))
    built_index = ti.build_index({"faiss_index_type": "scann", "scann_backend": "tree_ah"}, CPU, tm)
    assert isinstance(built_index, ScaNNTreeAHIndex) and built_index.mesh is tm


def test_build_index_hands_the_mesh_on():
    _, tm = _meshes()
    for kind, cls in (("flat", ti.FlatIndex), ("ivf", ti.IVFIndex), ("streaming", ti.StreamingFlatIndex)):
        index = ti.build_index({"faiss_index_type": kind}, "cuda", tm)
        assert isinstance(index, cls) and index.device == CPU
    assert ti.build_index({"faiss_index_type": "scann"}, CPU, tm).n_shards == 8
    one = ti.build_index({"faiss_index_type": "flat"}, CPU, tmesh.make_mesh(devices=[CPU]))
    assert one.n_shards == 1  # a mesh of one entry: the unsharded route
