"""The port's ColBERT serving slice against the JAX package on the CPU: the
model (params carried with ``flax_to_state_dict``), the multi-vector corpus
encode, the MaxSim merges, ``search_queries``' routing of a multi-vector
encoder, FlatIndex's ``mips_tile_rows`` and both CLIs'
``run("encode+index+search")`` with ``model: colbert`` on the same seeded
collection, queries, qrels and weights (tiny encoder, f32, fused layers,
compression 32, float16 storage, the binmax token index)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matchmaker_tpu.cli.dense_retrieval as jax_cli
from matchmaker_tpu.models.colbert import ColBert as JaxColBert
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.parallel.mesh import make_mesh
from matchmaker_tpu.retrieval import colbert_search as jcs
from matchmaker_tpu.retrieval.encode import encode_corpus as jax_encode_corpus
from matchmaker_tpu.retrieval.indexes import FlatIndex as JaxFlatIndex
from matchmaker_tpu.training.checkpoints import save_params
from tests.make_tiny_dataset import make_tiny_dataset
from tests.test_torch_dense_retrieval import _files, _metrics, _ranking, _seeded_params

from matchmaker_tpu_torch.cli.dense_retrieval import run as torch_run
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.metrics import calculate_metrics_plain, load_qrels, unrolled_to_ranked_result
from matchmaker_tpu_torch.models import get_model
from matchmaker_tpu_torch.models.colbert import ColBert
from matchmaker_tpu_torch.models.encoder import EncoderConfig
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, save_npz
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.retrieval import colbert_search as tcs
from matchmaker_tpu_torch.retrieval.encode import encode_corpus, load_encoded
from matchmaker_tpu_torch.retrieval.indexes import FlatIndex
from matchmaker_tpu_torch.retrieval.search import search_queries

CPU = torch.device("cpu")


# ---- the model ---------------------------------------------------------------

def _batch(seed, b=4, lq=9, ld=24, vocab=900):
    rng = np.random.default_rng(seed)
    out = {}
    for side, length in (("query", lq), ("doc", ld)):
        ids = rng.integers(2, vocab, size=(b, length)).astype(np.int32)
        mask = np.ones((b, length), np.float32)
        mask[1, length // 2:] = 0
        mask[3, 3:] = 0
        ids[mask == 0] = 0
        out[f"{side}_ids"], out[f"{side}_mask"] = ids, mask
    return out


@pytest.mark.parametrize("normalize", [False, True])
def test_colbert_matches_jax(normalize):
    """A JAX ColBert (tiny encoder, fused layers, f32, compression 32) and the
    port's, its params carried by ``flax_to_state_dict`` into a strict
    ``load_state_dict``: ``encode`` for the three sequence types, ``forward``
    (score, per-term scores, vectors) and ``inbatch_aggregate`` agree at the
    encoder tests' tolerance (atol 2e-4, rtol 1e-4)."""
    kw = dict(compression_dim=32, return_vecs=True, return_per_term=True, normalize=normalize)
    jm = JaxColBert(encoder_cfg=JaxEncoderConfig.tiny(fused_attention=True), compute_dtype=jnp.float32, **kw)
    batch = _batch(0)
    params = jm.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    tm = ColBert(EncoderConfig.tiny(fused_attention=True), compute_dtype=torch.float32, **kw)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    tb = {k: torch.from_numpy(v).long() if k.endswith("ids") else torch.from_numpy(v) for k, v in batch.items()}
    tol = dict(atol=2e-4, rtol=1e-4)
    with torch.no_grad():
        for seq_type in ("doc_encode", "query_encode", "n/a"):
            want = jm.apply({"params": params}, batch["doc_ids"], batch["doc_mask"], seq_type,
                            method=JaxColBert.encode)
            got = tm.encode(tb["doc_ids"], tb["doc_mask"], seq_type)
            assert got.dtype == torch.float32 and got.shape == (4, 24, 32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
            if seq_type != "n/a":
                assert (got.numpy()[batch["doc_mask"] == 0] == 0).all()
        want = jm.apply({"params": params}, batch)
        got = tm(tb)
        for key in ("score", "per_term_scores", "query_vecs", "doc_vecs"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **tol)
        qv, dv = np.array(want["query_vecs"]), np.array(want["doc_vecs"])
        want_all = jm.apply({"params": params}, qv, batch["query_mask"], dv, batch["doc_mask"],
                            method=JaxColBert.inbatch_aggregate)
        got_all = tm.inbatch_aggregate(torch.from_numpy(qv), tb["query_mask"], torch.from_numpy(dv), tb["doc_mask"])
        np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), **tol)
        np.testing.assert_allclose(np.diag(got_all.numpy()), got["score"].numpy(), **tol)


def test_colbert_from_config_and_registry():
    config = {"model": "colbert", "bert_pretrained_model": "bert-tiny-random", "colbert_compression_dim": 128,
              "colbert_normalize": True, "use_fp16": True}
    model = get_model(config, build_tokenizer(config))
    assert isinstance(model, ColBert) and model.compression_dim == 128 and model.normalize
    assert model.compute_dtype == torch.bfloat16 and not model.return_vecs
    assert tuple(model.compressor.kernel.shape) == (64, 128)


# ---- multi-vector encode, routing --------------------------------------------

def _token_config(paths):
    return {"bert_pretrained_model": "bert-tiny-random", "max_query_length": 8, "max_doc_length": 24,
            "batch_size_inference": 8, "token_dtype": "float16", "token_block_size": 512,
            "collection_tsv": paths["collection"]}


def _one_hot_tokens(ids, mask, width=128):
    """Per-token one-hot vectors of the token ids (mod ``width``), masked rows
    zeroed; a document whose first word id is a multiple of 7 encodes to all
    zeros (it keeps one row)."""
    vecs = (ids[..., None] % width == np.arange(width)).astype(np.float32) * mask[..., None]
    return vecs * (ids[:, 1] % 7 != 0)[:, None, None]


def test_multi_vector_encode_corpus_matches_jax(tmp_path):
    """Per-document non-zero rows, the first row of a document without one,
    the same blocks (rows never span a block) and doc_infos as JAX."""
    paths = make_tiny_dataset(str(tmp_path / "data"))
    config = _token_config(paths)
    tok = build_tokenizer(config)
    torch_infos = encode_corpus(lambda i, m: torch.from_numpy(_one_hot_tokens(i.numpy(), m.numpy())), config, tok,
                                paths["collection"], str(tmp_path / "torch"), CPU)
    jax_infos = jax_encode_corpus(lambda _, i, m: jnp.asarray(_one_hot_tokens(np.asarray(i), np.asarray(m))), None,
                                  config, tok, paths["collection"], str(tmp_path / "jax"))
    assert torch_infos == jax_infos
    assert len({e - s for _, s, e in torch_infos.values()}) >= 3  # variable-length spans
    assert any(e - s == 1 for _, s, e in torch_infos.values())  # an empty document kept one row
    assert _files(str(tmp_path / "torch")) == _files(str(tmp_path / "jax"))
    vt, it = load_encoded(str(tmp_path / "torch"))
    vj, ij = load_encoded(str(tmp_path / "jax"))
    assert vt.dtype == np.float16 and (vt == vj).all() and (it == ij).all()


def test_search_queries_routes_multivector(tmp_path):
    """A multi-vector encoder handed to the generic ``search_queries`` gets
    the ColBERT per-token path (JAX: tests/test_colbert_retrieval.py:151):
    the planted-relevance queries rank their documents first."""
    paths = make_tiny_dataset(str(tmp_path / "data"))
    config = _token_config(paths)
    tok = build_tokenizer(config)

    def token_encode(ids, mask):
        return torch.nn.functional.one_hot(ids.long(), tok.vocab_size).float() * mask[..., None]

    encode_corpus(token_encode, config, tok, paths["collection"], str(tmp_path / "enc"), CPU)
    vectors, row_ids = load_encoded(str(tmp_path / "enc"))
    index = FlatIndex({"token_dtype": "float32"}, CPU)
    index.prepare(vectors.shape[1])
    index.index(row_ids, vectors)
    _build.reset_launches()
    results = search_queries(token_encode, dict(config, encode_folder=str(tmp_path / "enc"), colbert_rescore_n=12),
                             tok, index, paths["queries"], top_n=10, device=CPU)
    metrics = calculate_metrics_plain(unrolled_to_ranked_result(results), load_qrels(paths["qrels"]))
    assert metrics["QueriesRanked"] == 12
    assert metrics["MRR@10"] > 0.9, metrics["MRR@10"]
    assert not any(_build.LAUNCHES.values())


# ---- the MaxSim merge ----------------------------------------------------------

def _candidates(seed, b=5, lq=7, k=16, n_docs=40):
    """Descending per-token scores (the search's contract) on a 0.25 grid, so
    sums are exact and equal totals are exact ties; duplicate docs within
    and across token lists, invalid slots, a masked query token."""
    rng = np.random.default_rng(seed)
    scores = -np.sort(-(rng.integers(0, 24, size=(b, lq, k)) * 0.25), axis=-1).astype(np.float32)
    slots = rng.integers(0, n_docs, size=(b, lq, k))
    scores[0, 0, 10:] = -np.inf
    slots[1, 2, 3:8] = 7
    # query 3: docs 11 and 12 lead every token's list with equal scores, an exact tie
    slots[3][np.isin(slots[3], (11, 12))] = 13
    slots[3, :, :2] = (11, 12)
    scores[3, :, 1] = scores[3, :, 0]
    mask = np.ones((b, lq), np.float32)
    mask[2, 4:] = 0.0
    return scores, slots, mask, np.array([f"d{i}" for i in range(n_docs)])


@pytest.mark.parametrize("seed", [0, 1])
def test_device_maxsim_merge_matches_jax(seed):
    """``_device_maxsim_merge`` bit for bit against JAX's (values, slots and
    tie order), and ``aggregate_maxsim_device`` against JAX's and against the
    host merge."""
    scores, slots, mask, vocab = _candidates(seed)
    valid = np.isfinite(scores) & (slots >= 0) & (mask[:, :, None] > 0)
    s0 = np.where(valid, scores, 0.0).astype(np.float32)
    for top_n in (10, 7 * 16):
        tv, ts = tcs._device_maxsim_merge(torch.from_numpy(s0), torch.from_numpy(slots), torch.from_numpy(valid),
                                          top_n)
        jv, js = jcs._device_maxsim_merge(jnp.asarray(s0), jnp.asarray(slots.astype(np.int32)), jnp.asarray(valid),
                                          top_n)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tv.numpy()[3, 0] == tv.numpy()[3, 1] and ts.numpy()[3, :2].tolist() == [11, 12]  # tie: lower first
    got = tcs.aggregate_maxsim_device(scores, slots, mask, 10, vocab=vocab, q_chunk=2, device=CPU)
    want = jcs.aggregate_maxsim_device(scores, slots.astype(np.int32), mask, 10, vocab=vocab, q_chunk=2)
    host = tcs.aggregate_maxsim_batch(scores, slots.astype(np.int64), mask, 10, vocab=vocab)
    assert got == want
    for dev_row, host_row in zip(got, host):  # exact ties at the cut may keep other docs
        assert sorted(s for _, s in dev_row) == sorted(s for _, s in host_row)
        hd = dict(host_row)
        assert all(hd[d] == s for d, s in dev_row if d in hd)
    assert host == jcs.aggregate_maxsim_batch(scores, slots.astype(np.int64), mask, 10, vocab=vocab)


# ---- FlatIndex mips_tile_rows --------------------------------------------------

@pytest.mark.parametrize("per_bin", [1, 2])
def test_flat_index_honours_mips_tile_rows(per_bin):
    """131,072 rows of D 32, k 8: the pool n/128·per_bin >= 128·k takes the
    keep-8/128 level 2. With ``mips_tile_rows: 4096`` the port's
    ``search_rows`` returns JAX's ids (one device). The port used to ignore
    the key and search with 2048-row tiles: at per_bin 2 a tile's candidates
    are rank-major (column tile·(2·nb) + rank·nb + bin, nb = tile/128), so
    the tile decides each candidate's level-2 offset bits and the order of
    near-equal candidates, and 2048-row tiles differ from JAX. At per_bin 1
    the column is the global bin index whatever the tile, so the old code
    could not differ there."""
    rng = np.random.default_rng(5)
    vectors = rng.normal(size=(131_072, 32)).astype(np.float32)
    queries = rng.normal(size=(256, 32)).astype(np.float32)
    config = {"token_dtype": "float16", "mips_quantization": "float16", "mips_kernel": "binmax",
              "mips_per_bin": per_bin, "mips_tile_rows": 4096, "mips_q_chunk": 512}
    ids = np.arange(len(vectors))

    def rows(index):
        index.prepare(32)
        index.index(ids, vectors)
        return index.search_rows(queries, 8)[1].astype(np.int64)

    want = rows(JaxFlatIndex(config, mesh=None))
    got = rows(FlatIndex(config, CPU))
    np.testing.assert_array_equal(got, want)
    old = rows(FlatIndex(dict(config, mips_tile_rows=2048), CPU))
    if per_bin == 1:
        np.testing.assert_array_equal(old, want)
    else:
        assert (old != want).any()


def test_per_token_search_matches_jax_at_the_cli_colbert_geometry():
    """ColBERT's per-token search as the CLI configures it (per_bin 1,
    4096-row tiles, float16 store, bf16 index), 48 candidates a query token
    over 800,000 unit token rows: 6,250 bins >= 128 x 48, so the route takes
    the keep-8-of-128 level 2. The port's ``search_rows`` returns JAX's rows
    and scores for every query token: the per-token recall gap of the CLI's
    ColBERT run (ROADMAP.md, queue 3) is no difference from JAX's route."""
    rng = np.random.default_rng(11)
    n, dim, k = 800_000, 16, 48
    centers = rng.normal(size=(512, dim))
    vectors = (centers[rng.integers(0, 512, n)] + 0.3 * rng.normal(size=(n, dim))).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    queries = (vectors[rng.integers(0, n, 64)] + 0.05 * rng.normal(size=(64, dim))).astype(np.float32)
    config = {"token_dtype": "float16", "mips_quantization": "float16", "mips_kernel": "binmax",
              "mips_per_bin": 1, "mips_tile_rows": 4096}
    assert n // 128 >= 128 * k
    found = []
    for index in (JaxFlatIndex(config, mesh=None), FlatIndex(config, CPU)):
        index.prepare(dim)
        index.index(np.arange(n), vectors)
        found.append(index.search_rows(queries, k))
    (want_scores, want_rows), (got_scores, got_rows) = found
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_scores, want_scores)


# ---- the slice end to end through both CLIs ------------------------------------

N_PASSAGES, N_QUERIES, TOP_N, CANDIDATES, RESCORE_N = 1024, 32, 10, 16, 24


def _write_data(root, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(400)]
    passages = [" ".join(rng.choice(words, size=rng.integers(8, 30))) for _ in range(N_PASSAGES)]
    with open(os.path.join(root, "collection.tsv"), "w") as f:
        for i, p in enumerate(passages):
            f.write(f"{1000 + i}\t{p}\n")
    targets = rng.choice(N_PASSAGES, size=N_QUERIES, replace=False)
    with open(os.path.join(root, "queries.tsv"), "w") as fq, open(os.path.join(root, "qrels.txt"), "w") as fr:
        for qi, t in enumerate(targets):
            fq.write(f"q{qi}\t{' '.join(rng.choice(passages[t].split(), size=4))}\n")
            fr.write(f"q{qi} 0 {1000 + t} 1\n")


def _config(root, rescore_n):
    return {
        "model": "colbert", "bert_pretrained_model": "bert-tiny-random", "use_fp16": False,
        "encoder_fused_attention": True, "colbert_compression_dim": 32, "query_augment_mask_number": 2,
        "faiss_index_type": "flat", "mips_quantization": "float16", "token_dtype": "float16",
        "token_block_size": 6000, "collection_tsv": os.path.join(root, "collection.tsv"),
        "collection_batch_size": 256, "query_batch_size": 8, "max_doc_length": 32, "max_query_length": 12,
        "random_seed": 3, "trained_model": os.path.join(root, "model"), "device": "cpu",
        "colbert_per_token_candidates": CANDIDATES, "colbert_rescore_n": rescore_n,
        "query_sets": {f"dev{rescore_n}": {"queries_tsv": os.path.join(root, "queries.tsv"),
                                            "qrels": os.path.join(root, "qrels.txt"),
                                            "top_n": TOP_N, "binarization_point": 1}},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each CLI: encode+index+search with the exact rescore, then a search
    of the saved index without it, into the same run folder. The JAX CLI
    runs on one device (its FlatIndex unsharded, as the port's)."""
    root = str(tmp_path_factory.mktemp("colbert"))
    _write_data(root)
    params = _seeded_params(_config(root, 0))
    os.makedirs(os.path.join(root, "model"))
    save_params(os.path.join(root, "model", "best-model.flax"), params)
    save_npz(os.path.join(root, "model", "best-model.npz"), flax_to_state_dict(params))
    folders = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))
        for name, fn in (("jax", jax_cli.run), ("torch", torch_run)):
            folders[name] = os.path.join(root, name)
            os.makedirs(folders[name])
            _build.reset_launches()
            assert fn("encode+index+search", _config(root, RESCORE_N), folders[name]) == 0
            assert fn("search", _config(root, 0), folders[name]) == 0
            # CPU tensors take the plain versions: no kernel was launched
            assert not any(_build.LAUNCHES.values())
    return root, folders


def test_colbert_slice_writes_the_same_files(runs):
    _, folders = runs
    assert _files(folders["torch"]) == _files(folders["jax"])
    assert f"dev{RESCORE_N}-output.txt" in _files(folders["torch"]) and "dev0-metrics.csv" in _files(folders["torch"])


def test_colbert_slice_token_vectors_match(runs):
    """The same per-token f16 blocks and spans (padding rows stripped)."""
    _, folders = runs
    vj, ij = load_encoded(os.path.join(folders["jax"], "encoded"))
    vt, it = load_encoded(os.path.join(folders["torch"], "encoded"))
    assert vt.dtype == vj.dtype == np.float16 and vt.shape == vj.shape and vt.shape[0] > 10 * N_PASSAGES
    assert (it == ij).all()
    np.testing.assert_allclose(vt.astype(np.float32), vj.astype(np.float32), atol=1e-3)


def _scores(path):
    out = {}
    with open(path) as f:
        for line in f:
            qid, did, _, score = line.split()
            out[qid, did] = float(score)
    return out


@pytest.mark.parametrize("rescore_n", [RESCORE_N, 0])
def test_colbert_slice_rankings_and_metrics_match(runs, rescore_n):
    """The same ranking for >= 90 % of the queries (all of them on this CPU;
    the f16 token blocks may round apart near a tie), >= 98 % of the same
    documents, scores within 2e-4 relative (4e-5 measured) and the same
    metrics."""
    _, folders = runs
    rj = _ranking(os.path.join(folders["jax"], f"dev{rescore_n}-output.txt"))
    rt = _ranking(os.path.join(folders["torch"], f"dev{rescore_n}-output.txt"))
    assert rj.keys() == rt.keys() and len(rt) == N_QUERIES
    assert all(len(v) == TOP_N for v in rt.values())
    same = np.mean([rj[q] == rt[q] for q in rj])
    overlap = np.mean([len(set(rj[q]) & set(rt[q])) / TOP_N for q in rj])
    assert overlap >= 0.98 and same >= 0.9, (overlap, same)
    sj = _scores(os.path.join(folders["jax"], f"dev{rescore_n}-output.txt"))
    st = _scores(os.path.join(folders["torch"], f"dev{rescore_n}-output.txt"))
    for key in set(sj) & set(st):
        assert abs(st[key] - sj[key]) <= 2e-4 * max(1.0, abs(sj[key])), (key, st[key], sj[key])
    mj = _metrics(os.path.join(folders["jax"], f"dev{rescore_n}-metrics.csv"))
    mt = _metrics(os.path.join(folders["torch"], f"dev{rescore_n}-metrics.csv"))
    assert mt == pytest.approx(mj, abs=0.01 if same < 1 else 1e-9)


def test_colbert_slice_rescore_scores_are_exact_maxsim(runs):
    """With ``colbert_rescore_n`` > 0 every (query, doc, score) of the port's
    run file is the exact MaxSim of the query's re-encoded token vectors
    against the document's stored ones (numpy, f64)."""
    root, folders = runs
    config = _config(root, RESCORE_N)
    tok = build_tokenizer(config)
    model = get_model(config, tok)
    model.load_state_dict(flax_to_state_dict(_seeded_params(config)))
    model.eval()
    store = tcs.TokenVectorStore(os.path.join(folders["torch"], "encoded"))
    from matchmaker_tpu_torch.data.loaders import single_sequence_loader

    queries = {}
    for batch, qids in single_sequence_loader(dict(config, batch_size_inference=8), tok,
                                              os.path.join(root, "queries.tsv"), "query"):
        with torch.no_grad():
            vecs = model.encode(torch.from_numpy(batch["seq_ids"]).long(), torch.from_numpy(batch["seq_mask"]),
                                "query_encode").numpy()
        for i, qid in enumerate(qids):
            queries[qid] = (vecs[i].astype(np.float64), batch["seq_mask"][i] > 0)
    checked = 0
    with open(os.path.join(folders["torch"], f"dev{RESCORE_N}-output.txt")) as f:
        for line in f:
            qid, did, _, score = line.split()
            q, live = queries[qid]
            best = (q @ store.get(did).astype(np.float64).T).max(axis=1)
            assert float(score) == pytest.approx(best[live].sum(), rel=1e-4, abs=1e-4)
            checked += 1
    assert checked == N_QUERIES * TOP_N


def test_colbert_search_with_ivf_as_the_candidate_generator(runs, tmp_path):
    """IVF as ColBERT's per-token candidate generator (``search_rows``):
    the JAX CLI indexes the JAX run's token vectors into an IVF index (32
    lists, 4 probed, one device) and searches; the port's CLI searches a
    copy of that run folder, so the same index, in ``search`` mode. The
    same documents and ranking at the slice's bars above, scores within
    2e-4 relative."""
    root, folders = runs
    config = dict(_config(root, 0), faiss_index_type="ivf", faiss_ivf_list_count=32, faiss_ivf_nprobe=4)
    jax_folder, torch_folder = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(folders["jax"], jax_folder)
    shutil.rmtree(os.path.join(jax_folder, "index"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))
        assert jax_cli.run("index+search", dict(config), jax_folder) == 0
    shutil.copytree(jax_folder, torch_folder)
    os.remove(os.path.join(torch_folder, "dev0-output.txt"))
    _build.reset_launches()
    assert torch_run("search", dict(config), torch_folder) == 0
    assert not any(_build.LAUNCHES.values())
    assert os.path.isfile(os.path.join(torch_folder, "index", "ivf_index.npz"))
    rj = _ranking(os.path.join(jax_folder, "dev0-output.txt"))
    rt = _ranking(os.path.join(torch_folder, "dev0-output.txt"))
    assert rj.keys() == rt.keys() and len(rt) == N_QUERIES and all(len(v) == TOP_N for v in rt.values())
    same = np.mean([rj[q] == rt[q] for q in rj])
    overlap = np.mean([len(set(rj[q]) & set(rt[q])) / TOP_N for q in rj])
    assert overlap >= 0.98 and same >= 0.9, (overlap, same)
    sj = _scores(os.path.join(jax_folder, "dev0-output.txt"))
    st = _scores(os.path.join(torch_folder, "dev0-output.txt"))
    for key in set(sj) & set(st):
        assert abs(st[key] - sj[key]) <= 2e-4 * max(1.0, abs(sj[key])), (key, st[key], sj[key])
