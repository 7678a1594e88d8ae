"""The TAS-Balanced pieces of the port against the JAX package on the CPU:
one student step (Margin-MSE plus KLDivTeacherList over a ColBERT dynamic
teacher's in-batch matrix, plus term-level distillation), the MLM head's
loss, the k-means, the query clustering CLI, the encoder graft, and the host
copies (the planted corpora byte for byte, the TAS-Balanced sampler's and
the MLM loader's batches for a seed).

Tolerances: a student step at the port's training parity bar
(tests/test_torch_training.py: losses rtol 1e-4; every gradient within rtol
1e-4 plus 1e-5 of its tensor's largest entry, the analytically zero key-bias
gradients within 1e-5 of the query bias gradient's scale); the MLM loss at
rtol 1e-5; k-means distortion within 1e-4 relative."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from matchmaker_tpu.data import mlm as jmlm
from matchmaker_tpu.data import synthetic as jsynthetic
from matchmaker_tpu.data.tas_balanced import TASBalancedSampler as JaxTASBalancedSampler
from matchmaker_tpu.data.tokenization import HashBertTokenizer as JaxHashBertTokenizer
from matchmaker_tpu.distillation.dynamic_teacher import DynamicTeacher as JaxDynamicTeacher
from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models import get_model as jax_get_model
from matchmaker_tpu.models import init_params as jax_init_params
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.modules.mlm_head import MLMPretrainModel as JaxMLMPretrainModel
from matchmaker_tpu.retrieval.indexes import kmeans as jax_kmeans
from matchmaker_tpu.training.checkpoints import save_params as jax_save_params
from matchmaker_tpu.training.train_step import make_loss_fn as jax_make_loss_fn
from matchmaker_tpu_torch.cli import cluster_queries
from matchmaker_tpu_torch.cli.pretrain import mlm_loss_fn
from matchmaker_tpu_torch.config import auto_fill
from matchmaker_tpu_torch.data import mlm as tmlm
from matchmaker_tpu_torch.data import synthetic as tsynthetic
from matchmaker_tpu_torch.data.tas_balanced import TASBalancedSampler
from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
from matchmaker_tpu_torch.distillation.dynamic_teacher import DynamicTeacher
from matchmaker_tpu_torch.losses import dispatch as tdispatch
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.models.encoder import EncoderConfig
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, init_parameters, save_npz
from matchmaker_tpu_torch.modules.mlm_head import MLMPretrainModel
from matchmaker_tpu_torch.retrieval.indexes import DynamicClusterIndex, kmeans
from matchmaker_tpu_torch.training.checkpoints import load_encoder_subtree, save_params
from matchmaker_tpu_torch.training.train_step import make_loss_fn

_TOK = HashBertTokenizer(1000)


# ---- the host copies -------------------------------------------------------------

def _same_files(a, b, paths_a, paths_b):
    assert {k: os.path.relpath(v, a) for k, v in paths_a.items()} == {k: os.path.relpath(v, b) for k, v in
                                                                       paths_b.items()}
    for key in paths_a:
        assert filecmp.cmp(paths_a[key], paths_b[key], shallow=False), key


def test_planted_corpora_are_byte_identical(tmp_path):
    for name, kw in (("make_planted_corpus", dict(n_train_queries=40, n_eval_queries=10, n_docs=300)),
                     ("make_planted_tas_corpus", dict(n_train_queries=48, n_eval_queries=10, n_docs=400))):
        a, b = str(tmp_path / f"jax_{name}"), str(tmp_path / f"torch_{name}")
        _same_files(a, b, getattr(jsynthetic, name)(a, seed=11, **kw), getattr(tsynthetic, name)(b, seed=11, **kw))


@pytest.fixture(scope="module")
def tas_data(tmp_path_factory):
    """A small planted TAS corpus, its candidate pairs scored by a seeded
    stand-in teacher, and four query clusters."""
    out = str(tmp_path_factory.mktemp("tas"))
    paths = tsynthetic.make_planted_tas_corpus(out, n_train_queries=48, n_eval_queries=10, n_docs=400, seed=3)
    rng = np.random.default_rng(0)
    pairs = os.path.join(out, "pairs.tsv")
    with open(paths["candidates"]) as f, open(pairs, "w") as g:
        for line in f:
            qid, pos, neg = line.split()
            g.write(f"{rng.uniform(5, 10):.4f} {rng.uniform(0, 6):.4f} {qid} {pos} {neg}\n")
    clusters = os.path.join(out, "clusters.tsv")
    with open(clusters, "w") as f:
        for c in range(4):
            f.write(" ".join(f"t{q}" for q in range(c, 48, 4)) + "\n")
    return dict(paths, pairs=pairs, clusters=clusters)


@pytest.mark.parametrize("strategy", ["bins", "random"])
def test_tas_balanced_sampler_yields_jax_batches(tas_data, strategy):
    kw = dict(collection_file=tas_data["collection"], query_file=tas_data["train_queries"],
              pairs_with_teacher_scores=tas_data["pairs"], query_cluster_file=tas_data["clusters"], batch_size=8,
              clusters_per_batch=2, pair_balancing_strategy=strategy, seed=5)
    config = {"max_query_length": 8, "max_doc_length": 24, "query_augment_mask_number": 2}
    want = list(JaxTASBalancedSampler(**kw).batches(config, JaxHashBertTokenizer(1000), max_batches=4))
    got = list(TASBalancedSampler(**kw).batches(config, _TOK, max_batches=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("whole_words,bias", [(True, "none"), (True, "log-tf"), (False, "none")])
def test_mlm_loader_yields_jax_batches(tas_data, whole_words, bias):
    config = {"batch_size_train": 16, "max_doc_length": 24, "random_seed": 9, "mlm_mask_whole_words": whole_words,
              "mlm_bias_sampling_method": bias}
    want = list(jmlm.mlm_training_loader(config, JaxHashBertTokenizer(1000), tas_data["collection"]))
    got = list(tmlm.mlm_training_loader(config, _TOK, tas_data["collection"]))
    assert len(got) == len(want) == 25
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


# ---- the MLM head and the encoder graft ----------------------------------------------

def test_mlm_head_loss_matches_jax(tas_data):
    """MLMPretrainModel's masked-token loss (and the POD term) from carried
    parameters, on a loader batch."""
    cfg = {"batch_size_train": 8, "max_doc_length": 24, "random_seed": 1}
    batch = next(tmlm.mlm_training_loader(cfg, _TOK, tas_data["collection"]))
    jm = JaxMLMPretrainModel(JaxEncoderConfig.tiny(), jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    params = jax.tree_util.tree_map(lambda p: p + 0.01 if p.ndim == 1 else p, params)  # biases not all zero
    out = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})
    labels = jnp.asarray(batch["mlm_labels"])
    mask = (labels != jmlm.IGNORE_LABEL).astype(jnp.float32)
    logp = jax.nn.log_softmax(out["mlm_logits"], axis=-1)
    ll = jnp.take_along_axis(logp, jnp.clip(labels, min=0)[..., None], axis=-1)[..., 0]
    want_mlm = float(-(ll * mask).sum() / jnp.maximum(mask.sum(), 1.0))
    cls = out["cls_vecs"]
    sims = cls @ cls.T
    want_pod = float(-jnp.take_along_axis(jax.nn.log_softmax(sims, -1), jnp.arange(8)[:, None], -1).mean())

    tm = MLMPretrainModel(EncoderConfig.tiny(), torch.float32)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        _, stats = mlm_loss_fn(tm, 0.5)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(mask.sum()) > 0
    np.testing.assert_allclose(float(stats["mlm_loss"]), want_mlm, rtol=1e-5)
    np.testing.assert_allclose(float(stats["pod_loss"]), want_pod, rtol=1e-5)
    np.testing.assert_allclose(float(stats["loss"]), want_mlm + 0.5 * want_pod, rtol=1e-5)


@pytest.mark.parametrize("model", ["colbert", "bert_dot_dualencoder"])
def test_load_encoder_subtree_keeps_the_heads_fresh(tmp_path, model):
    mlm = MLMPretrainModel(EncoderConfig.tiny(), torch.float32)
    init_parameters(mlm, torch.Generator().manual_seed(1))
    snapshot = str(tmp_path / "mlm.npz")
    save_params(snapshot, mlm)
    config = auto_fill({"model": model, "bert_pretrained_model": "tiny-random", "colbert_compression_dim": 24,
                        "bert_dot_compress_dim": 16})
    ranker = get_model(config, _TOK)
    init_params(ranker, config, torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in ranker.state_dict().items()}
    load_encoder_subtree(snapshot, ranker)
    enc = {k[len("encoder."):]: v for k, v in mlm.state_dict().items() if k.startswith("encoder.")}
    towers = 0
    for name, value in ranker.state_dict().items():
        slot, rest = name.split(".", 1)
        if slot in ("encoder", "query_encoder", "doc_encoder"):
            towers += 1
            assert torch.equal(value, enc[rest]), name
        else:
            assert torch.equal(value, before[name]), name  # the head stays fresh
    assert towers == len(enc) * (2 if model == "bert_dot_dualencoder" else 1)
    with pytest.raises(ValueError, match="no encoder tensor"):
        small = get_model(auto_fill({"model": "bert_dot", "bert_pretrained_model": "mini-lm"}), _TOK)
        load_encoder_subtree(snapshot, small)


# ---- k-means and the query clustering ----------------------------------------------

def test_kmeans_finds_jax_partition_on_separated_clusters():
    rng = np.random.default_rng(4)
    centers = np.eye(5, 12, dtype=np.float32) * 100  # 141 apart, unit noise
    labels = rng.integers(0, 5, size=600)
    x = (centers[labels] + rng.normal(size=(600, 12))).astype(np.float32)
    jc, ja = jax_kmeans(jnp.asarray(x), 5, iters=10, seed=42)
    tc, ta = kmeans(torch.from_numpy(x), 5, iters=10, seed=42)
    ja, ta, jc, tc = np.asarray(ja), ta.numpy(), np.asarray(jc), tc.numpy()
    # the same partition up to relabeling: a one-to-one map of the labels
    pairs = set(zip(ja.tolist(), ta.tolist()))
    assert len(pairs) == 5 == len({a for a, _ in pairs}) == len({b for _, b in pairs})
    assert len(set(zip(labels.tolist(), ta.tolist()))) == 5  # the planted clusters
    dist = lambda c, a: float(((x - c[a]) ** 2).sum())  # noqa: E731
    np.testing.assert_allclose(dist(tc, ta), dist(jc, ja), rtol=1e-4)


def test_dynamic_cluster_index_assigns_and_updates(tmp_path):
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=(30, 6)) + 40 * i for i in range(3)]).astype(np.float32)
    ids = np.array([f"q{i}" for i in range(90)])
    index = DynamicClusterIndex({"faiss_ivf_list_count": 3}, "cpu")
    index.index_all(ids, x)
    assert len(set(index._assignments.tolist())) == 3
    np.testing.assert_array_equal(index.assign(x), index._assignments)
    moved = x[:2] + 80.0  # into the third cluster
    index.update(ids[:2], moved)
    assert index._assignments[0] == index._assignments[89]
    assert set(index.cluster_members(int(index._assignments[89]))) >= {"q0", "q1"}
    index.save(str(tmp_path))
    again = DynamicClusterIndex({}, "cpu")
    again.load(str(tmp_path))
    np.testing.assert_array_equal(again._assignments, index._assignments)


@pytest.mark.parametrize("model", ["bert_dot", "colbert"])
def test_cluster_queries_writes_one_line_a_cluster(tas_data, tmp_path, model):
    """A run folder's model (the config from the caller) clusters the
    training queries: one line a cluster, every query once; a multi-vector
    encoder's query vector is its token vectors' masked mean."""
    config = auto_fill({"model": model, "bert_pretrained_model": "tiny-random", "use_fp16": False,
                        "colbert_compression_dim": 24, "max_query_length": 8, "device": "cpu"})
    run = str(tmp_path / "run")
    os.makedirs(run)
    ranker = get_model(config, _TOK)
    init_params(ranker, config, torch.Generator().manual_seed(3))
    save_params(os.path.join(run, "best-model.npz"), ranker)
    out = str(tmp_path / "clusters.tsv")
    assert cluster_queries.run(run, tas_data["train_queries"], out, clusters=6, batch_size=16, config=config) == 0
    with open(out) as f:
        lines = [line.split() for line in f]
    assert 2 <= len(lines) <= 6 and all(lines)
    assert sorted(q for line in lines for q in line) == sorted(f"t{i}" for i in range(48))
    if model == "colbert":
        ids = torch.randint(2, 900, (3, 8))
        mask = torch.ones(3, 8)
        mask[1, 5:] = 0
        with torch.no_grad():
            vecs = ranker.encode(ids, mask, "query")
        want = (vecs * mask[..., None]).sum(1) / mask.sum(1, keepdim=True)
        got = cluster_queries.query_vectors(ranker, {"seq_ids": ids, "seq_mask": mask})
        torch.testing.assert_close(got, want)


# ---- one TAS-B student step ----------------------------------------------------------

def _triple(seed, b=4, lq=8, ld=20, vocab=900):
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
            "doc_neg_mask": nm, "valid": np.array([1, 1, 1, 0], np.float32)}


def _carried_model(config, seed):
    """A JAX model's params and the port's model holding them."""
    jm = jax_get_model(config, JaxHashBertTokenizer(1000))
    params = jax_init_params(jm, config, jax.random.PRNGKey(seed))
    tm = get_model(config, _TOK)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def colbert_teacher(tmp_path_factory):
    """A teacher run folder both packages read: config.yaml, the JAX
    package's best-model.flax and the port's best-model.npz of the same
    parameters (a normalized tiny ColBERT, seeded weights)."""
    folder = str(tmp_path_factory.mktemp("teacher"))
    config = auto_fill({"model": "colbert", "bert_pretrained_model": "tiny-random", "use_fp16": False,
                        "colbert_compression_dim": 24, "colbert_normalize": True, "max_query_length": 8,
                        "max_doc_length": 20, "in_batch_negatives": True, "device": "cpu"})
    with open(os.path.join(folder, "config.yaml"), "w") as f:
        yaml.safe_dump(dict(config), f)
    _, params, tm = _carried_model(config, seed=11)
    jax_save_params(os.path.join(folder, "best-model.flax"), params)
    save_npz(os.path.join(folder, "best-model.npz"), tm.state_dict())
    return folder, config


@pytest.mark.parametrize("student", ["bert_dot", "colbert"])
def test_tasb_student_step_matches_jax(colbert_teacher, student):
    """The recipe's student step: Margin-MSE against the dynamic teacher's
    pairwise scores plus KLDivTeacherList against its in-batch ColBERT
    matrix; a ColBERT student also distils the teacher's per-term scores.
    The teacher's scores, the losses and every gradient agree with JAX's."""
    folder, teacher_cfg = colbert_teacher
    colbert = student == "colbert"
    config = auto_fill({"model": student, "bert_pretrained_model": "tiny-random", "use_fp16": False,
                        "colbert_compression_dim": 24, "max_query_length": 8, "max_doc_length": 20,
                        "loss": "margin-mse", "train_pairwise_distillation": True, "in_batch_negatives": True,
                        "in_batch_neg_loss": "KLDivTeacherList", "dynamic_teacher": True,
                        "dynamic_teacher_path": folder, "dynamic_teacher_in_batch_scoring": True,
                        "dynamic_teacher_per_term_scores": colbert, "device": "cpu"})
    batch = _triple(7)
    jbatch = next(JaxDynamicTeacher(config).wrap(iter([{k: jnp.asarray(v) for k, v in batch.items()}])))
    tbatch = next(DynamicTeacher(config).wrap(iter([{k: torch.from_numpy(v).long() if k.endswith("ids") else
                                                     torch.from_numpy(v) for k, v in batch.items()}])))
    from_caller = next(DynamicTeacher(config, teacher_config=teacher_cfg).wrap(iter([dict(tbatch)])))
    keys = ["pos_score", "neg_score", "dyn_teacher_matrix"] + (
        ["dyn_teacher_pos_per_term", "dyn_teacher_neg_per_term"] if colbert else [])
    for key in keys:
        assert not tbatch[key].is_inference() and not tbatch[key].requires_grad
        np.testing.assert_allclose(tbatch[key].numpy(), np.asarray(jbatch[key]), atol=2e-4, rtol=1e-4, err_msg=key)
        torch.testing.assert_close(from_caller[key], tbatch[key], rtol=0, atol=0)
    assert tbatch["dyn_teacher_matrix"].shape == (4, 8)

    jm, params, tm = _carried_model(config, seed=12)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm, jdispatch.get_loss(config), config),
                                                         has_aux=True))(params, jbatch)
    tloss, tstats = make_loss_fn(tm, tdispatch.get_loss(config), config)(tbatch)
    tloss.backward()
    stat_keys = ("loss", "ranking_loss", "inbatch_loss") + (("per_term_loss",) if colbert else ())
    assert ("per_term_loss" in tstats) == colbert
    for key in stat_keys:
        np.testing.assert_allclose(float(tstats[key].detach()), float(jstats[key]), rtol=1e-4, err_msg=key)
    want = flax_to_state_dict(jgrads)
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        if name.endswith("attention.key.bias"):  # zero in exact arithmetic: both frameworks' rounding noise
            scale = float(np.abs(want[name.replace("key", "query")].numpy()).max())
            assert max(float(p.grad.abs().max()), float(np.abs(w).max())) <= 1e-5 * scale, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5 * float(np.abs(w).max()), rtol=1e-4, err_msg=name)
