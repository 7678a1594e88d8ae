"""JAX run folders, gradient accumulation, hub teachers and dropout on the
port, against the JAX package on the CPU.

- ``write_flax`` writes the bytes of ``flax.serialization.to_bytes`` (JAX's
  ``save_params``) for the param trees of tiny BERT_DOT, ColBERT, BERT_CAT,
  TK and ``MLMPretrainModel``, through ``state_dict_to_flax`` of the port
  model holding them, and for a tree with a chunked leaf; ``read_flax`` of
  the JAX-written files equals JAX's ``load_params`` leaf for leaf;
  ``state_dict_to_flax`` undoes ``flax_to_state_dict`` for every model of
  the factory.
- The trainer's warm start and ``load_encoder_subtree`` on JAX-written
  ``best-model.flax`` files score a batch as JAX does with the same
  parameters (f32, rtol 1e-5, atol 1e-6; the dense-retrieval CLI's case is
  tests/test_torch_dense_retrieval.py::test_slice_serves_a_jax_run_folder).
- ``gradient_accumulation_steps: 2`` against ``optax.MultiSteps`` over four
  micro-steps with clipping and a cosine schedule (atol 1e-6, the optimizer
  test's bar): the first micro-step leaves the parameters as they are; the
  trainer resumed mid-accumulation ends bit-identical to a run that never
  stopped.
- A hub teacher built from a seeded DistilBERT checkpoint in a temporary
  Hugging Face cache: its encoder is the checkpoint's bit for bit, its
  heads keep their init, and with JAX's heads carried across its scores
  equal those of JAX's teacher on the same checkpoint (rtol 1e-5).
- Dropout: ``deterministic=True`` unchanged; the keep rate within five
  binomial standard deviations and the kept values scaled by 1 / (1 - p);
  the attention probabilities' keep mask shared by the batch and the heads;
  the embeddings' dropout active on the fused path, as in JAX.
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matchmaker_tpu.data.tokenization import HashBertTokenizer as JaxHashBertTokenizer
from matchmaker_tpu.models import example_batch as jax_example_batch
from matchmaker_tpu.models import get_model as jax_get_model
from matchmaker_tpu.models import tk as jtk
from matchmaker_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from matchmaker_tpu.models.encoder import TransformerEncoderLM as JaxEncoder
from matchmaker_tpu.modules.mlm_head import MLMPretrainModel as JaxMLMPretrainModel
from matchmaker_tpu.training import checkpoints as jckpt
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu_torch.config import auto_fill
from matchmaker_tpu_torch.data.tokenization import HashBertTokenizer
from matchmaker_tpu_torch.distillation.dynamic_teacher import load_teacher
from matchmaker_tpu_torch.models import get_model, hf_import, init_params
from matchmaker_tpu_torch.models import tk as ttk
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, dropout
from matchmaker_tpu_torch.models.weights import flatten_params, flax_to_state_dict, init_parameters
from matchmaker_tpu_torch.modules.mlm_head import MLMPretrainModel
from matchmaker_tpu_torch.training import checkpoints as tckpt
from matchmaker_tpu_torch.training import optim as toptim
from matchmaker_tpu_torch.training.trainer import Trainer
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.make_tiny_dataset import make_tiny_dataset

_TOK = HashBertTokenizer(1000)
HUB = "sebastian-hofstaetter/colbert-distilbert-margin_mse-T2-msmarco"


def _ids_mask(seed, b, l, vocab=900):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    mask[-1, l // 2:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _pair_batch(seed, lq=8, ld=20, concatenated=False):
    q, qm = _ids_mask(seed, 3, lq)
    d, dm = _ids_mask(seed + 1, 3, ld)
    if concatenated:
        return {"seq_ids": np.concatenate([q, d], 1), "seq_mask": np.concatenate([qm, dm], 1),
                "seq_type_ids": np.concatenate([np.zeros_like(q), np.ones_like(d)], 1)}
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if "ids" in k else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ---- .flax files -----------------------------------------------------------------

TK_CONFIG = {"_vocab_size": 200, "token_embedding_size": 32, "tk_att_heads": 4, "tk_att_ff_dim": 32,
             "max_query_length": 8, "max_doc_length": 20}


def _jax_init(jm, config, seed):
    """JAX's init_params for a model without a checkpoint (its init on the
    example batch), jitted: eager flax init compiles op by op."""
    return jax.jit(jm.init)(jax.random.PRNGKey(seed), jax_example_batch(config))["params"]


def _jax_and_port(name):
    """(JAX param tree, port model holding it) of a tiny model."""
    if name == "tk":
        jm, tm = jtk.TK.from_config(TK_CONFIG, None), ttk.TK.from_config(TK_CONFIG, None)
        q, qm = _ids_mask(1, 2, 8, vocab=200)
        d, dm = _ids_mask(2, 2, 20, vocab=200)
        batch = {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm}
        params = jax.jit(jm.init)(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    elif name == "mlm":
        jm, tm = JaxMLMPretrainModel(JaxEncoderConfig.tiny(), jnp.float32), MLMPretrainModel(EncoderConfig.tiny())
        ids, mask = _ids_mask(1, 2, 12)
        params = jm.init(jax.random.PRNGKey(1), {"seq_ids": jnp.asarray(ids), "seq_mask": jnp.asarray(mask)})["params"]
    else:
        config = auto_fill({"model": name, "bert_pretrained_model": "tiny-random", "colbert_compression_dim": 24,
                            "max_query_length": 8, "max_doc_length": 20})
        params = _jax_init(jax_get_model(config, JaxHashBertTokenizer(1000)), config, 1)
        tm = get_model(config, _TOK)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    return params, tm


@pytest.mark.parametrize("name", ["bert_dot", "colbert", "bert_cat", "tk", "mlm"])
def test_write_flax_equals_jax_save_params_and_read_flax_its_load(name, tmp_path):
    params, tm = _jax_and_port(name)
    jax_file, port_file = str(tmp_path / "jax.flax"), str(tmp_path / "port.flax")
    jckpt.save_params(jax_file, params)
    tckpt.write_flax(port_file, tckpt.state_dict_to_flax(tm))
    with open(jax_file, "rb") as a, open(port_file, "rb") as b:
        assert a.read() == b.read()
    want = flatten_params(jax.device_get(jckpt.load_params(jax_file, params)))
    got = flatten_params(tckpt.read_flax(jax_file))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert got[path].dtype == value.dtype and np.array_equal(got[path], value), path


def test_write_flax_chunks_a_large_leaf_as_flax_does(tmp_path, monkeypatch):
    """A leaf over the chunk size (1 GiB in flax; 4 KB here) is written as
    flax's chunked dict, the same bytes, and read back whole; scalars, ints
    and numpy scalars as flax writes them."""
    rng = np.random.default_rng(0)
    tree = {"z": {"big": rng.normal(size=(3, 1000)).astype(np.float32), "small": np.arange(5)},
            "a": np.float32(2.5), "n": 3, "f": 0.25}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    path = str(tmp_path / "chunked.flax")
    tckpt.write_flax(path, tree, max_chunk_bytes=4096)
    with open(path, "rb") as f:
        data = f.read()
    assert data == flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = tckpt.read_flax(path)
    assert np.array_equal(got["z"]["big"], tree["z"]["big"]) and np.array_equal(got["z"]["small"], np.arange(5))
    assert (got["a"], got["n"], got["f"]) == (np.float32(2.5), 3, 0.25)


FACTORY_MODELS = ["bert_dot", "colbert", "bert_cat", "prettr", "parade", "maxP->bert_cat", "bert_dot_dualencoder",
                  "knrm", "conv_knrm", "tk", "tkl", "tk_sparse", "idcm", "pacrr", "co_pacrr", "drmm",
                  "matchpyramid", "duet"]


@pytest.mark.parametrize("model", FACTORY_MODELS)
def test_state_dict_to_flax_undoes_flax_to_state_dict(model):
    config = auto_fill({"model": model, "bert_pretrained_model": "tiny-random", "colbert_compression_dim": 24,
                        "in_batch_negatives": True, "tk_att_heads": 10})  # 10 heads of the 300-wide embeddings
    tm = get_model(config, _TOK)
    init_parameters(tm, torch.Generator().manual_seed(3))
    state = tm.state_dict()
    back = flax_to_state_dict(tckpt.state_dict_to_flax(tm))
    assert back.keys() == state.keys()
    for name, value in state.items():
        assert back[name].shape == value.shape and torch.equal(back[name], value), name


def test_snapshots_prefer_npz_and_say_so_once(tmp_path):
    params, tm = _jax_and_port("bert_dot")
    folder = str(tmp_path)
    jckpt.save_params(os.path.join(folder, tckpt.BEST_MODEL_FLAX), params)
    assert tckpt.resolve_snapshot(folder).endswith(".flax")
    tckpt.save_params(os.path.join(folder, tckpt.BEST_MODEL), tm)
    with pytest.warns(UserWarning, match="both"):
        assert tckpt.resolve_snapshot(folder).endswith(".npz")
    state = tckpt.load_state(os.path.join(folder, tckpt.BEST_MODEL_FLAX))
    assert all(torch.equal(state[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(FileNotFoundError, match="best-model.flax"):
        tckpt.resolve_snapshot(str(tmp_path / "nowhere"))


# ---- warm start and graft from JAX-written files -----------------------------------

@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    return make_tiny_dataset(str(tmp_path_factory.mktemp("tiny")))


def _trainer_config(paths, **kw):
    return {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
            "encoder_fused_attention": True, "loss": "ranknet", "batch_size_train": 8, "batch_size_eval": 16,
            "max_query_length": 8, "max_doc_length": 24, "epochs": 1, "param_group0_learning_rate": 1e-3,
            "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 2, "max_training_steps": 20,
            "validate_every_n_batches": -1, "random_seed": 3, "device": "cpu", "train_tsv": paths["train_tsv"],
            "enable_tensorboard": False, "gradient_clip_norm": 1.0, **kw}


def test_warm_start_from_a_jax_file_scores_as_jax(tiny_data, tmp_path):
    config = _trainer_config(tiny_data)
    jm = jax_get_model(auto_fill(dict(config)), JaxHashBertTokenizer(1000))
    params = _jax_init(jm, config, 5)
    params = jax.tree_util.tree_map(lambda p: p + 0.01 if p.ndim == 1 else p, params)  # biases not all zero
    jax_run = tmp_path / "jax_run"  # a JAX run folder: its best-model.flax alone
    jax_run.mkdir()
    jckpt.save_params(str(jax_run / "best-model.flax"), params)
    batch = _pair_batch(4)
    want = jax.jit(jm.apply)({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()})["score"]
    run = tmp_path / "run"
    run.mkdir()
    trainer = Trainer(dict(config, warmstart_model_path=str(jax_run)), str(run))
    with torch.no_grad():
        _close(trainer.model.eval()(_torch(batch))["score"], want)


def test_encoder_graft_from_a_jax_mlm_file_scores_as_jax(tmp_path):
    """load_encoder_subtree of a JAX MLMPretrainModel's best-model.flax into
    a ColBERT: JAX's graft of the same file, the same scores."""
    params, _ = _jax_and_port("mlm")
    snapshot = str(tmp_path / "best-model.flax")
    jckpt.save_params(snapshot, params)
    config = auto_fill({"model": "colbert", "bert_pretrained_model": "tiny-random", "colbert_compression_dim": 24,
                        "use_fp16": False})
    jm = jax_get_model(config, JaxHashBertTokenizer(1000))
    ranker = jckpt.load_encoder_subtree(snapshot, _jax_init(jm, config, 2))
    tm = get_model(config, _TOK)
    init_params(tm, config, torch.Generator().manual_seed(2))
    heads = flax_to_state_dict({"compressor": ranker["compressor"]})
    tm.load_state_dict(heads, strict=False)  # the fresh head JAX drew, carried across
    tckpt.load_encoder_subtree(snapshot, tm)
    batch = _pair_batch(6)
    want = jax.jit(jm.apply)({"params": ranker}, {k: jnp.asarray(v) for k, v in batch.items()})["score"]
    with torch.no_grad():
        _close(tm.eval()(_torch(batch))["score"], want)


# ---- gradient accumulation ---------------------------------------------------------

_OPT_TREE = {"encoder": {"layer_0": {"kernel": (6, 5), "bias": (5,)}}, "compressor": {"kernel": (6, 3)}}


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def test_accumulation_matches_optax_multisteps():
    """k = 2 over four micro-steps, clip 1.0 (active: the mean's norm is
    above it) and a cosine schedule with warmup: the parameters after each
    micro-step as MultiSteps gives them, the first micro-step's exactly the
    start, and two counted updates."""
    config = {"gradient_accumulation_steps": 2, "gradient_clip_norm": 1.0, "lr_schedule": "cosine",
              "optimizer_warmup_steps": 1, "max_training_steps": 4, "param_group0_learning_rate": 0.002,
              "param_group1_learning_rate": 0.005, "weight_decay": 0.01}
    rng = np.random.default_rng(0)
    shapes = {"encoder/layer_0/kernel": (6, 5), "encoder/layer_0/bias": (5,), "compressor/kernel": (6, 3)}
    init = {p: rng.normal(size=s).astype(np.float32) for p, s in shapes.items()}
    jparams = _unflatten({p: jnp.asarray(a) for p, a in init.items()})
    tx = joptim.build_optimizer(config, jparams)
    state = tx.init(jparams)
    tparams = {p: torch.nn.Parameter(torch.from_numpy(a.copy())) for p, a in init.items()}
    opt = toptim.Optimizer([(p.replace("/", "."), t) for p, t in tparams.items()], config)
    for micro in range(4):
        grads = {p: rng.normal(size=a.shape).astype(np.float32) * 2 for p, a in init.items()}
        updates, state = tx.update(_unflatten({p: jnp.asarray(g) for p, g in grads.items()}), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, t in tparams.items():
            t.grad = torch.from_numpy(grads[p])
        assert opt.step() is (micro % 2 == 1)
        for p, want in flatten_params(jparams).items():
            got = tparams[p].detach().numpy()
            if micro == 0:
                assert np.array_equal(got, init[p]), p
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, err_msg=f"{p} after micro-step {micro}")
    assert (opt.count, opt.mini_step) == (2, 0)
    assert all(np.abs(tparams[p].detach().numpy() - init[p]).max() > 1e-4 for p in init)


def test_trainer_resumed_mid_accumulation_is_bit_identical(tiny_data, tmp_path):
    """3 micro-steps straight (k = 2: one update, one half-accumulated)
    equal 1 micro-step, a train-state save, a resume (the accumulated mean
    and the micro-step index with it) and 2 more; the loss CSV and
    global_step count micro-steps."""
    base = dict(gradient_accumulation_steps=2, save_train_state=True)
    straight, split = tmp_path / "straight", tmp_path / "split"
    straight.mkdir()
    split.mkdir()
    t0 = Trainer(_trainer_config(tiny_data, max_training_batches=3, **base), str(straight))
    t0.train()
    assert (t0.global_step, t0.optimizer.count, t0.optimizer.mini_step) == (3, 1, 1)
    Trainer(_trainer_config(tiny_data, max_training_batches=1, **base), str(split)).train()
    t2 = Trainer(_trainer_config(tiny_data, max_training_batches=3, **base), str(split))
    assert t2.resume_from_train_state()
    assert (t2.global_step, t2.optimizer.count, t2.optimizer.mini_step) == (1, 0, 1)
    t2.train()
    want = t0.model.state_dict()
    for name, p in t2.model.state_dict().items():
        torch.testing.assert_close(p, want[name], atol=0, rtol=0, msg=name)
    for a, b in zip(t2.optimizer.acc, t0.optimizer.acc):
        assert torch.equal(a, b)


# ---- hub teachers ------------------------------------------------------------------

def test_hub_teacher_scores_as_jax_with_its_heads(tmp_path, monkeypatch):
    """The ColBERT hub stub's teacher over a seeded DistilBERT checkpoint
    (random weights) in a temporary cache: the port's encoder is the checkpoint's bit for bit and
    its compressor its own init; with JAX's compressor carried across it
    scores a batch as JAX's teacher does on the same encoder tensors."""
    # DistilBERT's size: the stub names a DistilBERT checkpoint, which sizes the encoder in both packages
    hf_config, sd = hf_import.seeded_distilbert_checkpoint(EncoderConfig.distilbert(), seed=9)
    snapshot = tmp_path / ("models--" + HUB.replace("/", "--")) / "snapshots" / "0123abc"
    hf_import.save_hf_checkpoint(str(snapshot), hf_config, sd, True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    model, config, _ = load_teacher(HUB, overrides={"use_fp16": False}, device="cpu")
    assert config["model"] == "colbert" and config["colbert_compression_dim"] == 768
    _, enc = hf_import.load_hf_encoder(str(snapshot))
    state = model.state_dict()
    for name, value in enc.items():
        assert torch.equal(state[f"encoder.{name}"], value), name
    kernel = state["compressor.kernel"]  # its own lecun-normal init (std 768 ** -0.5), no checkpoint's
    assert abs(float(kernel.std()) * 768 ** 0.5 - 1.0) < 0.05

    # JAX's teacher on the same checkpoint: init_params' two steps, the init at PRNGKey(0) (jitted),
    # then the encoder replaced by the checkpoint's (JAX's import equals the port's exactly,
    # tests/test_torch_hf_import.py; taken from the port's here, which needs no transformers)
    jm = jax_get_model(config, JaxHashBertTokenizer(1000))
    jparams = dict(jax.jit(jm.init)(jax.random.PRNGKey(0), jax_example_batch(config))["params"])
    imported = TransformerEncoderLM(EncoderConfig.distilbert())
    imported.load_state_dict(enc)
    jparams["encoder"] = tckpt.state_dict_to_flax(imported)
    model.load_state_dict(flax_to_state_dict({"compressor": jparams["compressor"]}), strict=False)
    batch = _pair_batch(8, lq=10, ld=30)
    want = jax.jit(jm.apply)({"params": jparams}, {k: jnp.asarray(v) for k, v in batch.items()})["score"]
    with torch.no_grad():
        _close(model(_torch(batch))["score"], want, rtol=1e-5, atol=1e-5)


# ---- dropout -----------------------------------------------------------------------

def test_dropout_keep_rate_and_scaling():
    g = torch.Generator().manual_seed(0)
    n, p = 200_000, 0.1
    out = dropout(torch.ones(n), p, g)
    kept = out != 0
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) <= 5 * sd
    assert torch.all(out[kept] == 1.0 / (1 - p))
    probs = torch.ones(4, 3, 16, 16, dtype=torch.bfloat16)
    shared = dropout(probs, p, g, shape=(1, 1, 16, 16))  # one mask over the (query, key) plane
    assert torch.equal(shared, shared[:1, :1].expand_as(shared))
    assert set(shared.unique().tolist()) == {0.0, float(torch.tensor(1.0, dtype=torch.bfloat16)
                                                         / torch.tensor(0.9, dtype=torch.bfloat16))}


def test_deterministic_passes_are_unchanged_and_dropout_passes_are_not():
    torch.manual_seed(0)
    ids, mask = (torch.from_numpy(a) for a in _ids_mask(3, 2, 12))
    ids = ids.long()
    enc = TransformerEncoderLM(EncoderConfig.tiny())
    init_parameters(enc, torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = enc(ids, mask), enc(ids, mask, deterministic=True, generator=torch.Generator().manual_seed(1))
        c = enc(ids, mask, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_embedding_dropout_runs_on_the_fused_path_as_in_jax():
    """JAX's encoder applies the embeddings' dropout also when the layers are
    fused: the dropped share of the embedded rows' entries is the rate in
    both packages (within five binomial deviations), and on the port's fused
    path a non-deterministic pass is the layers over the dropped embeddings
    of the same generator."""
    p = 0.25
    ids, mask = _ids_mask(4, 4, 64)
    jm = JaxEncoder(JaxEncoderConfig.tiny(fused_attention=True, dropout=p))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]
    jx = jm.apply({"params": params}, jnp.asarray(ids), deterministic=False, method=jm.embed,
                  rngs={"dropout": jax.random.PRNGKey(1)})
    enc = TransformerEncoderLM(EncoderConfig.tiny(fused_attention=True, dropout=p))
    enc.load_state_dict(flax_to_state_dict(params))
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        tx = enc.embed(tids, deterministic=False, generator=torch.Generator().manual_seed(1))
        clean = enc.embed(tids)
    n = tx.numel()
    sd = (n * p * (1 - p)) ** 0.5
    for dropped in (float((np.asarray(jx) == 0).sum()), float((tx == 0).sum())):
        assert abs(dropped - n * p) <= 5 * sd
    kept = tx != 0
    _close(tx[kept], (clean / (1 - p))[kept])
    with torch.no_grad(), pytest.warns(UserWarning, match="NO-OP"):
        import matchmaker_tpu_torch.models.encoder as encoder_module

        encoder_module._warned_fused_dropout = False
        out = enc(tids, torch.from_numpy(mask), deterministic=False, generator=torch.Generator().manual_seed(1))
        want = enc.encode_layers(tx, torch.from_numpy(mask), 0, enc.cfg.num_layers)
    with torch.no_grad():
        assert torch.equal(out, want) and not torch.equal(out, enc(tids, torch.from_numpy(mask)))


def test_the_smokes_hub_stub_is_the_repositorys():
    """chip_smoke.py types the ColBERT hub stub's keys in (the card has no
    PyYAML); they are the file's, key for key."""
    import chip_smoke
    from matchmaker_tpu_torch.config import get_config_single, resolve_hub_config

    with open(resolve_hub_config(chip_smoke.HUB_TEACHER)) as f:
        import yaml

        assert yaml.safe_load(f) == chip_smoke.HUB_TEACHER_STUB
    assert get_config_single(chip_smoke.HUB_TEACHER)["bert_pretrained_model"] == chip_smoke.HUB_TEACHER
