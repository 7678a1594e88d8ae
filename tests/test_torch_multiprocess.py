"""The port on two real processes over gloo on the CPU
(tests/_torch_multiprocess_worker.py, one launch): one BERT_DOT and one
ColBERT train step with in-batch negatives on each process's half of a
global batch against JAX's make_train_step on the whole batch, also on a
padded global batch whose valid rows the processes share unevenly or one
process holds none of; the eval step's padding (13 rows
over two processes); a Trainer run stopped at step 2 and resumed, bit for
bit the uninterrupted run, with only the primary writing the run folder;
cli.dense_retrieval's run on two processes (the mesh spans them, a shard
each) writing the run file of one process. The launch contract, the backend
rule and the loader's striding are in tests/test_torch_parallel.py."""

import functools
import json
import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.losses import dispatch as jdispatch
from matchmaker_tpu.models.bert_dot import BertDot as JaxBertDot
from matchmaker_tpu.models.colbert import ColBert as JaxColBert
from matchmaker_tpu.training import optim as joptim
from matchmaker_tpu.training.train_step import make_train_step as jax_make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.make_tiny_dataset import make_tiny_dataset

from matchmaker_tpu_torch.cli.dense_retrieval import run as dense_retrieval
from matchmaker_tpu_torch.models.bert_dot import BertDot
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, load_npz, save_npz
from matchmaker_tpu_torch.training.train_step import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_training.py's step configuration (adam_eps 1e-4: see there) at a constant rate
# without warm-up (a first step at learning rate 0 would move nothing)
STEP_CONFIG = {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
               "encoder_fused_attention": True, "loss": "margin-mse", "in_batch_negatives": True,
               "in_batch_neg_loss": "margin-mse", "param_group0_learning_rate": 1e-3,
               "param_group1_learning_rate": 1e-2, "optimizer_warmup_steps": 0, "max_training_steps": 10,
               "lr_schedule": "constant", "gradient_clip_norm": 5.0, "weight_decay": 0.01, "adam_eps": 1e-4}


def _ids_mask(rng, b, length, vocab=900):
    ids = rng.integers(2, vocab, size=(b, length)).astype(np.int32)
    mask = np.ones((b, length), np.float32)
    mask[::3, length // 2:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _global_batch(b=8, lq=8, ld=24, n_valid=None):
    """The global batch; with ``n_valid`` the padded last batch of a file
    (data/batching.py): rows past ``n_valid`` all zeros, ``valid`` 0."""
    rng = np.random.default_rng(12)
    q, qm = _ids_mask(rng, b, lq)
    p, pm = _ids_mask(rng, b, ld)
    n, nm = _ids_mask(rng, b, ld)
    batch = {"query_ids": q, "query_mask": qm, "doc_pos_ids": p, "doc_pos_mask": pm, "doc_neg_ids": n,
             "doc_neg_mask": nm, "pos_score": rng.uniform(5, 10, b).astype(np.float32),
             "neg_score": rng.uniform(0, 5, b).astype(np.float32)}
    if n_valid is not None:
        for v in batch.values():
            v[n_valid:] = 0
        batch["valid"] = (np.arange(b) < n_valid).astype(np.float32)
    return batch


# padded global batches of 8, 4 rows a process: process 1 holds one valid
# row ("padded": each of its rows would weigh 4x process 0's under a mean a
# process) or none ("empty")
PADDED_VALID = {"padded": 5, "empty": 4}


def _eval_batch(rows=13):
    rng = np.random.default_rng(13)
    q, qm = _ids_mask(rng, rows, 8)
    d, dm = _ids_mask(rng, rows, 24)
    return {"query_ids": q, "query_mask": qm, "doc_ids": d, "doc_mask": dm}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ColBERT's step: tests/test_torch_colbert_training.py's model, its in-batch
# loss listwise over the all-pairs MaxSim against the default [I | 0] teacher
COLBERT_CONFIG = dict(STEP_CONFIG, model="colbert", colbert_compression_dim=24, in_batch_neg_loss="KLDivTeacherList")


def _jax_start(name="step"):
    batch = _global_batch()
    config = COLBERT_CONFIG if name == "colbert" else STEP_CONFIG
    jm = (JaxColBert if name == "colbert" else JaxBertDot).from_config(config)
    params = jm.init(jax.random.PRNGKey(0), {"query_ids": batch["query_ids"], "query_mask": batch["query_mask"],
                                             "doc_ids": batch["doc_pos_ids"], "doc_mask": batch["doc_pos_mask"]})
    return jm, params["params"], batch


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """JAX's jitted step of ``name`` and its start (compiled once for every
    batch of the module)."""
    config = COLBERT_CONFIG if name == "colbert" else STEP_CONFIG
    jm, params, _ = _jax_start(name)
    tx = joptim.build_optimizer(config, params)
    return jax_make_train_step(jm, jdispatch.get_loss(config), tx, config), params, tx.init(params)


def _check_step_against_jax(work, name, suffix, batch):
    """The two processes' step (loss and grad_norm rtol 1e-4, parameters
    atol 1e-5, as tests/test_torch_training.py holds one process to JAX)
    against JAX's step on the global batch."""
    jstep, params, opt_state = _jax_step(name)
    new_params, _, jstats = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
    with open(work / f"{name}{suffix}_stats.json") as f:
        tstats = json.load(f)
    for key in ("loss", "grad_norm", "ranking_loss", "inbatch_loss", "score_pos_mean", "score_neg_mean"):
        np.testing.assert_allclose(tstats[key], float(jstats[key]), rtol=1e-4, err_msg=key)
    want, start = flax_to_state_dict(new_params), flax_to_state_dict(params)
    moved = 0.0
    for key, p in load_npz(str(work / f"{name}{suffix}_params.npz")).items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5, err_msg=key)
        moved = max(moved, float((p - start[key]).abs().max()))
    assert moved > 1e-3


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Both processes' launch and the work directory they wrote."""
    work = tmp_path_factory.mktemp("two_processes")
    for name in ("step", "colbert"):
        _, params, batch = _jax_start(name)
        save_npz(str(work / f"start_{name}.npz"), flax_to_state_dict(params))
    np.savez(work / "batch.npz", **batch)
    for pad, n_valid in PADDED_VALID.items():
        np.savez(work / f"batch_{pad}.npz", **_global_batch(n_valid=n_valid))
    np.savez(work / "eval_batch.npz", **_eval_batch())
    paths = make_tiny_dataset(str(work / "data"))
    rng = random.Random(0)
    scored = str(work / "data" / "train_scored.tsv")
    with open(paths["train_tsv"]) as f, open(scored, "w") as g:
        for line in f:
            g.write(f"{rng.uniform(5, 10):.3f}\t{rng.uniform(0, 5):.3f}\t{line}")
    trainer = {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False,
               "encoder_fused_attention": True, "loss": "margin-mse", "train_pairwise_distillation": True,
               "in_batch_negatives": True, "in_batch_neg_loss": "margin-mse", "batch_size_train": 8,
               "batch_size_eval": 16, "max_query_length": 8, "max_doc_length": 24, "epochs": 1,
               "param_group0_learning_rate": 1e-4, "param_group1_learning_rate": 1e-3,
               "optimizer_warmup_steps": 2, "max_training_steps": 100, "validate_every_n_batches": 5,
               "random_seed": 3, "device": "cpu", "train_tsv": scored, "enable_tensorboard": False,
               "gradient_clip_norm": 1.0, "save_train_state": True,
               "validation_cont": {"tsv": paths["val_tsv"], "qrels": paths["qrels"], "binarization_point": 1}}
    dense = {"model": "bert_dot", "bert_pretrained_model": "tiny-random", "use_fp16": False, "device": "cpu",
             "faiss_index_type": "scann", "collection_tsv": paths["collection"], "max_query_length": 8,
             "max_doc_length": 24, "collection_batch_size": 32, "query_batch_size": 8,
             "query_sets": {"dev": {"queries_tsv": paths["queries"], "qrels": paths["qrels"], "top_n": 10}}}
    with open(work / "configs.json", "w") as f:
        json.dump({"step": STEP_CONFIG, "colbert": COLBERT_CONFIG, "trainer": trainer, "dense": dense}, f)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MATCHMAKER_COORDINATOR=f"127.0.0.1:{port}", MATCHMAKER_NUM_PROCESSES="2",
                   MATCHMAKER_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_multiprocess_worker.py"),
                                       str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = [p.communicate(timeout=400)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "TORCH_MULTIPROCESS_OK" in out, f"rank {rank}:\n{out[-4000:]}"
    return {"work": work, "dense": dense, "outs": outs}


def test_backend_rule_printed_at_start_up(two_processes):
    for rank, out in enumerate(two_processes["outs"]):
        assert f"process {rank}/2 up on cpu, backend gloo" in out


@pytest.mark.parametrize("name", ["step", "colbert"])
def test_one_step_on_two_processes_matches_jax_on_the_global_batch(two_processes, name):
    """Each process steps on 4 of the 8 rows, its in-batch negatives the
    8 rows' documents (gathered with gradients; ColBERT's token vectors and
    masks into the all-pairs MaxSim), each query's positive at its global
    column, the gradients averaged: loss and grad_norm rtol 1e-4,
    parameters atol 1e-5, as tests/test_torch_training.py holds one
    process to JAX."""
    _check_step_against_jax(two_processes["work"], name, "", _global_batch())


@pytest.mark.parametrize("name,pad", [("step", "padded"), ("step", "empty"), ("colbert", "padded")])
def test_one_step_on_a_padded_global_batch_matches_jax(two_processes, name, pad):
    """The padded last batch: 5 (or 4) valid rows of 8, process 1 holding
    one (or none). Every loss term and stat is one mean over the global
    batch's valid rows (BERT_DOT's Margin-MSE and in-batch Margin-MSE), or
    over its rows (ColBERT's in-batch KLDivTeacherList), as JAX's
    one-program step takes it: the processes' gradients summed, not
    averaged."""
    _check_step_against_jax(two_processes["work"], name, f"_{pad}", _global_batch(n_valid=PADDED_VALID[pad]))


def test_eval_step_pads_13_rows_over_two_processes(two_processes):
    """13 rows padded to 14, 7 a process, gathered and cut back: the one
    process scores of the same rows."""
    work = two_processes["work"]
    model = BertDot.from_config(STEP_CONFIG)
    model.load_state_dict(load_npz(str(work / "step_params.npz")))
    model.eval()
    want = make_eval_step(model)({k: torch.from_numpy(v) for k, v in _eval_batch().items()})["score"]
    got = np.load(work / "eval_scores.npy")
    assert got.shape == (13,)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_resumed_two_process_run_is_bit_identical(two_processes):
    """Stopped at step 2 (a collective train-state snapshot), resumed by new
    Trainers (parameters, optimizer, step, each process's data cursor): the
    uninterrupted run's parameters bit for bit."""
    work = two_processes["work"]
    straight, split = load_npz(str(work / "trainer_straight.npz")), load_npz(str(work / "trainer_split.npz"))
    for name, p in straight.items():
        torch.testing.assert_close(split[name], p, atol=0, rtol=0, msg=name)
    with open(work / "trainer_straight.json") as f:
        assert json.load(f)["global_step"] == 15  # 120 triples / a global batch of 8
    assert os.path.isfile(work / "split" / "train_state" / "step_2.pt")


def test_primary_alone_writes_the_run_folder(two_processes):
    """One row a validation (steps 5, 10, 15 and the epoch's end), not one a
    process; each process's own efficiency file; the best weights."""
    run = two_processes["work"] / "straight"
    with open(run / "validation-metrics-cont.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 4
    for name in ("best-model.npz", "best-info.csv", "efficiency-metrics-p0.json", "efficiency-metrics-p1.json"):
        assert os.path.isfile(run / name), name
    assert not os.path.exists(run / "efficiency-metrics.json")


def test_dense_retrieval_on_two_processes_writes_the_run_file_of_one(two_processes, tmp_path):
    """Encode (every other batch a process, the primary writing the blocks),
    the scann index (float16, binmax's exact fallback at this size) sharded
    over the two processes, the merge across them: the single process's
    encoded blocks and run file."""
    work = two_processes["work"]
    assert dense_retrieval("encode+index+search", two_processes["dense"], str(tmp_path)) == 0
    with open(tmp_path / "dev-output.txt") as f, open(work / "dense" / "dev-output.txt") as g:
        want, got = f.read().splitlines(), g.read().splitlines()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        (qa, da, ra, sa), (qb, db, rb, sb) = a.split(), b.split()
        assert (qa, da, ra) == (qb, db, rb)
        np.testing.assert_allclose(float(sa), float(sb), rtol=1e-6)
    for name in ("token_reps_0.npy", "doc_infos.npz", "encode_meta.json"):
        assert os.path.isfile(work / "dense" / "encoded" / name), name
    np.testing.assert_array_equal(np.load(work / "dense" / "encoded" / "token_reps_0.npy"),
                                  np.load(tmp_path / "encoded" / "token_reps_0.npy"))
    assert os.path.isfile(work / "dense" / "efficiency-metrics-p1.json")
