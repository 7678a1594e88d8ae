"""The port's parallel/ layer against the JAX package's on the CPU:
tests/test_multihost.py's unit cases held to the port's functions over the
same grids (shard bounds, per_process_batch, the no-op without the launch
variables, the loader's process stride), the launch contract's refusals and
the backend rule, and the mesh helpers on one- and two-axis meshes beside
JAX's (the merge's tie order, row shards as views, batch splits, parameter
replicas). Two real processes run in tests/test_torch_multiprocess.py."""

import numpy as np
import pytest
import torch

from matchmaker_tpu.config import Config, auto_fill
from matchmaker_tpu.data.loaders import triple_training_loader as jax_triple_loader
from matchmaker_tpu.data.tokenization import build_tokenizer as jax_build_tokenizer
from matchmaker_tpu.parallel import mesh as jmesh
from matchmaker_tpu.parallel import multihost as jmultihost

from matchmaker_tpu_torch.data.loaders import triple_training_loader
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.parallel import mesh as tmesh
from matchmaker_tpu_torch.parallel import multihost

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_items", [1, 7, 100, 8_841_823])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 8])
def test_process_shard_bounds_equal_jax(n_items, n_proc):
    """Every row owned once, in order, the remainder on the last process:
    JAX's bounds exactly."""
    seen = []
    for pid in range(n_proc):
        lo, hi = multihost.process_shard_bounds(n_items, n_proc, pid)
        assert (lo, hi) == jmultihost.process_shard_bounds(n_items, n_proc, pid)
        seen.extend(range(lo, hi)) if n_items < 1000 else seen.append((lo, hi))
    if n_items < 1000:
        assert seen == list(range(n_items))


def test_per_process_batch_and_its_refusal(monkeypatch):
    assert multihost.per_process_batch(32) == jmultihost.per_process_batch(32) == 32
    assert multihost.process_shard_bounds(32, 4, 0) == (0, 8)
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.per_process_batch(32)
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    assert multihost.per_process_batch(32) == 8


def test_no_process_group_without_the_launch_variables(monkeypatch):
    for name in ("MATCHMAKER_COORDINATOR", "MATCHMAKER_MULTIHOST"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.maybe_initialize_distributed() is False
    assert jmultihost.maybe_initialize_distributed() is False
    assert (multihost.process_count(), multihost.process_index(), multihost.is_primary()) == (1, 0, True)
    # outside a group the collectives are identities
    t = torch.arange(6.0).reshape(3, 2).requires_grad_()
    assert multihost.gather_rows(t) is t and multihost.all_gather(t)[0] is t
    assert multihost.all_have(True) and not multihost.all_have(False)
    assert list(multihost.lockstep(iter([1, 2]))) == [1, 2]
    assert multihost.on_primary(lambda: "folder") == "folder"
    assert multihost.average_gradients([t], torch.ones(2)).tolist() == [1.0, 1.0]


def test_a_tpu_pod_launch_is_refused(monkeypatch):
    monkeypatch.delenv("MATCHMAKER_COORDINATOR", raising=False)
    monkeypatch.setenv("MATCHMAKER_MULTIHOST", "tpu_pod")
    with pytest.raises(ValueError, match="tpu_pod"):
        multihost.maybe_initialize_distributed()


def test_backend_rule(monkeypatch):
    """nccl when every rank has a card of its own, judged on this host's
    ranks, else gloo; a rank's card is cuda:(rank % cards)."""
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.rank_device(0)  # no card visible here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [multihost.backend_rule(n) for n in (1, 4, 5)] == ["nccl", "nccl", "gloo"]
    assert [multihost.rank_device(r) for r in (0, 5)] == [torch.device("cuda", 0), torch.device("cuda", 1)]
    # two hosts of four cards, four processes each: nccl, from the local count
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("MATCHMAKER_LOCAL_PROCESSES", raising=False)
    assert multihost.local_process_count(8) == 8
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert multihost.backend_rule(multihost.local_process_count(8)) == "nccl"
    monkeypatch.setenv("MATCHMAKER_LOCAL_PROCESSES", "5")
    assert multihost.backend_rule(multihost.local_process_count(8)) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.backend_rule(2) == "gloo"  # two ranks on one card: NCCL refuses a duplicate GPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.backend_rule(1) == "gloo"


def test_process_stride_equals_jax_and_skips_before_tokenization(tmp_path):
    """tests/test_multihost.py's stride case: each process's batches are
    JAX's, interleaved they are the unstrided stream, the skipped samples
    never reach the tokenizer, and skip_batches drops this process's first."""
    (tmp_path / "triples.tsv").write_text("".join(f"q {i}\tpos {i}\tneg {i}\n" for i in range(25)))
    raw = {"model": "bert_dot", "model_input_type": "auto", "token_embedder_type": "auto",
           "bert_pretrained_model": "tiny-test", "max_query_length": 4, "max_doc_length": 6}
    jconfig = Config(auto_fill(dict(raw)))
    path = str(tmp_path / "triples.tsv")

    class Counting:
        def __init__(self, inner):
            self.inner, self.calls = inner, 0

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def encode(self, *a, **kw):
            self.calls += 1
            return self.inner.encode(*a, **kw)

    base = list(triple_training_loader(jconfig, build_tokenizer(jconfig), path, batch_size=4))
    strided = []
    for pid in range(3):
        tok = Counting(build_tokenizer(jconfig))
        got = list(triple_training_loader(jconfig, tok, path, batch_size=4, process_stride=(pid, 3)))
        want = list(jax_triple_loader(jconfig, jax_build_tokenizer(jconfig), path, batch_size=4,
                                      process_stride=(pid, 3)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        kept = sum(int(b["query_mask"].sum(axis=1).astype(bool).sum()) for b in got)
        assert tok.calls == 3 * kept
        strided.append(got)
    for step, want in enumerate(base):
        for k in want:
            np.testing.assert_array_equal(strided[step % 3][step // 3][k], want[k])
    skipped = list(triple_training_loader(jconfig, build_tokenizer(jconfig), path, batch_size=4,
                                          process_stride=(0, 3), skip_batches=1))
    assert len(skipped) == len(strided[0]) - 1
    np.testing.assert_array_equal(skipped[0]["query_ids"], strided[0][1]["query_ids"])


@pytest.mark.parametrize("axes,shape", [(("data",), None), (("dcn", "ici"), (2, 4)), (("dcn", "ici"), (4, 2))])
def test_mesh_helpers_equal_jax(axes, shape):
    """make_mesh, corpus_axes and axis_size on one- and two-axis meshes of
    eight entries, beside JAX's over its eight virtual devices."""
    jm = jmesh.make_mesh(axes, shape=shape)
    tm = tmesh.make_mesh(axes, devices=[CPU] * 8, shape=shape)
    assert tmesh.corpus_axes(tm) == jmesh.corpus_axes(jm)
    assert tm.shape == dict(jm.shape) and tm.size == 8
    for axis in list(axes) + [tuple(axes)]:
        assert tmesh.axis_size(tm, axis) == jmesh.axis_size(jm, axis)
    assert tmesh.n_shards(tm) == 8 and tmesh.n_shards(None) == 1


def test_mesh_refusals_and_default_devices(monkeypatch):
    with pytest.raises(ValueError, match="explicit shape"):
        tmesh.make_mesh(("dcn", "ici"), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="holds 6 entries"):
        tmesh.make_mesh(("dcn", "ici"), devices=[CPU] * 8, shape=(2, 3))
    assert tmesh.make_mesh(device="cpu").local_devices == [CPU]
    # the CPU only when asked for: cuda, named or by default, needs a card
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmesh.make_mesh(device=device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_mesh(device="cuda:1").local_devices == [torch.device("cuda", 1)]
    assert tmesh.make_mesh().local_devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_shard_rows_are_views_of_one_upload_and_pad_with_zeros():
    """Entries on one device share one upload (views); rows past the real
    ones are zeros; each shard knows its global index."""
    tm = tmesh.make_mesh(devices=[CPU] * 4)
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    sh = tmesh.shard_rows(tm, a, torch.float32, padded_rows=12)
    assert sh.rows == 3 and sh.n_shards == 4 and [s for s, _ in sh] == [0, 1, 2, 3]
    base = sh.parts[0].untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == base for p in sh.parts)
    np.testing.assert_array_equal(torch.cat(sh.parts).numpy()[:10], a)
    assert (sh.parts[3][1:] == 0).all() and sh.nbytes == 12 * 3 * 4
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_rows(tm, a)


def test_merge_keeps_lax_top_k_order_among_ties():
    """Equal scores: the lower place in the shard-major concatenation first,
    as jax.lax.top_k merges JAX's shards; -inf slots stay last."""
    inf = float("-inf")
    parts = [(torch.tensor([[3.0, 1.0, inf]]), torch.tensor([[7, 2, -1]])),
             (torch.tensor([[3.0, 2.0, 1.0]]), torch.tensor([[40, 41, 42]]))]
    vals, ids = tmesh.merge_topk(parts, 5, CPU)
    assert vals.tolist() == [[3.0, 3.0, 2.0, 1.0, 1.0]] and ids.tolist() == [[7, 40, 41, 2, 42]]
    padded = tmesh.pad_partial(torch.tensor([[1.0]]), torch.tensor([[5]]), 3)
    assert padded[0].tolist() == [[1.0, inf, inf]] and padded[1].tolist() == [[5, -1, -1]]


def test_batch_sharding_and_parameter_replicas():
    """Rows split over the distinct devices in contiguous runs, the first
    taking the remainder (cpu and cpu:0 are two device names on the CPU);
    one parameter replica a distinct device."""
    tm = tmesh.make_mesh(devices=[CPU, CPU, torch.device("cpu", 0)])
    split = tmesh.batch_sharding(tm)
    assert split.devices == [CPU, torch.device("cpu", 0)]
    assert split.split(7) == [(0, 4), (4, 7)] and split.split(1) == [(0, 1), (1, 1)]
    model = torch.nn.Linear(3, 2)
    replicas = tmesh.shard_params(model, tm)
    assert len(replicas) == 2 and replicas[0] is model and replicas[1] is not model
    torch.testing.assert_close(replicas[1].weight, model.weight)


def test_encode_splits_a_batch_over_the_replicas():
    """cli.dense_retrieval's encode over two parameter replicas: the rows
    of one encode, in order."""
    from matchmaker_tpu_torch.cli.dense_retrieval import make_encode_fn

    class Enc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(5, 4, generator=torch.Generator().manual_seed(0)))

        def encode(self, ids, mask, sequence_type):
            return self.w[ids] * mask[..., None]

    model = Enc()
    mesh = tmesh.make_mesh(devices=[CPU, torch.device("cpu", 0)])
    replicas = tmesh.shard_params(model, mesh)
    ids, mask = torch.randint(0, 5, (7, 3)), torch.ones(7, 3)
    torch.testing.assert_close(make_encode_fn(model, "doc_encode", mesh, replicas)(ids, mask),
                               make_encode_fn(model, "doc_encode")(ids, mask))
    with pytest.raises(ValueError, match="replicas"):
        make_encode_fn(model, "doc_encode", mesh, replicas[:1])
