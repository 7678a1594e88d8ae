"""The port's TKL against the JAX package on the CPU, with
tests/test_torch_embedding_models.py's sizes and helpers (chunks of 16 with
overlap 4, windows of 8): scores and secondary outputs (the window scores,
the top regions' indices exactly) in the log, idf and embedding
saturations at rtol = atol = 1e-5, one ranknet step in the log and the idf
saturations. The idf power overflows on the short document in both
packages (ROADMAP.md §3): the port's NaN stand where JAX's do, and the idf
step runs on full-length documents, where both are finite. The ``linear``
saturation, whose JAX expression raises for every input, is held to its
formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.models import tkl as jtkl
from matchmaker_tpu_torch.models import tkl
from matchmaker_tpu_torch.models.weights import init_parameters
from tests.test_torch_embedding_models import BASE, _pair_batch, _torch, compare_outputs, compare_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["tkl-log", "tkl-idf", "tkl-embedding"])
def test_tkl_matches_jax(name):
    assert compare_outputs(name, _pair_batch(3)) == (name != "tkl-idf")
    full = _pair_batch(4)
    full["doc_mask"][:] = 1.0
    full["doc_ids"][full["doc_ids"] == 0] = 5
    assert compare_outputs(name, full)


@pytest.mark.parametrize("name,full_docs", [("tkl-log", False), ("tkl-idf", True)])
def test_tkl_train_step_matches_jax(name, full_docs):
    compare_train_step(name, full_docs)


def test_tkl_linear_saturation_follows_its_formula():
    """``linear``: the JAX expression does not broadcast ((B, Lq, W) against
    (B, Lq, W, 1)) and raises for every input. The port's per-window value,
    ``saturation_linear(inf) · Σ_k clamp(s_k, 1e-10) + saturation_linear2(inf)``
    for every kernel, against numpy from the same window sums and layers;
    the rest of TKL's path is the one the other saturations hold to JAX."""
    config = dict(BASE, tkl_saturation="linear")
    jm = jtkl.TKL.from_config(config, None)
    batch = _pair_batch(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="broadcast"):
        jax.jit(jm.init)(jax.random.PRNGKey(1), jb)
    tm = tkl.TKL.from_config(config, None)
    init_parameters(tm, torch.Generator().manual_seed(2))
    captured = {}
    saturate = tm.saturate

    def spy(pkq, win_lengths, q_ctx, q_mask, idfs):
        out = saturate(pkq, win_lengths, q_ctx, q_mask, idfs)
        captured.update(pkq=pkq.detach().numpy(), lengths=win_lengths.numpy(), out=out.detach().numpy())
        return out

    tm.saturate = spy
    with torch.no_grad():
        score = tm(_torch(batch))["score"]
    assert torch.isfinite(score).all()
    pkq, lengths = captured["pkq"], captured["lengths"]
    influencer = np.stack([np.maximum(batch["query_idfs"], 0)[:, :, None] * np.ones_like(lengths),
                           lengths.astype(np.float32)], axis=-1)

    def dense(layer):
        return (influencer @ layer.kernel.detach().numpy() + layer.bias.detach().numpy())[..., 0]

    want = dense(tm.saturation_linear) * np.maximum(pkq, 1e-10).sum(-1) + dense(tm.saturation_linear2)
    np.testing.assert_allclose(captured["out"], np.broadcast_to(want[..., None], pkq.shape), rtol=1e-5, atol=1e-5)
