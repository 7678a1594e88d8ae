"""The port's fused encoder halves (matchmaker_tpu_torch/ops/fused_attention.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On CPU tensors the port's wrappers run their plain versions, which compute
what the CUDA kernels compute; the same numpy inputs go to both packages and
the outputs are compared in f32 with the JAX tests' own tolerances
(tests/test_fused_encoder.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import fused_attention as jfa
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as tfa


def _attention_inputs(seed, b, l, hid):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * 0.1).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[min(2, b - 1), max(1, l * 2 // 3):] = 0  # one padded example
    return x, ws, bs, mask, g, be


def _mlp_inputs(seed, b, l, hid, ff):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, l, hid)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(hid, ff)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(ff,)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(ff, hid)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(hid,)) * 0.05).astype(np.float32)
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2, g, be


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,l", [(6, 30), (3, 8), (2, 1)])
def test_attention_block_matches_jax_kernel(b, l):
    """K1 at HID=64, 4 heads, with a padded example; atol 2e-4."""
    x, ws, bs, mask, g, be = _attention_inputs(1, b, l, 64)
    want = jfa.fused_attention_block(jnp.asarray(x), *_j(ws), *_j(bs), jnp.asarray(mask), 4,
                                     jnp.asarray(g), jnp.asarray(be))
    _build.reset_launches()
    got = tfa.fused_attention_block(torch.from_numpy(x), *_t(ws), *_t(bs), torch.from_numpy(mask), 4,
                                    torch.from_numpy(g), torch.from_numpy(be))
    assert _build.LAUNCHES["fused_attention_block"] == 0  # CPU tensor → plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_packed_qkv_entry_matches_separate_weights():
    """fused_attention_block_qkv (Q/K/V packed, as the encoder keeps them)
    computes what fused_attention_block does."""
    x, ws, bs, mask, g, be = _attention_inputs(4, 3, 11, 64)
    wq, wk, wv, wo = _t(ws)
    bq, bk, bv, bo = _t(bs)
    rest = (torch.from_numpy(mask), 4, torch.from_numpy(g), torch.from_numpy(be))
    want = tfa.fused_attention_block(torch.from_numpy(x), wq, wk, wv, wo, bq, bk, bv, bo, *rest)
    got = tfa.fused_attention_block_qkv(torch.from_numpy(x), torch.cat([wq, wk, wv], dim=1),
                                        torch.cat([bq, bk, bv]), wo, bo, *rest)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_attention_reference_matches_jax_reference():
    x, ws, bs, mask, g, be = _attention_inputs(3, 4, 17, 64)
    want = jfa.reference_attention_block(jnp.asarray(x), *_j(ws), *_j(bs), jnp.asarray(mask), 4,
                                         jnp.asarray(g), jnp.asarray(be))
    got = tfa.reference_attention_block(torch.from_numpy(x), *_t(ws), *_t(bs), torch.from_numpy(mask), 4,
                                        torch.from_numpy(g), torch.from_numpy(be))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("ff_chunks", [2, 4])
def test_mlp_block_matches_jax_kernel(ff_chunks):
    """K2 at HID=64, FF=256 (the f32 kernel uses the A&S gelu); atol 5e-4."""
    x, w1, b1, w2, b2, g, be = _mlp_inputs(2, 5, 24, 64, 256)
    want = jfa.fused_mlp_block(*_j([x, w1, b1, w2, b2, g, be]), ff_chunks=ff_chunks)
    got = tfa.fused_mlp_block(*_t([x, w1, b1, w2, b2, g, be]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


@pytest.mark.parametrize("name", ["_gelu_poly", "_gelu_exact"])
def test_gelu_matches_jax(name):
    h = np.linspace(-12.0, 12.0, 20001, dtype=np.float32)
    want = np.asarray(getattr(jfa, name)(jnp.asarray(h)))
    got = getattr(tfa, name)(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_gelu_for_follows_dtype():
    assert tfa._gelu_for(torch.bfloat16) is tfa._gelu_poly
    assert tfa._gelu_for(torch.float32) is tfa._gelu_exact


def test_bf16_blocks_track_f32():
    """The bf16 plain versions (what the CUDA kernels compute) stay within a
    few bf16 ulps of the f32 blocks: the casts sit where the kernels' do."""
    x, ws, bs, mask, g, be = _attention_inputs(5, 3, 20, 64)
    bf = torch.bfloat16
    args32 = (*_t(ws), *_t(bs), torch.from_numpy(mask), 4, torch.from_numpy(g), torch.from_numpy(be))
    args16 = (*[w.to(bf) for w in _t(ws)], *_t(bs), torch.from_numpy(mask), 4,
              torch.from_numpy(g), torch.from_numpy(be))
    o32 = tfa.fused_attention_block(torch.from_numpy(x), *args32)
    o16 = tfa.fused_attention_block(torch.from_numpy(x).to(bf), *args16)
    assert o16.dtype == bf
    cos = torch.nn.functional.cosine_similarity(o16.float().reshape(-1, 64), o32.reshape(-1, 64), dim=-1)
    assert float(cos.min()) > 0.999
