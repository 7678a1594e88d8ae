"""The rounding of the card's attention-core backward (K12's core,
matchmaker_tpu_torch/csrc/encoder_backward_kernels.cu), emulated in plain torch
on the CPU and held against the JAX package's Pallas backward run in
interpret mode, under the bars the card's kernel is held to.

The TPU kernel keeps p and ds in f32 into their products
(matchmaker_tpu/ops/fused_backward.py:_attn_bwd_kernel). The card's kernel
rounds P to bf16 into dV and dS to bf16 into dQ, takes dS into dK as a bf16
hi + lo pair, and sums D = sum_j P_ij dP_ij exactly in f32. The emulation
replaces the plain core of ``reference_attention_block_bwd`` by one that
rounds there; the rest of the backward is the plain version's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import fused_backward as jfb
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.ops import fused_backward as tfb
from matchmaker_tpu_torch.ops import matmul_f32

NAMES = ("dx", "dwq", "dwk", "dwv", "dwo", "dbq", "dbk", "dbv", "dbo", "dg", "dbe")


def _bf16(t):
    return t.to(torch.bfloat16).float()


def kernel_rounding_core(q, k, v, da, mask, scale):
    """The attention core and its backward as the card's kernels round them."""
    cd = q.dtype
    s = matmul_f32(q, k.transpose(-1, -2)) * scale + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    a = matmul_f32(p, v).to(cd)
    dp = matmul_f32(da, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    hi = _bf16(ds)
    lo = _bf16(ds - hi)
    dv = matmul_f32(_bf16(p).transpose(-1, -2), da).to(cd)
    dq = matmul_f32(hi, k).to(cd)
    dk = (matmul_f32(hi.transpose(-1, -2), q) + matmul_f32(lo.transpose(-1, -2), q)).to(cd)
    return a, dq, dk, dv


def _inputs(seed, b, l, n_heads):
    rng = np.random.default_rng(seed)
    hid = 64 * n_heads
    x = rng.normal(size=(b, l, hid)).astype(np.float32)
    ws = [(rng.normal(size=(hid, hid)) * hid ** -0.5).astype(np.float32) for _ in range(4)]
    bs = [(rng.normal(size=(hid,)) * 0.05).astype(np.float32) for _ in range(4)]
    g = (rng.normal(size=(hid,)) * 0.1 + 1).astype(np.float32)
    be = (rng.normal(size=(hid,)) * 0.1).astype(np.float32)
    mask = np.ones((b, l), np.float32)
    mask[0, l // 2 + 1:] = 0  # padded keys
    mask[1, 1:] = 0  # one live key
    cot = rng.normal(size=(b, l, hid)).astype(np.float32)
    return x, ws, bs, g, be, mask, cot


@pytest.mark.parametrize("l", [30, 77])
def test_kernel_rounding_holds_the_bars_against_jax_pallas(l, monkeypatch):
    """Head width 64, 2 heads, batch 3: every gradient of the emulated card
    backward within cosine 0.999 and max |d| <= 2e-2 max |JAX| of JAX's
    interpreted _attn_bwd_kernel, the key bias (zero in exact arithmetic)
    within 2e-2 of the query bias's size."""
    n_heads = 2
    x, ws, bs, g, be, mask, cot = _inputs(40 + l, 3, l, n_heads)
    monkeypatch.setattr(jfb, "FORCE_PALLAS_BWD", True)

    def loss(x, ws, bs, g, be):
        return (jfb.fused_attention_block_train(x, *ws, *bs, jnp.asarray(mask), n_heads, g, be) * cot).sum()

    jx, jws, jbs, jg, jbe = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(v) for v in bs], jnp.asarray(g), jnp.asarray(be))
    want = dict(zip(NAMES, (jx, *jws, *jbs, jg, jbe)))

    t = torch.from_numpy
    _, acc = tfa.reference_attention_block(t(x), *map(t, ws), *map(t, bs), t(mask), n_heads, t(g), t(be),
                                           save_acc=True)
    monkeypatch.setattr(tfb, "_attention_core_plain", kernel_rounding_core)
    got = dict(zip(NAMES, tfb.reference_attention_block_bwd(t(x), *map(t, ws), *map(t, bs[:3]), t(mask), n_heads,
                                                             t(g), t(cot), acc)))
    ref_q = float(np.abs(np.asarray(want["dbq"])).max())
    for name in NAMES:
        a = got[name].float().reshape(-1)
        b = torch.from_numpy(np.array(want[name])).float().reshape(-1)
        err = float((a - b).abs().max())
        if name == "dbk":
            assert err <= 2e-2 * ref_q, (name, err, ref_q)
            continue
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        assert cos >= 0.999 and err <= 2e-2 * float(b.abs().max()), (name, cos, err)


def test_kernel_rounding_core_rounds_and_plain_core_does_not():
    """The emulation differs from the plain core only where it rounds: the
    forward output agrees, dV/dQ/dK move by bf16 rounding only."""
    rng = np.random.default_rng(3)
    q, k, v, da = (torch.from_numpy(rng.normal(size=(2, 2, 21, 64)).astype(np.float32)) for _ in range(4))
    mask = torch.ones(2, 21)
    mask[1, 9:] = 0
    plain = tfb._attention_core_plain(q, k, v, da, mask, 0.125)
    emul = kernel_rounding_core(q, k, v, da, mask, 0.125)
    torch.testing.assert_close(emul[0], plain[0], atol=1e-6, rtol=1e-5)
    for e, p in zip(emul[1:], plain[1:]):
        assert not torch.equal(e, p)
        torch.testing.assert_close(e, p, atol=2e-2 * float(p.abs().max()), rtol=0)
