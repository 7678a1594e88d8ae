"""The logic around the probes' card kernels that runs without a card: K15's
plan for L keys (``probes.attn_inner.kernel_plan``: key padding, the
two-half form past 256 keys, query tiles, grid, shared memory), K16's
persistent walk over the output tiles (``probes.int8_matmul.tile_schedule``),
and K15's rounding order, emulated in numpy: past 256 keys the card's
kernel takes each half's max and sum and combines them, so its softmax
denominator rounds otherwise than one sum over the row. The emulation is
held to the port's plain version and to the TPU probe's ``k_batched``
(interpret mode) at lengths on both sides of 256."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu_torch.probes import attn_inner as tai
from matchmaker_tpu_torch.probes import int8_matmul as tim
from tests.test_torch_probes import ATTN_ATOL, SCALE, _interpret_attn, jattn

LENGTHS = [1, 16, 64, 65, 77, 200, 208, 256, 257, 512]


# ---- K15's plan ---------------------------------------------------------------

@pytest.mark.parametrize("length", LENGTHS)
def test_attn_plan_pads_keys_to_whole_chunks_and_splits_past_256(length):
    plan = tai.kernel_plan(length, batch=256, n_heads=12)
    tiles = -(-length // 64)
    assert plan["q_tiles"] == tiles and plan["grid"] == [12, 256] and plan["threads"] == 128
    assert plan["keys_padded"] - 64 < length <= plan["keys_padded"] if length <= 256 else plan["keys_padded"] == 512
    if length <= 256:  # the whole row in registers: one accumulator of 32 f32 a thread per chunk
        assert plan["halves"] == 1 and plan["chunks"] == tiles and 32 * plan["chunks"] <= 128
    else:  # two halves of four chunks, whatever L
        assert plan["halves"] == 2 and plan["chunks"] == 4
    # a block's most on the H100; two CTAs an SM up to 256 keys (228 KB an SM, 1 KB of it each block's)
    assert plan["smem_bytes"] <= 232_448
    if length <= 256:
        assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024


def test_attn_plan_at_the_headline_and_refusals():
    plan = tai.kernel_plan(200)
    assert (plan["q_tiles"], plan["chunks"], plan["halves"], plan["keys_padded"]) == (4, 4, 1, 256)
    assert plan["smem_bytes"] == 1024 + 12 * 8192 + 256 * 4 + 6 * 8
    for bad in (0, 513):
        with pytest.raises(ValueError, match="1 <= L <= 512"):
            tai.kernel_plan(bad)


# ---- K16's persistent schedule ---------------------------------------------------

@pytest.mark.parametrize("m", [1, 127, 129, 1000, 16384])
@pytest.mark.parametrize("n", [8, 40, 264, 3072])
def test_int8_schedule_covers_every_output_tile_once(m, n):
    schedule = tim.tile_schedule(m, n)
    tiles = [t for cta in schedule for t in cta]
    want = {(r, c) for r in range(0, m, 128) for c in range(0, n, 128)}
    assert len(tiles) == len(want) and set(tiles) == want
    assert len(schedule) == min(len(want), tim.SMS) and all(schedule)
    # the CTAs' loads are balanced to one tile
    assert max(map(len, schedule)) - min(map(len, schedule)) <= 1
    # along N first: a CTA's first tiles of one row band sit side by side
    assert schedule[0][0] == (0, 0) and (len(schedule) < 2 or schedule[1][0] == ((128, 0) if n <= 128 else (0, 128)))


def test_int8_schedule_at_the_headline():
    schedule = tim.tile_schedule(16384, 3072)
    assert len(schedule) == 132 and sum(map(len, schedule)) == 3072
    assert sorted({len(c) for c in schedule}) == [23, 24]  # 3,072 = 132 x 23 + 36
    assert len(tim.tile_schedule(1000, 3072)) == 132  # 8 x 24 = 192 tiles: two rounds


# ---- K15's rounding order, emulated ---------------------------------------------

def _bf16(x):
    """numpy f32 rounded to bf16 (nearest, ties to even), kept as f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).view(np.float32)


def emulate_kernel(q, k, v, mask, variant, n_heads=12, bf16_io=True):
    """The card kernel's softmax and products in its order, in numpy f32:
    s = (q.k^T) * scale + (m - 1) * 1e9 (keys past L out); per pass of up
    to 256 keys the row max m_h and l_h = sum exp(s - m_h); m = max of the
    halves', l = sum of l_h exp(m_h - m); p = exp(s - m) * (1 / l), rounded
    to bf16 unless f32_p (then hi + lo, exact in f32 products); o = p.v
    with f32 sums, rounded to bf16 when the inputs are bf16."""
    b, length, hid = q.shape
    d = hid // n_heads
    plan = tai.kernel_plan(length)
    split = plan["chunks"] * 64  # keys a pass
    negk = ((mask.astype(np.float32) - np.float32(1.0)) * np.float32(1e9)).astype(np.float32)
    out = np.zeros_like(q, dtype=np.float32)
    for h in range(n_heads):
        sl = slice(h * d, (h + 1) * d)
        s = np.einsum("bqd,bkd->bqk", q[:, :, sl], k[:, :, sl]).astype(np.float32) * np.float32(SCALE)
        s = (s + negk[:, None, :]).astype(np.float32)
        m = np.full((b, length, 1), -np.inf, np.float32)
        total = np.zeros((b, length, 1), np.float32)
        for lo in range(0, length, split):
            part = s[:, :, lo:lo + split]
            mh = part.max(axis=-1, keepdims=True)
            lh = np.exp(part - mh, dtype=np.float32).sum(axis=-1, keepdims=True, dtype=np.float32)
            mn = np.maximum(m, mh)
            total = (total * np.exp(m - mn, dtype=np.float32) + lh * np.exp(mh - mn, dtype=np.float32)).astype(
                np.float32)
            m = mn
        p = (np.exp(s - m, dtype=np.float32) * (np.float32(1.0) / total)).astype(np.float32)
        if variant == "batched" and bf16_io:
            p = _bf16(p)
        o = np.einsum("bqk,bkd->bqd", p, v[:, :, sl]).astype(np.float32)
        out[:, :, sl] = _bf16(o) if bf16_io else o
    return out


def _inputs(length, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng.normal(0, 0.3, (2, length, 768)).astype(np.float32)) for _ in range(3))
    mask = np.ones((2, length), np.float32)
    mask[0, length // 3:] = 0.0
    mask[1, 5] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["batched", "f32_p"])
@pytest.mark.parametrize("length", [200, 300, 512])
def test_two_half_softmax_order_matches_plain_and_k_batched(length, variant, dtype):
    """The emulated kernel order (one pass at 200 keys, two halves at 300
    and 512) against the port's plain version and the TPU probe's
    k_batched in interpret mode, at the bar of tests/test_torch_probes.py
    (f32: 1e-5; bf16: one bf16 rounding of an output below 0.5)."""
    q, k, v, mask = _inputs(length, seed=length)
    got = emulate_kernel(q, k, v, mask, variant, bf16_io=dtype == "bf16")
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    plain = tai.reference_attn_inner(*(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(mask),
                                     variant)
    np.testing.assert_allclose(got, plain.float().numpy(), atol=ATTN_ATOL[dtype], rtol=0)
    flags = {"keep_f32_p": True} if variant == "f32_p" else {}
    want = _interpret_attn(functools.partial(jattn.k_batched, scale=SCALE, **flags),
                           *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask), 2)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), atol=ATTN_ATOL[dtype], rtol=0)


def test_two_half_denominator_is_a_few_ulps_off_one_sum():
    """Past 256 keys the combined l = l_0 exp(m_0 - m) + l_1 exp(m_1 - m)
    differs from one f32 sum of exp(s - m) by a few ulps at most; the
    probabilities themselves are the same exp(s - m)."""
    rng = np.random.default_rng(3)
    s = (rng.normal(0, 2.0, (64, 512))).astype(np.float32)
    m = s.max(axis=-1, keepdims=True)
    one = np.exp(s - m, dtype=np.float32).sum(axis=-1, dtype=np.float32)
    halves = [s[:, :256], s[:, 256:]]
    mh = [h.max(axis=-1, keepdims=True) for h in halves]
    lh = [np.exp(h - x, dtype=np.float32).sum(axis=-1, dtype=np.float32) for h, x in zip(halves, mh)]
    two = sum(l_ * np.exp(x[:, 0] - m[:, 0], dtype=np.float32) for l_, x in zip(lh, mh)).astype(np.float32)
    assert np.max(np.abs(two - one) / one) < 8 * np.finfo(np.float32).eps
