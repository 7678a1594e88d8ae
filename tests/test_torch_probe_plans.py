"""The logic around the probes' card kernels that runs without a card: K15's
plan for L keys (``probes.attn_inner.kernel_plan``: key padding, the
two-half form past 256 keys, query tiles, grid, shared memory), K16's
persistent walk over the output tiles (``probes.int8_matmul.tile_schedule``),
K17/K18's cluster plan and geometry check (``probes.mlp_rows.kernel_plan``,
``check_geometry``), and two rounding orders emulated in numpy. K15: past
256 keys the card's kernel takes each half's max and sum and combines them,
so its softmax denominator rounds otherwise than one sum over the row; the
emulation is held to the port's plain version and to the TPU probe's
``k_batched`` (interpret mode) at lengths on both sides of 256. K17/K18:
h rounded to bf16 a 64-column chunk at a time, the second product's chunks
summed in the kernel's order, each row's LayerNorm sums taken over each
CTA's 192 columns and combined c = 0..3; held to the plain version and to
the TPU probe's ``_mlp_kernel_rows2d`` / ``_mlp_kernel_rowsblk``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu_torch.probes import attn_inner as tai
from matchmaker_tpu_torch.ops import fused_attention as tfa
from matchmaker_tpu_torch.probes import int8_matmul as tim
from matchmaker_tpu_torch.probes import mlp_rows as tmr
from tests.test_torch_probes import ATTN_ATOL, MLP_ATOL, SCALE, _interpret_attn, _mlp_inputs, jattn, jmlp

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


# ---- K17/K18's cluster plan ------------------------------------------------------

@pytest.mark.parametrize("m", [1, 127, 128, 129, 1232, 51_200])
def test_mlp_rows_plan_covers_every_row_once_within_the_budget(m):
    """Cluster t of the grid owns rows [128t, 128t + 128), CTA c of it the
    columns [192c, 192c + 192): every (row, column) of the (M, 768) output
    falls to exactly one CTA, no cluster is empty, and a CTA fits the
    H100's shared memory and, one CTA an SM, its registers."""
    plan = tmr.kernel_plan(m)
    (grid, gy, gz), cluster = plan["grid"], plan["cluster"]
    assert cluster == [4, 1, 1] and (gy, gz) == (1, 1) and grid % 4 == 0 and plan["threads"] == 384
    rows, cols = plan["rows_per_cluster"], plan["cols_per_cta"]
    row_hits = np.zeros(m, np.int64)
    col_hits = {}
    for b in range(grid):
        tile, rank = divmod(b, cluster[0])
        lo, hi = tile * rows, min(m, tile * rows + rows)
        assert lo < hi  # no cluster without rows
        if rank == 0:
            row_hits[lo:hi] += 1
        col_hits.setdefault(tile, np.zeros(768, np.int64))[rank * cols:(rank + 1) * cols] += 1
    assert (row_hits == 1).all()
    assert all((hits == 1).all() for hits in col_hits.values()) and len(col_hits) == -(-m // 128)
    assert plan["smem_bytes"] <= 232_448 and plan["registers_per_sm"] <= 65_536


def test_mlp_rows_plan_at_the_headline_and_refusals():
    """At (256, 200) = 51,200 rows: 400 clusters, twelve rounds of 256 FF
    columns, 230,528 B of shared memory, 64,512 registers an SM, and 4.88 GB
    between L2 and the SMs a call: below the 7.55 GB the first port's
    64-row blocks pulled (all of W1 and W2, 9.4 MB, each 64 rows)."""
    plan = tmr.kernel_plan(51_200)
    assert plan["grid"] == [1600, 1, 1] and plan["rounds"] == 12
    assert plan["smem_bytes"] == 4 * 24_576 + 2 * 65_536 + 16 * 8 + 1024 == 230_528
    assert plan["registers_per_sm"] == 2 * 128 * 232 + 128 * 40
    first_port = (51_200 // 64) * 2 * 768 * 3072 * 2
    assert plan["l2_bytes"] == 400 * (12 * 128 * 768 * 2 + 2 * 768 * 3072 * 2 + 2 * 128 * 768 * 2)
    assert plan["l2_bytes"] < 7.5e9 < first_port
    assert tmr.kernel_plan(0)["grid"] == [0, 1, 1] and tmr.kernel_plan(1232, 1536)["rounds"] == 6
    with pytest.raises(ValueError, match="multiple of 256"):
        tmr.kernel_plan(128, 1000)


@pytest.mark.parametrize("hid,ff,match", [(768, 3072, None), (768, 1536, None), (768, 256, None),
                                          (512, 3072, "hid 768"), (64, 256, "hid 768"), (768, 128, "multiple of 256"),
                                          (768, 3000, "multiple of 256"), (768, 0, "multiple of 256")])
def test_mlp_rows_geometry_check_names_what_it_refuses(hid, ff, match):
    """The wrappers' check before a launch, callable on any machine: hid
    768 and FF a whole number of 256-column rounds, each refusal naming
    which."""
    if match is None:
        tmr.check_geometry(hid, ff)
    else:
        with pytest.raises(ValueError, match=match):
            tmr.check_geometry(hid, ff)


# ---- K17/K18's rounding order, emulated --------------------------------------------

def emulate_mlp_rows(x, w1, b1, w2, b2, g, be, eps=1e-12, cluster=4, chunk=64):
    """The card kernel's order in numpy f32 on bf16 values: per round of
    cluster x chunk FF columns, chunk s of it h_s = bf16(gelu(x.W1[:, s] +
    b1[s])) and acc += h_s.W2[s, :] (acc f32, chunks in order); v = (x + b2)
    + acc; the row sum over each CTA's hid / cluster columns, the partials
    added c = 0..cluster-1 and times 1 / hid (the mean); the same for the
    centred squares; y = bf16((v - mean) * rstd * g + be)."""
    m, hid = x.shape
    ff = w1.shape[1]
    cols = hid // cluster

    def gelu(h):
        return tfa._gelu_poly(torch.from_numpy(h)).numpy()

    acc = np.zeros((m, hid), np.float32)
    for lo in range(0, ff, chunk):
        sl = slice(lo, lo + chunk)
        h = _bf16(gelu((x @ w1[:, sl]).astype(np.float32) + b1[sl]))
        acc = (acc + (h @ w2[sl, :]).astype(np.float32)).astype(np.float32)
    v = ((x + b2).astype(np.float32) + acc).astype(np.float32)

    def over_ctas(a):
        total = a[:, :cols].sum(axis=1, dtype=np.float32)
        for c in range(1, cluster):
            total = (total + a[:, c * cols:(c + 1) * cols].sum(axis=1, dtype=np.float32)).astype(np.float32)
        return total

    mean = (over_ctas(v) * np.float32(1.0 / hid)).astype(np.float32)
    d = (v - mean[:, None]).astype(np.float32)
    rstd = (1.0 / np.sqrt(over_ctas(d * d) * np.float32(1.0 / hid) + np.float32(eps))).astype(np.float32)
    return _bf16((d * rstd[:, None] * g + be).astype(np.float32))


def _bf16_ulp(*ys):
    """One bf16 unit in the last place (8 significant bits) at the largest
    |y| of each element, and at least at 1: y = (v - mean) * rstd * g + be
    near 0 is a difference of terms of O(0.1-1), whose own roundings stay."""
    top = np.maximum.reduce([np.abs(y) for y in ys] + [np.ones_like(ys[0])])
    return np.exp2(np.floor(np.log2(top)) - 7).astype(np.float32)


@pytest.mark.parametrize("wrapper", ["mlp_rows2d", "mlp_rowsblk"])
@pytest.mark.parametrize("hid,ff", [(64, 256), (768, 3072)])
def test_mlp_rows_cluster_order_matches_plain_and_the_tpu_kernels(wrapper, hid, ff):
    """The emulated kernel order through each wrapper's padding (K17: L 30
    to 32, B 3 to 8; K18: 90 rows to 1,024) against the port's plain
    version and the TPU probe's kernel in interpret mode, bf16. At hid 64 /
    FF 256 (16 columns a CTA, one round) at the bar of
    test_mlp_rows_wrappers_match_jax (2^-6: one bf16 ulp below 4); at the
    kernel's 768 / 3,072, where |y| passes 4, one bf16 ulp at the larger
    |y| of the pair and at least at 1 (2^-7): the orders differ only in f32
    sums, which can flip a rounding of h or of y. The plain version and the
    TPU kernel are held to each other at the same bar."""
    x, w = _mlp_inputs(11, hid=hid, ff=ff)
    x = _bf16(x)
    w = [_bf16(w[0]), w[1], _bf16(w[2])] + list(w[3:])
    b, l, _ = x.shape
    if wrapper == "mlp_rows2d":
        rows = np.zeros((8, 32, hid), np.float32)
        rows[:b, :l] = x
    else:
        rows = np.zeros((1024 // l + 1, l, hid), np.float32).reshape(-1, hid)[:1024].reshape(1024, 1, hid)
        rows[:b * l, 0] = x.reshape(-1, hid)
    got = emulate_mlp_rows(rows.reshape(-1, hid), *w)
    got = got.reshape(8, 32, hid)[:b, :l] if wrapper == "mlp_rows2d" else got[:b * l].reshape(b, l, hid)
    tw = [torch.from_numpy(w[0]).to(torch.bfloat16), torch.from_numpy(w[1]),
          torch.from_numpy(w[2]).to(torch.bfloat16)] + [torch.from_numpy(a) for a in w[3:]]
    plain = tmr.reference_mlp_rows(torch.from_numpy(x).to(torch.bfloat16), *tw).float().numpy()
    jw = [jnp.asarray(w[0], jnp.bfloat16), jnp.asarray(w[1]), jnp.asarray(w[2], jnp.bfloat16)] + \
        [jnp.asarray(a) for a in w[3:]]
    tpu = getattr(jmlp, wrapper)(jnp.asarray(x, jnp.bfloat16), *jw)
    tpu = np.asarray(jnp.asarray(tpu, jnp.float32))
    for a, want in ((got, plain), (got, tpu), (plain, tpu)):
        if hid == 64:
            np.testing.assert_allclose(a, want, atol=MLP_ATOL["bf16"], rtol=0)
        else:
            assert np.all(np.abs(a - want) <= _bf16_ulp(a, want)), np.max(np.abs(a - want))
