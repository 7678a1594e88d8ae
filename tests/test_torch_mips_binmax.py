"""The port's binmax scan (matchmaker_tpu_torch/ops/mips_binmax.py) and exact
scans against the JAX package on the CPU.

JAX runs its plain reference (``binmax_candidates_jnp`` /
``use_pallas=False``, bit-exact on the CPU) and, for one geometry, its
Pallas kernels in interpret mode. Level-1 comparisons use dyadic inputs
(multiples of 1/8 in bf16) so every f32 score is exact whatever the
summation order, and the packed candidates can be compared bit for bit,
ties included; the end-to-end top-k uses random floats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips_binmax as jmb
from matchmaker_tpu.ops.mips import blocked_topk_scores as jax_blocked_topk
from matchmaker_tpu.ops.mips_f16 import f16_scan_topk as jax_f16_scan_topk
from matchmaker_tpu_torch.ops import mips_binmax as tmb
from matchmaker_tpu_torch.ops.mips import blocked_topk_scores
from matchmaker_tpu_torch.ops.mips_f16 import f16_scan_topk


def _dyadic(rng, n, d):
    return (rng.integers(-4, 5, size=(n, d)) / 8.0).astype(np.float32)


def _clustered(rng, n, d, n_clusters=16):
    centers = rng.normal(size=(n_clusters, d))
    vecs = centers[np.sort(rng.integers(0, n_clusters, size=n))] + 0.4 * rng.normal(size=(n, d))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs.astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same(a, b):
    return float(np.mean(_bits(a) == _bits(b)))


def test_padding_grain_matches_jax():
    for tile in (1024, 2048, 4096):
        for per_bin in (1, 2, 4, 8):
            assert tmb.padding_grain(tile, per_bin) == jmb.padding_grain(tile, per_bin)


@pytest.mark.parametrize("per_bin", [2, 4, 8])
def test_level1_candidates_match_jax(per_bin):
    rng = np.random.default_rng(per_bin)
    n, d = 5000, 32  # ragged: padded to the grain, tail masked by n_valid
    corpus, queries = _dyadic(rng, n, d), _dyadic(rng, 20, d)
    want = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=n, per_bin=per_bin)
    got = tmb.binmax_candidates(torch.from_numpy(queries), torch.from_numpy(corpus), n_valid=n, per_bin=per_bin)
    assert got.shape == want.shape
    assert _same(got.numpy(), want) >= 0.999


def test_level1_candidates_match_jax_pallas_interpret():
    rng = np.random.default_rng(9)
    n, d = 3000, 32
    corpus, queries = _dyadic(rng, n, d), _dyadic(rng, 12, d)
    want = jmb.binmax_candidates(jnp.asarray(queries), jnp.asarray(corpus), n_valid=n, per_bin=2,
                                 interpret=True)
    got = tmb.binmax_candidates(torch.from_numpy(queries), torch.from_numpy(corpus), n_valid=n, per_bin=2)
    assert _same(got.numpy(), want) >= 0.999


def test_topk_per_bin_t_matches_jax():
    rng = np.random.default_rng(4)
    scores = _dyadic(rng, 512, 24) * 3
    for base, n_valid in ((0, 512), (0, 300), (1024, 1200)):
        want = jmb._topk_per_bin_t(jnp.asarray(scores), base, n_valid, 4, use_argmax=True)
        got = tmb._topk_per_bin_t(torch.from_numpy(scores), base, n_valid, 4)
        assert _same(got.numpy(), want) == 1.0


@pytest.mark.parametrize("width", [tmb.L2_MID, tmb.L2_WIDE])
def test_level2_matches_jax(width):
    rng = np.random.default_rng(width)
    corpus, queries = _clustered(rng, 9000, 32), _clustered(rng, 16, 32)
    raw = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=9000, per_bin=8)
    want = jmb._level2_reduce(raw.T, interpret=False, use_pallas=False, bin_width=width).T
    got = tmb._level2_reduce(torch.from_numpy(np.array(raw)), width)
    assert got.shape == want.shape
    assert _same(got.numpy(), want) >= 0.999


@pytest.mark.parametrize("level2", [None, tmb.L2_MID, tmb.L2_WIDE])
def test_unpack_matches_jax(level2):
    rng = np.random.default_rng(5)
    corpus, queries = _clustered(rng, 9000, 32), _clustered(rng, 16, 32)
    packed = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=9000, per_bin=4,
                                       level2=level2)
    top = np.sort(np.asarray(packed), axis=1)[:, ::-1][:, :50].copy()
    pos = np.argsort(-np.asarray(packed), axis=1, kind="stable")[:, :50].astype(np.int32)
    wv, wi = jmb.unpack_candidates(jnp.asarray(top), jnp.asarray(pos), 2048, 4, level2=level2)
    gv, gi = tmb.unpack_candidates(torch.from_numpy(top), torch.from_numpy(pos).long(), 2048, 4, level2)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert _same(gv.numpy(), wv) == 1.0


# (rows, k, per_bin): no tournament, keep-8/32 and keep-8/128
GEOMETRIES = [(5000, 10, 2), (5000, 10, 8), (24_576, 10, 8)]


@pytest.mark.parametrize("n,k,per_bin", GEOMETRIES)
def test_binmax_scan_topk_matches_jax(n, k, per_bin):
    rng = np.random.default_rng(n + per_bin)
    corpus, queries = _clustered(rng, n, 48), _clustered(rng, 24, 48)
    wv, wi = jmb.binmax_scan_topk(jnp.asarray(queries), jnp.asarray(corpus, jnp.bfloat16), k, n_valid=n,
                                  per_bin=per_bin, use_pallas=False)
    gv, gi = tmb.binmax_scan_topk(torch.from_numpy(queries), torch.from_numpy(corpus).to(torch.bfloat16),
                                  k, n_valid=n, per_bin=per_bin)
    wi, gi = np.asarray(wi), gi.numpy()
    overlap = min(len(set(a) & set(b)) / k for a, b in zip(wi, gi))  # per query
    assert overlap >= 0.999, overlap
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=2e-3)


def test_f16_fallback_matches_jax():
    rng = np.random.default_rng(6)
    n, k = 3000, 25
    corpus = _clustered(rng, n, 48).astype(np.float16)
    queries = _clustered(rng, 10, 48)
    padded = np.concatenate([corpus, np.zeros((96, 48), np.float16)])
    wv, wi = jax_f16_scan_topk(jnp.asarray(queries), jnp.asarray(padded), k, approx=False, n_valid=n)
    gv, gi = f16_scan_topk(torch.from_numpy(queries), torch.from_numpy(padded), k, n_valid=n)
    assert (gi.numpy() < n).all()
    overlap = min(len(set(a) & set(b)) / k for a, b in zip(np.asarray(wi), gi.numpy()))
    assert overlap >= 0.999, overlap
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)


def test_exact_blocked_scan_matches_jax():
    rng = np.random.default_rng(8)
    corpus, queries = _clustered(rng, 5000, 32), _clustered(rng, 7, 32)
    wv, wi = jax_blocked_topk(jnp.asarray(queries), jnp.asarray(corpus), 30, block_size=2048)
    gv, gi = blocked_topk_scores(torch.from_numpy(queries), torch.from_numpy(corpus), 30, block_size=2048)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)


# ---- K4 on the card (l2::level2_kernel<W>), emulated on the CPU --------------
#
# A warp takes one (query row, 1024-column block); lane l selects from the
# 32 columns [32l, 32l + 32) by int32 keys: the score's bits made
# signed-ordered, the low BITS = log2(W) bits replaced by W - 1 - offset
# (offset within the W-column group), so max/min order the keys by score,
# then lower offset. Chunks of 8 keys are sorted by a 19-comparator network
# and merged into the running top 8 (the larger of each pair (i, 7 - i),
# then three half-cleaner stages), the largest key dropped kept as the 9th;
# at W = 128 the quad's lanes merge with xor 1, then xor 2. Keys that agree
# above their low BITS bits (+0 and -0 counted equal, two -inf not) are in
# offset order (+0's first); if two such neighbours among the top 8 are out
# of the scores' order (value descending, offset ascending), the 8th and
# the 9th key agree so, or a kept score is NaN, the warp selects again by
# the scan's branch-free insert (ascending offsets, strict '>') and lane
# merges (value descending, offset ascending). A change to the kernel's selection
# has to change this emulation, or the kernel's card tests fail where this
# one passes.

SORT8 = [(0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7), (0, 1), (2, 3), (4, 5), (6, 7),
         (2, 4), (3, 5), (1, 4), (3, 6), (1, 2), (3, 4), (5, 6)]
INT_MIN = -(1 << 31)


def test_sort8_network_sorts_every_zero_one_input():
    """The 0-1 principle: a comparator network that sorts every 0/1 input
    sorts every input."""
    for word in range(256):
        k = torch.tensor([[(word >> i) & 1 for i in range(8)]], dtype=torch.int32)
        _sort8(k)
        assert k[0].tolist() == sorted(k[0].tolist(), reverse=True)


def _ordered(x):
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _cx(k, i, j):
    hi, lo = torch.maximum(k[..., i], k[..., j]), torch.minimum(k[..., i], k[..., j])
    k[..., i], k[..., j] = hi, lo


def _sort8(k):
    for i, j in SORT8:
        _cx(k, i, j)


def _merge8(a, b, rej):
    x, y = a, b.flip(-1)
    a = torch.maximum(x, y)
    rej = torch.maximum(rej, torch.minimum(x, y).amax(-1))
    for h in (4, 2, 1):
        for i in range(8):
            if i & h == 0:
                _cx(a, i, i + h)
    return a, rej


def _high(key, bits):
    h = key & ~((1 << bits) - 1)
    return torch.where(h == -(1 << bits), torch.zeros_like(h), h)


def _insert_exact(tv, ti, v, idx):
    """The scan's branch-free insert (strict '>', offsets ascending)."""
    for j in range(7, 0, -1):
        above, here = v > tv[..., j - 1], v > tv[..., j]
        tv[..., j] = torch.where(above, tv[..., j - 1], torch.where(here, v, tv[..., j]))
        ti[..., j] = torch.where(above, ti[..., j - 1], torch.where(here, idx, ti[..., j]))
    first = v > tv[..., 0]
    tv[..., 0] = torch.where(first, v, tv[..., 0])
    ti[..., 0] = torch.where(first, idx, ti[..., 0])


def _merge_exact(tv, ti, m):
    """scan::merge_lanes with lane ^ m: value descending, offset ascending."""
    perm = torch.arange(32) ^ m
    ov, oi = tv[..., perm, :].flip(-1), ti[..., perm, :].flip(-1)
    keep = (tv > ov) | ((tv == ov) & (ti < oi))
    tv, ti = torch.where(keep, tv, ov), torch.where(keep, ti, oi)
    for h in (4, 2, 1):
        for i in range(8):
            if i & h == 0:
                a, b, ai, bi = tv[..., i].clone(), tv[..., i + h].clone(), ti[..., i].clone(), ti[..., i + h].clone()
                swap = (b > a) | ((b == a) & (bi < ai))
                tv[..., i], tv[..., i + h] = torch.where(swap, b, a), torch.where(swap, a, b)
                ti[..., i], ti[..., i + h] = torch.where(swap, bi, ai), torch.where(swap, ai, bi)
    return tv, ti


def emulate_level2(x, width, exact_path=True):
    """(Q, C), C % 1024 == 0 → the (Q, C/W·8) output before the 128-column
    padding, as the kernel computes it; with ``exact_path=False`` the keys'
    selection alone, and the share of warps that take the exact path."""
    q, c = x.shape
    bits = 5 if width == 32 else 7
    m = (1 << bits) - 1
    lane = torch.arange(32)
    sub = x.reshape(q, c // 1024, 32, 32)  # (Q, block, lane, its 32 columns)
    base = torch.zeros(32, dtype=torch.int32) if width == 32 else (32 * (lane & 3)).int()
    offs = base[:, None] + torch.arange(32, dtype=torch.int32)[None, :]
    keys = (_ordered(sub) | m) - offs
    a, rej = None, torch.full(sub.shape[:3], INT_MIN, dtype=torch.int32)
    for ch in range(4):
        b = keys[..., 8 * ch:8 * ch + 8].clone()
        _sort8(b)
        if ch:
            a, rej = _merge8(a, b, rej)
        else:
            a = b
    if width == 128:
        for mask in (1, 2):
            perm = lane ^ mask
            rej = torch.maximum(rej, rej[..., perm])
            a, rej = _merge8(a, a[..., perm, :], rej)
    off = m - (a & m)
    group = sub.reshape(q, c // 1024, 1024 // width, width)
    g = lane if width == 32 else lane >> 2
    kept = torch.gather(group[:, :, g, :], -1, off.long())
    nxt = torch.cat([a[..., 1:], rej[..., None]], dim=-1)
    hi, hn = _high(a, bits), _high(nxt, bits)
    high_neg_inf = (0x807FFFFF & ~m) - (1 << 32)
    k0, k1, o0, o1 = kept[..., :-1], kept[..., 1:], off[..., :-1], off[..., 1:]
    out_of_order = ~((k0 > k1) | ((k0 == k1) & (o0 < o1)))  # scan::before, negated
    out_of_order = torch.cat([out_of_order, torch.ones_like(kept[..., :1], dtype=torch.bool)], -1)
    near = ((hi == hn) & (hi != high_neg_inf) & out_of_order).any(-1) | torch.isnan(kept).any(-1)
    redo = near.any(-1)  # the warp's __any_sync
    if exact_path:
        tv = torch.full(a.shape, float("-inf"))
        ti = torch.zeros(a.shape, dtype=torch.int32)
        for j in range(32):
            _insert_exact(tv, ti, sub[..., j], offs[:, j].expand(sub.shape[:3]))
        if width == 128:
            for mask in (1, 2):
                tv, ti = _merge_exact(tv, ti, mask)
        kept = torch.where(redo[..., None, None], tv, kept)
        off = torch.where(redo[..., None, None], ti, off)
    out = tmb._pack_lane(kept, off, tmb.LANE_BITS)  # (Q, block, lane, rank)
    if width == 128:
        out = out[:, :, ::4, :]  # the quad's lanes hold their group's list
    return out.transpose(-1, -2).reshape(q, -1), float(redo.float().mean())


def _level2_input(kind, rng, q, c):
    if kind == "normal":
        return torch.from_numpy(rng.normal(size=(q, c)).astype(np.float32))
    if kind == "ties":  # small integers: most groups hold exact ties in their top 9
        return torch.from_numpy(rng.integers(-3, 4, size=(q, c)).astype(np.float32))
    if kind == "near_ties":  # small integers with random low 5 mantissa bits: equal above them
        x = rng.integers(1, 4, size=(q, c)).astype(np.float32)
        return torch.from_numpy((x.view(np.int32) | rng.integers(0, 32, size=(q, c)).astype(np.int32))
                                .view(np.float32))
    if kind == "signed_zero_pairs":  # each 32 columns: -0.0 and +0.0 at random offsets, else -inf
        x = np.full((q, c // 32, 32), -np.inf, np.float32)
        for row in x.reshape(-1, 32):
            a, b = rng.choice(32, size=2, replace=False)
            row[a], row[b] = -0.0, 0.0
        return torch.from_numpy(x.reshape(q, c))
    if kind == "zeros_and_inf":  # +0 ties -0; groups of -inf only; a few finite
        return torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.0, -np.inf, -np.inf, -np.inf], np.float32),
                                           size=(q, c)))
    raise ValueError(kind)


def _pad1024(x):
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 1024), value=float("-inf"))


@pytest.mark.parametrize("width", [tmb.L2_MID, tmb.L2_WIDE])
@pytest.mark.parametrize("kind", ["normal", "ties", "near_ties", "zeros_and_inf", "signed_zero_pairs",
                                  "candidates"])
def test_level2_emulation_matches_plain_and_jax(width, kind):
    """The card's K4 emulated: bit-identical (int32 view) to the port's
    ``_level2_plain`` and JAX's ``_level2_reduce(use_pallas=False)`` on
    normal scores, exact ties, near ties, signed zeros beside all -inf
    groups, a +0.0 and a -0.0 alone in each 32 columns (equal scores whose
    keys order +0 first whatever their offsets), and real
    level-1 candidates (per_bin 8, a corpus cut mid-tile, so C is no
    multiple of 1024 and the tail is -inf). Where +0 ties -0, JAX packs the
    group's max (+0) at the first zero's offset and the port packs that
    zero itself: there the two agree but for the sign bit."""
    rng = np.random.default_rng(width + len(kind))
    if kind == "candidates":
        corpus, queries = _clustered(rng, 6000, 32), _clustered(rng, 6, 32)
        x = jmb.binmax_candidates_jnp(jnp.asarray(queries), jnp.asarray(corpus), n_valid=5000, per_bin=8)
        x = torch.from_numpy(np.array(x))
    else:
        x = _level2_input(kind, rng, 6, 2048 + 1024)
    xp = _pad1024(x)
    got, _ = emulate_level2(xp, width)
    plain = tmb._level2_reduce(x, width)
    want = np.asarray(jmb._level2_reduce(jnp.asarray(x.numpy().T), interpret=False, use_pallas=False,
                                         bin_width=width)).T
    n_out = got.shape[1]
    assert plain.shape == want.shape and plain.shape[1] >= n_out
    assert torch.isneginf(plain[:, n_out:]).all()
    assert torch.equal(got.view(torch.int32), plain[:, :n_out].contiguous().view(torch.int32))
    got_bits, want_bits = got.view(torch.int32).numpy(), np.ascontiguousarray(want[:, :n_out]).view(np.int32)
    if kind in ("zeros_and_inf", "signed_zero_pairs"):
        zeros = (got_bits & 0x7FFFFFFF) < (1 << 14)  # +-0 with packed lanes
        got_bits, want_bits = np.where(zeros, got_bits & 0x7FFFFFFF, got_bits), np.where(
            zeros, want_bits & 0x7FFFFFFF, want_bits)
    assert np.array_equal(got_bits, want_bits)


@pytest.mark.parametrize("width", [tmb.L2_MID, tmb.L2_WIDE])
def test_level2_keys_need_the_exact_path_only_at_near_ties(width):
    """Normal scores have no near tie: the keys alone give the plain output
    and no warp redoes its selection. Exact ties inside the top 8 keep the
    keys' offset order, which is the plain order. Scores equal but for their
    low 5 mantissa bits tie near in nearly every group: the keys alone then
    differ from the plain output (the check is what keeps the kernel exact),
    and with the exact path they match."""
    rng = np.random.default_rng(3)
    for kind, redo in (("normal", False), ("ties", None), ("near_ties", True)):
        x = _level2_input(kind, rng, 4, 2048)
        keys_only, share = emulate_level2(x, width, exact_path=False)
        plain = tmb._level2_plain(x, width)[:, :keys_only.shape[1]].contiguous()
        if redo is False:
            assert share == 0.0 and torch.equal(keys_only.view(torch.int32), plain.view(torch.int32))
        if redo:
            assert share == 1.0 and not torch.equal(keys_only.view(torch.int32), plain.view(torch.int32))
        got, _ = emulate_level2(x, width)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def test_level2_exact_ties_inside_the_top_8_need_no_exact_path():
    """Eight equal scores ahead of distinct lower ones: the keys' offset
    order is the plain order, so no warp redoes its selection."""
    x = -torch.arange(2048, dtype=torch.float32).reshape(1, 2048) / 2048 - 1
    x.view(1, 64, 32)[:, :, :8] = 5.0  # each 32-group's first eight tie
    x.view(1, 64, 32)[:, :, 8:16] = 4.0 - torch.arange(8, dtype=torch.float32)
    got, share = emulate_level2(x, tmb.L2_MID, exact_path=False)
    assert share == 0.0
    assert torch.equal(got.view(torch.int32), tmb._level2_plain(x, tmb.L2_MID)[:, :got.shape[1]]
                       .contiguous().view(torch.int32))


# ---- K6 on the card (unpack::unpack_kernel), emulated on the CPU --------------
#
# 32-bit column arithmetic: the level-2 block and group by shifts, then
# t = c / nb by FastDiv's multiply-shift (mul = ceil(2^(31 + l) / nb),
# l = ceil(log2 nb), q = umulhi(c, mul) >> (l - 1); nb = 1 passes c
# through), bin = c - t·nb, tile = t >> log2(per_bin); only tile·tile_rows +
# bin·128 + lane is 64-bit.

def _fastdiv(d):
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()
    return ((1 << p) + d - 1) // d, p - 32


def _div(n, d):
    """FastDiv.div on int64 tensors holding values in [0, 2^31)."""
    mul, shift = _fastdiv(d)
    return n if d == 1 else ((n * mul) >> 32) >> shift


def emulate_unpack(vals, pos, tile_rows, per_bin, level2):
    bits = vals.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    clear = 127 | (127 << 7) if level2 else 127
    out_vals = torch.where(finite, (bits & ~clear).view(torch.float32), vals)
    col = pos.long()
    assert int(col.max()) < 2 ** 31  # the kernel's int
    if level2:
        shift = (1024 // level2 * 8).bit_length() - 1
        rc = ((col >> shift) << 10) + ((col & (1024 // level2 - 1)) << (level2.bit_length() - 1)) \
            + ((bits >> 7) & 127).long()
    else:
        rc = col
    assert int(rc.max()) < 2 ** 31
    nb = tile_rows // 128
    t = _div(rc, nb)
    ids = (t >> (per_bin.bit_length() - 1)) * tile_rows + ((rc - t * nb) << 7) + (bits & 127).long()
    return out_vals, torch.where(finite, ids, -1)


@pytest.mark.parametrize("d", [1, 2, 3, 9, 16, 24, 32, 127, 1000, 12_345])
def test_fastdiv_is_exact_below_2_to_31(d):
    rng = np.random.default_rng(d)
    n = np.concatenate([rng.integers(0, 2 ** 31, size=200_000), np.arange(0, 4 * d + 5),
                        2 ** 31 - 1 - np.arange(4 * d + 5), (np.arange(1, 2000) * d) % 2 ** 31,
                        (np.arange(1, 2000) * d - 1) % 2 ** 31])
    t = torch.from_numpy(n.astype(np.int64))
    assert torch.equal(_div(t, d), t // d)


def _unpack_case(rng, tile_rows, per_bin, level2, q, k, top_col):
    """Selected candidates: finite values with random lane bits (a level-2
    offset below W), some -inf, and columns spread up to ``top_col``, which
    appears once."""
    vals = rng.normal(size=(q, k)).astype(np.float32)
    vals[rng.random(size=(q, k)) < 0.1] = -np.inf
    bits = vals.view(np.int32)
    lanes = rng.integers(0, 128, size=(q, k)) | (rng.integers(0, level2 or 128, size=(q, k)) << 7)
    bits[:] = np.where(np.isfinite(vals), (bits & ~0x3FFF) | lanes, bits)
    pos = rng.integers(0, top_col + 1, size=(q, k)).astype(np.int64)
    pos[0, 0], pos[-1, -1] = top_col, 0
    return torch.from_numpy(vals), torch.from_numpy(pos)


# the level-2 column whose level-1 column is the largest below 2^31
def _top_column(level2):
    if not level2:
        return 2 ** 31 - 1
    shift = (1024 // level2 * 8).bit_length() - 1
    return (1 << (21 + shift)) - 1


@pytest.mark.parametrize("tile_rows", [128, 1152, 2048, 3072, 4096])
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("level2", [None, tmb.L2_MID, tmb.L2_WIDE])
def test_unpack_emulation_matches_plain_and_jax(tile_rows, per_bin, level2):
    """The card's 32-bit K6 emulated against ``_unpack_plain`` (int64 all
    through) up to the largest column the geometry holds, values bit for
    bit; and against JAX's ``unpack_candidates`` where its int32 ids hold."""
    rng = np.random.default_rng(tile_rows + 10 * per_bin + (level2 or 0))
    vals, pos = _unpack_case(rng, tile_rows, per_bin, level2, 5, 64, _top_column(level2))
    gv, gi = emulate_unpack(vals, pos, tile_rows, per_bin, level2)
    wv, wi = tmb._unpack_plain(vals, pos, tile_rows, per_bin, level2)
    assert torch.equal(gi, wi) and torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    # ids below 2^31: id < (rc + 1024) * 128 / per_bin + tile_rows, rc <= column * W / 8 + 1023
    small = ((2 ** 31 - 1) // 128 - tile_rows // 128 - 1024) // (level2 // 8 if level2 else 1)
    vals, pos = _unpack_case(rng, tile_rows, per_bin, level2, 5, 64, small)
    gv, gi = emulate_unpack(vals, pos, tile_rows, per_bin, level2)
    jv, ji = jmb.unpack_candidates(jnp.asarray(vals.numpy()), jnp.asarray(pos.numpy().astype(np.int32)),
                                   tile_rows, per_bin, level2=level2)
    assert np.array_equal(gi.numpy(), np.asarray(ji).astype(np.int64))
    assert np.array_equal(gv.view(torch.int32).numpy(), np.asarray(jv).view(np.int32))
