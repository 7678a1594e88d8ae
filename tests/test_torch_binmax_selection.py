"""The binmax scans' register selection (K3, K7, K8 in
matchmaker_tpu_torch/csrc/binmax_kernels.cu, ``scan_kernel``), emulated in
torch on the CPU and held to the plain selection (``_select_plain``) bit
for bit, and for one case to JAX's ``_topk_per_bin_t``; and K8's mode
(``SCAN_MIXED``): its conversion of the int8 codes to bf16 by their bits
and its score order (the f32 sum of bf16 products, times the bin scale,
rounded once) through the same selection, against ``_scan_int8f_plain`` and
JAX's interpreted Pallas K8.

The kernel's lane-to-column map: in the wgmma m64n128 accumulator layout,
lane t = lane % 4 of a quad holds, for each of its query rows, the bin
columns {8j + 2t, 8j + 2t + 1}, j = 0..15 (``_lane_columns``). Each lane
keeps the top P of its 32 columns in ascending column order with a strict
'>' (``_insert_sorted``), then two xor rounds over the quad (lane ^ 1, then
lane ^ 2) merge the sorted lists: the better of each pair (r, P-1-r), then a
bitonic sort (``_merge_lanes``), value descending and column ascending on
equal values. A change to the kernel's map or selection has to change this
emulation, or the kernel's card tests fail where this one passes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matchmaker_tpu.ops import mips_binmax as jmb
from matchmaker_tpu.ops import mips_quant as jmq
from matchmaker_tpu_torch.ops import matmul_f32
from matchmaker_tpu_torch.ops import mips_binmax as tmb

BIN = 128
NEG_INF = float("-inf")


def _lane_columns(t):
    """Bin columns lane t of a quad holds, in the order it selects them."""
    return [8 * j + 2 * t + e for j in range(16) for e in range(2)]


def _insert_sorted(tv, ti, v, idx):
    """The kernel's branch-free insert: slot j takes slot j - 1 if v passes
    it, else v if v passes slot j, else keeps its own; j downwards."""
    p = tv.shape[-1]
    for j in range(p - 1, 0, -1):
        above, here = v > tv[..., j - 1], v > tv[..., j]
        tv[..., j] = torch.where(above, tv[..., j - 1], torch.where(here, v, tv[..., j]))
        ti[..., j] = torch.where(above, ti[..., j - 1], torch.where(here, torch.full_like(ti[..., j], idx),
                                                                    ti[..., j]))
    first = v > tv[..., 0]
    tv[..., 0] = torch.where(first, v, tv[..., 0])
    ti[..., 0] = torch.where(first, torch.full_like(ti[..., 0], idx), ti[..., 0])


def _before(a, ai, b, bi):
    return (a > b) | ((a == b) & (ai < bi))


def _merge_lanes(mine, theirs):
    """One xor round: the top P of two sorted lists, sorted."""
    tv, ti = mine[0].clone(), mine[1].clone()
    ov, oi = theirs
    p = tv.shape[-1]
    for r in range(p):
        keep = _before(tv[..., r], ti[..., r], ov[..., p - 1 - r], oi[..., p - 1 - r])
        tv[..., r] = torch.where(keep, tv[..., r], ov[..., p - 1 - r])
        ti[..., r] = torch.where(keep, ti[..., r], oi[..., p - 1 - r])
    h = p // 2
    while h > 0:
        for r in range(p):
            if r & h == 0:
                swap = _before(tv[..., r + h], ti[..., r + h], tv[..., r], ti[..., r])
                a, b = tv[..., r].clone(), tv[..., r + h].clone()
                tv[..., r], tv[..., r + h] = torch.where(swap, b, a), torch.where(swap, a, b)
                a, b = ti[..., r].clone(), ti[..., r + h].clone()
                ti[..., r], ti[..., r + h] = torch.where(swap, b, a), torch.where(swap, a, b)
        h //= 2
    return tv, ti


def _exact(s, per_bin):
    """Masked scores (Q, bins, 128) → each row's top P (values, columns)."""
    q, bins, _ = s.shape
    lanes = []
    for t in range(4):
        tv = torch.full((q, bins, per_bin), NEG_INF)
        ti = torch.zeros((q, bins, per_bin), dtype=torch.int32)
        for c in _lane_columns(t):
            _insert_sorted(tv, ti, s[:, :, c], c)
        lanes.append((tv, ti))
    for m in (1, 2):
        lanes = [_merge_lanes(lanes[t], lanes[t ^ m]) for t in range(4)]
    for t in range(1, 4):  # every lane of the quad ends with the same list
        assert torch.equal(lanes[t][0].view(torch.int32), lanes[0][0].view(torch.int32))
        assert torch.equal(lanes[t][1], lanes[0][1])
    return lanes[0]


def emulate_register_selection(scores, n_valid, per_bin, tile_rows):
    """(Q, N) f32 scores → (Q, N/128·per_bin) packed candidates, as the
    kernel's quads select them (column = tile·(per_bin·nb) + rank·nb + bin)."""
    q, n = scores.shape
    cols = torch.arange(n)
    s = torch.where(cols < n_valid, scores, NEG_INF).reshape(q, n // BIN, BIN)
    tv, ti = _exact(s, per_bin)
    packed = tmb._pack_lane(tv, ti)  # (Q, bins, P)
    nb = tile_rows // BIN
    return packed.reshape(q, n // tile_rows, nb, per_bin).transpose(2, 3).reshape(q, -1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _scores(kind, rng, q, n):
    if kind == "random":
        return torch.from_numpy(rng.normal(size=(q, n)).astype(np.float32))
    if kind == "ties":  # integers in [-3, 3]: most of a bin's values tie
        return torch.from_numpy(rng.integers(-3, 4, size=(q, n)).astype(np.float32))
    if kind == "signed_zeros":  # +0.0 and -0.0 compare equal: ties to the lowest offset
        return torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), size=(q, n)))
    raise ValueError(kind)


@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("kind,n_valid", [("random", 2048), ("random", 1984 + 37), ("ties", 2048),
                                          ("ties", 1920), ("signed_zeros", 2048)])
def test_register_selection_matches_plain(per_bin, kind, n_valid):
    """Random scores, integer scores with many exact ties, signed zeros,
    n_valid mid-bin and at a bin's first row (1920): bit-identical to the
    plain selection."""
    rng = np.random.default_rng(per_bin * 31 + n_valid)
    scores = _scores(kind, rng, 9, 2048)
    got = emulate_register_selection(scores, n_valid, per_bin, 1024)
    want = tmb._select_plain(scores, n_valid, per_bin, 1024)
    assert got.shape == want.shape == (9, 2048 // BIN * per_bin)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
def test_register_selection_of_all_masked_bins_is_minus_inf(per_bin):
    """Bins wholly at or past n_valid, and bins whose scores are all -inf,
    select -inf in every rank, as the plain version does."""
    rng = np.random.default_rng(per_bin)
    scores = _scores("random", rng, 5, 1024)
    scores[:, 256:384] = NEG_INF  # a live bin of -inf scores
    got = emulate_register_selection(scores, 640, per_bin, 512)
    want = tmb._select_plain(scores, 640, per_bin, 512)
    assert torch.equal(_bits(got), _bits(want))
    ranks = got.reshape(5, 2, per_bin, 4)  # (Q, tiles, rank, bin)
    assert torch.isneginf(ranks[:, 0, :, 2]).all()  # bin 2: -inf scores
    assert torch.isneginf(ranks[:, 1, :, 1:]).all()  # bins 5..7: rows >= 640
    assert torch.isfinite(ranks[:, 1, :, 0]).all()  # bin 4 (rows 512..639) is live


@pytest.mark.parametrize("per_bin", [2, 8])
def test_register_selection_matches_jax_topk_per_bin_t(per_bin):
    """The emulation against JAX's reference selection (first argmax,
    ``use_argmax=True``) on the same numpy scores, with ties and n_valid
    mid-bin."""
    rng = np.random.default_rng(77 + per_bin)
    scores = (rng.integers(-6, 7, size=(7, 1024)) / 4.0).astype(np.float32)
    n_valid = 1024 - 77
    want = np.asarray(jmb._topk_per_bin_t(jnp.asarray(scores.T), 0, n_valid, per_bin, use_argmax=True)).T
    got = emulate_register_selection(torch.from_numpy(scores), n_valid, per_bin, 1024)
    assert np.array_equal(_bits(got).numpy(), np.ascontiguousarray(want).view(np.int32))


def test_lane_columns_cover_each_bin_once():
    cols = sorted(c for t in range(4) for c in _lane_columns(t))
    assert cols == list(range(BIN))
    for t in range(4):
        assert _lane_columns(t) == sorted(_lane_columns(t))  # ascending offsets: '>' keeps the lowest


def code_to_bf16_bits(codes: np.ndarray) -> np.ndarray:
    """K8's conversion (binmax_kernels.cu ``code_bits`` / ``codes_to_bf16``):
    the code's byte with its sign bit flipped under 0x4B000000 is the f32
    2^23 + 128 + x; less 2^23 + 128 it is x, and the bf16 is that f32's high
    half."""
    flipped = (codes.astype(np.int8).view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    value = (np.uint32(0x4B000000) | flipped).view(np.float32) - np.float32(8388736.0)
    return (value.astype(np.float32).view(np.uint32) >> np.uint32(16)).astype(np.uint16)


def test_mixed_code_conversion_is_exact_for_every_code():
    """Every int8 value becomes the bf16 torch makes of it, the low half of
    the f32 being zero (|x| <= 127 needs 7 mantissa bits)."""
    codes = np.arange(-128, 128, dtype=np.int8)
    flipped = (codes.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    value = (np.uint32(0x4B000000) | flipped).view(np.float32) - np.float32(8388736.0)
    assert (value.view(np.uint32) & np.uint32(0xFFFF) == 0).all()
    want = torch.from_numpy(codes).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(code_to_bf16_bits(codes), want)


def emulate_mixed_scan(queries, codes, bin_scales, n_valid, per_bin, tile_rows):
    """K8 as the kernel computes it: codes to bf16 by their bits, the f32
    sum of bf16 products, times the bin scale (one f32 rounding), then the
    register selection."""
    c16 = torch.from_numpy(code_to_bf16_bits(codes.numpy()).view(np.int16)).view(torch.bfloat16)
    raw = matmul_f32(queries, c16.T)
    scores = raw * bin_scales.reshape(-1).float().repeat_interleave(BIN)[None, :]
    return emulate_register_selection(scores, n_valid, per_bin, tile_rows)


@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["integer", "random"])
def test_mixed_scan_emulation_matches_plain_and_jax(per_bin, kind):
    """K8's mode against ``_scan_int8f_plain`` bit for bit, n_valid mid-bin;
    with integer-valued bf16 queries (exact sums, many exact ties) also bit
    for bit against JAX's interpreted Pallas K8 (``_binmax_kernel_int8f``)."""
    rng = np.random.default_rng(per_bin + (100 if kind == "integer" else 0))
    codes, scales = jmq.quantize_corpus_binwise(rng.normal(size=(2048, 64)).astype(np.float32))
    if kind == "integer":
        q = rng.integers(-3, 4, size=(7, 64)).astype(np.float32)
    else:
        q = rng.normal(size=(7, 64)).astype(np.float32)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    n_valid = 2048 - 77
    got = emulate_mixed_scan(qb, torch.from_numpy(codes), torch.from_numpy(scales), n_valid, per_bin, 1024)
    want = tmb._scan_int8f_plain(qb, torch.from_numpy(codes), torch.from_numpy(scales), n_valid, per_bin, 1024)
    assert got.shape == want.shape == (7, 2048 // BIN * per_bin)
    assert torch.equal(_bits(got), _bits(want))
    if kind == "integer":
        jax_k8 = np.asarray(jmb.binmax_candidates(jnp.asarray(qb.float().numpy(), dtype=jnp.bfloat16),
                                                  jnp.asarray(codes), n_valid=n_valid, per_bin=per_bin,
                                                  tile_rows=1024, corpus_scales=jnp.asarray(scales),
                                                  interpret=True))
        # JAX pads the corpus to its candidate grain: whole tiles of -inf past ours
        assert np.isneginf(jax_k8[:, got.shape[1]:]).all()
        assert np.array_equal(_bits(got).numpy(), np.ascontiguousarray(jax_k8[:, :got.shape[1]]).view(np.int32))
