"""The Hopper probes' plain versions (``matchmaker_tpu_torch/probes``: K15
attention inner loop, K16 int8 product, K17/K18 row-packed fused MLP)
against the TPU probes' kernels in ``benchmarks/`` on the CPU: the same
numpy inputs go to both. The TPU probe modules are loaded from their files
(``benchmarks/`` is not a package) and their kernel bodies run inside
test-local ``pl.pallas_call(..., interpret=True)``; each probe's ``main()``
runs once with ``--device cpu`` at a tiny shape."""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.probes import attn_inner as tai
from matchmaker_tpu_torch.probes import int8_matmul as tim
from matchmaker_tpu_torch.probes import mlp_rows as tmr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpu_probe(name):
    """benchmarks/<name>.py as a module, the environment left as it was (the
    probes set JAX cache variables on import)."""
    saved = dict(os.environ)
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


jattn = _tpu_probe("attn_inner_probe")
jmlp = _tpu_probe("mlp_rows_probe")

HID = jattn.H * jattn.D  # the TPU probe's 12 heads x 64
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


# ---- K15: the attention inner loop ------------------------------------------

def _attn_inputs(seed, b=2, l=16):
    """q, k, v (B, L, 768) as the probe draws them (N(0, 0.3)) and a mask
    with padded keys in both examples."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 0.3, (b, l, HID)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), np.float32)
    mask[0, l - 5:] = 0.0
    mask[1, 3] = 0.0
    return q, k, v, mask


def _interpret_attn(kernel, q, k, v, mask, block_b):
    """The TPU probe's ``run`` grid (blocks of ``block_b`` examples) in
    interpret mode."""
    b, l, hid = q.shape
    blk3 = pl.BlockSpec((block_b, l, hid), lambda i: (i, 0, 0))
    return pl.pallas_call(
        kernel, grid=(b // block_b,),
        in_specs=[blk3, blk3, blk3, pl.BlockSpec((block_b, l), lambda i: (i, 0))],
        out_specs=blk3, out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype), interpret=True)(q, k, v, mask)


SCALE = 1.0 / jattn.D ** 0.5
# (TPU kernel, block_b): every formulation of the same function as k_batched
ATTN_KERNELS = {
    "k_batched": (functools.partial(jattn.k_batched, scale=SCALE), 2),
    "k_unrolled": (functools.partial(jattn.k_unrolled, scale=SCALE, block_b=1), 1),
    "k_blockdiag": (functools.partial(jattn.k_blockdiag, scale=SCALE, length=16), 2),
    "k_allheads": (functools.partial(jattn.k_allheads, scale=SCALE, block_b=2, length=16), 2),
}
# f32: the K13 test's bar (tests/test_torch_maxsim.py:161). bf16: both sides
# round p and the output to bf16 after f32 sums taken in another order, so
# an output may differ by one bf16 rounding: one ulp at |o| < 0.5 (the
# outputs here are below 0.3)
ATTN_ATOL = {"f32": 1e-5, "bf16": 2.0 ** -9}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", sorted(ATTN_KERNELS))
def test_attn_inner_batched_matches_every_tpu_formulation(kernel, dtype):
    """The port's plain ``batched`` against k_batched, k_unrolled,
    k_blockdiag and k_allheads (interpret mode), keys masked in both
    examples."""
    jd, td = DTYPES[dtype]
    q, k, v, mask = _attn_inputs(0)
    fn, block_b = ATTN_KERNELS[kernel]
    want = _interpret_attn(fn, *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask), block_b)
    got = tai.attn_inner(*(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(mask), "batched")
    assert got.dtype == td and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant,flags", [("f32_p", {"keep_f32_p": True}), ("softmax_stub", {"stub_softmax": True})])
def test_attn_inner_variants_match_k_batched(variant, flags, dtype):
    """``f32_p`` against k_batched(keep_f32_p=True) and the stub against
    k_batched(stub_softmax=True): the stub ignores the mask, as the TPU
    probe's does."""
    jd, td = DTYPES[dtype]
    q, k, v, mask = _attn_inputs(1)
    want = _interpret_attn(functools.partial(jattn.k_batched, scale=SCALE, **flags),
                           *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(mask), 2)
    got = tai.attn_inner(*(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(mask), variant)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL[dtype], rtol=0)


def test_attn_inner_variants_differ_where_they_should():
    """In bf16 the f32-P variant moves the output off the bf16-P one, the
    stub ignores the mask, and an unknown variant is refused."""
    q, k, v, mask = (torch.from_numpy(a) for a in _attn_inputs(2))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    assert not torch.equal(tai.attn_inner(*bf, mask, "f32_p"), tai.attn_inner(*bf, mask, "batched"))
    assert torch.equal(tai.attn_inner(q, k, v, mask, "softmax_stub"),
                       tai.attn_inner(q, k, v, torch.ones_like(mask), "softmax_stub"))
    with pytest.raises(ValueError, match="variant"):
        tai.attn_inner(q, k, v, mask, "allheads")


# ---- K16: the int8 product --------------------------------------------------

def _pk(x_ref, w_ref, o_ref):
    # the body of benchmarks/int8_matmul_probe.py:97 (pk), which the probe
    # defines inside main()
    o_ref[...] = jax.lax.dot_general(x_ref[...], w_ref[...], (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.int32)


@pytest.mark.parametrize("m,k,n,bm", [(64, 96, 40, 32), (512, 768, 64, 512)])
def test_int8_matmul_is_bit_identical_to_jax(m, k, n, bm):
    """The plain K16 (the weight codes K-major) against JAX's
    dot_general(int8, int8 -> int32) and against pk's body in a
    test-local Pallas call (the probe's grid of ``bm``-row blocks),
    interpret mode: every bit, the extreme codes included."""
    rng = np.random.default_rng(m + n)
    xq = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, size=(k, n), dtype=np.int8)
    xq[0], wq[:, 0] = 127, -127  # the largest sums
    got = tim.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq.T.copy()))
    assert got.dtype == torch.int32
    want = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    kernel = pl.pallas_call(_pk, grid=(m // bm,),
                            in_specs=[pl.BlockSpec((bm, k), lambda i: (i, 0)), pl.BlockSpec((k, n), lambda i: (0, 0))],
                            out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
                            out_shape=jax.ShapeDtypeStruct((m, n), jnp.int32), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(kernel(jnp.asarray(xq), jnp.asarray(wq))))
    assert int(got[0, 0]) == -127 * 127 * k


def test_int8_chain_matches_the_tpu_probes_chain():
    """The chain's per-row codes are bit-identical to the TPU probe's
    (``mm_int8_chain``: amax / 127, round half to even, clip) and its
    dequantized product within f32 rounding."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(48, 64)), jnp.bfloat16)
    wq = rng.integers(-127, 127, size=(64, 24), dtype=np.int8)
    wscale = rng.uniform(0.5, 2.0, size=(24,)).astype(np.float32)
    s = jnp.max(jnp.abs(x), axis=1, keepdims=True).astype(jnp.float32) / 127.0
    codes = jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(codes, jnp.asarray(wq), (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    want = acc.astype(jnp.float32) * (s * jnp.asarray(wscale)[None, :])
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got_codes, got_s = tim.quantize_rows(xt)
    assert np.array_equal(got_codes.numpy(), np.asarray(codes))
    assert np.array_equal(got_s.numpy(), np.asarray(s))
    got = tim.int8_chain(xt, torch.from_numpy(wq.T.copy()), torch.from_numpy(wscale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


# ---- K17/K18: the row-packed fused MLP --------------------------------------

def _mlp_inputs(seed, b=3, l=30, hid=64, ff=256):
    """x (B, L, hid) and the probe's weights in its own layout (w1 (hid, ff),
    w2 (ff, hid)), biases N(0, 0.02), a LayerNorm scale and shift off 1 / 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, l, hid)).astype(np.float32)
    w = (rng.normal(0, hid ** -0.5, (hid, ff)), rng.normal(0, 0.02, (ff,)), rng.normal(0, ff ** -0.5, (ff, hid)),
         rng.normal(0, 0.02, (hid,)), rng.normal(1, 0.1, (hid,)), rng.normal(0, 0.1, (hid,)))
    return x, [a.astype(np.float32) for a in w]


# f32: K2's bar (tests/test_torch_fused_attention.py:92). bf16: the gelu
# output and y are rounded to bf16 after f32 sums taken in another order
# (JAX adds the FF chunks one by one): one bf16 ulp at |y| < 4 (the outputs
# here are below 3.6)
MLP_ATOL = {"f32": 5e-4, "bf16": 2.0 ** -6}
WRAPPERS = {"mlp_rows2d": ({}, {"block_b": 8}), "mlp_rowsblk_1024": ({"block_r": 1024}, {"block_r": 1024}),
            "mlp_rowsblk_64": ({"block_r": 64}, {"block_r": 64})}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_mlp_rows_wrappers_match_jax(wrapper, dtype):
    """mlp_rows2d (K17: L 30 padded to 32, B 3 to 8) and mlp_rowsblk (K18:
    90 rows padded to 1024, or to 128 at block_r 64) against JAX's wrappers
    in interpret mode, hid 64 / ff 256."""
    jd, td = DTYPES[dtype]
    x, w = _mlp_inputs(5)
    jw = [jnp.asarray(w[0], jd), jnp.asarray(w[1]), jnp.asarray(w[2], jd)] + [jnp.asarray(a) for a in w[3:]]
    tw = [torch.from_numpy(w[0]).to(td), torch.from_numpy(w[1]), torch.from_numpy(w[2]).to(td)] + \
        [torch.from_numpy(a) for a in w[3:]]
    jax_kw, port_kw = WRAPPERS[wrapper]
    if wrapper == "mlp_rows2d":
        want = jmlp.mlp_rows2d(jnp.asarray(x, jd), *jw, **jax_kw)
        got = tmr.mlp_rows2d(torch.from_numpy(x).to(td), *tw, **port_kw)
    else:
        want = jmlp.mlp_rowsblk(jnp.asarray(x, jd), *jw, **jax_kw)
        got = tmr.mlp_rowsblk(torch.from_numpy(x).to(td), *tw, **port_kw)
    assert got.shape == x.shape and got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), atol=MLP_ATOL[dtype], rtol=0)


def test_mlp_rows_padding_leaves_live_rows_alone():
    """Both wrappers give the plain version's rows: the padded rows they add
    are sliced away and change nothing."""
    x, w = _mlp_inputs(6, b=5, l=13)
    xt, tw = torch.from_numpy(x), [torch.from_numpy(a) for a in w]
    want = tmr.reference_mlp_rows(xt, *tw)
    torch.testing.assert_close(tmr.mlp_rows2d(xt, *tw, block_b=4), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tmr.mlp_rowsblk(xt, *tw, block_r=48), want, rtol=1e-6, atol=1e-6)


# ---- main() of each probe, on the CPU ---------------------------------------

PROBE_MAINS = {
    "attn_inner": (["--rows", "2", "--len", "9", "--heads", "2"],
                   {"batched(current)", "batched_SOFTMAX_STUB", "batched_f32_p", "fused_mha(K13)", "sdpa"}),
    "int8_matmul": (["--m", "40", "--k", "64", "--n", "24"],
                    {"bf16_tflops", "int8_tops", "int8_chain_efftops", "kernel_int8_tops", "int8_vs_bf16",
                     "chain_vs_bf16"}),
    "mlp_rows": (["--batch", "2", "--hid", "32", "--ff", "64"], {"shapes"}),
}


@pytest.mark.parametrize("name", sorted(PROBE_MAINS))
def test_probe_main_on_the_cpu_prints_its_json_line(name, capsys):
    """``main(["--device", "cpu", ...])`` runs the plain versions, launches
    nothing, and prints one JSON line with the TPU probe's keys and the
    device; no device rate comes from a CPU run."""
    argv, keys = PROBE_MAINS[name]
    probe = {"attn_inner": tai, "int8_matmul": tim, "mlp_rows": tmr}[name]
    _build.reset_launches()
    result = probe.main(argv + ["--device", "cpu", "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and keys <= set(line) and line["device"] == "cpu"
    assert not any(_build.LAUNCHES.values())
    if name == "attn_inner":
        assert all(line[k]["ms"] > 0 and line[k]["tflops"] is None for k in keys)
    elif name == "int8_matmul":
        assert line["exact"] and line["kernel_int8_tops"] is None and line["ms"]["kernel"] > 0
    else:
        assert [s["shape"] for s in line["shapes"]] == [[4, 200, 32], [2, 32, 32]]
        for s in line["shapes"]:
            assert set(s["rows2d"]) == {"r16", "r32", "r64"} and set(s) >= {"prod_3d", "rowsblk_1024",
                                                                             "rowsblk_2048", "chain"}
            assert s["rows2d"]["r64"]["max_abs_vs_prod_3d"] == 0.0


def test_probe_refuses_a_missing_card():
    """Without a card the default device is refused: no silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tim.main(["--m", "40", "--k", "64", "--n", "24"])
