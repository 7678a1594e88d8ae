"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, at the encoder's DistilBERT width and binmax shapes of the main
path (cut in batch and corpus rows to keep each test short), the backward
kernels of the fused halves at training shapes, and the autograd graph
through them.

Run on a machine with an NVIDIA GPU: ``python -m pytest -m cuda tests/``.
Without a card every ``cuda`` test skips (the decision is made inside the
``device`` fixture, never at import). The import-hygiene test runs anywhere.
"""

import os
import subprocess
import sys

import pytest
import torch

from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM
from matchmaker_tpu_torch.models.weights import init_parameters
from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as fa
from matchmaker_tpu_torch.ops import fused_backward as fb
from matchmaker_tpu_torch.ops import fused_int8 as fi
from matchmaker_tpu_torch.ops import maxsim as ms
from matchmaker_tpu_torch.ops import mips_binmax as mb
from matchmaker_tpu_torch.ops import mips_quant as mq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _rows_close(a, b):
    """(min per-row cosine, max |a - b|) in f32."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    return float(cos.min()), float((a - b).abs().max())


def _layer_weights(hid, ff, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def w(*shape, std):
        return (torch.randn(*shape, generator=g, device=device) * std).to(bf)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = dict(wq=w(hid, hid, std=hid ** -0.5), wk=w(hid, hid, std=hid ** -0.5),
                wv=w(hid, hid, std=hid ** -0.5), wo=w(hid, hid, std=hid ** -0.5),
                bq=v(hid, 0.05), bk=v(hid, 0.05), bv=v(hid, 0.05), bo=v(hid, 0.05),
                ln_scale=v(hid, 0.1, 1.0), ln_bias=v(hid, 0.1))
    mlp = dict(w1=w(hid, ff, std=hid ** -0.5), b1=v(ff, 0.05), w2=w(ff, hid, std=ff ** -0.5),
               b2=v(hid, 0.05), ln_scale=v(hid, 0.1, 1.0), ln_bias=v(hid, 0.1))
    return attn, mlp


SHAPES = [(4, 128), (3, 200), (5, 30), (2, 1), (1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", SHAPES)
def test_attention_block_kernel_matches_plain(device, b, l):
    hid, heads = 768, 12
    attn, _ = _layer_weights(hid, 3072, device, seed=b * 1000 + l)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0  # a padded example
    args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"],
            attn["bo"], mask, heads, attn["ln_scale"], attn["ln_bias"])
    got = fa.fused_attention_block(x, *args)
    want = fa.reference_attention_block(x, *args)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", SHAPES[:2])
def test_attention_block_qkv_kernel_matches_plain(device, b, l):
    """The packed entry the encoder calls."""
    hid, heads = 768, 12
    attn, _ = _layer_weights(hid, 3072, device, seed=b * 1000 + l + 2)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[-1, l // 3 + 1:] = 0.0
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    rest = (mask, heads, attn["ln_scale"], attn["ln_bias"])
    _build.reset_launches()
    got = fa.fused_attention_block_qkv(x, wqkv, bqkv, attn["wo"], attn["bo"], *rest)
    assert _build.LAUNCHES["fused_attention_block"] == 1
    want = fa.reference_attention_block(x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"],
                                        attn["bk"], attn["bv"], attn["bo"], *rest)
    torch.cuda.synchronize()
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", SHAPES[:3])
def test_mlp_block_kernel_matches_plain(device, b, l):
    hid, ff = 768, 3072
    _, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + 1)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    got = fa.fused_mlp_block(x, *args)
    want = fa.reference_mlp_block(x, *args)
    torch.cuda.synchronize()
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
def test_encoder_kernels_reject_f32(device):
    hid = 768
    attn, _ = _layer_weights(hid, 3072, device, seed=7)
    x = torch.randn(2, 8, hid, device=device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.fused_attention_block(x, attn["wq"].float(), attn["wk"].float(), attn["wv"].float(),
                                 attn["wo"].float(), attn["bq"], attn["bk"], attn["bv"], attn["bo"],
                                 torch.ones(2, 8, device=device), 12, attn["ln_scale"], attn["ln_bias"])


def _ragged_mask(b, l, device):
    """A ragged example, an example without a live key, full ones."""
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    mask[1] = 0.0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("l", [30, 77, 200, 512])
def test_bf16_halves_and_mha_match_plain_with_ragged_masks(device, l):
    """K1 (packed Q/K/V, as the encoder calls it), K2 and K13 at B = 3 (M =
    B*L rows not a multiple of the 128-row tile for L = 30, 77, 200) with a
    ragged and an all-masked example, each launching once, held to the
    encoder halves' bar (row cosine >= 0.999, max |d| <= 0.1)."""
    hid, heads, b = 768, 12, 3
    attn, mlp = _layer_weights(hid, 3072, device, seed=40 + l)
    g = torch.Generator(device=device).manual_seed(l)
    x = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    mask = _ragged_mask(b, l, device)
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    ln1 = (attn["ln_scale"], attn["ln_bias"])
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mlp_args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    _build.reset_launches()
    got = {"fused_attention_block": fa.fused_attention_block_qkv(x, wqkv, bqkv, attn["wo"], attn["bo"], mask, heads,
                                                                 *ln1),
           "fused_mlp_block": fa.fused_mlp_block(x, *mlp_args),
           "fused_mha": fa.fused_mha(q, k, v, mask, heads)}
    want = {"fused_attention_block": fa.reference_attention_block(
                x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], attn["bo"],
                mask, heads, *ln1),
            "fused_mlp_block": fa.reference_mlp_block(x, *mlp_args),
            "fused_mha": fa.mha_reference(q, k, v, mask, heads)}
    torch.cuda.synchronize()
    for name in got:
        assert _build.LAUNCHES[name] == 1, name
        assert got[name].shape == (b, l, hid) and got[name].dtype == torch.bfloat16, name
        assert bool(torch.isfinite(got[name].float()).all()), name
        cos, err = _rows_close(got[name], want[name])
        assert cos >= 0.999 and err <= 0.1, (name, cos, err)
    # the all-masked example attends uniformly over its L keys
    mean_v = v[1].float().mean(dim=0).expand(l, hid)
    cos, err = _rows_close(got["fused_mha"][1], mean_v)
    assert cos >= 0.999 and err <= 0.02, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4096, 90, 1])
@pytest.mark.parametrize("form", ["qkv", "w1", "wo", "w2"])
def test_forward_gemm_epilogues_match_matmul(device, m, form):
    """Each forward product of the Hopper GEMM with its epilogue (bias; bias
    + gelu poly; bias + bf16 residual, f32 out) against an f32 torch.matmul
    of the same bf16 inputs, the weight read (K, N) where it lies."""
    hid, ff = 768, 3072
    k, n = {"qkv": (hid, 3 * hid), "w1": (hid, ff), "wo": (hid, hid), "w2": (ff, hid)}[form]
    g = torch.Generator(device=device).manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=device) * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=g, device=device) * 0.05
    want = torch.matmul(a.float(), w.float()) + bias
    if form in ("qkv", "w1"):
        out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
        if form == "w1":
            fa._gemm(a, w, bias, out, fa._EPI_BIAS_GELU_BF16)
            want = fa._gelu_poly(want)
        else:
            fa._gemm(a, w, bias, out, fa._EPI_BIAS_BF16)
        _close_to_matmul(out, want, 8e-3)
    else:
        resid = torch.randn(m, n, generator=g, device=device).to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.float32, device=device)
        fa._gemm(a, w, bias, out, fa._EPI_BIAS_RESID_F32, resid=resid)
        _close_to_matmul(out, want + resid.float(), 1e-4)


@pytest.mark.cuda
def test_bf16_halves_and_mha_are_bit_identical_run_to_run(device):
    """Two calls of K1, K2 and K13 on the same inputs give the same bits."""
    hid, heads, b, l = 768, 12, 8, 200
    attn, mlp = _layer_weights(hid, 3072, device, seed=32)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = _ragged_mask(b, l, device)
    a_args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], attn["bo"], mask,
              heads, attn["ln_scale"], attn["ln_bias"])
    m_args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    q, k, v = (torch.randn(b, l, hid, device=device).to(torch.bfloat16) for _ in range(3))
    first, second = ((fa.fused_attention_block(x, *a_args), fa.fused_mlp_block(x, *m_args),
                      fa.fused_mha(q, k, v, mask, heads)) for _ in range(2))
    for one, two in zip(first, second):
        assert torch.equal(one, two)


def _plain_attention_saved(x, wqkv, bqkv, mask, heads):
    """The plain versions' qkv (bf16, after the bias) and attention output
    (f32 p into P.V, cast to bf16) of an attention half."""
    b, l, hid = x.shape
    d = hid // heads
    qkv = (torch.matmul(x.reshape(b * l, hid).float(), wqkv.float()) + bqkv).to(torch.bfloat16).reshape(b, l, -1)
    q, k, v = (t.float().reshape(b, l, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5 + ((mask - 1.0) * 1e9)[:, None, None, :]
    attn = torch.matmul(torch.softmax(s, dim=-1), v).to(torch.bfloat16).transpose(1, 2).reshape(b, l, hid)
    return qkv, attn


@pytest.mark.cuda
def test_training_forward_saves_what_the_plain_versions_compute(device):
    """The training forward's saved tensors, which the backward kernels read
    instead of recomputing: the attention half's (acc, qkv, attn) and the MLP
    half's (acc, h) against the plain versions."""
    hid, heads, b, l = 768, 12, 3, 77
    attn, mlp = _layer_weights(hid, 3072, device, seed=33)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = _ragged_mask(b, l, device)
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    out, (acc, qkv, a) = fb.attention_block_fwd(x, wqkv, bqkv, attn["wo"], attn["bo"], mask, heads,
                                                attn["ln_scale"], attn["ln_bias"])
    want_out, want_acc = fa.reference_attention_block(
        x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], attn["bo"], mask,
        heads, attn["ln_scale"], attn["ln_bias"], save_acc=True)
    want_qkv, want_a = _plain_attention_saved(x, wqkv, bqkv, mask, heads)
    torch.cuda.synchronize()
    assert acc.dtype == torch.float32 and qkv.dtype == a.dtype == torch.bfloat16
    for got, want, rel in ((acc, want_acc, 1e-3), (qkv, want_qkv, 8e-3), (a, want_a, 2e-2), (out, want_out, 2e-2)):
        _close_to_matmul(got, want, rel)
    out, (acc, h) = fb.mlp_block_fwd(x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    want_out, want_acc = fa.reference_mlp_block(x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"],
                                                mlp["ln_bias"], save_acc=True)
    want_h = fa._gelu_poly(torch.matmul(x.reshape(b * l, hid).float(), mlp["w1"].float()) + mlp["b1"])
    torch.cuda.synchronize()
    assert acc.dtype == torch.float32 and h.dtype == torch.bfloat16
    for got, want, rel in ((acc, want_acc, 1e-3), (h, want_h, 8e-3), (out, want_out, 2e-2)):
        _close_to_matmul(got, want, rel)


def grads_close(got, want, scale_of=None):
    """Per-tensor check of a backward kernel's gradients against the plain
    version's: cosine >= 0.999 and max |d| <= 2e-2 * max |plain| (f32 sums
    over up to 51,200 rows in another order, bf16 rounding of dz/dq/dk/dv at
    the same points). A gradient that is zero in exact arithmetic (the key
    bias: each softmax row's gradient sums to zero) holds only rounding
    noise; ``scale_of`` names the gradient whose size bounds it instead.
    Returns {name: (cosine, max |d|)}."""
    out = {}
    for name, g in got.items():
        a, b = g.float().reshape(-1), want[name].float().reshape(-1)
        err = float((a - b).abs().max())
        if scale_of and name in scale_of:
            ref = float(want[scale_of[name]].float().abs().max())
            assert err <= 2e-2 * ref, (name, err, ref)
            out[name] = (float("nan"), err)
            continue
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        assert cos >= 0.999 and err <= 2e-2 * float(b.abs().max()), (name, cos, err, float(b.abs().max()))
        out[name] = (cos, err)
    return out


def attention_bwd_pair(x, attn, mask, heads, dy):
    """K12 (after the K1 training forward) and the plain backward (after the
    plain forward) on the same inputs: two dicts of named gradients, the
    Q/K/V parts of the packed kernel gradients split out."""
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    g, be = attn["ln_scale"], attn["ln_bias"]
    _, saved = fb.attention_block_fwd(x, wqkv, bqkv, attn["wo"], attn["bo"], mask, heads, g, be)
    dx, dwqkv, dbqkv, dwo, dbo, dg, dbe = fb.attention_block_bwd(x, wqkv, bqkv, attn["wo"], mask, heads, g, dy,
                                                                  saved)
    got = dict(dx=dx, dwo=dwo, dbo=dbo, dg=dg, dbe=dbe)
    for i, n in enumerate("qkv"):
        got[f"dw{n}"] = dwqkv.chunk(3, dim=1)[i]
        got[f"db{n}"] = dbqkv.chunk(3)[i]
    _, acc = fa.reference_attention_block(x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"],
                                          attn["bv"], attn["bo"], mask, heads, g, be, save_acc=True)
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dbq", "dbk", "dbv", "dbo", "dg", "dbe")
    want = dict(zip(names, fb.reference_attention_block_bwd(
        x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], mask, heads, g, dy,
        acc)))
    return got, want


def mlp_bwd_pair(x, mlp, dy):
    """K11 (after the K2 training forward) and the plain backward."""
    args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    names = ("dx", "dw1", "db1", "dw2", "db2", "dg", "dbe")
    _, saved = fb.mlp_block_fwd(x, *args)
    got = dict(zip(names, fb.mlp_block_bwd(x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["ln_scale"], dy, saved)))
    _, acc = fa.reference_mlp_block(x, *args, save_acc=True)
    want = dict(zip(names, fb.reference_mlp_block_bwd(x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["ln_scale"], dy, acc)))
    return got, want


BWD_SHAPES = [(4, 128), (3, 200), (5, 30), (2, 1), (1, 512), (3, 77)]


def zero_attention_grads(l):
    """The attention gradients that are zero in exact arithmetic, each with
    the gradient whose size bounds its rounding noise: the key bias always;
    with one key (L = 1) the softmax is constant, so all of dq and dk."""
    if l == 1:
        return {"dwq": "dwv", "dwk": "dwv", "dbq": "dbv", "dbk": "dbv"}
    return {"dbk": "dbq"}


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", BWD_SHAPES)
def test_attention_block_bwd_kernel_matches_plain(device, b, l):
    hid, heads = 768, 12
    attn, _ = _layer_weights(hid, 3072, device, seed=b * 1000 + l + 3)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    got, want = attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    assert got["dx"].dtype == torch.bfloat16 and got["dx"].shape == x.shape
    grads_close(got, want, scale_of=zero_attention_grads(l))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", BWD_SHAPES[:3] + BWD_SHAPES[-1:])
def test_mlp_block_bwd_kernel_matches_plain(device, b, l):
    hid, ff = 768, 3072
    _, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + 4)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    got, want = mlp_bwd_pair(x, mlp, dy)
    torch.cuda.synchronize()
    grads_close(got, want)


@pytest.mark.cuda
def test_fused_halves_keep_the_autograd_graph_and_count_backward_launches(device):
    """On a CUDA tensor that requires grad, each training half's output has a
    grad_fn and its backward launches K12 / K11 once; CPU tensors launch nothing."""
    hid = 768
    attn, mlp = _layer_weights(hid, 3072, device, seed=21)
    ws = {k: v.clone().requires_grad_() for k, v in {**attn, **mlp}.items()}
    mask = torch.ones(2, 40, device=device)
    for dev in (device, torch.device("cpu")):
        x = torch.randn(2, 40, hid, device=dev).to(torch.bfloat16).requires_grad_()
        w = {k: v.detach().to(dev).requires_grad_() for k, v in ws.items()}
        _build.reset_launches()
        h = fb.fused_attention_block_train(x, w["wq"], w["wk"], w["wv"], w["wo"], w["bq"], w["bk"], w["bv"], w["bo"],
                                           mask.to(dev), 12, w["ln_scale"], w["ln_bias"])
        out = fb.fused_mlp_block_train(h, w["w1"], w["b1"], w["w2"], w["b2"], w["ln_scale"], w["ln_bias"])
        assert h.grad_fn is not None and out.grad_fn is not None
        out.float().square().sum().backward()
        n = 1 if dev.type == "cuda" else 0
        assert _build.LAUNCHES["fused_attention_block_bwd"] == n and _build.LAUNCHES["fused_mlp_block_bwd"] == n
        assert x.grad is not None and all(v.grad is not None for v in w.values())


@pytest.mark.cuda
def test_fused_encoder_backward_fills_every_grad(device):
    """A fused DistilBERT-width encoder (depth cut to 2) trained on the card:
    every parameter gets a finite gradient through K1/K2/K11/K12."""
    cfg = EncoderConfig.distilbert(fused_attention=True, num_layers=2)
    model = TransformerEncoderLM(cfg, torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(device)
    ids = torch.randint(104, cfg.vocab_size, (4, 64), device=device)
    mask = torch.ones(4, 64, device=device)
    mask[1, 40:] = 0
    _build.reset_launches()
    loss = model(ids, mask)[:, 0].square().sum()
    loss.backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_attention_block_bwd"] == 2 and _build.LAUNCHES["fused_mlp_block_bwd"] == 2
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name


def _close_to_matmul(got, want, rel):
    """got (the kernel's output) against want, an f32 torch.matmul of the same
    bf16 inputs: cosine >= 0.99999 and max |d| <= rel * max |want| (rel 8e-3
    for a bf16 output, one rounding; 1e-4 for f32 sums in another order)."""
    a, b = got.float().reshape(-1), want.float().reshape(-1)
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    err = float((a - b).abs().max())
    assert cos >= 0.99999 and err <= rel * float(b.abs().max()), (cos, err, float(b.abs().max()))


GEMM_ROWS = [960, 1232, 12800]  # queries (32, 30), (16, 77), docs (64, 200)


@pytest.mark.cuda
@pytest.mark.parametrize("m", GEMM_ROWS)
@pytest.mark.parametrize("form", ["da", "dx_attention", "dx_mlp", "dz"])
def test_wgmma_gemm_products_match_matmul(device, m, form):
    """Each backward product of the Hopper GEMM with its epilogue, against an
    f32 torch.matmul of the same bf16 inputs (DistilBERT widths)."""
    g = torch.Generator(device=device).manual_seed(m + len(form))
    hid, ff = 768, 3072

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=device) * std).to(torch.bfloat16)

    if form == "dz":
        x, dacc = rand(m, hid), rand(m, hid)
        w1, w2 = rand(hid, ff, std=hid ** -0.5), rand(ff, hid, std=ff ** -0.5)
        b1 = torch.randn(ff, generator=g, device=device) * 0.05
        got = fb._gelu_dz(x, w1, b1, dacc, w2)
        want = torch.matmul(dacc.float(), w2.float().t()) * fb._gelu_grad_poly(torch.matmul(x.float(), w1.float()) + b1)
        _close_to_matmul(got, want, 8e-3)
        return
    k = {"da": hid, "dx_attention": 3 * hid, "dx_mlp": ff}[form]
    a, w = rand(m, k), rand(hid, k, std=k ** -0.5)
    want = torch.matmul(a.float(), w.float().t())
    out = torch.empty((m, hid), dtype=torch.bfloat16, device=device)
    if form == "da":
        fb._bwd_gemm(a, w, out, fb._EPI_BF16)
    else:
        aux = torch.randn(m, hid, generator=g, device=device)
        fb._bwd_gemm(a, w, out, fb._EPI_RESID_BF16, aux=aux)
        want = want + aux
    _close_to_matmul(out, want, 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m", GEMM_ROWS)
@pytest.mark.parametrize("i,j", [(768, 768), (768, 2304), (768, 3072), (3072, 768)])
def test_wgmma_weight_gradients_match_matmul(device, m, i, j):
    """The weight-gradient form aᵀ·b (both operands read MN-major, split along
    the rows by wgrad_plan) against an f32 torch.matmul."""
    g = torch.Generator(device=device).manual_seed(m + i + j)
    a = torch.randn(m, i, generator=g, device=device).to(torch.bfloat16)
    b = torch.randn(m, j, generator=g, device=device).to(torch.bfloat16)
    got = fb._wgrad(a, b)
    assert got.dtype == torch.float32 and got.shape == (i, j)
    _close_to_matmul(got, torch.matmul(a.float().t(), b.float()), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 30, 77, 200, 512])
def test_attention_core_bwd_matches_plain(device, l):
    """The tensor-core attention-core backward alone against its plain
    version: padded keys in one example, a single live key in another."""
    b, heads, hid = 3, 12, 768
    g = torch.Generator(device=device).manual_seed(l)
    qkv = torch.randn(b, l, 3 * hid, generator=g, device=device).to(torch.bfloat16)
    da = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    mask[1, 1:] = 0.0
    got = fb.attention_core_bwd(qkv, mask, da, heads)
    want = fb.attention_core_bwd(qkv.cpu(), mask.cpu(), da.cpu(), heads)
    torch.cuda.synchronize()
    got = dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1)))
    want = dict(zip(("dq", "dk", "dv"), want.to(device).chunk(3, dim=-1)))
    grads_close(got, want, scale_of={"dq": "dv", "dk": "dv"} if l == 1 else None)


@pytest.mark.cuda
def test_backward_halves_are_bit_identical_run_to_run(device):
    """Two backward calls of each half on the same inputs give the same bits:
    every sum runs in a fixed order, no float atomics."""
    hid, heads, b, l = 768, 12, 8, 200
    attn, mlp = _layer_weights(hid, 3072, device, seed=31)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, 50:] = 0.0
    first, second = ((attention_bwd_pair(x, attn, mask, heads, dy)[0], mlp_bwd_pair(x, mlp, dy)[0])
                     for _ in range(2))
    for one, two in zip(first, second):
        for name in one:
            assert torch.equal(one[name], two[name]), name


def _corpus(n, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(n, d, generator=g, device=device)
    c = c / c.norm(dim=1, keepdim=True)
    q = c[torch.randint(0, n, (200,), generator=g, device=device)] + 0.05 * torch.randn(
        200, d, generator=g, device=device)
    return q.to(torch.bfloat16), c.to(torch.bfloat16)


def _candidate_agreement(got, want, tile_rows, per_bin, level2=None):
    """Share of candidate slots that decode to the same corpus row, and the
    largest relative value gap among them."""
    pos = torch.arange(got.shape[1], device=got.device).expand_as(got).contiguous()
    gv, gi = mb._unpack_plain(got, pos, tile_rows, per_bin, level2)
    wv, wi = mb._unpack_plain(want, pos, tile_rows, per_bin, level2)
    same = gi == wi
    fin = same & torch.isfinite(wv)
    rel = ((gv - wv).abs() / wv.abs().clamp_min(1e-3))[fin]
    return float(same.float().mean()), float(rel.max()) if rel.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
def test_binmax_scan_kernel_matches_plain(device, per_bin):
    n, d, tile = 65_536, 768, 2048
    q, c = _corpus(n, d, device, seed=per_bin)
    n_valid = n - 1000  # ragged tail masked inside the last tile
    got = mb._scan_cuda(q, c, n_valid, per_bin, tile)
    want = mb._scan_plain(q, c, n_valid, per_bin, tile)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (200, n // 128 * per_bin)
    same, rel = _candidate_agreement(got, want, tile, per_bin)
    assert same >= 0.999 and rel <= 1e-4, (same, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [mb.L2_MID, mb.L2_WIDE])
def test_level2_kernel_matches_plain(device, width):
    n, d, tile, per_bin = 65_536, 768, 2048, 8
    q, c = _corpus(n, d, device, seed=11)
    packed = mb._scan_plain(q, c, n, per_bin, tile)
    got = mb._level2_reduce(packed, width)
    want = mb._level2_reduce(packed.cpu(), width).to(device)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("level2", [None, mb.L2_MID])
def test_unpack_kernel_matches_plain_and_topk_overlaps(device, level2):
    n, d, tile, per_bin, k = 65_536, 768, 2048, 8, 100
    q, c = _corpus(n, d, device, seed=13)
    packed = mb._scan_plain(q, c, n, per_bin, tile)
    if level2:
        packed = mb._level2_reduce(packed, level2)
    top, pos = torch.topk(packed, k, dim=1)
    gv, gi = mb._unpack_cuda(top, pos, tile, per_bin, level2)
    wv, wi = mb._unpack_plain(top, pos, tile, per_bin, level2)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and torch.equal(gv, wv)
    # the whole scan through the kernels against an exact search
    _, ids_k = mb.binmax_scan_topk(q, c, k, per_bin=per_bin)
    exact = torch.topk(q.float() @ c.float().T, k, dim=1).indices
    overlap = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids_k, exact)) / exact.numel()
    assert overlap >= 0.99, overlap


@pytest.mark.cuda
def test_wrappers_count_launches(device):
    _build.reset_launches()
    q, c = _corpus(16_384, 768, device, seed=17)
    mb.binmax_scan_topk(q, c, 10, per_bin=2)  # 256 candidates >= 16 x 10: keep-8/32
    assert _build.LAUNCHES["binmax_candidates"] == 1
    assert _build.LAUNCHES["level2_reduce"] == 1
    assert _build.LAUNCHES["unpack_candidates"] == 1
    mb.binmax_scan_topk(q.cpu(), c.cpu(), 10, per_bin=2)  # plain: not counted
    assert _build.LAUNCHES["binmax_candidates"] == 1
    assert _build.LAUNCHES["level2_reduce"] == 1
    assert _build.LAUNCHES["unpack_candidates"] == 1


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_level2_kernel_at_colbert_geometry_is_bit_identical(device):
    """K4 at width 128 on the candidates of ColBERT's per-token scan (per_bin
    1, 4096-row tiles, n_valid mid-bin, width-128 queries), at 1,024 query
    rows over 300,000 rows (ColBERT's 8,192 over 1.35M, cut)."""
    g = torch.Generator(device=device).manual_seed(31)
    n, n_valid = 311_296, 300_000 - 57  # 19 grains of 16,384 rows (per_bin 1 at 4096-row tiles)
    c = torch.randn(n, 128, generator=g, device=device)
    c = (c / c.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = (c[torch.randint(0, n_valid, (1024,), generator=g, device=device)].float()
         + 0.05 * torch.randn(1024, 128, generator=g, device=device)).to(torch.bfloat16)
    packed = mb.binmax_candidates(q, c, n_valid=n_valid, per_bin=1, tile_rows=4096)
    got = mb._level2_reduce(packed, mb.L2_WIDE)
    want = mb._level2_plain(torch.nn.functional.pad(packed, (0, -packed.shape[1] % 1024), value=float("-inf")),
                            mb.L2_WIDE)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _bits_equal(got, want)
    # the same through binmax_candidates' own route (the scan writes K4's padded input)
    assert _bits_equal(mb.binmax_candidates(q, c, n_valid=n_valid, per_bin=1, tile_rows=4096, level2=mb.L2_WIDE),
                       want)


def _level2_case(kind, q, c, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "ties":  # small integers: exact ties in nearly every group
        return torch.randint(-3, 4, (q, c), generator=g, device=device).float()
    if kind == "near_ties":  # equal but for the low 5 mantissa bits: the kernel's exact path
        x = torch.randint(1, 4, (q, c), generator=g, device=device).float()
        low = torch.randint(0, 32, (q, c), generator=g, device=device, dtype=torch.int32)
        return (x.view(torch.int32) | low).view(torch.float32)
    if kind == "signed_zero_pairs":  # each 32 columns: -0.0 and +0.0 at random offsets, else -inf
        x = torch.full((q, -(-c // 32), 32), float("-inf"), device=device)
        order = torch.rand(x.shape, generator=g, device=device).argsort(-1)
        x.scatter_(-1, order[..., :1], -0.0)
        x.scatter_(-1, order[..., 1:2], 0.0)
        return x.reshape(q, -1)[:, :c].contiguous()
    if kind == "zeros_and_inf":  # +0 ties -0; whole groups of -inf
        choice = torch.tensor([-0.0, 0.0, 1.0, float("-inf"), float("-inf"), float("-inf")], device=device)
        x = choice[torch.randint(0, 6, (q, c), generator=g, device=device)]
        x[:, 64:192] = float("-inf")
        return x
    return torch.randn(q, c, generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [mb.L2_MID, mb.L2_WIDE])
@pytest.mark.parametrize("kind", ["normal", "ties", "near_ties", "zeros_and_inf", "signed_zero_pairs"])
@pytest.mark.parametrize("c", [3 * 1024, 3 * 1024 - 200])
def test_level2_kernel_ties_and_padding_are_bit_identical(device, width, kind, c):
    """K4 bit for bit (int32 view) against ``_level2_plain`` with exact ties
    and near ties inside groups, +0 beside -0 (and alone together, where the
    keys put +0 first whatever the offsets), all -inf groups, and an input
    that is no multiple of 1,024 columns (padded -inf by _level2_reduce; at
    width 128 over 3,072 columns the output's last 64 columns are the -inf
    padding the kernel writes)."""
    x = _level2_case(kind, 37, c, device, seed=c + width)
    got = mb._level2_reduce(x, width)
    want = mb._level2_reduce(x.cpu(), width)
    torch.cuda.synchronize()
    assert got.shape == want.shape and _bits_equal(got.cpu(), want)
    if width == mb.L2_WIDE:
        assert torch.isneginf(got[:, 192:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("q_rows,k,per_bin,level2,tile", [(256, 4000, 4, None, 2048), (8192, 48, 1, mb.L2_WIDE, 4096),
                                                          (256, 1000, 2, mb.L2_MID, 3072), (3, 5, 8, None, 1152)])
def test_unpack_kernel_is_exact_at_the_paths_shapes(device, q_rows, k, per_bin, level2, tile):
    """K6 at the two-stage route's (256, 4000), ColBERT's (8192, 48), and
    odd geometries (3,072- and 1,152-row tiles: nb not a power of two; 15
    elements): ids equal, values bit for bit, -inf slots -1."""
    g = torch.Generator(device=device).manual_seed(k)
    n_cols = 1 << 20
    vals = torch.randn(q_rows, k, generator=g, device=device)
    vals[torch.rand(q_rows, k, generator=g, device=device) < 0.05] = float("-inf")
    lanes = torch.randint(0, 128, (q_rows, k), generator=g, device=device, dtype=torch.int32) | (
        torch.randint(0, level2 or 128, (q_rows, k), generator=g, device=device, dtype=torch.int32) << 7)
    vals = torch.where(torch.isfinite(vals), ((vals.view(torch.int32) & ~0x3FFF) | lanes).view(torch.float32), vals)
    pos = torch.randint(0, n_cols, (q_rows, k), generator=g, device=device)
    gv, gi = mb.unpack_candidates(vals, pos, tile, per_bin, level2)
    wv, wi = mb._unpack_plain(vals, pos, tile, per_bin, level2)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi) and _bits_equal(gv, wv)
    assert (gi[torch.isneginf(vals)] == -1).all()


# ---- the wgmma/TMA scans K3 and K7 at every geometry they take ----------------

SCAN_ROWS = 16_384  # four 4096-row tiles


def _scan_case(q_rows, dim, device, seed, n=SCAN_ROWS):
    """Normalised corpus rows and queries near random rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(n, dim, generator=g, device=device)
    c = c / c.norm(dim=1, keepdim=True)
    q = c[torch.randint(0, n, (q_rows,), generator=g, device=device)] + 0.05 * torch.randn(
        q_rows, dim, generator=g, device=device)
    return q, c


def _int8_scan_case(q_rows, n, device, seed):
    """Int8 query codes with their scales, corpus codes with bin scales."""
    q, c = _scan_case(q_rows, 768, device, seed, n)
    values, scales = mq.quantize_corpus_binwise(c.cpu().numpy())
    q8, qs = mq.quantize_queries(q)
    return q8, qs, torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", [2048, 4096])
@pytest.mark.parametrize("dim", [128, 768])
@pytest.mark.parametrize("q_rows", [1, 77, 256, 300])
def test_binmax_scan_geometries_match_plain(device, q_rows, dim, tile, per_bin):
    """K3 at one query, one and two 128-query slabs and a ragged second
    256-query block, both widths, the tile sizes the port runs and every
    per_bin, with n_valid mid-bin and at a bin's first row: >= 99.9 %
    identical candidates."""
    q, c = _scan_case(q_rows, dim, device, seed=q_rows + dim + per_bin)
    q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    for n_valid in (SCAN_ROWS - 1000, SCAN_ROWS - 3 * 128):
        got = mb._scan_cuda(q, c, n_valid, per_bin, tile)
        want = mb._scan_plain(q, c, n_valid, per_bin, tile)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (q_rows, SCAN_ROWS // 128 * per_bin)
        same, rel = _candidate_agreement(got, want, tile, per_bin)
        assert same >= 0.999 and rel <= 1e-4, (n_valid, same, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
def test_binmax_scan_ties_match_plain_exactly(device, per_bin):
    """Runs of four identical corpus rows (exact ties inside a lane and
    across the lanes of a quad) on dyadic inputs, whose f32 sums are exact
    in any order: K3's packed candidates equal the plain version's bit for
    bit, ties to the lowest offset."""
    g = torch.Generator(device=device).manual_seed(per_bin)
    n, dim = 8192, 768
    c = (torch.randint(-4, 5, (n // 4, dim), generator=g, device=device) / 8.0).repeat_interleave(4, dim=0)
    q = torch.randint(-4, 5, (300, dim), generator=g, device=device) / 8.0
    c, q = c.to(torch.bfloat16), q.to(torch.bfloat16)
    n_valid = n - 300
    got = mb._scan_cuda(q, c, n_valid, per_bin, 2048)
    want = mb._scan_plain(q, c, n_valid, per_bin, 2048)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,per_bin,q_rows", [(16_384, 2, 200), (262_144, 8, 256), (16_384, 4, 300),
                                              (16_384, 1, 77), (16_384, 8, 1)])
def test_int8_scan_kernel_is_bit_identical_to_plain(device, n, per_bin, q_rows):
    """K7: exact int32 sums, the plain version's rounding order and tie
    rule, so its packed candidates equal the plain version's as int32."""
    q8, qs, values, scales = _int8_scan_case(q_rows, n, device, seed=per_bin + q_rows)
    n_valid = n - 1000
    got = mb._scan_int8_cuda(q8, values, scales, qs, n_valid, per_bin, 2048)
    want = mb._scan_int8_plain(q8, values, scales, qs, n_valid, per_bin, 2048)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_binmax_scans_are_bit_identical_run_to_run(device):
    """K3, K7 and K8 twice on the same inputs: the same bits."""
    q, c = _scan_case(300, 768, device, seed=3)
    q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
    runs = [mb._scan_cuda(q, c, SCAN_ROWS - 77, 8, 2048) for _ in range(2)]
    q8, qs, values, scales = _int8_scan_case(300, SCAN_ROWS, device, seed=4)
    runs8 = [mb._scan_int8_cuda(q8, values, scales, qs, SCAN_ROWS - 77, 8, 2048) for _ in range(2)]
    runs8f = [mb._scan_int8f_cuda(q, values, scales, SCAN_ROWS - 77, 8, 2048) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0].view(torch.int32), runs[1].view(torch.int32))
    assert torch.equal(runs8[0].view(torch.int32), runs8[1].view(torch.int32))
    assert torch.equal(runs8f[0].view(torch.int32), runs8f[1].view(torch.int32))


def _mixed_scan_case(q_rows, dim, device, seed, n=SCAN_ROWS):
    """bf16 queries, corpus codes with bin scales (K8's inputs)."""
    q, c = _scan_case(q_rows, dim, device, seed, n)
    values, scales = mq.quantize_corpus_binwise(c.cpu().numpy())
    return q.to(torch.bfloat16), torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", [2048, 4096])
@pytest.mark.parametrize("dim", [96, 768])
@pytest.mark.parametrize("q_rows", [1, 77, 256, 300])
def test_mixed_scan_geometries_match_plain(device, q_rows, dim, tile, per_bin):
    """K8 on the persistent scan (SCAN_MIXED) at one query, one and two
    128-query slabs and a ragged second 256-query block, D 768 and 96 (a
    last stage half past D, zero-filled), both tile sizes and every per_bin,
    n_valid mid-bin and at a bin's first row: >= 99.9 % identical candidates
    against its plain version."""
    q, values, scales = _mixed_scan_case(q_rows, dim, device, seed=q_rows + dim + per_bin + 1)
    for n_valid in (SCAN_ROWS - 1000, SCAN_ROWS - 3 * 128):
        got = mb._scan_int8f_cuda(q, values, scales, n_valid, per_bin, tile)
        want = mb._scan_int8f_plain(q, values, scales, n_valid, per_bin, tile)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (q_rows, SCAN_ROWS // 128 * per_bin)
        same, rel = _candidate_agreement(got, want, tile, per_bin)
        assert same >= 0.999 and rel <= 1e-4, (n_valid, same, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("per_bin", [1, 2, 4, 8])
@pytest.mark.parametrize("q_rows", [77, 300])
def test_mixed_scan_ties_match_plain_exactly(device, per_bin, q_rows):
    """K8 with integer-valued bf16 queries and runs of four identical code
    rows: every f32 sum is exact in any order, so the packed candidates
    equal the plain version's bit for bit, exact ties to the lowest offset."""
    g = torch.Generator(device=device).manual_seed(per_bin + q_rows)
    n, dim = 8192, 768
    codes = torch.randint(-127, 128, (n // 4, dim), generator=g, device=device, dtype=torch.int8)
    codes = codes.repeat_interleave(4, dim=0)
    scales = torch.rand(n // 128, 1, generator=g, device=device) * 0.01 + 1e-3
    q = torch.randint(-3, 4, (q_rows, dim), generator=g, device=device).to(torch.bfloat16)
    n_valid = n - 300
    got = mb._scan_int8f_cuda(q, codes, scales, n_valid, per_bin, 2048)
    want = mb._scan_int8f_plain(q, codes, scales, n_valid, per_bin, 2048)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- the int8 serving kernels (K9, K10, K8, K7) -------------------------------

def _int8_layer(hid, ff, device, seed):
    """Per-column codes and scales of random f32 weights, f32 biases and LN."""
    g = torch.Generator(device=device).manual_seed(seed)

    def q(rows, cols):
        return fi.quantize_weights_per_col(torch.randn(rows, cols, generator=g, device=device) * rows ** -0.5)

    def v(n, std, mean=0.0):
        return torch.randn(n, generator=g, device=device) * std + mean

    attn = [*q(hid, hid), *q(hid, hid), *q(hid, hid), *q(hid, hid), v(hid, 0.05), v(hid, 0.05), v(hid, 0.05),
            v(hid, 0.05)]
    mlp = [*q(hid, ff), v(ff, 0.05), *q(ff, hid), v(hid, 0.05)]
    return attn, mlp, (v(hid, 0.1, 1.0), v(hid, 0.1))


def _int8_case(b, l, hid, ff, device, seed):
    """One case of the int8 halves: the layer's weights and the input x and
    mask, each drawn from a ``torch.Generator`` seeded from ``seed`` (never
    the device's global generator, whose state depends on the tests run
    before). Example 0 keeps its first l // 2 + 1 positions, the others a
    random length in [1, l]."""
    attn, mlp, ln = _int8_layer(hid, ff, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    lengths = torch.randint(1, l + 1, (b,), generator=g, device=device)
    lengths[0] = l // 2 + 1
    mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    return attn, mlp, ln, x, mask


def _int8_kmajor(attn, mlp):
    """The weights as the encoder holds them for the card: K-major codes,
    Q/K/V packed."""
    w1q, s1, b1, w2q, s2, b2 = mlp
    return fi.kmajor_attention_weights(*attn), (fi.kmajor_codes(w1q), s1, b1, fi.kmajor_codes(w2q), s2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,ff", [(768, 3072), (1024, 4096)])
@pytest.mark.parametrize("b,l", [(4, 128), (3, 200), (5, 30), (256, 128), (16, 77), (1, 5)])
def test_int8_halves_kernels_match_plain(device, b, l, hid, ff):
    """K10 and K9 at DistilBERT width, and at BERT-large width (16 heads,
    FF chunks of 1,024 columns: the W1 kernel's two-pass path), against
    their plain versions on the card, through the public functions and the
    encoder's K-major entry points (the same bits): row cosine >= 0.999,
    max |d| <= 0.1, the bar K1/K2 meet, and a mean |d| <= 5e-5. The plain
    versions round step by step as the kernels do, so only rare rounding
    flips differ; a wrong scale granularity (gelu codes per row instead of
    per FF chunk, attention codes per row instead of per head group) moves
    the mean |d| to >= 1e-3 at this width."""
    heads = hid // 64
    attn, mlp, ln, x, mask = _int8_case(b, l, hid, ff, device, seed=b * 1000 + l)
    attn_t, mlp_t = _int8_kmajor(attn, mlp)
    for kernel, kmajor, plain, args, args_t in (
            (fi.fused_attention_int8_block, fi.fused_attention_int8_block_qkv_kmajor,
             fi.reference_attention_int8_block, (*attn, mask, heads, *ln), (*attn_t, mask, heads, *ln)),
            (fi.fused_mlp_int8_block, fi.fused_mlp_int8_block_kmajor, fi.reference_mlp_int8_block, (*mlp, *ln),
             (*mlp_t, *ln))):
        got, want = kernel(x, *args), plain(x, *args)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        assert torch.equal(kmajor(x, *args_t), got)
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        print(f"{kernel.__name__} B={b} L={l} HID={hid}: min row cosine {cos}, max |d| {err}, mean |d| {mean}")
        assert cos >= 0.999 and err <= 0.1, (kernel.__name__, cos, err)
        assert mean <= 5e-5, (kernel.__name__, mean)


@pytest.mark.cuda
def test_int8_halves_are_bit_identical_run_to_run(device):
    """No atomics and a fixed order of every sum: K10 and K9 give the same
    bits twice on the same inputs."""
    attn, mlp, ln = _int8_layer(768, 3072, device, seed=21)
    x = torch.randn(64, 128, 768, device=device).to(torch.bfloat16)
    mask = torch.ones(64, 128, device=device)
    mask[::3, 90:] = 0.0
    attn_t, mlp_t = _int8_kmajor(attn, mlp)
    a1 = fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, 12, *ln)
    m1 = fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln)
    a2 = fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, 12, *ln)
    m2 = fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln)
    torch.cuda.synchronize()
    assert torch.equal(a1, a2) and torch.equal(m1, m2)


def _codes(m, k, device, gen):
    return torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4096, 77, 1])
@pytest.mark.parametrize("form,k,n,chunk", [("qkv", 768, 2304, 768), ("w1", 768, 3072, 768), ("w2", 3072, 768, 768),
                                            ("wo", 768, 768, 128), ("wo_odd", 384, 256, 128),
                                            ("ragged", 192, 48, 64)])
def test_int8_wgmma_gemm_is_exact(device, form, k, n, chunk, m):
    """The int8 wgmma GEMM alone (mm_wg_gemm_s8) at the products' shapes of
    K10 (QKV, Wo: six chunks of one 128-deep stage; three of them) and K9
    (W1, W2), and a ragged one (K and N not multiples of the 128-wide tile,
    chunks of 64, half a stage), at M = 4096 and a ragged M: each K
    chunk's int32 sum equals the float64 product of the codes exactly
    (|sum| <= 1,024 * 127^2 < 2^24, so its f32 is exact too), and the
    epilogue's f32 arithmetic repeats bit for bit in f32 on the same
    device: bf16(dq + bias) for one chunk (QKV, W1), (resid + bias) + dq_0 +
    dq_1 + ... in order for several (W2, Wo), dq_c = f32(sum_c) * (row
    scale * column scale)."""
    gen = torch.Generator(device=device).manual_seed(m * 7 + k + n)
    a, w_t = _codes(m, k, device, gen), _codes(n, k, device, gen)
    nchunks = k // chunk
    rs = torch.rand(m, nchunks, generator=gen, device=device) * 0.02 + 1e-3
    cs = torch.rand(n, generator=gen, device=device) * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device=device) * 0.05
    sums = [(a[:, c * chunk:(c + 1) * chunk].double() @ w_t[:, c * chunk:(c + 1) * chunk].double().t()).float()
            for c in range(nchunks)]
    if nchunks == 1:
        out = torch.empty(m, n, dtype=torch.bfloat16, device=device)
        fi._gemm_s8(a, w_t, rs, cs, bias, out, fi._EPI_S8_BIAS_BF16, chunk)
        want = (sums[0] * (rs * cs[None, :]) + bias).to(torch.bfloat16)
    else:
        resid = torch.randn(m, n, generator=gen, device=device).to(torch.bfloat16)
        out = torch.empty(m, n, dtype=torch.float32, device=device)
        fi._gemm_s8(a, w_t, rs, cs, bias, out, fi._EPI_S8_CHUNKS_RESID_F32, chunk, resid=resid)
        want = resid.float() + bias
        for c, acc in enumerate(sums):
            want = want + acc * (rs[:, c:c + 1] * cs[None, :])
    torch.cuda.synchronize()
    assert torch.equal(out, want), float((out.float() - want.float()).abs().max())


def _gelu_poly_fma(h):
    """csrc/encoder_common.cuh:gelu_poly as the card computes it: each
    ``p * v + c`` (and ``1 + p * uc``) contracted to one fused multiply-add,
    emulated in float64 (exact product, one rounding, then f32)."""
    def fma(a, b, c):
        return (a.double() * b.double() + c).float()

    def f32(c):
        return float(torch.tensor(c, dtype=torch.float32))

    uc = torch.clamp(h * 0.7071067811865476, -3.4, 3.4)
    v = uc * uc
    p = torch.full_like(v, f32(1.2036946e-08))
    for c in (-7.4665718e-07, 2.0221069e-05, -0.00031579041, 0.0031725222, -0.021726243, 0.10513879, -0.37025923,
              1.1268175):
        p = fma(p, v, f32(c))
    return (0.5 * h) * fma(p, uc, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4096, 77, 1])
@pytest.mark.parametrize("hid,ff", [(768, 3072), (1024, 4096), (64, 256)])
def test_int8_w1_epilogue_codes_are_bit_identical(device, hid, ff, m):
    """K9's W1 kernel (mm_wg_gemm_s8_gelu_quant) writes, per FF chunk, the
    codes and scales _quant_rows makes of gelu_poly(dequant + b1), bit for
    bit: chunks of 768 (one pass), 1,024 (two passes: amax first, then the
    codes) and 64 (a chunk narrower than one 128-wide box). The reference's
    gelu contracts to FMAs as the card's does (_gelu_poly_fma)."""
    gen = torch.Generator(device=device).manual_seed(m + hid)
    x = (torch.randn(m, hid, generator=gen, device=device) * 2).to(torch.bfloat16)
    w1q, s1 = fi.quantize_weights_per_col(torch.randn(hid, ff, generator=gen, device=device) * hid ** -0.5)
    b1 = torch.randn(ff, generator=gen, device=device) * 0.05
    xq, rs = fi._quant_groups_cuda(x, 1)
    hq, hs = fi._gemm_s8_gelu_quant(xq, fi.kmajor_codes(w1q), rs, s1, b1, 4)
    ch = ff // 4
    for c in range(4):
        sl = slice(c * ch, (c + 1) * ch)
        acc = (xq.double() @ w1q[:, sl].double()).float()
        want_q, want_s = fi._quant_rows(_gelu_poly_fma(acc * (rs * s1[sl]) + b1[sl]))
        assert torch.equal(hs[:, c:c + 1], want_s), c
        assert torch.equal(hq[:, sl], want_q), (c, int((hq[:, sl] != want_q).sum()))


@pytest.mark.cuda
def test_mlp_int8_half_keeps_the_gelu_output_on_chip(device):
    """K9 allocates no (M, FF) f32 tensor on the card: its peak memory over
    the call stays below the f32 gelu output's bytes (M x FF x 4), which the
    earlier design wrote and read twice."""
    attn, mlp, ln = _int8_layer(768, 3072, device, seed=8)
    x = torch.randn(64, 128, 768, device=device).to(torch.bfloat16)
    _, mlp_t = _int8_kmajor(attn, mlp)
    fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < 64 * 128 * 3072 * 4, peak
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cols,groups", [(torch.bfloat16, 768, 1), (torch.float32, 3072, 4),
                                               (torch.float32, 768, 6)])
def test_int8_quantize_kernel_matches_plain_bit_for_bit(device, dtype, cols, groups):
    """The activation quantizer of K9/K10 (x per row, gelu per row and FF
    chunk, attention output per row and head group): codes and scales equal
    the plain version's, the scale an IEEE division by 127."""
    x = (torch.randn(1000, cols, device=device) * 3).to(dtype)
    x[7] = 0.0  # an all-zero row takes the 1e-12 floor
    q, s = fi._quant_groups_cuda(x, groups)
    w = cols // groups
    parts = [fi._quant_rows(x[:, g * w:(g + 1) * w].float()) for g in range(groups)]
    assert torch.equal(s, torch.cat([p[1] for p in parts], dim=1))
    assert torch.equal(q, torch.cat([p[0] for p in parts], dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("n,per_bin", [(16_384, 2), (262_144, 8)])
def test_int8_scan_kernels_match_plain(device, mixed, n, per_bin):
    """K8 (bf16 queries) and K7 (int8 queries) against their plain versions:
    >= 99.9 % identical candidates, and K7 bit-identical."""
    q, c = _corpus(n, 768, device, seed=per_bin)
    values, scales = mq.quantize_corpus_binwise(c.float().cpu().numpy())
    values, scales = torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)
    if mixed:
        got = mb._scan_int8f_cuda(q, values, scales, n, per_bin, 2048)
        want = mb._scan_int8f_plain(q, values, scales, n, per_bin, 2048)
    else:
        q8, qs = mq.quantize_queries(q)
        got = mb._scan_int8_cuda(q8, values, scales, qs, n, per_bin, 2048)
        want = mb._scan_int8_plain(q8, values, scales, qs, n, per_bin, 2048)
    torch.cuda.synchronize()
    share, _ = _candidate_agreement(got, want, 2048, per_bin)
    assert share >= 0.999, share
    if not mixed:  # K7's sums are exact and its rounding is the plain version's
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_int8_wrappers_count_cuda_launches_only(device):
    """K7-K10 count one launch per wrapper call on the card (K9/K10 through
    the public functions and the K-major entry points alike); a CPU call
    runs the plain version and counts nothing."""
    _build.reset_launches()
    attn, mlp, ln = _int8_layer(768, 3072, device, seed=3)
    x = torch.randn(2, 64, 768, device=device).to(torch.bfloat16)
    mask = torch.ones(2, 64, device=device)
    fi.fused_attention_int8_block(x, *attn, mask, 12, *ln)
    fi.fused_mlp_int8_block(x, *mlp, *ln)
    attn_t, mlp_t = _int8_kmajor(attn, mlp)
    fi.fused_attention_int8_block_qkv_kmajor(x, *attn_t, mask, 12, *ln)
    fi.fused_mlp_int8_block_kmajor(x, *mlp_t, *ln)
    q, c = _corpus(16_384, 768, device, seed=5)
    values, scales = mq.quantize_corpus_binwise(c.float().cpu().numpy())
    values, scales = torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)
    mb.binmax_scan_topk(q, values, 10, per_bin=2, corpus_scales=scales)
    mb.binmax_scan_topk(q, values, 10, per_bin=2, corpus_scales=scales, mixed_queries=True)
    torch.cuda.synchronize()
    want = {"fused_attention_int8_block": 2, "fused_mlp_int8_block": 2, "binmax_candidates_int8": 1,
            "binmax_candidates_int8f": 1}
    assert {k: _build.LAUNCHES[k] for k in want} == want
    cpu = lambda t: t.cpu()  # noqa: E731
    fi.fused_mlp_int8_block(x.cpu(), *map(cpu, mlp), *map(cpu, ln))
    fi.fused_mlp_int8_block_kmajor(x.cpu(), *map(cpu, mlp_t), *map(cpu, ln))
    fi.fused_attention_int8_block_qkv_kmajor(x.cpu(), *map(cpu, attn_t), mask.cpu(), 12, *map(cpu, ln))
    mb.binmax_scan_topk(q.cpu(), values.cpu(), 10, per_bin=2, corpus_scales=scales.cpu())
    assert {k: _build.LAUNCHES[k] for k in want} == want


# ---- ColBERT MaxSim (K14) and the standalone attention (K13) -----------------

def _maxsim_case(bq, lq, bd, ld, dim, device, seed, below_fill=False):
    """Random f32 token vectors and masks with zeros; one all-padding doc and
    one all-padding query; ``below_fill``: every third doc's live dots below
    −1000."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(bq, lq, dim, generator=g, device=device)
    d = torch.randn(bd, ld, dim, generator=g, device=device)
    if below_fill:
        q, d[::3] = q.abs() * 5, -d[::3].abs() * 40
    q_mask = (torch.rand(bq, lq, generator=g, device=device) > 0.2).float()
    d_mask = (torch.rand(bd, ld, generator=g, device=device) > 0.2).float()
    q_mask[:, 0] = d_mask[:, 0] = 1.0
    d_mask[min(1, bd - 1)] = 0.0
    q_mask[-1] = 0.0
    return q, d, q_mask, d_mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fill,below", [((128, 32, 256, 200, 128), ms.NEG_FILL, False),
                                              ((32, 32, 64, 200, 128), ms.NEG_FILL, False),
                                              ((1, 32, 64, 128, 128), float("-inf"), False),
                                              ((3, 13, 21, 77, 128), ms.NEG_FILL, True),
                                              ((3, 13, 21, 77, 128), float("-inf"), True),
                                              ((5, 40, 9, 30, 32), ms.NEG_FILL, False)])
def test_maxsim_kernel_matches_plain(device, shape, fill, below):
    """K14 against its plain version on the card (rtol = atol = 1e-4, the
    bar of tests/test_perf_ops.py:91): the phase-3 shapes, the exact
    rescore's fill −inf, dots below −1000, all-padding docs and queries."""
    q, d, qm, dm = _maxsim_case(*shape, device, seed=sum(shape), below_fill=below)
    _build.reset_launches()
    got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
    want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["maxsim_all_pairs"] == 1
    assert got.shape == (shape[0], shape[2])
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    assert bool((got[-1] == 0).all())


@pytest.mark.cuda
def test_maxsim_kernel_refuses_autograd_and_bad_shapes(device):
    """The gathered form is forward-only; the all-pairs form under autograd
    launches the training form and its backward kernel, never the plain
    version, also past 1,024 doc tokens (refused until the backward's tie
    classes moved to memory sized by Ld); D past 2,048 raises."""
    q, d, qm, dm = _maxsim_case(2, 8, 3, 16, 32, device, seed=1)
    first, count = torch.zeros(2, 3, dtype=torch.int64), torch.full((2, 3), 16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ms.maxsim_gathered(q.clone().requires_grad_(), qm, d.reshape(-1, 32), first, count, 16)
    _build.reset_launches()
    ms.maxsim_all_pairs(q.clone().requires_grad_(), d, qm, dm).sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["maxsim_all_pairs_argmax"] == 1 and _build.LAUNCHES["maxsim_all_pairs_bwd"] == 1
    assert _build.LAUNCHES["maxsim_all_pairs"] == 0
    wide_q, wide_d = (torch.zeros(*t.shape[:2], 2056, device=device) for t in (q, d))  # D past 2,048
    with pytest.raises(ValueError, match="D <= 2048"):
        ms.maxsim_all_pairs(wide_q, wide_d, qm, dm)
    with pytest.raises(ValueError, match="D <= 2048"):
        ms.maxsim_all_pairs(wide_q.clone().requires_grad_(), wide_d, qm, dm)
    long_d = torch.randn(3, 1025, 32, device=device)
    _build.reset_launches()
    ms.maxsim_all_pairs(q.clone().requires_grad_(), long_d, qm, torch.ones(3, 1025, device=device)).sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["maxsim_all_pairs_argmax"] == 1 and _build.LAUNCHES["maxsim_all_pairs_bwd"] == 1


def _maxsim_training_case(bq, lq, bd, ld, dim, device, seed, below_fill=False, ties=False):
    """_maxsim_case's inputs; ``ties``: in every doc token 5 repeats token 3,
    the sum of the batch's query rows (so the two hold the max of many
    (query token, doc) pairs), an exact tie for the kernel and for the plain
    dots alike."""
    q, d, qm, dm = _maxsim_case(bq, lq, bd, ld, dim, device, seed=seed, below_fill=below_fill)
    if ties:
        d[:, 3] = q.sum(dim=(0, 1))
        d[:, 5] = d[:, 3]
        dm[:, 3] = dm[:, 5] = 1.0
    return q, d, qm, dm


def _plain_maxsim_grads(q, d, qm, dm, g, fill):
    q, d = q.clone().requires_grad_(), d.clone().requires_grad_()
    (ms.reference_maxsim_all_pairs(q, d, qm, dm, fill) * g).sum().backward()
    return q.grad, d.grad


@pytest.mark.cuda
@pytest.mark.parametrize("shape,below,ties", [((32, 30, 64, 200, 128), False, False),
                                              ((7, 30, 21, 77, 128), True, False),
                                              ((4, 16, 6, 40, 64), False, True),
                                              ((128, 30, 256, 200, 128), False, False),
                                              ((32, 30, 64, 200, 768), False, False),
                                              ((16, 1, 32, 200, 128), False, False),
                                              ((4, 30, 8, 1024, 128), False, True),
                                              ((5, 13, 9, 30, 40), True, False),
                                              ((8, 30, 16, 1025, 128), False, True),
                                              ((4, 600, 8, 2000, 128), False, True),
                                              ((2, 8, 3, 8200, 16), False, True)])
def test_maxsim_training_form_and_backward_match_plain(device, shape, below, ties):
    """K14's training form and the backward kernel against plain autograd
    through reference_maxsim_all_pairs: the forward at K14's bar (rtol =
    atol = 1e-4), the saved doc tokens equal to the plain argmax but for
    near ties, dq and dd at rtol = atol = 1e-4 on the rows whose tokens
    agree, the exact ties split evenly, reruns bit-identical; past 1,024
    doc tokens too (Ld 1,025 and 2,000 with 600 query tokens; Ld 8,200, the
    tie classes in a global workspace)."""
    fill = ms.NEG_FILL
    q, d, qm, dm = _maxsim_training_case(*shape, device, seed=sum(shape), below_fill=below, ties=ties)
    g = torch.randn(shape[0], shape[2], device=device, generator=torch.Generator(device=device).manual_seed(3))
    _build.reset_launches()
    out, argmax = ms._launch_argmax(q, qm, d, dm, fill)
    torch.testing.assert_close(out, ms.reference_maxsim_all_pairs(q, d, qm, dm, fill), rtol=1e-4, atol=1e-4)
    _, want_idx, top1, top2 = ms.reference_maxsim_argmax(q, d, qm, dm, fill, with_top2=True)
    agree = argmax == want_idx
    assert float(agree.float().mean()) >= 0.9999
    assert bool(((top1 - top2).abs() <= 1e-5 * top1.abs())[~agree].all())
    dq, dd = ms._launch_bwd(q, qm, d, dm, argmax, g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["maxsim_all_pairs_argmax"] == 1 and _build.LAUNCHES["maxsim_all_pairs_bwd"] == 1
    pq, pd = _plain_maxsim_grads(q, d, qm, dm, g, fill)
    rows_q = agree.all(dim=2)  # (Bq, Lq)
    docs = agree.all(dim=(0, 1))  # (Bd,)
    torch.testing.assert_close(dq[rows_q], pq[rows_q], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dd[docs], pd[docs], rtol=1e-4, atol=1e-4)
    assert bool((dd[dm <= 0] == 0).all())
    if ties:
        assert bool(docs.all()) and bool((argmax == 3).any())
        assert torch.equal(dd[:, 3], dd[:, 5]) and bool(dd[:, 3].abs().max() > 0)
    again_out, again_idx = ms._launch_argmax(q, qm, d, dm, fill)
    assert torch.equal(again_out, out) and torch.equal(again_idx, argmax)
    again_q, again_d = ms._launch_bwd(q, qm, d, dm, argmax, g)
    assert torch.equal(again_q, dq) and torch.equal(again_d, dd)


@pytest.mark.cuda
def test_maxsim_all_pairs_under_autograd_matches_plain_autograd(device):
    """maxsim_all_pairs on CUDA tensors that require grad: the gradients of
    a loss through it against the plain autograd gradients, and a no-grad
    call keeps K14's plain launch."""
    q, d, qm, dm = _maxsim_training_case(8, 30, 16, 200, 128, device, seed=5)
    qg, dg = q.clone().requires_grad_(), d.clone().requires_grad_()
    _build.reset_launches()
    torch.logsumexp(ms.maxsim_all_pairs(qg, dg, qm, dm), dim=1).sum().backward()
    pq, pd = q.clone().requires_grad_(), d.clone().requires_grad_()
    torch.logsumexp(ms.reference_maxsim_all_pairs(pq, pd, qm, dm), dim=1).sum().backward()
    torch.testing.assert_close(qg.grad, pq.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dg.grad, pd.grad, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        ms.maxsim_all_pairs(qg, dg, qm, dm)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["maxsim_all_pairs_argmax"], _build.LAUNCHES["maxsim_all_pairs_bwd"],
            _build.LAUNCHES["maxsim_all_pairs"]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(256, 128), (64, 30), (3, 200), (2, 1)])
def test_fused_mha_kernel_matches_plain(device, b, l):
    """K13 against its plain version on the card at head width 64, 12 heads,
    with padded keys: the encoder halves' bar (row cosine >= 0.999, max |d|
    <= 0.1)."""
    g = torch.Generator(device=device).manual_seed(b + l)
    q, k, v = (torch.randn(b, l, 768, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    _build.reset_launches()
    got = fa.fused_mha(q, k, v, mask, 12)
    want = fa.mha_reference(q, k, v, mask, 12)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mha"] == 1 and got.dtype == torch.bfloat16
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


# The attention cores at head widths 16 and 32 (K1, K13, K10 forward; K12
# backward), beside the 64-wide instances above: hidden 384 as MiniLM-L6
# (12 heads of 32) and 24 heads of 16 at the same width, FF 1,536.
HEAD_WIDTHS = [(384, 12), (384, 24)]
HEAD_WIDTH_SHAPES = [(16, 230), (3, 77), (2, 1), (1, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", HEAD_WIDTH_SHAPES)
def test_attention_and_mlp_halves_at_head_widths_16_and_32(device, hid, heads, b, l):
    """K1 and K2 at hidden 384 against their plain versions, the encoder
    halves' bar (row cosine >= 0.999, max |d| <= 0.1)."""
    attn, mlp = _layer_weights(hid, 4 * hid, device, seed=b * 1000 + l + heads)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"],
            attn["bo"], mask, heads, attn["ln_scale"], attn["ln_bias"])
    margs = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    _build.reset_launches()
    for got, want in ((fa.fused_attention_block(x, *args), fa.reference_attention_block(x, *args)),
                      (fa.fused_mlp_block(x, *margs), fa.reference_mlp_block(x, *margs))):
        torch.cuda.synchronize()
        cos, err = _rows_close(got, want)
        assert cos >= 0.999 and err <= 0.1, (cos, err)
    assert _build.LAUNCHES["fused_attention_block"] == _build.LAUNCHES["fused_mlp_block"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", HEAD_WIDTH_SHAPES)
def test_fused_mha_kernel_at_head_widths_16_and_32(device, hid, heads, b, l):
    g = torch.Generator(device=device).manual_seed(b + l + heads)
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    _build.reset_launches()
    got = fa.fused_mha(q, k, v, mask, heads)
    want = fa.mha_reference(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mha"] == 1
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", HEAD_WIDTH_SHAPES)
def test_attention_block_bwd_kernel_at_head_widths_16_and_32(device, hid, heads, b, l):
    """K12 (with the attention core's backward at these widths) and, through
    the same inputs, the core's backward alone, at the backward's bar."""
    attn, _ = _layer_weights(hid, 4 * hid, device, seed=b * 1000 + l + heads + 5)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    got, want = attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    grads_close(got, want, scale_of=zero_attention_grads(l))
    g = torch.Generator(device=device).manual_seed(l + heads)
    qkv = torch.randn(b, l, 3 * hid, generator=g, device=device).to(torch.bfloat16)
    da = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    got = fb.attention_core_bwd(qkv, mask, da, heads)
    want = fb.attention_core_bwd(qkv.cpu(), mask.cpu(), da.cpu(), heads)
    torch.cuda.synchronize()
    got = dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1)))
    want = dict(zip(("dq", "dk", "dv"), want.to(device).chunk(3, dim=-1)))
    grads_close(got, want, scale_of={"dq": "dv", "dk": "dv"} if l == 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", HEAD_WIDTH_SHAPES)
def test_int8_halves_at_head_widths_16_and_32(device, hid, heads, b, l):
    """K10 and K9 at hidden 384 against their plain versions, at
    test_int8_halves_kernels_match_plain's bars; a head group is 64 columns
    (two heads of 32, four of 16), the Wo product's whole 64-code step."""
    group = 64 // (hid // heads)
    attn, mlp, ln, x, mask = _int8_case(b, l, hid, 4 * hid, device, seed=b * 1000 + l + heads)
    for kernel, plain, args in (
            (fi.fused_attention_int8_block, fi.reference_attention_int8_block, (*attn, mask, heads, *ln)),
            (fi.fused_mlp_int8_block, fi.reference_mlp_int8_block, (*mlp, *ln))):
        kw = {"group_heads": group} if kernel is fi.fused_attention_int8_block else {}
        got, want = kernel(x, *args, **kw), plain(x, *args, **kw)
        torch.cuda.synchronize()
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        assert cos >= 0.999 and err <= 0.1, (kernel.__name__, cos, err)
        assert mean <= 5e-5, (kernel.__name__, mean)


@pytest.mark.cuda
def test_attention_kernels_refuse_other_head_widths(device):
    """Heads wider than 128 (no core is instanced past 128) are refused
    before any launch, naming the widths taken; TinyBERT's 26 runs padded."""
    x = torch.zeros(1, 8, 1536, device=device, dtype=torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="head widths up to 128"):
        fa.fused_mha(x, x, x, torch.ones(1, 8, device=device), 6)
    assert _build.LAUNCHES["fused_mha"] == 0
    x = torch.zeros(1, 8, 312, device=device, dtype=torch.bfloat16)
    assert fa.fused_mha(x, x, x, torch.ones(1, 8, device=device), 12).shape == x.shape


# Heads narrower than an instance (K1, K13, K10 forward; K12 backward), run
# zero-padded to the next one: TinyBERT-General-4L-312D's 12 heads of 26
# (hidden 312, FF 1,200), 16 heads of 24 and 8 heads of 48 at hidden 384,
# against the plain versions on the unpadded weights.
ODD_HEAD_WIDTHS = [(312, 12, 1200), (384, 16, 1536), (384, 8, 1536)]
ODD_HEAD_SHAPES = [(16, 230), (3, 77), (2, 1)]


def padded_attention_bwd_pair(x, attn, mask, heads, dy):
    """K12 on the heads zero-padded as the encoder pads them (after the K1
    training forward), its gradients cut back to the real columns, and the
    plain backward on the unpadded weights: two dicts of named gradients."""
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    g, be = attn["ln_scale"], attn["ln_bias"]
    hid = x.shape[-1]
    d = hid // heads
    pw, pb, po, _ = fa.card_heads("test", wqkv, bqkv, attn["wo"], heads)
    width = po.shape[0] // heads
    _, saved = fb.attention_block_fwd(x, pw, pb, po, attn["bo"], mask, heads, g, be, head_dim=d)
    dx, dwqkv, dbqkv, dwo, dbo, dg, dbe = fb.attention_block_bwd(x, pw, pb, po, mask, heads, g, dy, saved,
                                                                  head_dim=d)
    real = (torch.arange(3 * heads * width, device=x.device) % width) < d
    assert not dwqkv[:, ~real].any() and not dbqkv[~real].any() and not dwo[~real[:heads * width]].any()
    dwqkv, dbqkv, dwo = dwqkv[:, real], dbqkv[real], dwo[real[:heads * width]]
    got = dict(dx=dx, dwo=dwo, dbo=dbo, dg=dg, dbe=dbe)
    for i, n in enumerate("qkv"):
        got[f"dw{n}"] = dwqkv.chunk(3, dim=1)[i]
        got[f"db{n}"] = dbqkv.chunk(3)[i]
    _, acc = fa.reference_attention_block(x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"],
                                          attn["bv"], attn["bo"], mask, heads, g, be, save_acc=True)
    names = ("dx", "dwq", "dwk", "dwv", "dwo", "dbq", "dbk", "dbv", "dbo", "dg", "dbe")
    want = dict(zip(names, fb.reference_attention_block_bwd(
        x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], mask, heads, g, dy,
        acc)))
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", ODD_HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", ODD_HEAD_SHAPES)
def test_attention_halves_and_mha_at_padded_head_widths(device, hid, heads, ff, b, l):
    """K1 (weights padded in the wrapper), K2 at the same hidden width, K13
    (q, k, v padded per head) against their plain versions on the unpadded
    weights: the encoder halves' bar (row cosine >= 0.999, max |d| <= 0.1)."""
    attn, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + heads + 7)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"],
            attn["bo"], mask, heads, attn["ln_scale"], attn["ln_bias"])
    margs = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    q, k, v = (torch.randn(b, l, hid, device=device).to(torch.bfloat16) for _ in range(3))
    _build.reset_launches()
    for got, want in ((fa.fused_attention_block(x, *args), fa.reference_attention_block(x, *args)),
                      (fa.fused_mlp_block(x, *margs), fa.reference_mlp_block(x, *margs)),
                      (fa.fused_mha(q, k, v, mask, heads), fa.mha_reference(q, k, v, mask, heads))):
        torch.cuda.synchronize()
        assert got.shape == want.shape
        cos, err = _rows_close(got, want)
        assert cos >= 0.999 and err <= 0.1, (cos, err)
    assert _build.LAUNCHES["fused_attention_block"] == _build.LAUNCHES["fused_mlp_block"] == 1
    assert _build.LAUNCHES["fused_mha"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", ODD_HEAD_WIDTHS)
@pytest.mark.parametrize("b,l", ODD_HEAD_SHAPES)
def test_attention_block_bwd_kernel_at_padded_head_widths(device, hid, heads, ff, b, l):
    """K12 on zero-padded heads (its LayerNorm backward at 312 columns for
    TinyBERT), the padded columns' gradients exactly zero, and the core's
    backward alone (padded per head in the wrapper), at the backward's bar."""
    attn, _ = _layer_weights(hid, ff, device, seed=b * 1000 + l + heads + 9)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    got, want = padded_attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    grads_close(got, want, scale_of=zero_attention_grads(l))
    g = torch.Generator(device=device).manual_seed(l + heads + 1)
    qkv = torch.randn(b, l, 3 * hid, generator=g, device=device).to(torch.bfloat16)
    da = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    got = fb.attention_core_bwd(qkv, mask, da, heads)
    want = fb.attention_core_bwd(qkv.cpu(), mask.cpu(), da.cpu(), heads)
    torch.cuda.synchronize()
    got = dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1)))
    want = dict(zip(("dq", "dk", "dv"), want.to(device).chunk(3, dim=-1)))
    grads_close(got, want, scale_of={"dq": "dv", "dk": "dv"} if l == 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", [(64, 4, 256), (128, 2, 512), (312, 12, 1200), (392, 8, 1024)])
@pytest.mark.parametrize("b,l", [(4, 30), (2, 77)])
def test_ln_backward_at_any_multiple_of_8(device, hid, heads, ff, b, l):
    """The LayerNorm backward at widths that are not a multiple of 128 (the
    tiny encoder's 64, TinyBERT's 312, 392) and at 128, through K11 and K12,
    at the backward's bar."""
    attn, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + hid)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    _build.reset_launches()
    got, want = mlp_bwd_pair(x, mlp, dy)
    torch.cuda.synchronize()
    grads_close(got, want)
    got, want = padded_attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    grads_close(got, want, scale_of=zero_attention_grads(l))
    assert _build.LAUNCHES["fused_mlp_block_bwd"] == _build.LAUNCHES["fused_attention_block_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", ODD_HEAD_WIDTHS + [(96, 4, 384)])
@pytest.mark.parametrize("b,l", [(16, 230), (3, 77), (1, 5)])
def test_int8_halves_at_padded_widths(device, hid, heads, ff, b, l):
    """K10 and K9 where the codes are padded for the card (hidden 312 and 96
    to 320 and 128; FF chunks of 300 and 96 to 320 and 128; heads of 26 and
    24 to 32, 48 to 64; two heads a group), through the public functions
    and the K-major entry points on codes padded once (the same bits),
    against the plain versions on the unpadded codes, at
    test_int8_halves_kernels_match_plain's bars."""
    attn, mlp, ln, x, mask = _int8_case(b, l, hid, ff, device, seed=b * 1000 + l + heads)
    attn_t, mlp_t = _int8_kmajor(attn, mlp)
    d = hid // heads
    attn_p = fi.pad_int8_attention(*attn_t[:4], heads) + attn_t[4:]
    mlp_p = fi.pad_int8_mlp(mlp_t[0], mlp_t[1], mlp_t[2], mlp_t[3]) + mlp_t[4:]
    for kernel, kmajor, plain, args, args_t, kw in (
            (fi.fused_attention_int8_block, fi.fused_attention_int8_block_qkv_kmajor,
             fi.reference_attention_int8_block, (*attn, mask, heads, *ln), (*attn_p, mask, heads, *ln),
             {"head_dim": d}),
            (fi.fused_mlp_int8_block, fi.fused_mlp_int8_block_kmajor, fi.reference_mlp_int8_block, (*mlp, *ln),
             (*mlp_p, *ln), {})):
        got, want = kernel(x, *args), plain(x, *args)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        assert torch.equal(kmajor(x, *args_t, **kw), got)
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        assert cos >= 0.999 and err <= 0.1, (kernel.__name__, cos, err)
        assert mean <= 5e-5, (kernel.__name__, mean)


# Heads of 128 on the 128-wide instances of the attention cores, and heads
# of 80 zero-padded to them (K1, K13, K10 forward; K12 backward), FF 4 x
# hidden; the LayerNorm backward past 1,024 columns (K11, K12 on the
# block-a-row kernel); hidden and FF widths that are not a multiple of 8
# (the products at the next one, the LayerNorm over the true width; K1, K2,
# K9, K10, K11, K12); K14 at D that is not a multiple of 8. All against the
# plain versions on the unpadded weights, at the bars of the tests above.
WIDE_HEADS = [(1024, 8, 4096), (640, 8, 2560)]
WIDE_SHAPES = [(4, 128), (3, 77), (2, 1), (1, 512)]
ODD_HIDDEN = [(100, 4, 400), (32, 4, 36), (36, 4, 37)]
ODD_HIDDEN_SHAPES = [(16, 230), (3, 77), (2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", WIDE_HEADS + ODD_HIDDEN)
def test_halves_and_mha_at_wide_heads_and_odd_widths(device, hid, heads, ff):
    """K1, K2 and K13 at heads of 128 and 80 and at hidden widths that are
    not a multiple of 8, against their plain versions: the encoder halves'
    bar (row cosine >= 0.999, max |d| <= 0.1), the output unpadded."""
    shapes = WIDE_SHAPES if hid // heads > 64 else ODD_HIDDEN_SHAPES
    for b, l in shapes:
        attn, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + hid)
        x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
        mask = torch.ones(b, l, device=device)
        mask[0, l // 2 + 1:] = 0.0
        args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"],
                attn["bo"], mask, heads, attn["ln_scale"], attn["ln_bias"])
        margs = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
        q, k, v = (torch.randn(b, l, hid, device=device).to(torch.bfloat16) for _ in range(3))
        _build.reset_launches()
        for got, want in ((fa.fused_attention_block(x, *args), fa.reference_attention_block(x, *args)),
                          (fa.fused_mlp_block(x, *margs), fa.reference_mlp_block(x, *margs)),
                          (fa.fused_mha(q, k, v, mask, heads), fa.mha_reference(q, k, v, mask, heads))):
            torch.cuda.synchronize()
            assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
            cos, err = _rows_close(got, want)
            assert cos >= 0.999 and err <= 0.1, (b, l, cos, err)
        assert (_build.LAUNCHES["fused_attention_block"], _build.LAUNCHES["fused_mlp_block"],
                _build.LAUNCHES["fused_mha"]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", WIDE_HEADS + ODD_HIDDEN)
def test_backward_halves_at_wide_heads_and_odd_widths(device, hid, heads, ff):
    """K12 (its attention core at 128, padded heads' columns exactly zero)
    and K11 at heads of 128 and 80 and at odd hidden and FF widths, every
    gradient unpadded, and the core's backward alone at the wide heads, at
    the backward's bar."""
    shapes = WIDE_SHAPES if hid // heads > 64 else ODD_HIDDEN_SHAPES
    for b, l in shapes:
        attn, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + hid + 3)
        x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
        dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
        mask = torch.ones(b, l, device=device)
        mask[0, l // 2 + 1:] = 0.0
        _build.reset_launches()
        got, want = padded_attention_bwd_pair(x, attn, mask, heads, dy)
        torch.cuda.synchronize()
        assert all(got[k].shape == want[k].shape for k in want)
        grads_close(got, want, scale_of=zero_attention_grads(l))
        got, want = mlp_bwd_pair(x, mlp, dy)
        torch.cuda.synchronize()
        assert all(got[k].shape == want[k].shape for k in want)
        grads_close(got, want)
        assert _build.LAUNCHES["fused_mlp_block_bwd"] == _build.LAUNCHES["fused_attention_block_bwd"] == 1
        if hid // heads > 64:
            g = torch.Generator(device=device).manual_seed(l + hid)
            qkv = torch.randn(b, l, 3 * hid, generator=g, device=device).to(torch.bfloat16)
            da = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
            got = fb.attention_core_bwd(qkv, mask, da, heads)
            want = fb.attention_core_bwd(qkv.cpu(), mask.cpu(), da.cpu(), heads)
            torch.cuda.synchronize()
            got = dict(zip(("dq", "dk", "dv"), got.chunk(3, dim=-1)))
            want = dict(zip(("dq", "dk", "dv"), want.to(device).chunk(3, dim=-1)))
            grads_close(got, want, scale_of={"dq": "dv", "dk": "dv"} if l == 1 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", [(1032, 12, 1032), (1536, 12, 1536), (4096, 32, 1024), (8192, 64, 512)])
@pytest.mark.parametrize("b,l", [(4, 30), (2, 77)])
def test_ln_backward_past_1024_columns(device, hid, heads, ff, b, l):
    """The LayerNorm backward on its block-a-row kernel (1,032 in 12 heads
    of 86 padded to 128, 1,536, 4,096 and 8,192 in heads of 128), through
    K11 and K12, at the backward's bar; reruns give the same bits."""
    attn, mlp = _layer_weights(hid, ff, device, seed=b * 1000 + l + hid)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    _build.reset_launches()
    got, want = mlp_bwd_pair(x, mlp, dy)
    again, _ = mlp_bwd_pair(x, mlp, dy)
    torch.cuda.synchronize()
    grads_close(got, want)
    assert all(torch.equal(got[k], again[k]) for k in got)
    got, want = padded_attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    grads_close(got, want, scale_of=zero_attention_grads(l))
    assert _build.LAUNCHES["fused_mlp_block_bwd"] == 2 and _build.LAUNCHES["fused_attention_block_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads,ff", WIDE_HEADS + ODD_HIDDEN[:2])
@pytest.mark.parametrize("b,l", [(16, 230), (3, 77), (1, 5)])
def test_int8_halves_at_wide_heads_and_odd_widths(device, hid, heads, ff, b, l):
    """K10 at heads of 128 and 80 (two heads a group) and at hidden 100 and
    32, and K9 at those widths, against the plain versions on the unpadded
    codes, at test_int8_halves_kernels_match_plain's bars."""
    attn, mlp, ln, x, mask = _int8_case(b, l, hid, ff, device, seed=b * 1000 + l + hid)
    for kernel, plain, args in (
            (fi.fused_attention_int8_block, fi.reference_attention_int8_block, (*attn, mask, heads, *ln)),
            (fi.fused_mlp_int8_block, fi.reference_mlp_int8_block, (*mlp, *ln))):
        got, want = kernel(x, *args), plain(x, *args)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        assert cos >= 0.999 and err <= 0.1, (kernel.__name__, cos, err)
        assert mean <= 5e-5, (kernel.__name__, mean)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [100, 12, 3])
def test_maxsim_kernels_at_d_not_a_multiple_of_8(device, dim):
    """K14 (all pairs and the gathered form), its training form and its
    backward at D = 100, 12 and 3, run on zero-padded columns: the scores
    at K14's bar (rtol = atol = 1e-4), the gradients cut back to D at the
    training tests' bar."""
    q, d, qm, dm = _maxsim_training_case(8, 30, 16, 77, dim, device, seed=dim)
    _build.reset_launches()
    got = ms.maxsim_all_pairs(q, d, qm, dm)
    torch.testing.assert_close(got, ms.reference_maxsim_all_pairs(q, d, qm, dm), rtol=1e-4, atol=1e-4)
    first = (torch.arange(16) * 77).reshape(2, 8)
    count = torch.full((2, 8), 70, dtype=torch.int32)
    tokens = d.reshape(-1, dim)
    got = ms.maxsim_gathered(q[:2], qm[:2], tokens, first, count, 77)
    want = ms.reference_maxsim_gathered(q[:2], qm[:2], tokens, first, count, 77)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    qg, dg = q.clone().requires_grad_(), d.clone().requires_grad_()
    torch.logsumexp(ms.maxsim_all_pairs(qg, dg, qm, dm), dim=1).sum().backward()
    pq, pd = q.clone().requires_grad_(), d.clone().requires_grad_()
    torch.logsumexp(ms.reference_maxsim_all_pairs(pq, pd, qm, dm), dim=1).sum().backward()
    torch.cuda.synchronize()
    assert qg.grad.shape == q.shape and dg.grad.shape == d.shape
    torch.testing.assert_close(qg.grad, pq.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dg.grad, pd.grad, rtol=1e-4, atol=1e-4)
    assert (_build.LAUNCHES["maxsim_all_pairs"], _build.LAUNCHES["maxsim_all_pairs_argmax"],
            _build.LAUNCHES["maxsim_all_pairs_bwd"]) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cols,groups,padded", [(torch.bfloat16, 312, 1, 320), (torch.float32, 312, 6, 64),
                                                      (torch.float32, 384, 12, 64)])
def test_int8_quantize_kernel_writes_a_padded_row_stride(device, dtype, cols, groups, padded):
    """The activation quantizer writing each group's codes into a padded
    stride (x's 312 into 320; six groups of 52 into 64): the plain
    version's codes and scales, zero codes in the padding."""
    x = (torch.randn(1000, cols, device=device) * 3).to(dtype)
    x[7] = 0.0
    q, s = fi._quant_groups_cuda(x, groups, padded)
    w = cols // groups
    parts = [fi._quant_rows(x[:, g * w:(g + 1) * w].float()) for g in range(groups)]
    assert tuple(q.shape) == (1000, groups * padded)
    assert torch.equal(s, torch.cat([p[1] for p in parts], dim=1))
    q = q.reshape(1000, groups, padded)
    assert torch.equal(q[:, :, :w], torch.stack([p[0] for p in parts], dim=1))
    assert not q[:, :, w:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bq,lq,bd,ld,dim", [(1, 32, 64, 128, 768), (2, 200, 9, 77, 768), (3, 129, 5, 40, 1024),
                                             (2, 512, 3, 64, 8), (4, 13, 7, 30, 264)])
def test_maxsim_kernel_takes_wide_and_long_queries(device, bq, lq, bd, ld, dim):
    """K14 past its old limits (D <= 256, Lq <= 128): D = 768 (ColBERT's
    default width) and 1,024 streamed in slabs, Lq > 128 in several row
    tiles, up to 512; rtol = atol = 1e-4 against the plain version."""
    q, d, qm, dm = _maxsim_case(bq, lq, bd, ld, dim, device, seed=lq + dim)
    for fill in (ms.NEG_FILL, float("-inf")):
        got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
        want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_maxsim_all_pairs_at_200_query_tokens_matches_plain(device):
    """maxsim_all_pairs with Lq = 200 (two row tiles a query) at the ColBERT
    width 128 against the plain version, rtol = atol = 1e-4."""
    q, d, qm, dm = _maxsim_case(6, 200, 33, 180, 128, device, seed=200)
    got = ms.maxsim_all_pairs(q, d, qm, dm)
    torch.testing.assert_close(got, ms.reference_maxsim_all_pairs(q, d, qm, dm), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 768])
def test_maxsim_kernel_reruns_are_bit_identical(device, dim):
    """Lq > 128: each query sums its row tiles' maxima in a fixed order, so
    two runs give the same bits; the all-pairs form (queries packed in a
    tile, docs shared) and the gathered form (one query a block, each
    query's own spans) of the same docs, padded at the end, give the same
    bits too: every row's sums run in the same order."""
    q, d, qm, dm = _maxsim_case(3, 300, 17, 90, dim, device, seed=dim)
    first = ms.maxsim_all_pairs(q, d, qm, dm)
    assert torch.equal(first, ms.maxsim_all_pairs(q, d, qm, dm))
    for lq in (32, 300):
        count = torch.randint(0, 91, (17,), device=device, dtype=torch.int32)
        prefix = (torch.arange(90, device=device)[None, :] < count[:, None]).float()
        spans = (torch.arange(17, device=device) * 90)[None, :].expand(3, 17)
        pairs = ms.maxsim_all_pairs(q[:, :lq], d, qm[:, :lq], prefix, fill=float("-inf"))
        gathered = ms.maxsim_gathered(q[:, :lq], qm[:, :lq], d.reshape(-1, dim), spans.cpu(),
                                      count[None, :].expand(3, 17).cpu(), 90, fill=float("-inf"))
        torch.cuda.synchronize()
        assert torch.equal(pairs, gathered)


def _gathered_case(b, lq, c, dim, pad, device, seed, f16=True):
    """Queries with padded tokens, a token matrix (float16 or f32) of 50
    documents of 0..pad tokens and each query's own candidate spans, one
    of them empty (count 0), on the CPU as maxsim_gathered takes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    counts = torch.randint(0, pad + 1, (50,), generator=g, device=device)
    counts[3] = 0
    starts = torch.cumsum(counts, 0) - counts
    tokens = torch.randn(int(counts.sum()), dim, generator=g, device=device) * 3
    tokens = tokens.half() if f16 else tokens
    pick = torch.randint(0, 50, (b, c), generator=g, device=device)
    pick[0, 0] = 3
    q = torch.randn(b, lq, dim, generator=g, device=device) * 3
    qm = (torch.rand(b, lq, generator=g, device=device) > 0.2).float()
    qm[:, 0] = 1.0
    return q, qm, tokens, starts[pick].cpu(), counts[pick].int().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,c,dim,pad", [(256, 32, 64, 128, 128), (5, 32, 64, 768, 128), (3, 200, 17, 128, 77),
                                            (2, 512, 9, 768, 40), (7, 13, 33, 264, 200)])
@pytest.mark.parametrize("f16", [True, False])
def test_maxsim_gathered_matches_plain_on_the_padded_copy(device, b, lq, c, dim, pad, f16):
    """K14's gathered form (the batched rescore's: a query's own candidate
    spans of one token matrix, padded slots -inf or -1000) against
    reference_maxsim_all_pairs on the padded copy of each query's
    candidates: rtol = atol = 1e-4, non-finite entries identical (an empty
    candidate with fill -inf); 768 wide, Lq 200 and 512; float16 and f32
    tokens; one launch; reruns bit-identical; spans on the card refused
    (they are checked on the CPU before the launch)."""
    q, qm, tokens, first, count = _gathered_case(b, lq, c, dim, pad, device, seed=b + lq + dim)
    if not f16:
        tokens = tokens.float()
    with pytest.raises(ValueError, match="on the CPU"):
        ms.maxsim_gathered(q, qm, tokens, first.to(device), count.to(device), pad)
    for fill in (ms.NEG_FILL, float("-inf")):
        _build.reset_launches()
        got = ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill)
        assert _build.LAUNCHES["maxsim_all_pairs"] == 1
        slots = torch.arange(pad, device=device)
        rows = (first.to(device)[..., None] + slots).clamp(max=tokens.shape[0] - 1)
        live = (slots < count.to(device)[..., None]).float()
        want = torch.stack([ms.reference_maxsim_all_pairs(q[i:i + 1], tokens[rows[i]].float(), qm[i:i + 1],
                                                          live[i], fill)[0]
                            for i in range(b)])
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
        assert torch.equal(got, ms.maxsim_gathered(q, qm, tokens, first, count, pad, fill=fill))
    assert bool(torch.isneginf(got[0, 0]))  # the empty candidate, fill -inf


@pytest.mark.cuda
def test_batched_rescore_matches_the_per_query_rescore(device, tmp_path):
    """The ColBERT CLI's batched rescore (one K14 launch for the batch, the
    store's float16 rows uploaded once) against the per-query exact_rescore
    on the card (one launch each): the same documents in the same order,
    scores within 1e-5 relative."""
    import numpy as np

    from matchmaker_tpu_torch.retrieval import colbert_search as cs

    rng = np.random.default_rng(128)
    ids = _write_token_store(str(tmp_path), rng, 128)
    store = cs.TokenVectorStore(str(tmp_path))
    q = rng.normal(size=(24, 32, 128)).astype(np.float32)
    qm = np.ones((24, 32), np.float32)
    qm[:, 20:] = 0
    cands = [[(ids[i], 0.0) for i in rng.permutation(40)[:rng.integers(1, 41)]] for _ in range(24)]
    pad_t = -(-store.max_tokens // 8) * 8
    _build.reset_launches()
    got = cs.exact_rescore_batch(torch.from_numpy(q).to(device), qm, cands, store, 10, 32, pad_t,
                                 store.device_rows(device))
    assert _build.LAUNCHES["maxsim_all_pairs"] == 1
    for i in range(24):
        want = cs.exact_rescore(q[i], qm[i], cands[i], store, 10, 32, pad_t, device=device)
        assert [d for d, _ in got[i]] == [d for d, _ in want]
        np.testing.assert_allclose([s for _, s in got[i]], [s for _, s in want], rtol=1e-5, atol=0)


def _write_token_store(folder, rng, dim, n_docs=40):
    """An encode folder by hand (token_reps blocks, doc_infos, encode_meta):
    docs of 1-150 float16 token vectors, doc 5 with none."""
    import json

    import numpy as np

    os.makedirs(folder, exist_ok=True)
    parts, spans, ids, start = [], [], [], 0
    for i in range(n_docs):
        n = 0 if i == 5 else int(rng.integers(1, 151))
        parts.append(rng.normal(size=(n, dim)).astype(np.float16))
        spans.append((0, start, start + n))
        ids.append(f"d{i}")
        start += n
    np.save(os.path.join(folder, "token_reps_0.npy"), np.concatenate(parts))
    np.savez_compressed(os.path.join(folder, "doc_infos.npz"), ids=np.array(ids), spans=np.array(spans))
    with open(os.path.join(folder, "encode_meta.json"), "w") as f:
        json.dump({"dim": dim, "dtype": "float16", "blocks": 1, "sequences": n_docs}, f)
    return ids


@pytest.mark.cuda
def test_exact_rescore_at_768_wide_matches_plain(device, tmp_path):
    """The repaired fault: ColBERT's exact rescore with 768-wide token
    vectors (colbert_compression_dim 768) runs K14 on the card and agrees
    with the plain version on the CPU, rtol = atol = 1e-4; a document with
    no token scores 0."""
    import numpy as np

    from matchmaker_tpu_torch.retrieval import colbert_search as cs

    rng = np.random.default_rng(768)
    ids = _write_token_store(str(tmp_path), rng, 768)
    store = cs.TokenVectorStore(str(tmp_path))
    q = rng.normal(size=(32, 768)).astype(np.float32)
    qm = np.ones(32, np.float32)
    qm[20:] = 0
    cands = [(doc, 0.0) for doc in ids]
    _build.reset_launches()
    got = cs.exact_rescore(q, qm, cands, store, 40, 64, 128, device=device)
    assert _build.LAUNCHES["maxsim_all_pairs"] == 1
    want = cs.exact_rescore(q, qm, cands, store, 40, 64, 128, device=torch.device("cpu"))
    assert {d for d, _ in got} == {d for d, _ in want} and dict(got)["d5"] == 0.0
    np.testing.assert_allclose([dict(got)[d] for d, _ in want], [s for _, s in want], rtol=1e-4, atol=1e-4)


# ---- the probes' kernels (K15-K18) ---------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["batched", "f32_p", "softmax_stub"])
@pytest.mark.parametrize("b,l", [(2, 200), (3, 77), (1, 512), (2, 1)])
def test_probe_attn_inner_kernel_matches_plain(device, variant, b, l):
    """K15 against its plain version, each variant against its own (the
    stub against the stub), padded keys in example 0: K13's bar (row cosine
    >= 0.999, max |d| <= 0.1)."""
    from matchmaker_tpu_torch.probes import attn_inner as ai

    g = torch.Generator(device=device).manual_seed(b * 1000 + l)
    q, k, v = (torch.randn(b, l, 768, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    _build.reset_launches()
    got = ai.attn_inner(q, k, v, mask, variant)
    want = ai.reference_attn_inner(q, k, v, mask, variant)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_inner"] == 1 and got.dtype == torch.bfloat16
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
def test_probe_attn_inner_f32_p_keeps_the_f32_agreement(device):
    """P as bf16 hi + lo carries 16 mantissa bits: against the f32-P plain
    version the f32_p kernel is closer than the bf16-P kernel."""
    from matchmaker_tpu_torch.probes import attn_inner as ai

    g = torch.Generator(device=device).manual_seed(7)
    q, k, v = (torch.randn(4, 200, 768, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(4, 200, device=device)
    want = ai.reference_attn_inner(q, k, v, mask, "f32_p").float()
    err_hi_lo = float((ai.attn_inner(q, k, v, mask, "f32_p").float() - want).abs().mean())
    err_bf16 = float((ai.attn_inner(q, k, v, mask, "batched").float() - want).abs().mean())
    assert err_hi_lo < err_bf16, (err_hi_lo, err_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["batched", "f32_p", "softmax_stub"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l", [1, 16, 64, 65, 77, 200, 208, 256, 257, 512])
def test_probe_attn_inner_kernel_at_every_key_chunking(device, variant, masked, l):
    """K15 at the lengths where its plan changes (one to four 64-key chunks
    in registers, the two-half form past 256 keys, partial and whole
    8-key groups past L), masked (a random length >= L/4 a row) and not,
    against its plain version at K13's bar; q, k, v as the probe draws
    them."""
    from matchmaker_tpu_torch.probes import attn_inner as ai

    g = torch.Generator(device=device).manual_seed(l * 10 + masked)
    b = 3
    q, k, v = ((torch.randn(b, l, 768, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(b, l, device=device)
    if masked:
        lengths = torch.randint(max(1, l // 4), l + 1, (b,), generator=g, device=device)
        mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).float()
    _build.reset_launches()
    got = ai.attn_inner(q, k, v, mask, variant)
    want = ai.reference_attn_inner(q, k, v, mask, variant)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["attn_inner"] == 1 and got.shape == q.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["batched", "f32_p"])
@pytest.mark.parametrize("l", [77, 200, 300])
def test_probe_attn_inner_all_masked_row_is_the_uniform_average(device, variant, l):
    """An example whose keys are all masked: every score takes the same
    additive -1e9, so its rows average v over the L keys, as the plain
    version does (padding past L takes -inf and stays out)."""
    from matchmaker_tpu_torch.probes import attn_inner as ai

    g = torch.Generator(device=device).manual_seed(l)
    q, k, v = ((torch.randn(2, l, 768, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(2, l, device=device)
    mask[1] = 0.0
    got = ai.attn_inner(q, k, v, mask, variant)
    want = ai.reference_attn_inner(q, k, v, mask, variant)
    mean_v = v[1].float().mean(dim=0, keepdim=True).expand(l, -1)
    cos, err = _rows_close(got, want)
    assert cos >= 0.999 and err <= 0.1, (cos, err)
    cos, err = _rows_close(got[1], mean_v)
    assert cos >= 0.999 and err <= 0.02, (cos, err)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [200, 512])
def test_probe_kernels_reruns_are_bit_identical(device, l):
    """K15 (each variant), K16, K17 and K18 (one launch a call) give the
    same bits on a rerun: no atomics, no order that depends on
    scheduling."""
    from matchmaker_tpu_torch.probes import attn_inner as ai
    from matchmaker_tpu_torch.probes import int8_matmul as im
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    g = torch.Generator(device=device).manual_seed(l)
    q, k, v = ((torch.randn(4, l, 768, generator=g, device=device) * 0.3).to(torch.bfloat16) for _ in range(3))
    mask = torch.ones(4, l, device=device)
    mask[0, l // 3:] = 0.0
    for variant in ai.VARIANTS:
        first = ai.attn_inner(q, k, v, mask, variant)
        assert torch.equal(first, ai.attn_inner(q, k, v, mask, variant)), variant
    xq = torch.randint(-127, 128, (4 * l, 768), generator=g, device=device, dtype=torch.int8)
    wq_t = torch.randint(-127, 128, (3072, 768), generator=g, device=device, dtype=torch.int8)
    assert torch.equal(im.int8_matmul(xq, wq_t), im.int8_matmul(xq, wq_t))
    # K17/K18: the cluster's LayerNorm sums its four CTAs' partials in one order
    _, mlp = _layer_weights(768, 3072, device, seed=l)
    weights = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    x = torch.randn(4, l, 768, generator=g, device=device).to(torch.bfloat16)
    for name, fn in (("mlp_rows2d", mr.mlp_rows2d), ("mlp_rowsblk", mr.mlp_rowsblk)):
        _build.reset_launches()
        first = fn(x, *weights)
        assert _build.LAUNCHES[name] == 1, name
        assert torch.equal(first, fn(x, *weights)), name


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 129, 1000])
@pytest.mark.parametrize("n", [8, 40, 264])
@pytest.mark.parametrize("k", [32, 96, 768])
def test_probe_int8_matmul_at_tile_and_box_edges(device, m, n, k):
    """K16 bit-identical to its plain version where a 128-row tile, a
    128-column tile, a 32-column store box or a 128-byte K stage is cut by
    the tensor's edge."""
    from matchmaker_tpu_torch.probes import int8_matmul as im

    g = torch.Generator(device=device).manual_seed(m * 7 + n * 3 + k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    wq_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    _build.reset_launches()
    got = im.int8_matmul(xq, wq_t)
    assert _build.LAUNCHES["int8_matmul"] == 1 and got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, im.reference_int8_matmul(xq, wq_t))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(16384, 768, 3072), (1000, 768, 3072), (129, 96, 40), (1, 32, 8)])
def test_probe_int8_matmul_kernel_is_exact(device, m, k, n):
    """K16 bit-identical to its plain version (a float64 product, exact
    here), ragged M and N tiles and a K tail of 32 included."""
    from matchmaker_tpu_torch.probes import int8_matmul as im

    g = torch.Generator(device=device).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    wq_t = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8)
    _build.reset_launches()
    got = im.int8_matmul(xq, wq_t)
    assert _build.LAUNCHES["int8_matmul"] == 1 and got.dtype == torch.int32
    assert torch.equal(got, im.reference_int8_matmul(xq, wq_t))
    with pytest.raises(ValueError, match="K % 32"):
        im.int8_matmul(xq[:, :16].contiguous(), wq_t[:, :16].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("ff", [3072, 1536])
@pytest.mark.parametrize("b,l,block_r", [(1, 1, 1), (1, 127, 1), (1, 128, 1), (1, 129, 1), (1, 513, 1),
                                         (16, 77, 1024), (3, 30, 1024)])
def test_probe_mlp_rows_kernels_match_plain(device, b, l, block_r, ff):
    """K17 and K18 (one cluster kernel) against their plain version through
    both wrappers' paddings: K2's bar (row cosine >= 0.999, max |d| <= 0.1).
    K18 with block_r 1 hands the kernel exactly B*L rows: one row, a
    128-row cluster tile short by one, whole, one over, and four tiles and
    one row; 16 x 77 and 3 x 30 are the probes' odd shapes (K17 pads them to
    1,280 and 256 rows). FF 1,536 takes six rounds of 256 instead of
    twelve."""
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    _, mlp = _layer_weights(768, ff, device, seed=b + l + ff)
    weights = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    x = torch.randn(b, l, 768, device=device).to(torch.bfloat16)
    want = mr.reference_mlp_rows(x, *weights)
    _build.reset_launches()
    for name, got in (("mlp_rows2d", mr.mlp_rows2d(x, *weights)),
                      ("mlp_rowsblk", mr.mlp_rowsblk(x, *weights, block_r=block_r))):
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        cos, err = _rows_close(got, want)
        assert cos >= 0.999 and err <= 0.1, (name, cos, err)
    assert _build.LAUNCHES["mlp_rows2d"] == 1 and _build.LAUNCHES["mlp_rowsblk"] == 1
    with pytest.raises(ValueError, match="hid 768"):
        mr.mlp_rowsblk(x[..., :512].contiguous(), mlp["w1"][:512].contiguous(), mlp["b1"],
                       mlp["w2"][:, :512].contiguous(), *(t[:512] for t in weights[3:]))
    with pytest.raises(ValueError, match="multiple of 256"):
        mr.mlp_rowsblk(x, mlp["w1"][:, :128].contiguous(), mlp["b1"][:128], mlp["w2"][:128].contiguous(),
                       *weights[3:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attn_inner", "int8_matmul", "mlp_rows"])
def test_probe_main_runs_on_the_card(device, name, capsys):
    """Each probe's main() on the card at a small shape: its kernel launched,
    one JSON line with the card's rates."""
    import importlib
    import json

    probe = importlib.import_module(f"matchmaker_tpu_torch.probes.{name}")
    argv = {"attn_inner": ["--rows", "8", "--len", "77"], "int8_matmul": ["--m", "1000"],
            "mlp_rows": ["--batch", "4"]}[name] + ["--iters", "3"]
    _build.reset_launches()
    result = probe.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result
    counters = {"attn_inner": ["attn_inner"], "int8_matmul": ["int8_matmul"],
                "mlp_rows": ["mlp_rows2d", "mlp_rowsblk"]}[name]
    assert all(_build.LAUNCHES[c] > 0 for c in counters)


@pytest.mark.parametrize("module", ["matchmaker_tpu_torch.cli.dense_retrieval", "matchmaker_tpu_torch.cli.train",
                                    "matchmaker_tpu_torch.training.trainer", "matchmaker_tpu_torch.retrieval.indexes",
                                    "matchmaker_tpu_torch.ops.fused_int8",
                                    "matchmaker_tpu_torch.retrieval.colbert_search",
                                    "matchmaker_tpu_torch.probes.attn_inner", "matchmaker_tpu_torch.probes.int8_matmul",
                                    "matchmaker_tpu_torch.probes.mlp_rows"])
def test_cli_import_loads_no_jax_flax_or_yaml(module):
    """The machine with the card has no jax, flax, optax or PyYAML, and the
    port depends on nothing of the JAX package: the port's entry points must
    import none of them, ``matchmaker_tpu`` included."""
    code = (f"import sys, {module}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'optax', 'yaml', 'matchmaker_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


# ---- the re-rankers' shapes (cross-encoder 30 + 200 = 230 tokens, maxP /
# PARADE chunks 30 + 50 + 2 x 7 = 94, PreTTR's towers and their join) --------

RERANK_SHAPES = [(16, 230), (3, 230), (64, 94), (5, 94)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", RERANK_SHAPES)
def test_halves_and_backward_at_the_rerankers_lengths(device, b, l):
    """K1/K2 and K12/K11 at L = 230 (a partial 64-key tile, 3,680 rows at
    B = 16: a partial 128-row GEMM tile) and L = 94, padded keys in one
    example, against the plain versions at the encoder halves' bars."""
    hid, heads = 768, 12
    attn, mlp = _layer_weights(hid, 3072, device, seed=b * 1000 + l + 7)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, 31:] = 0.0  # a query with an empty document
    mask[-1, l - 17:] = 0.0
    args = (attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"], attn["bk"], attn["bv"], attn["bo"], mask,
            heads, attn["ln_scale"], attn["ln_bias"])
    margs = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    for got, want in ((fa.fused_attention_block(x, *args), fa.reference_attention_block(x, *args)),
                      (fa.fused_mlp_block(x, *margs), fa.reference_mlp_block(x, *margs))):
        cos, err = _rows_close(got, want)
        assert cos >= 0.999 and err <= 0.1, (cos, err)
    grads_close(*attention_bwd_pair(x, attn, mask, heads, dy), scale_of=zero_attention_grads(l))
    grads_close(*mlp_bwd_pair(x, mlp, dy))


def _plain_halves(monkeypatch):
    """Route the encoder's fused halves to their plain versions (forward and,
    under autograd, PyTorch's own backward), on the card."""
    import matchmaker_tpu_torch.models.encoder as enc

    def plain_attention(x, wqkv, bqkv, wo, bo, *rest, **kw):  # the weights as packed, heads padded or not
        wq, wk, wv = wqkv.chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return fa.reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, *rest, **kw)

    for name, fn in (("fused_attention_block_qkv", plain_attention), ("fused_mlp_block", fa.reference_mlp_block),
                     ("fused_attention_block_qkv_train", plain_attention),
                     ("fused_mlp_block_train", fa.reference_mlp_block)):
        monkeypatch.setattr(enc, name, fn)


@pytest.mark.cuda
def test_prettr_join_through_the_fused_halves(device, monkeypatch):
    """A DistilBERT-width PreTTR (2 layers, joined after 1): the towers at 30
    and 200 tokens and their join at 230 through K1/K2 and K12/K11. A
    non-contiguous join gives the same bits as a contiguous one; the score
    and every gradient agree with the plain versions'."""
    from matchmaker_tpu_torch.models.prettr import PreTTR

    model = PreTTR(EncoderConfig.distilbert(fused_attention=True, num_layers=2), 1, torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(3))
    model.to(device)
    g = torch.Generator(device=device).manual_seed(4)
    batch = {"query_ids": torch.randint(1000, 30522, (4, 30), generator=g, device=device),
             "doc_ids": torch.randint(1000, 30522, (4, 200), generator=g, device=device),
             "query_mask": torch.ones(4, 30, device=device), "doc_mask": torch.ones(4, 200, device=device)}
    batch["query_mask"][1, 6:] = 0
    batch["doc_mask"][2, 90:] = 0
    enc = model.encoder
    with torch.no_grad():
        low = enc.encode_layers(enc.embed(batch["doc_ids"]), batch["doc_mask"], 0, 1)
        strided = low.transpose(0, 1).contiguous().transpose(0, 1)
        assert not strided.is_contiguous()
        assert torch.equal(enc.encode_layers(strided, batch["doc_mask"], 1, 2),
                           enc.encode_layers(low, batch["doc_mask"], 1, 2))

    def run():
        model.zero_grad(set_to_none=True)
        score = model(batch)["score"]
        score.float().square().sum().backward()
        return score.detach().float(), {n: p.grad.float().clone() for n, p in model.named_parameters()}

    _build.reset_launches()
    got, got_g = run()
    assert _build.LAUNCHES["fused_attention_block"] == 3 and _build.LAUNCHES["fused_attention_block_bwd"] == 3
    _plain_halves(monkeypatch)
    want, want_g = run()
    assert float((got - want).abs().max()) <= 0.1 * max(1.0, float(want.abs().max()))
    for name, a in got_g.items():
        if name.endswith("attention.key.bias"):
            continue  # zero in exact arithmetic: rounding noise only
        cos = float(torch.nn.functional.cosine_similarity(a.reshape(-1), want_g[name].reshape(-1), dim=0))
        assert cos >= 0.99, (name, cos)


@pytest.mark.cuda
def test_score_triples_on_the_card_matches_plain(device, tmp_path, monkeypatch):
    """cli.score_teacher's score_triples with a DistilBERT BERT_CAT (230
    tokens) on the card against the plain versions' scores of the same
    pairs: cosine >= 0.999, max |d| <= 0.1 x max(1, max |score|) (the
    encoder halves' bar, relative as in the PreTTR join's test: a score
    head of std 1 gives scores of tens)."""
    from matchmaker_tpu_torch.cli.score_teacher import score_triples
    from matchmaker_tpu_torch.data.synthetic import make_planted_corpus
    from matchmaker_tpu_torch.models.bert_cat import BertCat
    from matchmaker_tpu_torch.models.weights import save_npz

    config = {"model": "bert_cat", "model_input_type": "concatenated", "bert_pretrained_model": "distilbert-base-uncased",
              "encoder_fused_attention": True, "use_fp16": True, "max_query_length": 30, "max_doc_length": 200,
              "device": "cuda"}
    teacher = BertCat(EncoderConfig.distilbert(fused_attention=True), torch.bfloat16)
    init_parameters(teacher, torch.Generator().manual_seed(5))
    torch.nn.init.normal_(teacher.score_layer.kernel, std=1.0, generator=torch.Generator().manual_seed(6))
    save_npz(str(tmp_path / "best-model.npz"), teacher.state_dict())
    paths = make_planted_corpus(str(tmp_path / "corpus"), n_train_queries=20, n_eval_queries=2, n_docs=50, seed=6)
    scores = []
    for plain in (False, True):
        if plain:
            _plain_halves(monkeypatch)
        out = tmp_path / f"scores_{plain}.tsv"
        _build.reset_launches()
        assert score_triples(str(tmp_path), paths["train_tsv"], str(out), batch_size=16, config=config) == 60
        assert (_build.LAUNCHES["fused_attention_block"] > 0) != plain
        with open(out) as f:
            scores.append(torch.tensor([[float(c) for c in line.split("\t")[:2]] for line in f]).reshape(-1))
    cos = float(torch.nn.functional.cosine_similarity(scores[0], scores[1], dim=0))
    err = float((scores[0] - scores[1]).abs().max())
    assert cos >= 0.999 and err <= 0.1 * max(1.0, float(scores[1].abs().max())), (cos, err)


# ---- the kernel-pooling family and IDCM ------------------------------------------

def exact_match_activations(model, name, ids, mask):
    """The exact-match kernel's (mu 1, sigma 1e-4) activation of each live
    token against itself, query and document the same tokens, through the
    model's own representation and ``cosine_match_matrix``: KNRM's
    embeddings, Conv-KNRM's 2-gram convolution, TK's contextualization
    (document positions as the query's, so the two sides are the same)."""
    from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix, kernel_activations

    with torch.no_grad():
        emb = model.embedder(ids, mask)
        if name == "knrm":
            q = d = emb
        elif name == "conv_knrm":
            q = d = torch.relu(model.conv_2gram(emb))
        else:
            q = d = model.contextualize(emb, mask, model.pos_q)
        acts = kernel_activations(cosine_match_matrix(q, d), model.mu, model.sigma)[..., 0]
    return torch.diagonal(acts, dim1=1, dim2=2)[mask > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["knrm", "conv_knrm", "tk"])
def test_exact_match_kernel_survives_on_the_card(device, name):
    """300-d embeddings (configs/train/defaults.yaml), the repo's TK (2
    layers, 10 heads, FF 100): every live token's exact-match activation
    against itself >= 0.99 on the card (the cosine and the convolutions are
    full f32); the same cosine as a TF32 product turns the kernel off for
    some token, which is what the guard is for."""
    from matchmaker_tpu_torch.models import conv_knrm, knrm, tk

    cls = {"knrm": knrm.KNRM, "conv_knrm": conv_knrm.ConvKNRM, "tk": tk.TK}[name]
    kw = dict(att_heads=10, att_ff_dim=100, use_diff_posencoding=False) if name == "tk" else {}
    model = cls(5000, 300, **kw)
    init_parameters(model, torch.Generator().manual_seed(1))
    model.to(device)
    g = torch.Generator(device=device).manual_seed(2)
    ids = torch.randint(2, 5000, (8, 30), generator=g, device=device)
    mask = torch.ones(8, 30, device=device)
    mask[3, 11:] = 0
    ids[mask == 0] = 0
    acts = exact_match_activations(model, name, ids, mask)
    assert float(acts.min()) >= 0.99, float(acts.min())
    if name == "knrm":
        from matchmaker_tpu_torch.ops.kernel_pooling import l2_normalize_rows

        emb = l2_normalize_rows(model.embedder(ids, mask).detach())
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            tf32 = torch.matmul(emb, emb.transpose(1, 2))
        finally:
            torch.set_float32_matmul_precision(prev)
        tf32_acts = torch.exp(-((torch.diagonal(tf32, dim1=1, dim2=2)[mask > 0] - 1.0) ** 2) / (2 * 1e-4 ** 2))
        assert float(tf32_acts.min()) < 0.99, float(tf32_acts.min())


@pytest.mark.cuda
def test_idcm_cascade_on_the_card_matches_plain(device, monkeypatch):
    """A DistilBERT-width IDCM (2 layers, bf16, fused halves, ``ck``
    sampler, ``sample_n`` 3) over documents of 400 tokens (8 chunks of 50 +
    2 x 7), one with a single live chunk: K1/K2 once a layer for the
    selected chunks (B x 3 rows of 30 + 64 tokens), the sampler none; the
    scores against the plain versions' at the encoder halves' bar, relative
    as in the PreTTR join's test."""
    from matchmaker_tpu_torch.models.idcm import IDCM

    model = IDCM(EncoderConfig.distilbert(fused_attention=True, num_layers=2), sample_n=3, compute_dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(3))
    torch.nn.init.normal_(model.classification_layer.kernel, std=1.0, generator=torch.Generator().manual_seed(4))
    model.to(device).eval()
    g = torch.Generator(device=device).manual_seed(5)
    batch = {"query_ids": torch.randint(1000, 30522, (16, 30), generator=g, device=device),
             "doc_ids": torch.randint(1000, 30522, (16, 400), generator=g, device=device),
             "query_mask": torch.ones(16, 30, device=device), "doc_mask": torch.ones(16, 400, device=device)}
    batch["query_mask"][1, 6:] = 0
    batch["doc_mask"][2, 40:] = 0
    scores = []
    for plain in (False, True):
        if plain:
            _plain_halves(monkeypatch)
        _build.reset_launches()
        with torch.inference_mode():
            out = model(batch)
        assert _build.LAUNCHES["fused_attention_block"] == (0 if plain else 2)
        assert _build.LAUNCHES["fused_mlp_block"] == (0 if plain else 2)
        assert out["passage_scores"].shape == (16, 3)
        scores.append(out["score"].float())
    cos = float(torch.nn.functional.cosine_similarity(scores[0], scores[1], dim=0))
    err = float((scores[0] - scores[1]).abs().max())
    assert cos >= 0.999 and err <= 0.1 * max(1.0, float(scores[1].abs().max())), (cos, err)


# ---- the index layer on the card -------------------------------------------------

def _same_hits(got, want, rtol=1e-5, atol=1e-6):
    """Two searches' (scores, ids): scores within rtol / atol, ids equal but
    where a score ties a neighbour's within that tolerance (f32 sums in
    another order may swap them)."""
    import numpy as np

    (gv, gi), (wv, wi) = got, want
    gv, wv = np.asarray(gv, np.float64), np.asarray(wv, np.float64)
    finite = np.isfinite(wv)
    assert (np.isfinite(gv) == finite).all()
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(wv)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(wv, axis=1))
    near = np.zeros_like(finite)
    near[:, 1:] |= gap <= tol[:, 1:]
    near[:, :-1] |= gap <= tol[:, :-1]
    assert not ((np.asarray(gi) != np.asarray(wi)) & ~near).any()


def _index_corpus(n=20000, d=64, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    rows = centers[rng.integers(0, 32, n)] + 0.5 * rng.normal(size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = rows[rng.integers(0, n, 16)] + 0.05 * rng.normal(size=(16, d)).astype(np.float32)
    return rows, queries


_CARD_INDEXES = {
    "ivf": {"faiss_index_type": "ivf", "faiss_ivf_list_count": 64, "faiss_ivf_nprobe": 8},
    "ivf-float32": {"faiss_index_type": "ivf", "faiss_ivf_list_count": 64, "faiss_ivf_nprobe": 8,
                    "token_dtype": "float32"},
    "tree_ah": {"faiss_index_type": "scann", "scann_backend": "tree_ah", "scann_leaves_to_search": 20,
                "scann_reorder_mult": 2},
    "float16-scan": {"mips_quantization": "float16", "mips_kernel": "scan", "mips_block_size": 8192},
    "int8-scan-twostage": {"mips_quantization": "int8", "mips_kernel": "scan", "mips_twostage": True,
                           "mips_rescore_dtype": "float16", "mips_block_size": 8192},
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_CARD_INDEXES))
def test_index_search_on_the_card_matches_the_cpu(device, kind, tmp_path):
    """IVF (16-bit and f32 storage) and tree-AH built on the CPU, saved, and
    loaded into an index on the card; FlatIndex's scan routes built from the
    same rows on both: the card's search and search_rows equal the CPU's
    (ids but near-ties, scores to 1e-5 relative). No kernel is launched."""
    import numpy as np

    from matchmaker_tpu_torch.retrieval.indexes import build_index

    rows, queries = _index_corpus()
    config = _CARD_INDEXES[kind]
    cpu = build_index(config, "cpu")
    cpu.prepare(rows.shape[1])
    cpu.index(np.arange(len(rows)), rows)
    card = build_index(config, device)
    if hasattr(cpu, "storage_bytes"):
        cpu.save(str(tmp_path))
        card.load(str(tmp_path))
    else:
        card.index(np.arange(len(rows)), rows)
    _build.reset_launches()
    for top_n in (10, 100):
        _same_hits(card.search(queries, top_n), cpu.search(queries, top_n))
        if kind.startswith("ivf"):
            _same_hits(card.search_rows(queries, top_n), cpu.search_rows(queries, top_n))
    assert not any(_build.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("route", [{"mips_quantization": "float16"}, {"mips_quantization": "int8"},
                                   {"mips_quantization": "int8", "mips_int8_queries": "float"},
                                   {"mips_quantization": "int8", "mips_twostage": True}])
def test_binmax_routes_take_rows_off_the_scans_width_grain(device, route):
    """FlatIndex's binmax routes over 312-wide rows (TinyBERT's; the scans
    take widths in whole steps of 32 or 64): on the card the rows' columns
    are zero-padded to 320 at upload and the queries at search, so the hits
    are bit for bit those of the same rows and queries padded by the
    caller, the scan kernel runs, and recall@100 against the exact f32
    search is at the binmax floor (0.95, tests/test_binmax_recall.py:99)."""
    import numpy as np

    from matchmaker_tpu_torch.retrieval.indexes import build_index

    rows, queries = _index_corpus(n=32768, d=312)
    config = dict(route, faiss_index_type="flat", mips_kernel="binmax")
    results = []
    for r, q in ((rows, queries), (np.pad(rows, ((0, 0), (0, 8))), np.pad(queries, ((0, 0), (0, 8))))):
        index = build_index(config, device)
        index.prepare(r.shape[1])
        index.index(np.arange(len(r)), r)
        _build.reset_launches()
        results.append(index.search_rows(q, 100))
        assert sum(v for k, v in _build.LAUNCHES.items() if k.startswith("binmax_candidates")) == 1
    (gv, gi), (wv, wi) = results
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    exact = np.argsort(-(queries @ rows.T), axis=1, kind="stable")[:, :100]
    ids = index._ids[gi]
    recall = np.mean([len(set(a) & set(b)) / 100 for a, b in zip(ids, exact)])
    assert recall >= 0.95, recall


@pytest.mark.cuda
def test_streaming_search_on_the_card_syncs_only_at_the_end(device, tmp_path):
    """The streaming index over 1 block and over 8 blocks of the same rows
    on the card: the CPU's results, and as many synchronising calls under
    ``torch.cuda.set_sync_debug_mode("warn")`` for 8 blocks as for 1 (none
    in the block loop)."""
    import json
    import warnings

    import numpy as np

    from matchmaker_tpu_torch.retrieval.encode import BlockWriter
    from matchmaker_tpu_torch.retrieval.indexes import StreamingFlatIndex

    rows, queries = _index_corpus(n=16000)
    writer = BlockWriter(str(tmp_path), rows.shape[1], 2000)
    spans = [writer.append(rows[i:i + 100]) for i in range(0, len(rows), 100)]
    writer.flush()
    ids = np.array([f"s{i}" for i in range(len(spans))])
    np.savez_compressed(tmp_path / "doc_infos.npz", ids=ids, spans=np.array(spans, dtype=np.int64))
    with open(tmp_path / "encode_meta.json", "w") as f:
        json.dump({"dim": rows.shape[1], "dtype": "float16", "blocks": writer.block_num, "sequences": len(ids)}, f)
    syncs, results = [], []
    for folder in (True, False):
        index = StreamingFlatIndex({}, device)
        if folder:
            index.index_from_folder(str(tmp_path))
            assert len(index._blocks) == 8
        else:
            index.index(np.repeat(ids, 100), rows.astype(np.float16))
        index.search(queries, 100)  # warm: the side stream, the allocators
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                results.append(index.search(queries, 100))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    cpu = StreamingFlatIndex({}, "cpu")
    cpu.index_from_folder(str(tmp_path))
    for got in results:
        _same_hits(got, cpu.search(queries, 100))
    assert syncs[0] == syncs[1], syncs


# ---- the model zoo's encoder paths: listwise BERT_DOT, BERT_CAT's QA heads, bert_vectors ----

def _step_grads_vs_plain(model, loss_fn, batch, monkeypatch, exact_zero=None):
    """(loss with the kernels, loss with the plain versions, worst gradient
    cosine, its parameter) of one backward of ``loss_fn`` from the same
    parameters; each key bias's gradient and each of ``exact_zero``'s
    ({parameter: reference}), zero in exact arithmetic, checked as rounding
    noise within 2e-2 of the reference's largest gradient."""
    exact_zero = dict(exact_zero or {})

    def run():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch)[0]
        loss.backward()
        return float(loss), {n: p.grad.float().clone() for n, p in model.named_parameters() if p.grad is not None}

    lk, gk = run()
    _plain_halves(monkeypatch)
    lp, gp = run()
    assert set(gk) == set(gp)
    worst = (2.0, None)
    for name, a in gk.items():
        ref = exact_zero.get(name) or (name.replace("key.bias", "query.bias") if name.endswith("key.bias") else None)
        if ref:
            assert float((a - gp[name]).abs().max()) <= 2e-2 * float(gp[ref].abs().max()), name
            continue
        cos = float(torch.nn.functional.cosine_similarity(a.reshape(-1), gp[name].reshape(-1), dim=0))
        worst = min(worst, (cos, name))
    return lk, lp, worst


def _random_ids(g, device, b, l, lo=1000, hi=30522):
    return torch.randint(lo, hi, (b, l), generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["listnet", "lambdarank", "mrr"])
def test_list_step_on_the_card_matches_plain(device, monkeypatch, loss):
    """One list-batch step of a DistilBERT-width BERT_DOT (2 layers, bf16,
    fused halves): 4 lists of 8 documents of 200 tokens, the query repeated
    8 times, all 32 pairs in one forward: K1/K2 and K12/K11 twice a layer
    (the 32 queries of 30, the 32 documents of 200); the loss within 1e-2
    relative and every gradient's cosine >= 0.99 against the plain
    versions' (phase 6's bar)."""
    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.models.bert_dot import BertDot
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    model = BertDot(EncoderConfig.distilbert(fused_attention=True, num_layers=2), compute_dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(7))
    model.to(device)
    g = torch.Generator(device=device).manual_seed(8)
    batch = {"query_ids": _random_ids(g, device, 4, 30), "query_mask": torch.ones(4, 30, device=device),
             "list_doc_ids": _random_ids(g, device, 4 * 8, 200).reshape(4, 8, 200),
             "list_doc_mask": torch.ones(4, 8, 200, device=device),
             "list_labels": torch.tensor([[3.0, 1, 1, 1, 0, 0, 0, 0]] * 4, device=device),
             "valid": torch.ones(4, device=device)}
    batch["query_mask"][1, 7:] = 0
    batch["list_doc_mask"][2, 3, 60:] = 0
    config = {"loss": loss}
    loss_fn = make_loss_fn(model, get_loss(config), config)
    _build.reset_launches()
    lk, lp, (cos, name) = _step_grads_vs_plain(model, loss_fn, batch, monkeypatch)
    assert abs(lk - lp) <= 1e-2 * max(abs(lp), 1e-12), (lk, lp)
    assert cos >= 0.99, (name, cos)
    assert _build.LAUNCHES["fused_attention_block"] == 4 and _build.LAUNCHES["fused_attention_block_bwd"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("weighting", [True, False])
def test_qa_step_on_the_card_matches_plain(device, monkeypatch, weighting):
    """One step of a DistilBERT-width BERT_CAT with the QA heads (2 layers,
    bf16, fused halves; 4 triples of 30 + 200 tokens, span labels, a sample
    without an answer): the ranking (pointwise: a pairwise loss cancels for
    parameters that move both passes alike), span and answerability losses
    merged by ``mtl_log_vars`` or by ``qa_loss_lambda``: the loss within
    1e-2 relative and every gradient's cosine >= 0.99 against the plain
    versions', ``qa_span_layer``, ``answerability_layer`` and
    ``mtl_log_vars`` included; the span bias's gradient, zero in exact
    arithmetic (a shift of every logit), as noise."""
    import torch.nn as nn

    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.models.bert_cat import BertCat
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    model = BertCat(EncoderConfig.distilbert(fused_attention=True, num_layers=2), torch.bfloat16, qa_head=True)
    if weighting:
        model.register_parameter("mtl_log_vars", nn.Parameter(torch.zeros(3)))
    init_parameters(model, torch.Generator().manual_seed(9))
    model.to(device)
    g = torch.Generator(device=device).manual_seed(10)
    batch = {}
    for side in ("pos", "neg"):
        batch[f"{side}_ids"] = _random_ids(g, device, 4, 230)
        batch[f"{side}_mask"] = torch.ones(4, 230, device=device)
        batch[f"{side}_mask"][0, 100:] = 0
        batch[f"{side}_type_ids"] = torch.cat([torch.zeros(4, 30), torch.ones(4, 200)], 1).long().to(device)
    batch["qa_start"] = torch.tensor([[40, -1], [35, 50], [-1, -1], [200, -1]], device=device)
    batch["qa_end"] = torch.tensor([[42, -1], [36, 55], [-1, -1], [201, -1]], device=device)
    batch["qa_has_answer"] = torch.tensor([1, 1, 0, 1], device=device)
    config = {"loss": "MSETeacherPointwise", "train_qa_spans": True, "qa_loss": "StartEndCrossEntropy"}
    loss_fn = make_loss_fn(model, get_loss(config), config)
    lk, lp, (cos, name) = _step_grads_vs_plain(model, loss_fn, batch, monkeypatch,
                                               {"qa_span_layer.bias": "qa_span_layer.kernel"})
    assert abs(lk - lp) <= 1e-2 * max(abs(lp), 1e-12), (lk, lp)
    assert cos >= 0.99, (name, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("trainable", [False, True])
def test_bert_vectors_launches_the_backward_only_when_trainable(device, trainable):
    """TK over a DistilBERT-width encoder's vectors (2 layers, bf16, fused
    halves), one ranknet step of 4 triples: K1/K2 twice a layer a pass
    (query and document); frozen, no K11/K12 launch and no gradient in the
    encoder; trainable, K11/K12 as often as K1/K2 and every encoder
    parameter with a gradient."""
    from matchmaker_tpu_torch.losses import get_loss
    from matchmaker_tpu_torch.models.bert_vectors import ContextualVectorsAdapter
    from matchmaker_tpu_torch.models.tk import TK
    from matchmaker_tpu_torch.training.train_step import make_loss_fn

    inner = TK(1, 768, att_heads=8, external_embedding=True)
    model = ContextualVectorsAdapter(inner, EncoderConfig.distilbert(fused_attention=True, num_layers=2), trainable,
                                     torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(11))
    model.to(device)
    g = torch.Generator(device=device).manual_seed(12)
    batch = {"query_ids": _random_ids(g, device, 4, 30), "query_mask": torch.ones(4, 30, device=device),
             "doc_pos_ids": _random_ids(g, device, 4, 200), "doc_pos_mask": torch.ones(4, 200, device=device),
             "doc_neg_ids": _random_ids(g, device, 4, 200), "doc_neg_mask": torch.ones(4, 200, device=device)}
    config = {"loss": "ranknet"}
    _build.reset_launches()
    loss = make_loss_fn(model, get_loss(config), config)(batch)[0]
    loss.backward()
    assert torch.isfinite(loss)
    assert _build.LAUNCHES["fused_attention_block"] == _build.LAUNCHES["fused_mlp_block"] == 8
    want = 8 if trainable else 0
    assert _build.LAUNCHES["fused_attention_block_bwd"] == _build.LAUNCHES["fused_mlp_block_bwd"] == want
    enc = [p.grad for n, p in model.named_parameters() if n.startswith("encoder.")]
    assert all((grad is not None) == trainable for grad in enc)


_SHARDED_ROUTES = {
    "bf16": ({"mips_quantization": "float16"}, "binmax_candidates"),
    "int8": ({"mips_quantization": "int8"}, "binmax_candidates_int8"),
    "int8-mixed": ({"mips_quantization": "int8", "mips_int8_queries": "float"}, "binmax_candidates_int8f"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(_SHARDED_ROUTES))
def test_four_shard_search_on_one_card_matches_unsharded(device, route):
    """FlatIndex over a mesh of four cuda:0 entries: four scan launches a
    search (row views of one upload), one merge; the unsharded search's
    hits (at 32,768 rows and k 100 both take per_bin 4 without level 2, so
    the candidate pools are the same); and one shard's scan equal to its
    plain version on the CPU."""
    import numpy as np

    from matchmaker_tpu_torch.parallel.mesh import make_mesh
    from matchmaker_tpu_torch.retrieval.indexes import FlatIndex

    extra, counter = _SHARDED_ROUTES[route]
    rows, queries = _index_corpus(n=30_000, d=128, seed=5)
    config = {"token_dtype": "float16", "mips_kernel": "binmax", **extra}
    mesh = make_mesh(devices=[device] * 4)
    one, four = FlatIndex(config, device), FlatIndex(config, device, mesh)
    for index in (one, four):
        index.index(np.arange(len(rows)), rows)
    want = one.search(queries, 100)
    _build.reset_launches()
    got = four.search(queries, 100)
    assert _build.LAUNCHES[counter] == 4 and four._per_bin(100) == one._per_bin(100) == 4
    _same_hits(got, want)
    stored = four._device_vectors[0] if isinstance(four._device_vectors, tuple) else four._device_vectors
    assert len(stored.parts) == 4 and stored.parts[1].data_ptr() - stored.parts[0].data_ptr() == (
        stored.rows * stored.parts[0].stride(0) * stored.parts[0].element_size())
    shard, q = stored.parts[1], torch.from_numpy(queries).to(device)
    if route == "bf16":
        got_c = mb.binmax_candidates(q, shard, per_bin=4)
        want_c = mb.binmax_candidates(q.cpu(), shard.cpu(), per_bin=4).to(device)
        same, rel = _candidate_agreement(got_c, want_c, 2048, 4)
        assert same >= 0.999 and rel <= 1e-4, (same, rel)
    else:
        scales = four._device_vectors[1].parts[1]
        qq, qs = (q, None) if route == "int8-mixed" else mq.quantize_queries(q)
        got_c = mb.binmax_candidates(qq, shard, per_bin=4, corpus_scales=scales, query_scales=qs)
        want_c = mb.binmax_candidates(qq.cpu(), shard.cpu(), per_bin=4, corpus_scales=scales.cpu(),
                                      query_scales=None if qs is None else qs.cpu()).to(device)
        if route == "int8":  # K7: bit for bit
            assert torch.equal(got_c.view(torch.int32), want_c.view(torch.int32))
        else:
            same, rel = _candidate_agreement(got_c, want_c, 2048, 4)
            assert same >= 0.999 and rel <= 1e-4, (same, rel)


# ---- sequences past 512 ------------------------------------------------------
# The attention cores keep a 512-key window of the mask row in shared memory
# and refill it every eighth key tile; K14 sums a long query's rows in
# passes of 512; the MaxSim backward sizes its tie classes by Ld.
LONG_LENGTHS = [513, 1024, 2048]
LONG_HEADS = [(768, 12), (1024, 8)]  # heads of 64 and of 128


def _long_mask(b, l, device, seed):
    """Example 0 live up to a key past key 512 (its last tiles skipped),
    example 1 without a live key (every tile runs), example 2 with random
    holes."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = torch.ones(b, l, device=device)
    mask[0, 512 + (l - 512) // 2 + 1:] = 0.0
    if b > 1:
        mask[1] = 0.0
    if b > 2:
        mask[2] = (torch.rand(l, generator=g, device=device) > 0.3).float()
        mask[2, 0] = 1.0
    return mask


def _long_attention_checks(device, hid, heads, b, l, seed):
    """K1, K13, K10 and K12 at (b, l) with _long_mask's masks against their
    plain versions: the encoder halves' bar (K10 also its mean |d|), the
    backward's per-gradient bar; each launching once."""
    attn, _ = _layer_weights(hid, 4 * hid, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    dy = torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16)
    q, k, v = (torch.randn(b, l, hid, generator=g, device=device).to(torch.bfloat16) for _ in range(3))
    mask = _long_mask(b, l, device, seed)
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    ln1 = (attn["ln_scale"], attn["ln_bias"])
    _build.reset_launches()
    forwards = [("fused_attention_block", fa.fused_attention_block_qkv(x, wqkv, bqkv, attn["wo"], attn["bo"], mask,
                                                                       heads, *ln1),
                 fa.reference_attention_block(x, attn["wq"], attn["wk"], attn["wv"], attn["wo"], attn["bq"],
                                              attn["bk"], attn["bv"], attn["bo"], mask, heads, *ln1)),
                ("fused_mha", fa.fused_mha(q, k, v, mask, heads), fa.mha_reference(q, k, v, mask, heads))]
    a8, _, ln8 = _int8_layer(hid, 4 * hid, device, seed + 2)
    forwards.append(("fused_attention_int8_block", fi.fused_attention_int8_block(x, *a8, mask, heads, *ln8),
                     fi.reference_attention_int8_block(x, *a8, mask, heads, *ln8)))
    torch.cuda.synchronize()
    for name, got, want in forwards:
        assert _build.LAUNCHES[name] == 1, name
        assert got.shape == (b, l, hid) and bool(torch.isfinite(got.float()).all()), name
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        print(f"{name} B={b} L={l} HID={hid}/{heads}: min row cosine {cos}, max |d| {err}, mean |d| {mean}")
        assert cos >= 0.999 and err <= 0.1, (name, cos, err)
        if name == "fused_attention_int8_block":
            assert mean <= 5e-5, (name, mean)
    del forwards
    got, want = attention_bwd_pair(x, attn, mask, heads, dy)
    torch.cuda.synchronize()
    grads_close(got, want, scale_of={"dbk": "dbq"})


@pytest.mark.cuda
@pytest.mark.parametrize("hid,heads", LONG_HEADS)
@pytest.mark.parametrize("l", LONG_LENGTHS)
def test_attention_kernels_past_512_keys_match_plain(device, hid, heads, l):
    """K1, K13, K10 and K12 at L 513, 1,024 and 2,048, heads of 64 and 128,
    three examples: one live up to a key past 512, one without a live key,
    one with holes."""
    _long_attention_checks(device, hid, heads, 3, l, seed=l + hid)


@pytest.mark.cuda
def test_attention_kernels_at_8192_keys_match_plain(device):
    """K1, K13, K10 and K12 at L 8,192, B 1, heads of 64, the example live
    up to key 4,352: sixteen windows of the mask row, the last half of the
    key tiles skipped."""
    _long_attention_checks(device, 768, 12, 1, 8192, seed=8192)


@pytest.mark.cuda
def test_attention_core_bwd_at_long_sequences_matches_plain(device):
    """K12's attention core alone at L 1,024 and 2,048 with _long_mask's
    masks (the example without a live key included)."""
    for l in (1024, 2048):
        g = torch.Generator(device=device).manual_seed(l)
        qkv = torch.randn(3, l, 3 * 768, generator=g, device=device).to(torch.bfloat16)
        da = torch.randn(3, l, 768, generator=g, device=device).to(torch.bfloat16)
        mask = _long_mask(3, l, device, l)
        got = dict(zip(("dq", "dk", "dv"), fb.attention_core_bwd(qkv, mask, da, 12).chunk(3, dim=-1)))
        want = fb.attention_core_bwd(qkv.cpu(), mask.cpu(), da.cpu(), 12).to(device)
        torch.cuda.synchronize()
        grads_close(got, dict(zip(("dq", "dk", "dv"), want.chunk(3, dim=-1))))


@pytest.mark.cuda
def test_wrappers_launch_at_513_where_they_refused(device):
    """Each wrapper that refused L (Lq, Ld) past 512 (1,024) before now
    launches its kernel there, once: K1, K13, K10, K12, K14 at Lq 513 (all
    pairs and gathered), the training form and its backward at Ld 1,025."""
    hid, heads, l = 768, 12, 513
    attn, _ = _layer_weights(hid, 3072, device, seed=513)
    x = torch.randn(2, l, hid, device=device).to(torch.bfloat16)
    mask = _long_mask(2, l, device, 1)
    wqkv = torch.cat([attn["wq"], attn["wk"], attn["wv"]], dim=1)
    bqkv = torch.cat([attn["bq"], attn["bk"], attn["bv"]])
    a8, _, ln8 = _int8_layer(hid, 3072, device, 514)
    _build.reset_launches()
    _, saved = fb.attention_block_fwd(x, wqkv, bqkv, attn["wo"], attn["bo"], mask, heads, attn["ln_scale"],
                                      attn["ln_bias"])
    fb.attention_block_bwd(x, wqkv, bqkv, attn["wo"], mask, heads, attn["ln_scale"], x, saved)
    fa.fused_mha(x, x, x, mask, heads)
    fi.fused_attention_int8_block(x, *a8, mask, heads, *ln8)
    q, d, qm, dm = _maxsim_case(2, l, 3, 40, 128, device, seed=5)
    ms.maxsim_all_pairs(q, d, qm, dm)
    ms.maxsim_gathered(q, qm, d.reshape(-1, 128), torch.zeros(2, 3, dtype=torch.int64),
                       torch.full((2, 3), 40, dtype=torch.int32), 40)
    q, d, qm, dm = _maxsim_case(2, 30, 3, 1025, 128, device, seed=6)
    ms.maxsim_all_pairs(q.clone().requires_grad_(), d.clone().requires_grad_(), qm, dm).sum().backward()
    torch.cuda.synchronize()
    for name, n in (("fused_attention_block", 1), ("fused_attention_block_bwd", 1), ("fused_mha", 1),
                    ("fused_attention_int8_block", 1), ("maxsim_all_pairs", 2), ("maxsim_all_pairs_argmax", 1),
                    ("maxsim_all_pairs_bwd", 1)):
        assert _build.LAUNCHES[name] == n, (name, _build.LAUNCHES[name])


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [513, 1024])
@pytest.mark.parametrize("dim", [128, 768])
def test_maxsim_kernel_at_long_queries_matches_plain(device, lq, dim):
    """K14 at Lq 513 and 1,024 (a query's rows summed in passes of 512):
    all pairs and the gathered form against their plain versions at rtol =
    atol = 1e-4 with both fills, reruns bit-identical, and the two forms of
    the same docs equal bit for bit."""
    q, d, qm, dm = _maxsim_case(3, lq, 9, 77, dim, device, seed=lq + dim)
    for fill in (ms.NEG_FILL, float("-inf")):
        got = ms.maxsim_all_pairs(q, d, qm, dm, fill=fill)
        want = ms.reference_maxsim_all_pairs(q, d, qm, dm, fill)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)) and torch.equal(got[~fin], want[~fin])
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
        assert torch.equal(got, ms.maxsim_all_pairs(q, d, qm, dm, fill=fill))
    qg, qmg, tokens, first, count = _gathered_case(2, lq, 9, dim, 77, device, seed=lq + dim + 1)
    got = ms.maxsim_gathered(qg, qmg, tokens, first, count, 77, fill=float("-inf"))
    slots = torch.arange(77, device=device)
    rows = (first.to(device)[..., None] + slots).clamp(max=tokens.shape[0] - 1)
    live = (slots < count.to(device)[..., None]).float()
    want = torch.stack([ms.reference_maxsim_all_pairs(qg[i:i + 1], tokens[rows[i]].float(), qmg[i:i + 1], live[i],
                                                      float("-inf"))[0] for i in range(2)])
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    count9 = torch.randint(0, 78, (9,), device=device, dtype=torch.int32)
    prefix = (torch.arange(77, device=device)[None, :] < count9[:, None]).float()
    spans = (torch.arange(9, device=device) * 77)[None, :].expand(3, 9)
    pairs = ms.maxsim_all_pairs(q, d, qm, prefix, fill=float("-inf"))
    gathered = ms.maxsim_gathered(q, qm, d.reshape(-1, dim), spans.cpu(), count9[None, :].expand(3, 9).cpu(), 77,
                                  fill=float("-inf"))
    torch.cuda.synchronize()
    assert torch.equal(pairs, gathered)
