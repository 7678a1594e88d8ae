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
    attn, mlp, ln = _int8_layer(hid, ff, device, seed=b * 1000 + l)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
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
    version; shapes the kernels cannot take raise."""
    q, d, qm, dm = _maxsim_case(2, 8, 3, 16, 32, device, seed=1)
    first, count = torch.zeros(2, 3, dtype=torch.int64), torch.full((2, 3), 16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ms.maxsim_gathered(q.clone().requires_grad_(), qm, d.reshape(-1, 32), first, count, 16)
    _build.reset_launches()
    ms.maxsim_all_pairs(q.clone().requires_grad_(), d, qm, dm).sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["maxsim_all_pairs_argmax"] == 1 and _build.LAUNCHES["maxsim_all_pairs_bwd"] == 1
    assert _build.LAUNCHES["maxsim_all_pairs"] == 0
    with pytest.raises(ValueError, match="D % 8"):
        ms.maxsim_all_pairs(q.detach()[..., :12], d[..., :12], qm, dm)
    with pytest.raises(ValueError, match="D % 8"):
        ms.maxsim_all_pairs(q[..., :12].clone().requires_grad_(), d[..., :12], qm, dm)
    long_d = torch.randn(3, 1025, 32, device=device)
    with pytest.raises(ValueError, match="Ld <= 1024"):
        ms.maxsim_all_pairs(q.clone().requires_grad_(), long_d, qm, torch.ones(3, 1025, device=device))


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
                                              ((4, 16, 6, 40, 64), False, True)])
def test_maxsim_training_form_and_backward_match_plain(device, shape, below, ties):
    """K14's training form and the backward kernel against plain autograd
    through reference_maxsim_all_pairs: the forward at K14's bar (rtol =
    atol = 1e-4), the saved doc tokens equal to the plain argmax but for
    near ties, dq and dd at rtol = atol = 1e-4 on the rows whose tokens
    agree, the exact ties split evenly, reruns bit-identical."""
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
