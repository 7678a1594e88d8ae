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
    mb.binmax_scan_topk(q, c, 10, per_bin=2)
    assert _build.LAUNCHES["binmax_candidates"] == 1
    assert _build.LAUNCHES["unpack_candidates"] == 1
    mb.binmax_scan_topk(q.cpu(), c.cpu(), 10, per_bin=2)  # plain: not counted
    assert _build.LAUNCHES["binmax_candidates"] == 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,l", [(4, 128), (3, 200), (5, 30), (256, 128)])
def test_int8_halves_kernels_match_plain(device, b, l):
    """K10 and K9 at DistilBERT width against their plain versions on the
    card: row cosine >= 0.999, max |d| <= 0.1, the bar K1/K2 meet, and a
    mean |d| <= 5e-5. The plain versions round step by step as the kernels
    do, so only rare rounding flips differ; a wrong scale granularity (gelu
    codes per row instead of per FF chunk, attention codes per row instead
    of per head group) moves the mean |d| to >= 1e-3 at this width."""
    hid, heads = 768, 12
    attn, mlp, ln = _int8_layer(hid, 3072, device, seed=b * 1000 + l)
    x = torch.randn(b, l, hid, device=device).to(torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    mask[0, l // 2 + 1:] = 0.0
    for kernel, plain, args in ((fi.fused_attention_int8_block, fi.reference_attention_int8_block,
                                 (*attn, mask, heads, *ln)),
                                (fi.fused_mlp_int8_block, fi.reference_mlp_int8_block, (*mlp, *ln))):
        got, want = kernel(x, *args), plain(x, *args)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        cos, err = _rows_close(got, want)
        mean = float((got.float() - want.float()).abs().mean())
        print(f"{kernel.__name__} B={b} L={l}: min row cosine {cos}, max |d| {err}, mean |d| {mean}")
        assert cos >= 0.999 and err <= 0.1, (kernel.__name__, cos, err)
        assert mean <= 5e-5, (kernel.__name__, mean)


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
    >= 99.9 % identical candidates."""
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


@pytest.mark.cuda
def test_int8_wrappers_count_cuda_launches_only(device):
    """K7-K10 count one launch per wrapper call on the card; a CPU call runs
    the plain version and counts nothing."""
    _build.reset_launches()
    attn, mlp, ln = _int8_layer(768, 3072, device, seed=3)
    x = torch.randn(2, 64, 768, device=device).to(torch.bfloat16)
    mask = torch.ones(2, 64, device=device)
    fi.fused_attention_int8_block(x, *attn, mask, 12, *ln)
    fi.fused_mlp_int8_block(x, *mlp, *ln)
    q, c = _corpus(16_384, 768, device, seed=5)
    values, scales = mq.quantize_corpus_binwise(c.float().cpu().numpy())
    values, scales = torch.from_numpy(values).to(device), torch.from_numpy(scales).to(device)
    mb.binmax_scan_topk(q, values, 10, per_bin=2, corpus_scales=scales)
    mb.binmax_scan_topk(q, values, 10, per_bin=2, corpus_scales=scales, mixed_queries=True)
    torch.cuda.synchronize()
    want = {"fused_attention_int8_block": 1, "fused_mlp_int8_block": 1, "binmax_candidates_int8": 1,
            "binmax_candidates_int8f": 1}
    assert {k: _build.LAUNCHES[k] for k in want} == want
    cpu = lambda t: t.cpu()  # noqa: E731
    fi.fused_mlp_int8_block(x.cpu(), *map(cpu, mlp), *map(cpu, ln))
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
    q, d, qm, dm = _maxsim_case(2, 8, 3, 16, 32, device, seed=1)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ms.maxsim_all_pairs(q.requires_grad_(), d, qm, dm)
    with pytest.raises(ValueError, match="D % 8"):
        ms.maxsim_all_pairs(q.detach()[..., :12], d[..., :12], qm, dm)


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
    two runs give the same bits; at D <= 256 the streamed and the resident
    forms give the same bits too."""
    q, d, qm, dm = _maxsim_case(3, 300, 17, 90, dim, device, seed=dim)
    first = ms.maxsim_all_pairs(q, d, qm, dm)
    assert torch.equal(first, ms.maxsim_all_pairs(q, d, qm, dm))
    assert torch.equal(first, ms._maxsim_cuda(q, d, qm, dm, ms.NEG_FILL, stream_d=True))


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
@pytest.mark.parametrize("row_tile", [16, 32, 64])
@pytest.mark.parametrize("b,l", [(16, 77), (4, 200), (3, 30)])
def test_probe_mlp_rows_kernels_match_plain(device, row_tile, b, l):
    """K17 and K18 (one kernel, three row tiles) against their plain
    version through both wrappers' paddings: K2's bar (row cosine >= 0.999,
    max |d| <= 0.1)."""
    from matchmaker_tpu_torch.probes import mlp_rows as mr

    _, mlp = _layer_weights(768, 3072, device, seed=row_tile + b + l)
    weights = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["ln_scale"], mlp["ln_bias"])
    x = torch.randn(b, l, 768, device=device).to(torch.bfloat16)
    want = mr.reference_mlp_rows(x, *weights)
    _build.reset_launches()
    for name, fn in (("mlp_rows2d", mr.mlp_rows2d), ("mlp_rowsblk", mr.mlp_rowsblk)):
        got = fn(x, *weights, row_tile=row_tile)
        torch.cuda.synchronize()
        assert got.shape == x.shape and got.dtype == torch.bfloat16
        cos, err = _rows_close(got, want)
        assert cos >= 0.999 and err <= 0.1, (name, cos, err)
    assert _build.LAUNCHES["mlp_rows2d"] == 1 and _build.LAUNCHES["mlp_rowsblk"] == 1


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
