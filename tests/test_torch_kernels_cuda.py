"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, at the encoder's DistilBERT width and binmax shapes of the main
path (cut in batch and corpus rows to keep each test short).

Run on a machine with an NVIDIA GPU: ``python -m pytest -m cuda tests/``.
Without a card every ``cuda`` test skips (the decision is made inside the
``device`` fixture, never at import). The import-hygiene test runs anywhere.
"""

import os
import subprocess
import sys

import pytest
import torch

from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as fa
from matchmaker_tpu_torch.ops import mips_binmax as mb

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


def test_cli_import_loads_no_jax_flax_or_yaml():
    code = ("import sys, matchmaker_tpu_torch.cli.dense_retrieval; "
            "print(sorted(m for m in ('jax', 'flax', 'yaml') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
