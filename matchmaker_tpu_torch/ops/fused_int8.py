"""The encoder's int8 layer halves (inference only): counterpart of
``matchmaker_tpu/ops/fused_int8.py``.

- :func:`fused_mlp_int8_block`: LN(x + W2q·gelu(W1q·x + b1) + b2) with both
  products int8 × int8 → int32 (TPU kernel K9, ``_mlp_int8_kernel``);
- :func:`fused_attention_int8_block`: LN(x + OutProj(MHA(QKV-proj(x))))
  with the four projections int8 and the attention core in bf16/f32 (TPU
  kernel K10, ``_attn_int8_kernel``); :func:`fused_attention_int8_block_qkv`
  takes the Q/K/V codes packed.

Weights are quantized per output column (:func:`quantize_weights_per_col`,
symmetric, absmax/127) from the f32 parameters, outside the kernels.
Activations are quantized per row (:func:`_quant_rows`): x once per row,
the gelu output per row and FF chunk (``ff_chunks`` = 4: 768 columns at
DistilBERT width), the attention output per row and group of
``group_heads`` = 2 heads (128 columns). Every product's int32 sum is
dequantized by (row scale × column scale) and a chunk's or group's partial
is added onto x + bias in f32 with its own row scale. Biases, the gelu
(FMA-only polynomial), residual and LayerNorm run in f32; the output is in
x's dtype. The plain gelu rounds its multiply-adds once each, as the
kernel's fused ones do (:func:`_gelu_poly_fma`), so the gelu output's codes
and scales are the kernel's bit for bit.

On a CUDA tensor each half runs the hand-written kernels of
``csrc/encoder_int8_kernels.cu`` (bf16 x, int8 codes, f32 scales and
biases; head width at most 128): int8 ``wgmma`` products fed by TMA, which take both
operands K-major, so the weights' codes go in transposed, (OUT, IN).
:func:`fused_mlp_int8_block_kmajor` and
:func:`fused_attention_int8_block_qkv_kmajor` take them so (the encoder
keeps them transposed once per set of weights); the public functions keep
the JAX layout and transpose on the card. The card's products contract
whole 64-code steps, and its attention core takes heads of 16, 32 or 64:
:func:`pad_int8_mlp` and :func:`pad_int8_attention` pad the codes once
(the encoder at packing, the public functions on the card) with zero
codes of scale 1 and bias 0: each head to an instanced width, the
contraction over x (HID), each FF chunk and each head group's Wo rows to
a multiple of 64. A zero column's gelu is 0, meets zero rows of W2, and
leaves every row's, chunk's and group's amax, and so every real code,
JAX's; the activations' codes are written into the padded row stride by
the quantization kernel itself. The plain versions take the padded codes
as well as the unpadded ones. A hidden width that is not a multiple of 8
runs at the next one on the card (``card_width``, as the bf16 halves): x
copied into zero-padded rows, the output products' rows padded with zero
codes of scale 1 and bias 0 in the wrapper, the LayerNorm over the true
width. :func:`check_mlp_int8_geometry`
and :func:`check_attention_int8_geometry` say which shapes the card path
takes. On a CPU tensor each half runs its plain version,
:func:`reference_mlp_int8_block` / :func:`reference_attention_int8_block`,
which repeat the kernels' arithmetic: the int8 products as f32 products of
the codes, exact while 127²·K < 2²⁴ (K ≤ 1040), f64 past it (the exact
sums rounded once to f32, as the kernels convert theirs), TF32 kept out
(``ops.matmul_codes``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from matchmaker_tpu_torch.ops import _build, matmul_codes, matmul_f32, over_127
from matchmaker_tpu_torch.ops.fused_attention import (_ERF_FASTPOLY, _f32, _layer_norm_f32, _layernorm, card_width,
                                                      instanced_head_width, kernel_head_dim, pad_groups)

# Epilogues of mm_wg_gemm_s8 (csrc/encoder_int8_kernels.cu)
_EPI_S8_BIAS_BF16, _EPI_S8_CHUNKS_RESID_F32 = 0, 1
_CHUNK_STEP = 64  # a K chunk of the card's products: whole 64-code steps


def _round_up(n: int, step: int = _CHUNK_STEP) -> int:
    return -(-n // step) * step


def pad_int8_mlp(w1_t, s1, b1, w2_t, ff_chunks: int = 4):
    """K-major MLP codes, w1_t (FF, HID) and w2_t (HID, FF), with HID (W1's
    contraction) and each of the ``ff_chunks`` FF chunks padded to whole
    64-code steps: W1's padded rows code 0, scale 1, bias 0; W2's padded
    columns code 0. → (w1_t, s1, b1, w2_t); the inputs where nothing needs
    padding."""
    ff, hid = w1_t.shape
    chunk = ff // max(ff_chunks, 1)
    width = _round_up(chunk)
    w1_t = pad_groups(pad_groups(w1_t, 1, _round_up(hid), 1), ff_chunks, width, 0)
    return (w1_t, pad_groups(s1, ff_chunks, width, 0, 1.0), pad_groups(b1, ff_chunks, width, 0),
            pad_groups(w2_t, ff_chunks, width, 1))


def pad_int8_attention(wqkv_t, sqkv, bqkv, wo_t, n_heads: int, group_heads: int = 2):
    """K-major attention codes, wqkv_t (3·H·d, HID) and wo_t (HID, H·d), for
    the card: each head zero-padded to the width the attention core is
    instanced for (Q/K/V rows code 0, scale 1, bias 0; Wo's columns code
    0), the contraction over x (HID) and each group of ``group_heads``
    heads' Wo columns padded with zero codes to whole 64-code steps. →
    (wqkv_t, sqkv, bqkv, wo_t); the inputs where nothing needs padding.
    Heads wider than 128 stay as they are (the card refuses them)."""
    d = wqkv_t.shape[0] // (3 * n_heads)
    width = instanced_head_width(d)
    wqkv_t, sqkv, bqkv = (pad_groups(t, 3 * n_heads, width, 0, v) for t, v in ((wqkv_t, 0.0), (sqkv, 1.0),
                                                                             (bqkv, 0.0)))
    wqkv_t = pad_groups(wqkv_t, 1, _round_up(wqkv_t.shape[1]), 1)
    if wo_t.shape[1] == n_heads * d:  # Wo not padded yet (padding it twice would be wrong)
        groups = n_heads // group_heads if group_heads > 0 and n_heads % group_heads == 0 else 1
        wo_t = pad_groups(pad_groups(wo_t, n_heads, width, 1), groups, _round_up(n_heads * width // groups), 1)
    return wqkv_t, sqkv, bqkv, wo_t


def quantize_weights_per_col(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 codes of a (IN, OUT) weight and the
    (OUT,) f32 scales, max(absmax / 127, 1e-12); codes rounded half to even."""
    wf = w.float()
    scale = torch.clamp(over_127(wf.abs().amax(dim=0)), min=1e-12)
    wq = torch.clamp(torch.round(wf / scale[None, :]), -127, 127).to(torch.int8)
    return wq, scale


# the erf polynomial's coefficients as the kernel's float literals
_ERF_FASTPOLY_F32 = torch.tensor(_ERF_FASTPOLY, dtype=torch.float32).double().tolist()


def _gelu_poly_fma(h: torch.Tensor) -> torch.Tensor:
    """The gelu as the int8 MLP kernel evaluates it
    (csrc/encoder_common.cuh:gelu_poly): each ``p * v + c`` of the erf
    polynomial and ``1 + p * uc`` one fused multiply-add, as nvcc contracts
    them. Emulated in f64, where the f32 product is exact, then rounded once
    to f32 (a true FMA rounds once; the f64 step adds a second rounding that
    differs in about one case in 2^29). PyTorch's separate multiply and add
    round twice: on an H100 that moved about one gelu scale in three by an
    ulp and flipped codes, up to a mean |d| of 5.8e-5 on 5 rows, against none
    with this (tools/k10_seed_sweep.py, PERF.md)."""
    uc = torch.clamp(h * 0.7071067811865476, -3.4, 3.4)
    v = uc * uc
    uc64, v64 = uc.double(), v.double()
    p = torch.full_like(v, _ERF_FASTPOLY[-1])
    for c in _ERF_FASTPOLY_F32[-2::-1]:
        p = (p.double() * v64 + c).float()
    return (0.5 * h) * (p.double() * uc64 + 1.0).float()



def _quant_rows(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8 codes and (..., 1) scales."""
    rs = torch.clamp(over_127(xf.abs().amax(dim=-1, keepdim=True)), min=1e-12)
    xq = torch.clamp(torch.round(xf / rs), -127, 127).to(torch.int8)
    return xq, rs


def _codes_to(xq: torch.Tensor, k: int) -> torch.Tensor:
    """Codes (M, K0) padded with zero codes to the K rows of padded weights."""
    return xq if xq.shape[1] == k else torch.nn.functional.pad(xq, (0, k - xq.shape[1]))


def reference_mlp_int8_block(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12,
                             ff_chunks: int = 4):
    """Plain version of the int8 MLP-half kernel (same math, same order).
    The codes may be padded (:func:`pad_int8_mlp`, here (IN, OUT)): zero
    codes add nothing to the integer sums."""
    b, l, hid = x.shape
    xf = x.float().reshape(b * l, hid)
    xq, rs = _quant_rows(xf)
    xq = _codes_to(xq, w1q.shape[0])
    ch = w1q.shape[1] // ff_chunks
    acc = xf + b2.float()
    for c in range(ff_chunks):
        sl = slice(c * ch, (c + 1) * ch)
        h = matmul_codes(xq, w1q[:, sl]) * (rs * s1[sl].float()) + b1[sl].float()
        hq, hs = _quant_rows(_gelu_poly_fma(h))
        acc = acc + matmul_codes(hq, w2q[sl, :]) * (hs * s2.float())
    return _layer_norm_f32(acc, ln_scale, ln_bias, ln_eps).to(x.dtype).reshape(b, l, hid)


def reference_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask, n_heads,
                                   ln_scale, ln_bias, ln_eps: float = 1e-12, group_heads: int = 2, head_dim=None):
    """Plain version of the int8 attention-half kernel (same math, same
    order). The codes may be padded (:func:`pad_int8_attention`, here (IN,
    OUT)): heads zero-padded (``head_dim`` the true width), x's contraction
    and each group's Wo rows padded with zero codes."""
    b, l, hid = x.shape
    d = wqq.shape[1] // n_heads
    xf = x.float().reshape(b * l, hid)
    neg = (mask.float() - 1.0) * 1e9
    acc = xf + bo.float()
    xq, rs = _quant_rows(xf)
    xq = _codes_to(xq, wqq.shape[0])
    gw = group_heads * d
    n_groups = n_heads // group_heads
    wo_rows = woq.shape[0] // n_groups
    for g in range(n_groups):
        gl = slice(g * gw, (g + 1) * gw)

        def proj(wq_, s_, b_):  # (B, heads of the group, L, d) in x's dtype
            h = (matmul_codes(xq, wq_[:, gl]) * (rs * s_[gl].float()) + b_[gl].float()).to(x.dtype)
            return h.reshape(b, l, group_heads, d).transpose(1, 2)

        qg, kg, vg = proj(wqq, sq, bq), proj(wkq, sk, bk), proj(wvq, sv, bv)
        s = matmul_f32(qg, kg.transpose(-1, -2)) * (1.0 / (head_dim or d) ** 0.5)
        s = s + neg[:, None, None, :]
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)  # f32 into the attend product
        a = matmul_f32(p, vg).transpose(1, 2).reshape(b * l, gw)
        aq, as_ = _quant_rows(a)
        acc = acc + matmul_codes(aq, woq[g * wo_rows:g * wo_rows + gw, :]) * (as_ * so.float())
    return _layer_norm_f32(acc, ln_scale, ln_bias, ln_eps).to(x.dtype).reshape(b, l, hid)


def _quant_groups_cuda(x2: torch.Tensor, groups: int, padded: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, G·W) bf16 or f32 → int8 codes (M, G·P) and scales (M, G), per row
    and group of W columns, each group's codes followed by P − W zero codes
    (P = ``padded``, default W)."""
    m, n = x2.shape
    w = n // groups
    padded = padded or w
    q = torch.empty((m, groups * padded), dtype=torch.int8, device=x2.device)
    s = torch.empty((m, groups), dtype=torch.float32, device=x2.device)
    _build.call("mm_quant_groups", _build.ptr(x2), _build.ptr(q), _build.ptr(s), m, groups, w, padded,
                int(x2.dtype == torch.float32), _build.stream(x2.device))
    return q, s


def _gemm_s8(a, w_t, row_scale, col_scale, bias, out, epilogue, chunk, resid=None):
    """out = dequant(a (M, K) · w_t (N, K)ᵀ) + epilogue (csrc mm_wg_gemm_s8,
    both operands K-major); the K axis in chunks of ``chunk`` codes,
    row_scale (M, K / chunk)."""
    n, k = w_t.shape
    _build.call("mm_wg_gemm_s8", _build.ptr(a), _build.ptr(w_t), _build.ptr(row_scale), _build.ptr(col_scale),
                _build.ptr(bias), _build.ptr(resid) if resid is not None else ctypes.c_void_p(), _build.ptr(out),
                a.numel() // k, n, k, chunk, epilogue, _build.stream(a.device))


def _gemm_s8_gelu_quant(xq, w1_t, rs, s1, b1, ff_chunks):
    """The W1 product of K9 with its epilogue (csrc mm_wg_gemm_s8_gelu_quant):
    the per-(row, FF chunk) int8 codes (M, FF) and scales (M, ff_chunks) of
    gelu(dequant(xq · w1_t ᵀ) + b1); the f32 gelu output stays on chip."""
    m = xq.shape[0]
    ff, hid = w1_t.shape
    hq = torch.empty((m, ff), dtype=torch.int8, device=xq.device)
    hs = torch.empty((m, ff_chunks), dtype=torch.float32, device=xq.device)
    _build.call("mm_wg_gemm_s8_gelu_quant", _build.ptr(xq), _build.ptr(w1_t), _build.ptr(rs), _build.ptr(s1),
                _build.ptr(b1), _build.ptr(hq), _build.ptr(hs), m, ff, hid, ff // ff_chunks, _build.stream(xq.device))
    return hq, hs


def _check_chunked_dims(name: str, k: int, n: int, chunk: int) -> None:
    # after padding (pad_int8_mlp, pad_int8_attention): whole 64-code steps
    if chunk <= 0 or chunk % _CHUNK_STEP or k % chunk or n % 2:
        raise ValueError(f"{name}: the CUDA kernel needs chunk % {_CHUNK_STEP} == 0, K % chunk == 0 and "
                         f"N % 2 == 0, got K={k}, N={n}, chunk={chunk}")


def _check_hidden(name: str, hid: int) -> None:
    if hid <= 0:
        raise ValueError(f"{name}: the CUDA kernel takes a positive hidden width, got {hid}")


def check_mlp_int8_geometry(hid: int, ff: int, ff_chunks: int) -> None:
    """Raise ValueError, with the reason, unless the card path of
    :func:`fused_mlp_int8_block` takes this layer: any hidden width (run at
    ``card_width``) and FF in ``ff_chunks`` equal chunks. The W1 product
    runs over HID as one chunk and the W2 product over FF chunk by chunk,
    each padded to whole 64-code steps (:func:`pad_int8_mlp`; any chunk
    width: the W1 kernel runs a chunk wider than 768 columns in passes).
    An FF that ``ff_chunks`` does not divide is refused: JAX's fused int8
    MLP drops its last FF % ff_chunks columns there (ROADMAP.md §3) and its
    unfused MLP keeps them, so the two references disagree."""
    name = "fused_mlp_int8_block"
    if ff_chunks <= 0:
        raise ValueError(f"{name}: ff_chunks must be positive, got {ff_chunks}")
    _check_hidden(name, hid)
    if ff % ff_chunks:
        raise ValueError(f"{name}: the CUDA kernel takes FF in equal chunks (JAX's fused int8 MLP drops the last "
                         f"FF % ff_chunks columns, its unfused MLP keeps them), got FF={ff}, ff_chunks={ff_chunks}")


def check_attention_int8_geometry(hid: int, n_heads: int, group_heads: int, length: int) -> None:
    """Raise ValueError, with the reason, unless the card path of
    :func:`fused_attention_int8_block` takes this layer: any hidden width
    (run at ``card_width``), heads at most 128 wide (K1's attention core, a head
    zero-padded to the next width it is instanced for), whole groups of
    heads and L >= 1. The Wo product runs over the heads in chunks
    of one head group, each padded to whole 64-code steps
    (:func:`pad_int8_attention`)."""
    name = "fused_attention_int8_block"
    _check_hidden(name, hid)
    kernel_head_dim(name, hid, n_heads)
    if group_heads <= 0 or n_heads % group_heads:
        raise ValueError(f"{name}: the CUDA kernel takes whole head groups, got {n_heads} heads, "
                         f"group_heads={group_heads}")
    if length < 1:
        raise ValueError(f"{name}: the CUDA kernel takes L >= 1, got {length}")


def _check_int8_weights(name: str, **weights) -> None:
    for wname, t in weights.items():
        _build.check_cuda(t, f"{name}.{wname}", torch.int8)


def _f32_on_card(name: str, *vectors):
    """Scales, biases and LN parameters as contiguous f32 tensors, checked
    to lie on the card (the kernels read them through raw pointers)."""
    out = [_f32(v) for v in vectors]
    for i, t in enumerate(out):
        _build.check_cuda(t, f"{name}[{i}]", torch.float32)
    return out


def _check_kmajor(name: str, wname: str, w_t: torch.Tensor, out_dim: int, in_dim: int) -> None:
    if tuple(w_t.shape) != (out_dim, in_dim):
        raise ValueError(f"{name}.{wname}: expected K-major codes of shape {(out_dim, in_dim)} (OUT, IN), "
                         f"got {tuple(w_t.shape)}")


def _mlp_int8_cuda(x, w1_t, s1, b1, w2_t, s2, b2, ln_scale, ln_bias, ln_eps, ff_chunks):
    """K9 on the card: w1_t (FF, HID) and w2_t (HID, FF) K-major codes,
    padded here where :func:`pad_int8_mlp` has not padded them yet."""
    name = "fused_mlp_int8_block"
    b, l, hid = x.shape
    check_mlp_int8_geometry(hid, w1_t.shape[0], ff_chunks)
    w1_t, s1, b1, w2_t = pad_int8_mlp(w1_t, s1, b1, w2_t, ff_chunks)  # a no-op on padded codes
    ff, k = w1_t.shape
    width = card_width(hid)  # W2's output columns and the residual's rows
    w2_t, s2, b2 = (pad_groups(t, 1, width, 0, v) for t, v in ((w2_t, 0.0), (s2, 1.0), (b2, 0.0)))
    _check_chunked_dims(name, k, ff, k)
    _check_chunked_dims(name, ff, width, ff // ff_chunks)
    _check_kmajor(name, "w1_t", w1_t, ff, _round_up(hid))
    _check_kmajor(name, "w2_t", w2_t, width, ff)
    _build.check_cuda(x, f"{name}.x", torch.bfloat16)
    _check_int8_weights(name, w1_t=w1_t, w2_t=w2_t)
    s1, b1, s2, b2, ln_scale, ln_bias = _f32_on_card(name, s1, b1, s2, b2, ln_scale, ln_bias)
    m = b * l
    xp = pad_groups(x.reshape(m, hid), 1, width, 1)
    with torch.cuda.device(x.device):
        xq, rs = _quant_groups_cuda(xp, 1, k)
        hq, hs = _gemm_s8_gelu_quant(xq, w1_t, rs, s1, b1, ff_chunks)
        acc = torch.empty((m, width), dtype=torch.float32, device=x.device)
        _gemm_s8(hq, w2_t, hs, s2, b2, acc, _EPI_S8_CHUNKS_RESID_F32, ff // ff_chunks, resid=xp)
        out = torch.empty_like(x)
        _layernorm(acc, ln_scale, ln_bias, hid, ln_eps, out)
    _build.LAUNCHES[name] += 1
    return out


def _attention_int8_cuda(x, wqkv_t, sqkv, bqkv, wo_t, so, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                         group_heads, head_dim=None):
    """K10 on the card: wqkv_t (3·A, HID) and wo_t (HID, A) K-major codes,
    A = H·d, padded here where :func:`pad_int8_attention` has not padded
    them yet (``head_dim``: the true head width of padded codes)."""
    name = "fused_attention_int8_block"
    b, l, hid = x.shape
    check_attention_int8_geometry(hid, n_heads, group_heads, l)
    head_dim = head_dim or wqkv_t.shape[0] // (3 * n_heads)
    wqkv_t, sqkv, bqkv, wo_t = pad_int8_attention(wqkv_t, sqkv, bqkv, wo_t, n_heads, group_heads)  # idempotent
    width = wqkv_t.shape[0] // 3
    d = width // n_heads
    gw = group_heads * d
    groups = n_heads // group_heads
    k, chunk = wqkv_t.shape[1], wo_t.shape[1] // groups
    hidp = card_width(hid)  # Wo's output columns and the residual's rows
    wo_t, so, bo = (pad_groups(t, 1, hidp, 0, v) for t, v in ((wo_t, 0.0), (so, 1.0), (bo, 0.0)))
    _check_kmajor(name, "wqkv_t", wqkv_t, 3 * n_heads * kernel_head_dim(name, width, n_heads), _round_up(hid))
    _check_kmajor(name, "wo_t", wo_t, hidp, groups * _round_up(gw))
    _check_chunked_dims(name, k, 3 * width, k)
    _check_chunked_dims(name, groups * chunk, hidp, chunk)
    _build.check_cuda(x, f"{name}.x", torch.bfloat16)
    _check_int8_weights(name, wqkv_t=wqkv_t, wo_t=wo_t)
    sqkv, bqkv, so, bo, mask, ln_scale, ln_bias = _f32_on_card(name, sqkv, bqkv, so, bo, mask, ln_scale, ln_bias)
    m = b * l
    xp = pad_groups(x.reshape(m, hid), 1, hidp, 1)
    with torch.cuda.device(x.device):
        xq, rs = _quant_groups_cuda(xp, 1, k)
        qkv = torch.empty((b, l, 3 * width), dtype=torch.bfloat16, device=x.device)
        _gemm_s8(xq, wqkv_t, rs, sqkv, bqkv, qkv, _EPI_S8_BIAS_BF16, k)
        attn = torch.empty((m, width), dtype=torch.float32, device=x.device)
        _build.call("mm_attention_core_f32", _build.ptr(qkv), _build.ptr(mask), _build.ptr(attn),
                    b, l, n_heads, d, 1.0 / (head_dim or d) ** 0.5, _build.stream(x.device))
        aq, as_ = _quant_groups_cuda(attn, groups, chunk)
        acc = torch.empty((m, hidp), dtype=torch.float32, device=x.device)
        _gemm_s8(aq, wo_t, as_, so, bo, acc, _EPI_S8_CHUNKS_RESID_F32, chunk, resid=xp)
        out = torch.empty_like(x)
        _layernorm(acc, ln_scale, ln_bias, hid, ln_eps, out)
    _build.LAUNCHES[name] += 1
    return out


def kmajor_codes(w: torch.Tensor) -> torch.Tensor:
    """(IN, OUT) codes as the card's products read them: (OUT, IN), contiguous."""
    return w.t().contiguous()


def kmajor_attention_weights(wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo):
    """The attention half's weights in :func:`fused_attention_int8_block`'s
    order, as :func:`fused_attention_int8_block_qkv_kmajor` takes them:
    (wqkv_t, sqkv, bqkv, wo_t, so, bo), Q/K/V packed, codes K-major."""
    return (kmajor_codes(torch.cat([wqq, wkq, wvq], dim=1)), torch.cat([sq, sk, sv]), torch.cat([bq, bk, bv]),
            kmajor_codes(woq), so, bo)


def fused_mlp_int8_block(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12,
                         ff_chunks: int = 4):
    """LN(x + W2q·gelu(W1q·x + b1) + b2): x (B, L, HID); w1q (HID, FF) and
    w2q (FF, HID) int8 with (FF,) / (HID,) f32 column scales; biases and LN
    parameters f32. CUDA tensors: x bf16, any HID, FF in ``ff_chunks``
    equal chunks."""
    if not x.is_cuda:
        return reference_mlp_int8_block(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias, ln_eps, ff_chunks)
    return _mlp_int8_cuda(x, kmajor_codes(w1q), s1, b1, kmajor_codes(w2q), s2, b2, ln_scale, ln_bias, ln_eps,
                          ff_chunks)


def fused_mlp_int8_block_kmajor(x, w1_t, s1, b1, w2_t, s2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12,
                                ff_chunks: int = 4):
    """:func:`fused_mlp_int8_block` with the weight codes K-major, as the
    card's products read them: w1_t (FF, HID) = w1qᵀ and w2_t (HID, FF) =
    w2qᵀ, contiguous. The encoder keeps them so once per set of weights."""
    if not x.is_cuda:
        return reference_mlp_int8_block(x, w1_t.t(), s1, b1, w2_t.t(), s2, b2, ln_scale, ln_bias, ln_eps,
                                        ff_chunks)
    return _mlp_int8_cuda(x, w1_t, s1, b1, w2_t, s2, b2, ln_scale, ln_bias, ln_eps, ff_chunks)


def fused_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask, n_heads,
                               ln_scale, ln_bias, ln_eps: float = 1e-12, group_heads: int = 2):
    """LN(x + OutProj(MHA(QKV-proj(x)))) with int8 projections: x (B, L,
    HID); wqq/wkq/wvq/woq (HID, HID) int8 with (HID,) f32 column scales;
    biases and LN parameters (HID,); mask (B, L), 1 = real key. CUDA
    tensors: x bf16, head width at most 128, any L."""
    if not x.is_cuda:
        return reference_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask,
                                              n_heads, ln_scale, ln_bias, ln_eps, group_heads)
    return _attention_int8_cuda(x, *kmajor_attention_weights(wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo),
                                mask, n_heads, ln_scale, ln_bias, ln_eps, group_heads)


def fused_attention_int8_block_qkv(x, wqkv_q, sqkv, bqkv, woq, so, bo, mask, n_heads, ln_scale, ln_bias,
                                   ln_eps: float = 1e-12, group_heads: int = 2):
    """:func:`fused_attention_int8_block` with the Q, K and V codes packed
    side by side: wqkv_q (HID, 3·HID) int8, sqkv and bqkv (3·HID,). The
    encoder keeps them packed once per set of weights."""
    if not x.is_cuda:
        wqq, wkq, wvq = wqkv_q.chunk(3, dim=1)
        sq, sk, sv = sqkv.chunk(3)
        bq, bk, bv = bqkv.chunk(3)
        return reference_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask,
                                              n_heads, ln_scale, ln_bias, ln_eps, group_heads)
    return _attention_int8_cuda(x, kmajor_codes(wqkv_q), sqkv, bqkv, kmajor_codes(woq), so, bo, mask, n_heads,
                                ln_scale, ln_bias, ln_eps, group_heads)


def fused_attention_int8_block_qkv_kmajor(x, wqkv_t, sqkv, bqkv, wo_t, so, bo, mask, n_heads, ln_scale, ln_bias,
                                          ln_eps: float = 1e-12, group_heads: int = 2, head_dim=None):
    """:func:`fused_attention_int8_block_qkv` with the weight codes K-major,
    as the card's products read them: wqkv_t (3·HID, HID) = wqkv_qᵀ and
    wo_t (HID, HID) = woqᵀ, contiguous, or as :func:`pad_int8_attention`
    pads them (``head_dim`` the true head width). The encoder keeps them so
    once per set of weights."""
    if not x.is_cuda:
        wqq, wkq, wvq = wqkv_t.t().chunk(3, dim=1)
        sq, sk, sv = sqkv.chunk(3)
        bq, bk, bv = bqkv.chunk(3)
        return reference_attention_int8_block(x, wqq, sq, wkq, sk, wvq, sv, wo_t.t(), so, bq, bk, bv, bo, mask,
                                              n_heads, ln_scale, ln_bias, ln_eps, group_heads, head_dim)
    return _attention_int8_cuda(x, wqkv_t, sqkv, bqkv, wo_t, so, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                group_heads, head_dim)
