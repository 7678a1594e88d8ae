"""The encoder's fused layer halves: counterpart of
``matchmaker_tpu/ops/fused_attention.py``.

- :func:`fused_attention_block`: LN(x + Wo·MHA(QKV-proj(x)) + bo), the
  attention half of a post-norm layer (TPU kernel K1, ``_block_kernel``);
  :func:`fused_attention_block_qkv` takes the Q/K/V weights packed;
- :func:`fused_mlp_block`: LN(x + W2·gelu(W1·x + b1) + b2), the MLP half
  (TPU kernel K2, ``_mlp_kernel``).

On a CUDA tensor each runs the hand-written kernels of
``csrc/encoder_kernels.cu`` (bf16 activations and weights, f32 biases and
LayerNorm parameters). On a CPU tensor each runs its plain version,
:func:`reference_attention_block` / :func:`reference_mlp_block`, which
compute what the kernels compute: f32 accumulation of every product; q/k/v
cast to the compute dtype after their bias; the softmax in f32 and the
probabilities kept f32 into P·V; the gelu output cast before the second
product; the LayerNorm in f32 with the residual sum. The gelu is the one the
TPU kernel picks for the dtype (:func:`_gelu_for`): the FMA-only polynomial
for bf16, the A&S erf for f32 — so unlike JAX's ``reference_mlp_block`` no
exact erf is used.

``save_acc=True`` also returns the f32 pre-LN residual sum, the training
forward's residual for the backward (ops/fused_backward.py). The JAX kernels
return it in the compute dtype; the port keeps the f32 sum it computes.
"""

from __future__ import annotations

import ctypes

import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32

# Epilogues of mm_gemm (csrc/encoder_kernels.cu)
_EPI_BIAS_BF16, _EPI_BIAS_GELU_BF16, _EPI_BIAS_RESID_F32 = 0, 1, 2
_KERNEL_HEAD_DIM = 64
_KERNEL_MAX_LEN = 512


def _erf_poly(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (max abs error 1.5e-7)."""
    p = 0.3275911
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    s = torch.sign(z)
    az = torch.abs(z)
    t = 1.0 / (1.0 + p * az)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-az * az))


def _gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + _erf_poly(h * 0.7071067811865476))


# odd polynomial erf(u) = u·P(u²) on |u| ≤ 3.4, the same coefficients as the
# TPU kernel and csrc/encoder_kernels.cu:gelu_poly (max |gelu| error 1.4e-4)
_ERF_FASTPOLY = (1.1268175, -0.37025923, 0.10513879, -0.021726243,
                 0.0031725222, -0.00031579041, 2.0221069e-05,
                 -7.4665718e-07, 1.2036946e-08)


def _erf_fastpoly(u: torch.Tensor) -> torch.Tensor:
    uc = torch.clamp(u, -3.4, 3.4)
    v = uc * uc
    p = torch.full_like(v, _ERF_FASTPOLY[-1])
    for c in _ERF_FASTPOLY[-2::-1]:
        p = p * v + c
    return p * uc


def _gelu_poly(h: torch.Tensor) -> torch.Tensor:
    """gelu to 1.4e-4 abs, exp- and division-free."""
    return 0.5 * h * (1.0 + _erf_fastpoly(h * 0.7071067811865476))


def _gelu_for(dtype: torch.dtype):
    """The gelu the kernels use for an activation dtype."""
    return _gelu_poly if dtype == torch.bfloat16 else _gelu_exact


def _layer_norm_f32(acc: torch.Tensor, ln_scale, ln_bias, ln_eps: float) -> torch.Tensor:
    mean = acc.mean(dim=-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (acc - mean) * torch.rsqrt(var + ln_eps)
    return y * ln_scale.float() + ln_bias.float()


def reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads,
                              ln_scale, ln_bias, ln_eps: float = 1e-12, save_acc: bool = False):
    """Plain version of the attention-half kernel (same math, same casts)."""
    b, l, hid = x.shape
    d = hid // n_heads
    cd = x.dtype
    x2 = x.reshape(b * l, hid)

    def proj(w, bias):  # (B, H, L, D) in the compute dtype
        h = (matmul_f32(x2, w) + bias.float()).to(cd)
        return h.reshape(b, l, n_heads, d).transpose(1, 2)

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    s = matmul_f32(q, k.transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = s + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    a = matmul_f32(p, v).to(cd).transpose(1, 2).reshape(b * l, hid)
    acc = x2.float() + bo.float() + matmul_f32(a, wo)
    return _finish(acc, ln_scale, ln_bias, ln_eps, cd, (b, l, hid), save_acc)


def reference_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12,
                        save_acc: bool = False):
    """Plain version of the MLP-half kernel (same math, same casts)."""
    b, l, hid = x.shape
    cd = x.dtype
    x2 = x.reshape(b * l, hid)
    h = _gelu_for(cd)(matmul_f32(x2, w1) + b1.float()).to(cd)
    acc = x2.float() + b2.float() + matmul_f32(h, w2)
    return _finish(acc, ln_scale, ln_bias, ln_eps, cd, (b, l, hid), save_acc)


def _finish(acc, ln_scale, ln_bias, ln_eps, cd, shape, save_acc):
    out = _layer_norm_f32(acc, ln_scale, ln_bias, ln_eps).to(cd).reshape(shape)
    return (out, acc.reshape(shape)) if save_acc else out


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_gemm_dims(name: str, k: int, n: int) -> None:
    # tile_mma.cuh: K in steps of 32, 16-byte rows, columns in chunks of 8
    if k % 32 or n % 8:
        raise ValueError(f"{name}: the CUDA kernel needs K % 32 == 0 and N % 8 == 0, got K={k}, N={n}")


def _gemm(a, w, bias, out, epilogue, resid=None):
    """out = a (M, K) · w (K, N) + bias, then the epilogue (csrc mm_gemm)."""
    k, n = w.shape
    m = a.numel() // k
    _build.call("mm_gemm", _build.ptr(a), _build.ptr(w), _build.ptr(bias),
                _build.ptr(resid) if resid is not None else ctypes.c_void_p(),
                _build.ptr(out), m, n, k, epilogue, _build.stream(a.device))


def _attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                          save: bool = False):
    """K1 on the card. ``save``: also return (acc, qkv, attn), the f32 pre-LN
    sums and the bf16 QKV projections and attention output the backward
    (K12) reads instead of recomputing them."""
    b, l, hid = x.shape
    if hid % n_heads or hid // n_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"fused_attention_block: the CUDA kernel takes head width "
                         f"{_KERNEL_HEAD_DIM}, got {hid}/{n_heads}")
    if not 1 <= l <= _KERNEL_MAX_LEN:
        raise ValueError(f"fused_attention_block: the CUDA kernel takes 1 <= L <= {_KERNEL_MAX_LEN}, got {l}")
    _check_gemm_dims("fused_attention_block", hid, hid)
    bf16 = torch.bfloat16
    for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
        _build.check_cuda(t, f"fused_attention_block.{name}", bf16)
    with torch.cuda.device(x.device):
        qkv = torch.empty((b, l, 3 * hid), dtype=bf16, device=x.device)
        _gemm(x, wqkv, _f32(bqkv), qkv, _EPI_BIAS_BF16)
        attn = torch.empty((b, l, hid), dtype=bf16, device=x.device)
        _build.call("mm_attention_core", _build.ptr(qkv), _build.ptr(_f32(mask)), _build.ptr(attn),
                    b, l, n_heads, 1.0 / _KERNEL_HEAD_DIM ** 0.5, _build.stream(x.device))
        acc = torch.empty((b, l, hid), dtype=torch.float32, device=x.device)
        _gemm(attn, wo, _f32(bo), acc, _EPI_BIAS_RESID_F32, resid=x)
        out = torch.empty_like(x)
        _build.call("mm_layernorm", _build.ptr(acc), _build.ptr(_f32(ln_scale)), _build.ptr(_f32(ln_bias)),
                    _build.ptr(out), b * l, hid, ln_eps, _build.stream(x.device))
    _build.LAUNCHES["fused_attention_block"] += 1
    return (out, (acc, qkv, attn)) if save else out


def _mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save: bool = False):
    """K2 on the card. ``save``: also return (acc, h), the f32 pre-LN sums and
    the bf16 gelu output the backward (K11) reads."""
    b, l, hid = x.shape
    ff = w1.shape[1]
    _check_gemm_dims("fused_mlp_block", hid, ff)
    _check_gemm_dims("fused_mlp_block", ff, hid)
    bf16 = torch.bfloat16
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        _build.check_cuda(t, f"fused_mlp_block.{name}", bf16)
    with torch.cuda.device(x.device):
        h = torch.empty((b, l, ff), dtype=bf16, device=x.device)
        _gemm(x, w1, _f32(b1), h, _EPI_BIAS_GELU_BF16)
        acc = torch.empty((b, l, hid), dtype=torch.float32, device=x.device)
        _gemm(h, w2, _f32(b2), acc, _EPI_BIAS_RESID_F32, resid=x)
        out = torch.empty_like(x)
        _build.call("mm_layernorm", _build.ptr(acc), _build.ptr(_f32(ln_scale)), _build.ptr(_f32(ln_bias)),
                    _build.ptr(out), b * l, hid, ln_eps, _build.stream(x.device))
    _build.LAUNCHES["fused_mlp_block"] += 1
    return (out, (acc, h)) if save else out


def _acc_only(result, save_acc):
    if not save_acc:
        return result
    out, saved = result
    return out, saved[0]


def fused_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads,
                          ln_scale, ln_bias, ln_eps: float = 1e-12, save_acc: bool = False):
    """LN(x + OutProj(MHA(QKV-proj(x)))): x (B, L, HID); wq/wk/wv/wo (HID, HID)
    in x's dtype; biases and LN params (HID,); mask (B, L), 1 = real key.
    CUDA tensors: bf16, head width 64, 1 <= L <= 512. ``save_acc``: return
    (out, acc) with acc the f32 pre-LN sum (B, L, HID)."""
    if not x.is_cuda:
        return reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads,
                                         ln_scale, ln_bias, ln_eps, save_acc)
    return _acc_only(_attention_block_cuda(x, torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]), wo, bo,
                                           mask, n_heads, ln_scale, ln_bias, ln_eps, save_acc), save_acc)


def fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias,
                              ln_eps: float = 1e-12, save_acc: bool = False):
    """:func:`fused_attention_block` with the Q, K and V projections packed
    side by side: wqkv (HID, 3·HID), bqkv (3·HID,). The encoder keeps them
    packed once per set of weights, so no call concatenates them."""
    if not x.is_cuda:
        wq, wk, wv = wqkv.chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads,
                                         ln_scale, ln_bias, ln_eps, save_acc)
    return _acc_only(_attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                           save_acc), save_acc)


def fused_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12, save_acc: bool = False):
    """LN(x + W2·gelu(W1·x + b1) + b2): x (B, L, HID); w1 (HID, FF) and
    w2 (FF, HID) in x's dtype. CUDA tensors: bf16. ``save_acc``: return
    (out, acc) with acc the f32 pre-LN sum."""
    if not x.is_cuda:
        return reference_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc)
    return _acc_only(_mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc), save_acc)
