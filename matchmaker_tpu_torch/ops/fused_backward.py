"""Training the fused layer halves: counterpart of
``matchmaker_tpu/ops/fused_backward.py``.

Each half is a ``torch.autograd.Function`` whose forward is the K1/K2
forward with its residuals kept and whose backward is one more hand-written
kernel set on the card:

- :func:`fused_attention_block_train` / :func:`fused_attention_block_qkv_train`:
  backward K12 (TPU ``_attn_bwd_kernel``), ``csrc/encoder_backward_kernels.cu``;
- :func:`fused_mlp_block_train`: backward K11 (TPU ``_mlp_bwd_kernel``).

On a CPU tensor the backward is the plain version,
:func:`reference_attention_block_bwd` / :func:`reference_mlp_block_bwd`,
which follow the TPU kernels step for step: the LayerNorm backward from the
saved f32 pre-LN sum (:func:`_ln_backward`); the pre-gelu z recomputed in f32
with the gelu derivative the kernel picks for the dtype
(:func:`_gelu_grad_for`, poly erf for bf16); softmax probabilities p and
their gradient ds kept f32 into their products; dq/dk/dv, dz and the
LayerNorm input gradient cast to the compute dtype where the TPU kernels cast
them. The upstream gradient is cast to the compute dtype first, as JAX's
``_attn_train_bwd``/``_mlp_train_bwd`` do, and every gradient returns in its
input's dtype (bf16 weight gradients for bf16 weights).

The card's forward keeps what its kernels already write (the QKV projections
and the attention output, the gelu output, the f32 pre-LN sums) instead of
recomputing them as the TPU kernels do; only gelu'(z) is recomputed (one
GEMM), since z itself is never stored.
"""

from __future__ import annotations

import ctypes

import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32
from matchmaker_tpu_torch.ops import fused_attention as fa

_INV_SQRT_2PI = 0.3989422804014327

# Epilogues of mm_bwd_gemm (csrc/encoder_backward_kernels.cu)
_EPI_GELU_GRAD_F32, _EPI_MUL_BF16, _EPI_BF16, _EPI_RESID_BF16 = 0, 1, 2, 3
# a weight-gradient product is split along its B·L rows until about this many
# blocks are in flight (two waves of the card's 132 SMs)
_WGRAD_TARGET_BLOCKS = 264
_WGRAD_MIN_ROWS = 512


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz [0.5·z·(1 + erf(z/√2))] = Φ(z) + z·φ(z), A&S erf."""
    cdf = 0.5 * (1.0 + fa._erf_poly(z * 0.7071067811865476))
    return cdf + z * (_INV_SQRT_2PI * torch.exp(-0.5 * z * z))


def _gelu_grad_poly(z: torch.Tensor) -> torch.Tensor:
    """Φ through the FMA-only erf polynomial (the bf16 gelu's own)."""
    cdf = 0.5 * (1.0 + fa._erf_fastpoly(z * 0.7071067811865476))
    return cdf + z * (_INV_SQRT_2PI * torch.exp(-0.5 * z * z))


def _gelu_grad_for(dtype: torch.dtype):
    return _gelu_grad_poly if dtype == torch.bfloat16 else _gelu_grad


def _ln_backward(acc: torch.Tensor, dy: torch.Tensor, g: torch.Tensor, ln_eps: float):
    """Backward of y = LN(acc)·g + b over rows (N, H), all f32: returns
    (dacc, dg, dbe) with dg/dbe summed over the rows."""
    mean = acc.mean(dim=-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + ln_eps)
    yhat = (acc - mean) * rstd
    dg = (dy * yhat).sum(dim=0)
    dbe = dy.sum(dim=0)
    dyh = dy * g.float()
    m1 = dyh.mean(dim=-1, keepdim=True)
    m2 = (dyh * yhat).mean(dim=-1, keepdim=True)
    return rstd * (dyh - m1 - yhat * m2), dg, dbe


def reference_mlp_block_bwd(x, w1, b1, w2, ln_scale, dy, acc, ln_eps: float = 1e-12):
    """Plain version of K11. x, dy (B, L, H) in the compute dtype; w1 (H, FF),
    w2 (FF, H); acc the f32 pre-LN sum. Returns (dx in x's dtype, dw1, db1,
    dw2, db2, dg, dbe in f32)."""
    b, l, hid = x.shape
    cd = x.dtype
    x2 = x.reshape(-1, hid)
    dacc, dg, dbe = _ln_backward(acc.reshape(-1, hid).float(), dy.reshape(-1, hid).float(), ln_scale, ln_eps)
    db2 = dacc.sum(dim=0)
    dacc_lp = dacc.to(cd)
    z = matmul_f32(x2, w1) + b1.float()
    hc = fa._gelu_for(cd)(z).to(cd)
    dw2 = matmul_f32(hc.t(), dacc_lp)
    dz = (matmul_f32(dacc_lp, w2.t()) * _gelu_grad_for(cd)(z)).to(cd)
    dw1 = matmul_f32(x2.t(), dz)
    db1 = dz.float().sum(dim=0)
    dx = dacc + matmul_f32(dz, w1.t())
    return dx.to(cd).reshape(b, l, hid), dw1, db1, dw2, db2, dg, dbe


def reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, n_heads, ln_scale, dy, acc,
                                  ln_eps: float = 1e-12):
    """Plain version of K12. Returns (dx in x's dtype, dwq, dwk, dwv, dwo, dbq,
    dbk, dbv, dbo, dg, dbe in f32); q/k/v, p and the attention output are
    recomputed from x as the TPU kernel does."""
    b, l, hid = x.shape
    d = hid // n_heads
    cd = x.dtype
    scale = 1.0 / d ** 0.5
    x2 = x.reshape(-1, hid)
    dacc, dg, dbe = _ln_backward(acc.reshape(-1, hid).float(), dy.reshape(-1, hid).float(), ln_scale, ln_eps)
    dbo = dacc.sum(dim=0)
    dacc_lp = dacc.to(cd)

    def heads(t):  # (B·L, H) → (B, heads, L, d)
        return t.reshape(b, l, n_heads, d).transpose(1, 2)

    def proj(w, bias):
        return heads((matmul_f32(x2, w) + bias.float()).to(cd))

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    da = heads(matmul_f32(dacc_lp, wo.t()).to(cd))
    s = matmul_f32(q, k.transpose(-1, -2)) * scale + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    a = matmul_f32(p, v).to(cd)
    dp = matmul_f32(da, v.transpose(-1, -2))
    dv = matmul_f32(p.transpose(-1, -2), da).to(cd)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = matmul_f32(ds, k).to(cd)
    dk = matmul_f32(ds.transpose(-1, -2), q).to(cd)

    def rows(t):  # (B, heads, L, d) → (B·L, H)
        return t.transpose(1, 2).reshape(-1, hid)

    dwo = matmul_f32(rows(a).t(), dacc_lp)
    dx = dacc
    grads = []
    for w, g in ((wq, dq), (wk, dk), (wv, dv)):
        g2 = rows(g)
        grads.append((matmul_f32(x2.t(), g2), g2.float().sum(dim=0)))
        dx = dx + matmul_f32(g2, w.t())
    (dwq, dbq), (dwk, dbk), (dwv, dbv) = grads
    return dx.to(cd).reshape(b, l, hid), dwq, dwk, dwv, dwo, dbq, dbk, dbv, dbo, dg, dbe


# ---- the card's backward (K11, K12) -----------------------------------------

def _bwd_gemm(a, w, out, epilogue, bias=None, aux=None):
    """out = a (M, K) · w, w (K, N) for the gelu'-epilogue, else (N, K) used
    transposed; then the epilogue (csrc mm_bwd_gemm)."""
    k = a.shape[-1]
    n = out.shape[-1]
    m = a.numel() // k
    null = ctypes.c_void_p()
    _build.call("mm_bwd_gemm", _build.ptr(a), _build.ptr(w), _build.ptr(bias) if bias is not None else null,
                _build.ptr(aux) if aux is not None else null, _build.ptr(out), m, n, k, epilogue,
                _build.stream(a.device))


def _wgrad(a, b):
    """aᵀ · b contracting all B·L rows: a (R, I), b (R, J) bf16 → (I, J) f32,
    split along R over blocks and summed in a second pass (no atomics)."""
    i, j = a.shape[-1], b.shape[-1]
    r = a.numel() // i
    blocks = -(-i // 128) * -(-j // 128)
    splits = max(1, min(-(-_WGRAD_TARGET_BLOCKS // blocks), r // _WGRAD_MIN_ROWS))
    out = torch.empty((i, j), dtype=torch.float32, device=a.device)
    partial = torch.empty((splits, i, j), dtype=torch.float32, device=a.device) if splits > 1 else out
    _build.call("mm_gemm_tn", _build.ptr(a), _build.ptr(b), _build.ptr(partial), _build.ptr(out), r, i, j, splits,
                _build.stream(a.device))
    return out


def _colsum(t):
    """Column sums of a (R, C) bf16 or f32 tensor in f32, in a fixed order."""
    c = t.shape[-1]
    r = t.numel() // c
    splits = max(1, min(256, r // 64))
    partial = torch.empty((splits, c), dtype=torch.float32, device=t.device)
    out = torch.empty((c,), dtype=torch.float32, device=t.device)
    _build.call("mm_colsum", _build.ptr(t), _build.ptr(partial), _build.ptr(out), r, c, splits,
                int(t.dtype == torch.bfloat16), _build.stream(t.device))
    return out


def _ln_bwd_cuda(acc, dy, ln_scale, ln_eps):
    """(dacc f32, dacc bf16, dg, dbe, Σ dacc) from the saved pre-LN sums."""
    hid = acc.shape[-1]
    n = acc.numel() // hid
    dacc = torch.empty((n, hid), dtype=torch.float32, device=acc.device)
    dacc_lp = torch.empty((n, hid), dtype=torch.bfloat16, device=acc.device)
    blocks = -(-n // _build.LN_BWD_ROWS)
    partial = torch.empty((blocks, 3 * hid), dtype=torch.float32, device=acc.device)
    _build.call("mm_ln_bwd", _build.ptr(acc), _build.ptr(dy), _build.ptr(fa._f32(ln_scale)), _build.ptr(dacc),
                _build.ptr(dacc_lp), _build.ptr(partial), n, hid, ln_eps, _build.stream(acc.device))
    dg, dbe, dbias = _colsum(partial).split(hid)
    return dacc, dacc_lp, dg, dbe, dbias


def _check_bwd(name, x, dy, weights):
    bf16 = torch.bfloat16
    for label, t in (("x", x), ("dy", dy), *weights):
        _build.check_cuda(t, f"{name}.{label}", bf16)


def _mlp_block_bwd_cuda(x, w1, b1, w2, ln_scale, dy, saved, ln_eps):
    """K11 on the card: (dx bf16, dw1, db1, dw2, db2, dg, dbe f32)."""
    acc, h = saved
    b, l, hid = x.shape
    ff = w1.shape[1]
    fa._check_gemm_dims("fused_mlp_block_bwd", hid, ff)
    _check_bwd("fused_mlp_block_bwd", x, dy, (("w1", w1), ("w2", w2)))
    n = b * l
    with torch.cuda.device(x.device):
        dacc, dacc_lp, dg, dbe, db2 = _ln_bwd_cuda(acc, dy, ln_scale, ln_eps)
        dw2 = _wgrad(h, dacc_lp)
        ggrad = torch.empty((n, ff), dtype=torch.float32, device=x.device)
        _bwd_gemm(x, w1, ggrad, _EPI_GELU_GRAD_F32, bias=fa._f32(b1))
        dz = torch.empty((n, ff), dtype=torch.bfloat16, device=x.device)
        _bwd_gemm(dacc_lp, w2, dz, _EPI_MUL_BF16, aux=ggrad)
        del ggrad
        dw1 = _wgrad(x, dz)
        db1 = _colsum(dz)
        dx = torch.empty_like(x)
        _bwd_gemm(dz, w1, dx, _EPI_RESID_BF16, aux=dacc)
    _build.LAUNCHES["fused_mlp_block_bwd"] += 1
    return dx, dw1, db1, dw2, db2, dg, dbe


def _attention_block_bwd_cuda(x, wqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps):
    """K12 on the card: (dx bf16, dwqkv, dbqkv, dwo, dbo, dg, dbe f32), the
    Q/K/V gradients packed as the weights are."""
    acc, qkv, attn = saved
    b, l, hid = x.shape
    if hid % n_heads or hid // n_heads != fa._KERNEL_HEAD_DIM or not 1 <= l <= fa._KERNEL_MAX_LEN:
        raise ValueError(f"fused_attention_block_bwd: the CUDA kernel takes head width {fa._KERNEL_HEAD_DIM} "
                         f"and 1 <= L <= {fa._KERNEL_MAX_LEN}, got {hid}/{n_heads}, L={l}")
    fa._check_gemm_dims("fused_attention_block_bwd", hid, hid)
    _check_bwd("fused_attention_block_bwd", x, dy, (("wqkv", wqkv), ("wo", wo)))
    with torch.cuda.device(x.device):
        dacc, dacc_lp, dg, dbe, dbo = _ln_bwd_cuda(acc, dy, ln_scale, ln_eps)
        dwo = _wgrad(attn, dacc_lp)
        da = torch.empty((b, l, hid), dtype=torch.bfloat16, device=x.device)
        _bwd_gemm(dacc_lp, wo, da, _EPI_BF16)
        dqkv = torch.empty((b, l, 3 * hid), dtype=torch.bfloat16, device=x.device)
        stats = torch.empty((3, b, n_heads, l), dtype=torch.float32, device=x.device)
        _build.call("mm_attention_bwd", _build.ptr(qkv), _build.ptr(fa._f32(mask)), _build.ptr(da),
                    _build.ptr(dqkv), _build.ptr(stats), b, l, n_heads, 1.0 / fa._KERNEL_HEAD_DIM ** 0.5,
                    _build.stream(x.device))
        dwqkv = _wgrad(x, dqkv)
        dbqkv = _colsum(dqkv)
        dx = torch.empty_like(x)
        _bwd_gemm(dqkv, wqkv, dx, _EPI_RESID_BF16, aux=dacc)
    _build.LAUNCHES["fused_attention_block_bwd"] += 1
    return dx, dwqkv, dbqkv, dwo, dbo, dg, dbe


def attention_block_bwd(x, wqkv, bqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps: float = 1e-12):
    """Backward of the attention half with packed Q/K/V: K12 on a CUDA tensor
    (``saved`` = (acc, qkv, attn) of the card's forward), the plain version on
    a CPU tensor (``saved`` = (acc,)). Returns (dx, dwqkv, dbqkv, dwo, dbo,
    dg, dbe), weight and LayerNorm gradients in f32."""
    if x.is_cuda:
        return _attention_block_bwd_cuda(x, wqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps)
    wq, wk, wv = wqkv.chunk(3, dim=1)
    bq, bk, bv = bqkv.chunk(3)
    dx, dwq, dwk, dwv, dwo, dbq, dbk, dbv, dbo, dg, dbe = reference_attention_block_bwd(
        x, wq, wk, wv, wo, bq, bk, bv, mask, n_heads, ln_scale, dy, saved[0], ln_eps)
    return dx, torch.cat([dwq, dwk, dwv], dim=1), torch.cat([dbq, dbk, dbv]), dwo, dbo, dg, dbe


def mlp_block_bwd(x, w1, b1, w2, ln_scale, dy, saved, ln_eps: float = 1e-12):
    """Backward of the MLP half: K11 on a CUDA tensor (``saved`` = (acc, h)),
    the plain version on a CPU tensor (``saved`` = (acc,)). Returns (dx, dw1,
    db1, dw2, db2, dg, dbe)."""
    if x.is_cuda:
        return _mlp_block_bwd_cuda(x, w1, b1, w2, ln_scale, dy, saved, ln_eps)
    return reference_mlp_block_bwd(x, w1, b1, w2, ln_scale, dy, saved[0], ln_eps)


def attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps: float = 1e-12):
    """The training forward: (out, saved) for :func:`attention_block_bwd`."""
    if x.is_cuda:
        return fa._attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                        save=True)
    out, acc = fa.fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                            save_acc=True)
    return out, (acc,)


def mlp_block_fwd(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12):
    """The training forward: (out, saved) for :func:`mlp_block_bwd`."""
    if x.is_cuda:
        return fa._mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save=True)
    out, acc = fa.fused_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc=True)
    return out, (acc,)


class _AttentionBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, n_heads, ln_eps):
        out, saved = attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps)
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, *saved)
        ctx.n_heads, ctx.ln_eps = n_heads, ln_eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, *saved = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwo, dbo, dg, dbe = attention_block_bwd(
            x, wqkv, bqkv, wo, mask, ctx.n_heads, ln_scale, dy.to(x.dtype).contiguous(), saved, ctx.ln_eps)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype), None,
                dg.to(ln_scale.dtype), dbe.to(ln_bias.dtype), None, None)


class _MlpBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps):
        out, saved = mlp_block_fwd(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps)
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_scale, ln_bias, *saved)
        ctx.ln_eps = ln_eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, ln_scale, ln_bias, *saved = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dg, dbe = mlp_block_bwd(x, w1, b1, w2, ln_scale, dy.to(x.dtype).contiguous(),
                                                        saved, ctx.ln_eps)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
                dg.to(ln_scale.dtype), dbe.to(ln_bias.dtype), None)


def fused_attention_block_qkv_train(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias,
                                    ln_eps: float = 1e-12):
    """Differentiable attention half with packed Q/K/V (the encoder's entry):
    K1 forward, K12 backward on the card."""
    return _AttentionBlockTrain.apply(x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, n_heads, ln_eps)


def fused_attention_block_train(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads, ln_scale, ln_bias,
                                ln_eps: float = 1e-12):
    """Differentiable LN(x + OutProj(MHA(x))): the JAX function's signature."""
    return fused_attention_block_qkv_train(x, torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]), wo, bo,
                                           mask, n_heads, ln_scale, ln_bias, ln_eps)


def fused_mlp_block_train(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12):
    """Differentiable LN(x + W2·gelu(W1·x + b1) + b2): K2 forward, K11
    backward on the card."""
    return _MlpBlockTrain.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps)
