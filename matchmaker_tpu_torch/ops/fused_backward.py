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
recomputing them as the TPU kernels do; only gelu'(z) is recomputed, inside
the GEMM that forms dz, since z itself is never stored. Each half's backward
is one ctypes call that issues its launches from C: the training step is
bound by the host, which no longer pays a call a launch. The card's products
run on the Hopper GEMM of ``csrc/wgmma_gemm.cuh``; its attention-core
backward takes P into dV and dS into dQ as bf16 and dS into dK as a bf16
hi + lo pair, a rounding ``tests/test_torch_attention_bwd_rounding.py`` holds
to the bars on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32
from matchmaker_tpu_torch.ops import fused_attention as fa

_INV_SQRT_2PI = 0.3989422804014327

# Epilogues of mm_wg_gemm (csrc/wgmma_gemm.cuh)
_EPI_BF16, _EPI_RESID_BF16 = 0, 1
# wgmma_gemm.cuh's output tile and contraction tile
_TILE, _K_TILE = 128, 64
# a weight gradient's rows are split into at most this many ranges, each at
# least _WGRAD_MIN_K_TILES row tiles long, to fill the card's 132 SMs
_SMS = 132
_WGRAD_MAX_SPLITS = 4
_WGRAD_MIN_K_TILES = 4
# the widest row of the LayerNorm backward kernels (csrc ln_bwd: up to
# 1,024 columns a warp a row, past that a block a row, 8 register chunks of
# 1,024 columns); any width up to it, run at fa.card_width
_LN_BWD_MAX_WIDTH = 8192


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


def _attention_core_plain(q, k, v, da, mask, scale):
    """The attention core and its backward per head: q, k, v and the output
    gradient da (B, heads, L, d) in the compute dtype, mask (B, L). Returns
    (a, dq, dk, dv) in that dtype, p and ds kept f32 into their products as
    the TPU kernel keeps them."""
    cd = q.dtype
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
    return a, dq, dk, dv


def reference_attention_block_bwd(x, wq, wk, wv, wo, bq, bk, bv, mask, n_heads, ln_scale, dy, acc,
                                  ln_eps: float = 1e-12, head_dim=None):
    """Plain version of K12. Returns (dx in x's dtype, dwq, dwk, dwv, dwo, dbq,
    dbk, dbv, dbo, dg, dbe in f32); q/k/v, p and the attention output are
    recomputed from x as the TPU kernel does. The weights' heads may be
    zero-padded (ops/fused_attention.py:pad_attention_heads), ``head_dim``
    the true head width."""
    b, l, hid = x.shape
    width = wq.shape[1]
    d = width // n_heads
    cd = x.dtype
    scale = 1.0 / (head_dim or d) ** 0.5
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
    a, dq, dk, dv = _attention_core_plain(q, k, v, da, mask, scale)

    def rows(t):  # (B, heads, L, d) → (B·L, H·d)
        return t.transpose(1, 2).reshape(-1, width)

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

def wgrad_plan(r: int, i: int, j: int) -> tuple[int, int]:
    """Split plan of a weight gradient aᵀ·b, a (r, i), b (r, j): (splits,
    row tiles per split). Split z contracts row tiles [z·per, (z+1)·per) of
    the ceil(r / 64) into its own (i, j) f32 partial, and the partials are
    summed in order of z. The splits are chosen so that the units of work
    (128 × 128 output tiles × splits, each split 1/splits of the rows) leave
    the least idle: ceil(units / 132) rounds of 1/splits the work, the fewest
    splits among equals (one split for 108 tiles, three for dWo's 36, four
    for dW1's and dW2's 144)."""
    tiles = -(-i // _TILE) * -(-j // _TILE)
    k_tiles = -(-r // _K_TILE)
    most = max(1, min(_WGRAD_MAX_SPLITS, k_tiles // _WGRAD_MIN_K_TILES))
    splits = min(range(1, most + 1), key=lambda s: (-(-tiles * s // _SMS) / s, s))
    per = -(-k_tiles // splits)
    return -(-k_tiles // per), per


def _bwd_gemm(a, w, out, epilogue, aux=None):
    """out = a (M, K) · wᵀ, w (N, K), then the epilogue: bf16, or bf16 of the
    product plus aux (M, N) f32 (csrc mm_wg_gemm)."""
    k = a.shape[-1]
    n = out.shape[-1]
    m = a.numel() // k
    aux_ptr = _build.ptr(aux) if aux is not None else ctypes.c_void_p()
    _build.call("mm_wg_gemm", _build.ptr(a), _build.ptr(w), aux_ptr, _build.ptr(out), m, n, k, epilogue,
                _build.stream(a.device))


def _gelu_dz(x, w1, b1, dacc_lp, w2):
    """dz = bf16((dacc · w2ᵀ) ∘ gelu′(x · w1 + b1)) in one kernel with two
    accumulators (csrc mm_wg_gemm_dz): gelu′ never reaches device memory."""
    hid, ff = w1.shape
    m = x.numel() // hid
    dz = torch.empty((m, ff), dtype=torch.bfloat16, device=x.device)
    _build.call("mm_wg_gemm_dz", _build.ptr(x), _build.ptr(w1), _build.ptr(fa._f32(b1)), _build.ptr(dacc_lp),
                _build.ptr(w2), _build.ptr(dz), m, ff, hid, _build.stream(x.device))
    return dz


def _wgrad(a, b):
    """aᵀ · b contracting all B·L rows: a (R, I), b (R, J) bf16 → (I, J) f32,
    split along R by :func:`wgrad_plan` and summed in a fixed order."""
    i, j = a.shape[-1], b.shape[-1]
    r = a.numel() // i
    splits, per = wgrad_plan(r, i, j)
    out = torch.empty((i, j), dtype=torch.float32, device=a.device)
    partial = torch.empty((splits, i, j), dtype=torch.float32, device=a.device) if splits > 1 else out
    _build.call("mm_wg_wgrad", _build.ptr(a), _build.ptr(b), _build.ptr(partial), _build.ptr(out), r, i, j, splits,
                per, _build.stream(a.device))
    return out


@functools.lru_cache(maxsize=64)
def _workspace(name: str, *sizes) -> int:
    """Bytes of scratch a half's one C call takes (csrc ``<name>_bytes``)."""
    return _build.workspace_bytes(name + "_bytes", *sizes)


def _attention_core_bwd_cuda(qkv, mask, da, n_heads, head_dim):
    """The attention core's backward on the card (csrc mm_attention_bwd):
    dqkv (B, L, 3·A) bf16 from the forward's qkv and the output gradient
    da, heads at an instanced width, ``head_dim`` the true one."""
    b, l, width = da.shape
    d = width // n_heads
    dqkv = torch.empty((b, l, 3 * width), dtype=torch.bfloat16, device=da.device)
    stats = torch.empty((3, b, n_heads, l), dtype=torch.float32, device=da.device)
    _build.call("mm_attention_bwd", _build.ptr(qkv), _build.ptr(fa._f32(mask)), _build.ptr(da), _build.ptr(dqkv),
                _build.ptr(stats), b, l, n_heads, d, 1.0 / head_dim ** 0.5, _build.stream(da.device))
    return dqkv


def attention_core_bwd(qkv, mask, da, n_heads):
    """Backward of the attention core alone (part of K12): qkv (B, L, 3·HID)
    packed Q/K/V, mask (B, L) and da the output gradient (B, L, HID) → dqkv
    (B, L, 3·HID) in qkv's dtype. On a CUDA tensor the kernel (bf16, head
    width at most 128: narrower heads than an instance zero-padded to it and
    cut back, any L); on a CPU tensor the plain version."""
    b, l, hid = da.shape
    d = hid // n_heads
    if qkv.is_cuda:
        width = fa.kernel_head_dim("attention_core_bwd", hid, n_heads)
        for name, t in (("qkv", qkv), ("da", da)):
            _build.check_cuda(t, f"attention_core_bwd.{name}", torch.bfloat16)
        with torch.cuda.device(qkv.device):
            if width == d:
                return _attention_core_bwd_cuda(qkv, mask, da, n_heads, d)
            padded = _attention_core_bwd_cuda(fa.pad_groups(qkv, 3 * n_heads, width, -1), mask,
                                              fa.pad_groups(da, n_heads, width, -1), n_heads, d)
            return padded.reshape(b, l, 3 * n_heads, width)[..., :d].reshape(b, l, 3 * hid)

    def heads(t):  # (B, L, HID) → (B, heads, L, d)
        return t.reshape(b, l, n_heads, d).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    _, dq, dk, dv = _attention_core_plain(q, k, v, heads(da), mask, 1.0 / d ** 0.5)
    return torch.cat([g.transpose(1, 2).reshape(b, l, hid) for g in (dq, dk, dv)], dim=-1)


def check_ln_bwd_width(name: str, width: int) -> None:
    """Raise ValueError unless the LayerNorm backward kernels (K11's and
    K12's) take rows of ``width`` columns: any width up to 8,192 (run at
    :func:`fa.card_width`; past 8,192 a row's register chunks would not fit a
    block's threads)."""
    if not 0 < width <= _LN_BWD_MAX_WIDTH:
        raise ValueError(f"{name}: the LayerNorm backward kernel takes rows of 1 to {_LN_BWD_MAX_WIDTH} columns "
                         f"(eight register chunks of 1,024 a block's row), got {width}")


def _check_bwd(name, x, dy, weights):
    bf16 = torch.bfloat16
    for label, t in (("x", x), ("dy", dy), *weights):
        _build.check_cuda(t, f"{name}.{label}", bf16)


def _cut(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` cut back to ``like``'s shape (the gradient of a zero-padded input)."""
    return t if t.shape == like.shape else t[tuple(slice(0, s) for s in like.shape)]


def _mlp_block_bwd_cuda(x, w1, b1, w2, ln_scale, dy, saved, ln_eps):
    """K11 on the card, one C call (csrc mm_mlp_block_bwd): (dx bf16, dw1,
    db1, dw2, db2, dg, dbe f32), each cut back to its input's shape. HID and
    FF run at fa.card_width, as the forward ran them (``saved`` = (acc, h)
    at those widths)."""
    acc, h = saved
    n = x.shape[-1]
    hid, ff = fa.card_width(n), fa.card_width(w1.shape[1])
    check_ln_bwd_width("fused_mlp_block_bwd", n)
    pw1, pw2 = fa.pad_mlp_hidden(w1, w2, hid, ff)
    fa._check_gemm_dims("fused_mlp_block_bwd", hid, ff)
    if tuple(pw1.shape) != (hid, ff) or tuple(pw2.shape) != (ff, hid) or acc.shape[-1] != hid or h.shape[-1] != ff:
        raise ValueError(f"fused_mlp_block_bwd: w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, acc {tuple(acc.shape)} "
                         f"and h {tuple(h.shape)} do not fit x {tuple(x.shape)}")
    _check_bwd("fused_mlp_block_bwd", x, dy, (("w1", pw1), ("w2", pw2)))
    m = x.numel() // n
    w2_plan, w1_plan = wgrad_plan(m, ff, hid), wgrad_plan(m, hid, ff)
    f32, dev = torch.float32, x.device
    xp, dyp = fa.pad_groups(x, 1, hid, -1), fa.pad_groups(dy, 1, hid, -1)
    pb1, = fa.pad_vectors(ff, fa._f32(b1))
    g, = fa.pad_vectors(hid, fa._f32(ln_scale))
    with torch.cuda.device(dev):
        dx = torch.empty_like(xp)
        dw1 = torch.empty((hid, ff), dtype=f32, device=dev)
        dw2 = torch.empty((ff, hid), dtype=f32, device=dev)
        sums = torch.empty((3 * hid + ff,), dtype=f32, device=dev)
        scratch = torch.empty((_workspace("mm_mlp_block_bwd", m, hid, ff, w2_plan[0], w1_plan[0]),),
                              dtype=torch.uint8, device=dev)
        _build.call("mm_mlp_block_bwd", _build.ptr(xp), _build.ptr(pw1), _build.ptr(pb1), _build.ptr(pw2),
                    _build.ptr(g), _build.ptr(dyp), _build.ptr(acc), _build.ptr(h), _build.ptr(dx),
                    _build.ptr(dw1), _build.ptr(dw2), _build.ptr(sums), _build.ptr(scratch), m, hid, n, ff, ln_eps,
                    *w2_plan, *w1_plan, _build.stream(dev))
    _build.LAUNCHES["fused_mlp_block_bwd"] += 1
    dg, dbe, db2, db1 = sums.split((hid, hid, hid, ff))
    return (_cut(dx, x), _cut(dw1, w1), _cut(db1, b1), _cut(dw2, w2), db2[:n], dg[:n], dbe[:n])


def _attention_block_bwd_cuda(x, wqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps, head_dim=None):
    """K12 on the card, one C call (csrc mm_attention_block_bwd): (dx bf16,
    dwqkv, dbqkv, dwo, dbo, dg, dbe f32), the Q/K/V gradients packed as the
    weights are, each cut back to its input's shape. wqkv (HID, 3·A) and wo
    (A, HID) with the heads at an instanced width, as the forward took them;
    ``head_dim`` the true one; HID run at fa.card_width as the forward ran
    it."""
    acc, qkv, attn = saved
    b, l, n = x.shape
    hid = fa.card_width(n)
    width = wo.shape[0]
    d = width // n_heads
    pwqkv, pwo = fa.pad_attention_hidden(wqkv, wo, hid)
    if d not in fa._KERNEL_HEAD_DIMS or tuple(pwqkv.shape) != (hid, 3 * width) or pwo.shape[1] != hid:
        raise ValueError(f"fused_attention_block_bwd: the CUDA kernel takes head widths {fa._KERNEL_HEAD_DIMS} "
                         f"(pad_attention_heads), got wqkv {tuple(wqkv.shape)}, wo {tuple(wo.shape)}, "
                         f"{n_heads} heads for x {tuple(x.shape)}")
    check_ln_bwd_width("fused_attention_block_bwd", n)
    fa._check_gemm_dims("fused_attention_block_bwd", hid, width)
    _check_bwd("fused_attention_block_bwd", x, dy, (("wqkv", pwqkv), ("wo", pwo)))
    m = b * l
    wo_plan, wqkv_plan = wgrad_plan(m, width, hid), wgrad_plan(m, hid, 3 * width)
    f32, dev = torch.float32, x.device
    xp, dyp = fa.pad_groups(x, 1, hid, -1), fa.pad_groups(dy, 1, hid, -1)
    g, = fa.pad_vectors(hid, fa._f32(ln_scale))
    mask = fa._f32(mask)
    with torch.cuda.device(dev):
        dx = torch.empty_like(xp)
        dwqkv = torch.empty((hid, 3 * width), dtype=f32, device=dev)
        dwo = torch.empty((width, hid), dtype=f32, device=dev)
        sums = torch.empty((3 * hid + 3 * width,), dtype=f32, device=dev)
        scratch = torch.empty((_workspace("mm_attention_block_bwd", b, l, n_heads, hid, width, wo_plan[0],
                                          wqkv_plan[0]),), dtype=torch.uint8, device=dev)
        _build.call("mm_attention_block_bwd", _build.ptr(xp), _build.ptr(pwqkv), _build.ptr(pwo),
                    _build.ptr(mask), _build.ptr(g), _build.ptr(dyp), _build.ptr(acc),
                    _build.ptr(qkv), _build.ptr(attn), _build.ptr(dx), _build.ptr(dwqkv), _build.ptr(dwo),
                    _build.ptr(sums), _build.ptr(scratch), b, l, n_heads, hid, n, width, ln_eps,
                    1.0 / (head_dim or d) ** 0.5, *wo_plan, *wqkv_plan, _build.stream(dev))
    _build.LAUNCHES["fused_attention_block_bwd"] += 1
    dg, dbe, dbo, dbqkv = sums.split((hid, hid, hid, 3 * width))
    return _cut(dx, x), _cut(dwqkv, wqkv), dbqkv, _cut(dwo, wo), dbo[:n], dg[:n], dbe[:n]


def attention_block_bwd(x, wqkv, bqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps: float = 1e-12,
                        head_dim=None):
    """Backward of the attention half with packed Q/K/V: K12 on a CUDA tensor
    (``saved`` = (acc, qkv, attn) of the card's forward, the heads at an
    instanced width), the plain version on a CPU tensor (``saved`` =
    (acc,)). ``head_dim``: the true head width of zero-padded heads.
    Returns (dx, dwqkv, dbqkv, dwo, dbo, dg, dbe), weight and LayerNorm
    gradients in f32."""
    if x.is_cuda:
        return _attention_block_bwd_cuda(x, wqkv, wo, mask, n_heads, ln_scale, dy, saved, ln_eps, head_dim)
    wq, wk, wv = wqkv.chunk(3, dim=1)
    bq, bk, bv = bqkv.chunk(3)
    dx, dwq, dwk, dwv, dwo, dbq, dbk, dbv, dbo, dg, dbe = reference_attention_block_bwd(
        x, wq, wk, wv, wo, bq, bk, bv, mask, n_heads, ln_scale, dy, saved[0], ln_eps, head_dim)
    return dx, torch.cat([dwq, dwk, dwv], dim=1), torch.cat([dbq, dbk, dbv]), dwo, dbo, dg, dbe


def mlp_block_bwd(x, w1, b1, w2, ln_scale, dy, saved, ln_eps: float = 1e-12):
    """Backward of the MLP half: K11 on a CUDA tensor (``saved`` = (acc, h)),
    the plain version on a CPU tensor (``saved`` = (acc,)). Returns (dx, dw1,
    db1, dw2, db2, dg, dbe)."""
    if x.is_cuda:
        return _mlp_block_bwd_cuda(x, w1, b1, w2, ln_scale, dy, saved, ln_eps)
    return reference_mlp_block_bwd(x, w1, b1, w2, ln_scale, dy, saved[0], ln_eps)


def attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps: float = 1e-12,
                        head_dim=None):
    """The training forward: (out, saved) for :func:`attention_block_bwd`."""
    if x.is_cuda:
        return fa._attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                        save=True, head_dim=head_dim)
    out, acc = fa.fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                            save_acc=True, head_dim=head_dim)
    return out, (acc,)


def mlp_block_fwd(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12):
    """The training forward: (out, saved) for :func:`mlp_block_bwd`."""
    if x.is_cuda:
        return fa._mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save=True)
    out, acc = fa.fused_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc=True)
    return out, (acc,)


class _AttentionBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, n_heads, ln_eps, head_dim):
        out, saved = attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps, head_dim)
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, *saved)
        ctx.n_heads, ctx.ln_eps, ctx.head_dim = n_heads, ln_eps, head_dim
        return out

    @staticmethod
    def backward(ctx, dy):
        x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, *saved = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwo, dbo, dg, dbe = attention_block_bwd(
            x, wqkv, bqkv, wo, mask, ctx.n_heads, ln_scale, dy.to(x.dtype).contiguous(), saved, ctx.ln_eps,
            ctx.head_dim)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype), None,
                dg.to(ln_scale.dtype), dbe.to(ln_bias.dtype), None, None, None)


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
                                    ln_eps: float = 1e-12, head_dim=None):
    """Differentiable attention half with packed Q/K/V (the encoder's entry):
    K1 forward, K12 backward on the card. Weights whose heads are not at an
    instanced width are zero-padded on the card by differentiable ops, so
    autograd cuts their gradients back; ``head_dim``: the true head width of
    weights padded already (ops/fused_attention.py:pad_attention_heads)."""
    if x.is_cuda:
        wqkv, bqkv, wo, head_dim = fa.card_heads("fused_attention_block", wqkv, bqkv, wo, n_heads, head_dim)
    return _AttentionBlockTrain.apply(x, wqkv, bqkv, wo, bo, mask, ln_scale, ln_bias, n_heads, ln_eps, head_dim)


def fused_attention_block_train(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads, ln_scale, ln_bias,
                                ln_eps: float = 1e-12):
    """Differentiable LN(x + OutProj(MHA(x))): the JAX function's signature."""
    return fused_attention_block_qkv_train(x, torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]), wo, bo,
                                           mask, n_heads, ln_scale, ln_bias, ln_eps)


def fused_mlp_block_train(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12):
    """Differentiable LN(x + W2·gelu(W1·x + b1) + b2): K2 forward, K11
    backward on the card."""
    return _MlpBlockTrain.apply(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps)
