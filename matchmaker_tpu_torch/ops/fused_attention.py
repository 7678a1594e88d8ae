"""The encoder's fused layer halves: counterpart of
``matchmaker_tpu/ops/fused_attention.py``.

- :func:`fused_attention_block`: LN(x + Wo·MHA(QKV-proj(x)) + bo), the
  attention half of a post-norm layer (TPU kernel K1, ``_block_kernel``);
  :func:`fused_attention_block_qkv` takes the Q/K/V weights packed;
- :func:`fused_mlp_block`: LN(x + W2·gelu(W1·x + b1) + b2), the MLP half
  (TPU kernel K2, ``_mlp_kernel``);
- :func:`fused_mha`: standalone multi-head attention over separate Q, K, V
  (B, L, H·D) (TPU kernel K13, ``_attn_kernel``). No encoder path calls it,
  in either package; its plain version is :func:`mha_reference`.

The card's attention core is instanced for heads of 16, 32, 64 and 128. A
narrower head runs on the next wider instance, zero-padded
(:func:`pad_attention_heads`): each head's Q, K and V columns of the packed
weight and bias, and the matching rows of Wo, with the true scale 1/√d
(``head_dim``). Zero columns add nothing to QKᵀ, the padded output columns
are zero and meet zero rows of Wo, and in the backward the padded columns'
gradients are exactly zero: the function is the unpadded one's, up to the
order of the sums. The encoder pads once when it packs its weights; the
functions here pad in the wrapper when given unpadded weights on a card.
The plain versions take either. Heads wider than 128 are refused.

The card's products read their operands through TMA maps whose rows must
be a multiple of 16 bytes, so a hidden or FF width that is not a multiple
of 8 runs at the next one (:func:`card_width`): the weights' rows and
columns zero-padded (:func:`pad_attention_hidden`, :func:`pad_mlp_hidden`;
the encoder once when it packs them, the wrappers otherwise), x copied
into zero-padded rows, and the LayerNorm taken over the true width from the
padded pre-LN sums (csrc ``mm_layernorm_ld``), its output written unpadded.
Zero columns add nothing to any product, so the function is the unpadded
one's; the backward (ops/fused_backward.py) cuts each gradient back to its
input's shape.

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

# The forward epilogues of the wgmma GEMM (csrc/wgmma_gemm.cuh, wg::Epilogue)
_EPI_BIAS_BF16, _EPI_BIAS_GELU_BF16, _EPI_BIAS_RESID_F32 = 4, 5, 6
# the head widths the attention core is instanced for (csrc/encoder_kernels.cu)
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# the products' TMA maps: rows of a multiple of 16 bytes, 8 bf16
_WIDTH_STEP = 8


def card_width(n: int) -> int:
    """The width the card's products run a hidden or FF width of ``n`` at:
    the next multiple of 8."""
    return -(-n // _WIDTH_STEP) * _WIDTH_STEP


def instanced_head_width(d: int) -> int:
    """The narrowest head width the card's attention cores are instanced
    for that holds a head of ``d`` (``d`` itself past 128: none does)."""
    return next((w for w in _KERNEL_HEAD_DIMS if d <= w), d)


def kernel_head_dim(name: str, hid: int, n_heads: int) -> int:
    """The instanced width the card's attention cores (K1, K10, K12, K13)
    run a head of ``hid`` / ``n_heads`` at (the head zero-padded to it), or
    ValueError: a head wider than 128 needs an instance of its own, whose
    Q fragments and output sums (at least 192 registers a thread) and tiles
    the 128-wide design no longer holds."""
    if n_heads <= 0 or hid % n_heads or hid // n_heads > _KERNEL_HEAD_DIMS[-1]:
        raise ValueError(f"{name}: the CUDA kernel takes head widths up to {_KERNEL_HEAD_DIMS[-1]} (instanced for "
                         f"{_KERNEL_HEAD_DIMS}, narrower heads zero-padded; a wider head's registers and tiles "
                         f"need an instance of its own), got {hid}/{n_heads}")
    return instanced_head_width(hid // n_heads)


def pad_groups(t: torch.Tensor, groups: int, width: int, dim: int, value: float = 0.0) -> torch.Tensor:
    """``t`` with its axis ``dim`` (``groups`` equal groups side by side:
    heads, FF chunks) holding each group padded with ``value`` (zeros) to
    ``width``; differentiable, so autograd cuts the gradients back."""
    dim %= t.dim()
    g = t.shape[dim] // groups
    if width == g:
        return t
    split = t.reshape(t.shape[:dim] + (groups, g) + t.shape[dim + 1:])
    pad = [0, 0] * (t.dim() - dim - 1) + [0, width - g]
    return torch.nn.functional.pad(split, pad, value=value).reshape(
        t.shape[:dim] + (groups * width,) + t.shape[dim + 1:])


def pad_attention_heads(wqkv, bqkv, wo, n_heads: int):
    """The packed attention weights, wqkv (HID, 3·H·d), bqkv (3·H·d,), wo
    (H·d, HID), with every head zero-padded to :func:`instanced_head_width`
    (the inputs themselves where d is instanced, or wider than 128)."""
    d = wo.shape[0] // n_heads
    width = instanced_head_width(d)
    if width == d:
        return wqkv, bqkv, wo
    return (pad_groups(wqkv, 3 * n_heads, width, 1), pad_groups(bqkv, 3 * n_heads, width, 0),
            pad_groups(wo, n_heads, width, 0))


def pad_attention_hidden(wqkv, wo, width: int):
    """wqkv (HID, 3·A) and wo (A, HID) with HID zero-padded to ``width``
    (:func:`card_width`): wqkv's rows, wo's columns; differentiable, and the
    inputs themselves where HID is ``width`` already."""
    return pad_groups(wqkv, 1, width, 0), pad_groups(wo, 1, width, 1)


def pad_mlp_hidden(w1, w2, width: int, ff_width: int):
    """w1 (HID, FF) and w2 (FF, HID) with HID zero-padded to ``width`` and
    FF to ``ff_width``; differentiable, a no-op where nothing needs it."""
    return (pad_groups(pad_groups(w1, 1, width, 0), 1, ff_width, 1),
            pad_groups(pad_groups(w2, 1, ff_width, 0), 1, width, 1))


def pad_vectors(width: int, *vectors):
    """Each (N,) vector zero-padded to ``width``."""
    return tuple(pad_groups(v, 1, width, 0) for v in vectors)


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
                              ln_scale, ln_bias, ln_eps: float = 1e-12, save_acc: bool = False,
                              head_dim=None):
    """Plain version of the attention-half kernel (same math, same casts).
    The weights' heads may be zero-padded (:func:`pad_attention_heads`):
    ``head_dim``, the true head width, sets the scale (default: the
    weights' own)."""
    b, l, hid = x.shape
    width = wq.shape[1]
    d = width // n_heads
    cd = x.dtype
    x2 = x.reshape(b * l, hid)

    def proj(w, bias):  # (B, H, L, D) in the compute dtype
        h = (matmul_f32(x2, w) + bias.float()).to(cd)
        return h.reshape(b, l, n_heads, d).transpose(1, 2)

    q, k, v = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    s = matmul_f32(q, k.transpose(-1, -2)) * (1.0 / (head_dim or d) ** 0.5)
    s = s + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    a = matmul_f32(p, v).to(cd).transpose(1, 2).reshape(b * l, width)
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
    """f32, contiguous, 16-byte aligned (the kernels read biases in pairs)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_gemm_dims(name: str, k: int, n: int) -> None:
    # the TMA tensor maps of wgmma_gemm.cuh: rows of A (K) and of the weight
    # (N) a multiple of 16 bytes; the wrappers pad to card_width first
    if k % _WIDTH_STEP or n % _WIDTH_STEP:
        raise ValueError(f"{name}: the CUDA kernel needs K % 8 == 0 and N % 8 == 0 (pad to card_width), "
                         f"got K={k}, N={n}")


def _gemm(a, w, bias, out, epilogue, resid=None):
    """out = a (M, K) · w (K, N) + bias, then the epilogue (csrc
    mm_wg_gemm_fwd: the wgmma GEMM reading w MN-major where it lies)."""
    k, n = w.shape
    m = a.numel() // k
    _build.call("mm_wg_gemm_fwd", _build.ptr(a), _build.ptr(w), _build.ptr(bias),
                _build.ptr(resid) if resid is not None else ctypes.c_void_p(),
                _build.ptr(out), m, n, k, epilogue, _build.stream(a.device))


def _layernorm(acc, ln_scale, ln_bias, n: int, ln_eps: float, out):
    """out (M, n) = LayerNorm over the first n of acc's (M, ld) columns
    (csrc mm_layernorm_ld)."""
    ld = acc.shape[-1]
    g, be = pad_vectors(ld, _f32(ln_scale), _f32(ln_bias))
    _build.call("mm_layernorm_ld", _build.ptr(acc), _build.ptr(g), _build.ptr(be), _build.ptr(out),
                acc.numel() // ld, n, ld, n, ln_eps, _build.stream(acc.device))


def card_heads(name: str, wqkv, bqkv, wo, n_heads: int, head_dim=None):
    """(wqkv, bqkv, wo, head_dim) for the card's attention core: the heads
    zero-padded to an instanced width where they are not at one, and the
    true head width (``head_dim``, default: the weights' own)."""
    hid = wo.shape[1]
    if wo.shape[0] % max(n_heads, 1) or tuple(wqkv.shape) != (hid, 3 * wo.shape[0]):
        raise ValueError(f"{name}: wqkv {tuple(wqkv.shape)} and wo {tuple(wo.shape)} do not fit {n_heads} heads")
    kernel_head_dim(name, wo.shape[0], n_heads)
    head_dim = head_dim or wo.shape[0] // n_heads
    return (*pad_attention_heads(wqkv, bqkv, wo, n_heads), head_dim)


def _attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                          save: bool = False, head_dim=None):
    """K1 on the card: wqkv (HID, 3·A), wo (A, HID) with A = H·width, the
    heads at an instanced width (:func:`card_heads`), ``head_dim`` the true
    one; HID x's width or already padded to :func:`card_width` (x's rows
    are then copied into padded ones). ``save``: also return (acc, qkv,
    attn), the f32 pre-LN sums (at the padded width) and the bf16 QKV
    projections and attention output the backward (K12) reads instead of
    recomputing them."""
    b, l, n = x.shape
    hid = card_width(n)
    width = wo.shape[0]
    d = width // n_heads
    wqkv, wo = pad_attention_hidden(wqkv, wo, hid)
    if d not in _KERNEL_HEAD_DIMS or tuple(wqkv.shape) != (hid, 3 * width) or wo.shape[1] != hid:
        raise ValueError(f"fused_attention_block: the CUDA kernel takes head widths {_KERNEL_HEAD_DIMS} "
                         f"(pad_attention_heads), got wqkv {tuple(wqkv.shape)}, wo {tuple(wo.shape)}, {n_heads} heads "
                         f"for x {tuple(x.shape)}")
    _check_gemm_dims("fused_attention_block", hid, hid)
    bf16 = torch.bfloat16
    for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
        _build.check_cuda(t, f"fused_attention_block.{name}", bf16)
    xp = pad_groups(x, 1, hid, -1)
    bo, = pad_vectors(hid, _f32(bo))
    with torch.cuda.device(x.device):
        qkv = torch.empty((b, l, 3 * width), dtype=bf16, device=x.device)
        _gemm(xp, wqkv, _f32(bqkv), qkv, _EPI_BIAS_BF16)
        attn = torch.empty((b, l, width), dtype=bf16, device=x.device)
        _build.call("mm_attention_core", _build.ptr(qkv), _build.ptr(_f32(mask)), _build.ptr(attn),
                    b, l, n_heads, d, 1.0 / (head_dim or d) ** 0.5, _build.stream(x.device))
        acc = torch.empty((b, l, hid), dtype=torch.float32, device=x.device)
        _gemm(attn, wo, _f32(bo), acc, _EPI_BIAS_RESID_F32, resid=xp)
        out = torch.empty_like(x)
        _layernorm(acc, ln_scale, ln_bias, n, ln_eps, out)
    _build.LAUNCHES["fused_attention_block"] += 1
    return (out, (acc, qkv, attn)) if save else out


def _mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save: bool = False):
    """K2 on the card, HID and FF run at :func:`card_width` (the weights
    padded here where the encoder has not padded them). ``save``: also
    return (acc, h), the f32 pre-LN sums and the bf16 gelu output the
    backward (K11) reads, at the padded widths."""
    b, l, n = x.shape
    hid, ff = card_width(n), card_width(w1.shape[1])
    w1, w2 = pad_mlp_hidden(w1, w2, hid, ff)
    if tuple(w1.shape) != (hid, ff) or tuple(w2.shape) != (ff, hid):
        raise ValueError(f"fused_mlp_block: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    _check_gemm_dims("fused_mlp_block", hid, ff)
    bf16 = torch.bfloat16
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        _build.check_cuda(t, f"fused_mlp_block.{name}", bf16)
    xp = pad_groups(x, 1, hid, -1)
    b1, b2 = pad_vectors(ff, _f32(b1))[0], pad_vectors(hid, _f32(b2))[0]
    with torch.cuda.device(x.device):
        h = torch.empty((b, l, ff), dtype=bf16, device=x.device)
        _gemm(xp, w1, _f32(b1), h, _EPI_BIAS_GELU_BF16)
        acc = torch.empty((b, l, hid), dtype=torch.float32, device=x.device)
        _gemm(h, w2, _f32(b2), acc, _EPI_BIAS_RESID_F32, resid=xp)
        out = torch.empty_like(x)
        _layernorm(acc, ln_scale, ln_bias, n, ln_eps, out)
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
    CUDA tensors: bf16, head width at most 128, any L. ``save_acc``:
    return (out, acc) with acc the f32 pre-LN sum (B, L, HID; on a card at
    :func:`card_width`)."""
    return fused_attention_block_qkv(x, torch.cat([wq, wk, wv], dim=1), torch.cat([bq, bk, bv]), wo, bo, mask,
                                     n_heads, ln_scale, ln_bias, ln_eps, save_acc)


def fused_attention_block_qkv(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias,
                              ln_eps: float = 1e-12, save_acc: bool = False, head_dim=None):
    """:func:`fused_attention_block` with the Q, K and V projections packed
    side by side: wqkv (HID, 3·A), bqkv (3·A,), wo (A, HID), A = HID or the
    heads zero-padded (:func:`pad_attention_heads`, ``head_dim`` the true
    head width). The encoder keeps them packed once per set of weights, so
    no call concatenates them."""
    if not x.is_cuda:
        wq, wk, wv = wqkv.chunk(3, dim=1)
        bq, bk, bv = bqkv.chunk(3)
        return reference_attention_block(x, wq, wk, wv, wo, bq, bk, bv, bo, mask, n_heads,
                                         ln_scale, ln_bias, ln_eps, save_acc, head_dim)
    wqkv, bqkv, wo, head_dim = card_heads("fused_attention_block", wqkv, bqkv, wo, n_heads, head_dim)
    return _acc_only(_attention_block_cuda(x, wqkv, bqkv, wo, bo, mask, n_heads, ln_scale, ln_bias, ln_eps,
                                           save_acc, head_dim), save_acc)


def mha_reference(q, k, v, mask, n_heads):
    """Plain version of K13, the function the kernel computes: per head, f32
    logits QKᵀ scaled after the product, plus (mask − 1)·1e9, an f32 softmax
    with the max subtracted, the probabilities rounded to v's dtype before
    P·V (f32 sums), the output in q's dtype. JAX's ``mha_reference`` rounds
    the logits to the input dtype first; this follows its kernel, ``fused_mha``."""
    b, l, hd = q.shape
    d = hd // n_heads

    def split(t):  # (B, H, L, D)
        return t.reshape(b, l, n_heads, d).transpose(1, 2)

    s = matmul_f32(split(q), split(k).transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = s + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    o = matmul_f32(p.to(v.dtype), split(v)).to(q.dtype)
    return o.transpose(1, 2).reshape(b, l, hd)


def _mha_cuda(q, k, v, mask, n_heads):
    """K13 on the card: K1's attention core reading separate Q, K, V with
    row stride H·D, the normalised probabilities rounded to bf16 (csrc
    mm_fused_mha). Heads not at an instanced width are zero-padded to one
    per head and the output cut back."""
    b, l, hd = q.shape
    width = kernel_head_dim("fused_mha", hd, n_heads)
    if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != (b, l):
        raise ValueError(f"fused_mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(t, f"fused_mha.{name}", torch.bfloat16)
    d = hd // n_heads
    if width != d:
        q, k, v = (pad_groups(t, n_heads, width, -1) for t in (q, k, v))
    mask = _f32(mask)  # held in a name until the launch: the kernel reads it on the stream
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        _build.call("mm_fused_mha", _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask), _build.ptr(out),
                    b, l, n_heads, width, 1.0 / d ** 0.5, _build.stream(q.device))
    _build.LAUNCHES["fused_mha"] += 1
    if width != d:
        out = out.reshape(b, l, n_heads, width)[..., :d].reshape(b, l, hd)
    return out


def fused_mha(q, k, v, mask, n_heads):
    """Multi-head self-attention, forward only: q, k, v (B, L, H·D), mask
    (B, L) with 1 = real key; output (B, L, H·D) in q's dtype. CUDA tensors:
    bf16, head width at most 128, any L."""
    if not q.is_cuda:
        return mha_reference(q, k, v, mask, n_heads)
    return _mha_cuda(q, k, v, mask, n_heads)


def fused_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps: float = 1e-12, save_acc: bool = False):
    """LN(x + W2·gelu(W1·x + b1) + b2): x (B, L, HID); w1 (HID, FF) and
    w2 (FF, HID) in x's dtype. CUDA tensors: bf16, any HID and FF (run at
    :func:`card_width`). ``save_acc``: return (out, acc) with acc the f32
    pre-LN sum (on a card at the padded width)."""
    if not x.is_cuda:
        return reference_mlp_block(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc)
    return _acc_only(_mlp_block_cuda(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps, save_acc), save_acc)
