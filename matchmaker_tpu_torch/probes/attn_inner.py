"""The attention inner-loop probe: counterpart of
``benchmarks/attn_inner_probe.py`` and of its TPU kernel K15 (``k_batched``;
``k_unrolled``, ``k_allheads`` and ``k_blockdiag`` compute the same function
in other MXU shapes and have no separate port).

:func:`attn_inner` takes pre-projected q, k, v (B, L, H·64) and a key mask
(B, L) and returns, per head, softmax(q·kᵀ/8 + (m − 1)·1e9)·v in the input
layout, in one of three variants:

- ``batched``: the probabilities rounded to bf16 before P·V (as K13);
- ``f32_p``: the probabilities kept f32 (as K1's attention core); the
  kernel feeds them to the tensor cores as a bf16 hi + lo pair;
- ``softmax_stub``: p = s·0.005, no mask: wrong math on purpose, for
  attributing time, as in the TPU probe.

CUDA tensors (bf16, head width 64, 1 <= L <= 512) launch the kernel of
``csrc/probe_attn_inner.cu`` (one warpgroup a (head, example), the scores
in registers, both products on ``wgmma``; :func:`kernel_plan` says how it
takes L); CPU tensors run :func:`reference_attn_inner`.

    python -m matchmaker_tpu_torch.probes.attn_inner [--rows 256] [--len 200] [--iters 30] [--device cpu]

times the three variants, K13's ``fused_mha`` (P·V as f32 FMAs on the CUDA
cores) and ``scaled_dot_product_attention`` with the same additive mask (a
yardstick the port never calls) on q = k = v as the TPU probe does, and
prints one JSON line keyed by the TPU probe's names (``batched(current)``,
``batched_SOFTMAX_STUB``, ``batched_f32_p``), each {ms, tflops,
eff_vs_peak} against the H100's 989 TFLOP/s, FLOPs = 4·B·L²·64·12, and
the kernel's plan for L.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from matchmaker_tpu_torch.ops import _build, matmul_f32
from matchmaker_tpu_torch.ops import fused_attention as fa
from matchmaker_tpu_torch.probes import card, device_of, median_ms, rate

VARIANTS = {"batched": 0, "f32_p": 1, "softmax_stub": 2}
HEAD_DIM = 64
_KERNEL_MAX_LEN = 512
_CHUNK = 64  # keys of a wgmma accumulator, rows of a query tile and of a TMA box
_CHUNKS_IN_REGISTERS = 4  # 64-key chunks a thread's registers hold a pass


def kernel_plan(length: int, batch: int = 1, n_heads: int = 12) -> dict:
    """How the card's kernel takes L keys (``csrc/probe_attn_inner.cu``,
    ``launch_for``): one CTA of 128 threads a (head, example); ⌈L/64⌉
    query tiles of 64 rows; K and V in 64-key boxes, zero past L, their
    keys padded to a multiple of 64 with p = 0; up to 256 keys one pass
    with the whole row in registers (``chunks`` accumulators of 64 keys),
    past 256 two halves of four chunks (max and sum first, then S again);
    the dynamic shared memory of Q tiles, K and V boxes, the additive mask
    and the mbarriers."""
    if not 1 <= length <= _KERNEL_MAX_LEN:
        raise ValueError(f"attn_inner: the CUDA kernel takes 1 <= L <= {_KERNEL_MAX_LEN}, got {length}")
    tiles = -(-length // _CHUNK)
    halves = 1 if tiles <= _CHUNKS_IN_REGISTERS else 2
    chunks = tiles if halves == 1 else _CHUNKS_IN_REGISTERS
    boxes = chunks * halves
    box_bytes = _CHUNK * HEAD_DIM * 2
    return {"q_tiles": tiles, "chunks": chunks, "halves": halves, "keys_padded": _CHUNK * boxes,
            "grid": [n_heads, batch], "threads": 128,
            "smem_bytes": 1024 + (tiles + 2 * boxes) * box_bytes + boxes * _CHUNK * 4 + (2 + tiles) * 8}


def reference_attn_inner(q, k, v, mask, variant: str = "batched", n_heads: int = 12) -> torch.Tensor:
    """Plain version of K15: per head f32 logits q·kᵀ scaled after the
    product, then (variant ``softmax_stub``: s·0.005) or the softmax of
    s + (m − 1)·1e9 with the max subtracted; p rounded to v's dtype unless
    ``f32_p``; P·V with f32 sums; the output in q's dtype, (B, L, H·D)."""
    if variant not in VARIANTS:
        raise ValueError(f"attn_inner: variant {variant!r} is not one of {sorted(VARIANTS)}")
    b, l, hd = q.shape
    d = hd // n_heads

    def split(t):  # (B, H, L, D)
        return t.reshape(b, l, n_heads, d).transpose(1, 2)

    s = matmul_f32(split(q), split(k).transpose(-1, -2)) * (1.0 / d ** 0.5)
    if variant == "softmax_stub":
        p = s * 0.005
    else:
        s = s + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
        s = s - s.amax(dim=-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(dim=-1, keepdim=True)
    if variant != "f32_p":
        p = p.to(v.dtype)
    o = matmul_f32(p, split(v)).to(q.dtype)
    return o.transpose(1, 2).reshape(b, l, hd)


def attn_inner(q, k, v, mask, variant: str = "batched", n_heads: int = 12) -> torch.Tensor:
    """The attention inner loop, (B, L, H·D) in q's dtype."""
    if not q.is_cuda:
        return reference_attn_inner(q, k, v, mask, variant, n_heads)
    if variant not in VARIANTS:
        raise ValueError(f"attn_inner: variant {variant!r} is not one of {sorted(VARIANTS)}")
    b, l, hd = q.shape
    if hd % n_heads or hd // n_heads != HEAD_DIM:
        raise ValueError(f"attn_inner: the CUDA kernel takes head width {HEAD_DIM}, got {hd}/{n_heads}")
    if not 1 <= l <= _KERNEL_MAX_LEN:
        raise ValueError(f"attn_inner: the CUDA kernel takes 1 <= L <= {_KERNEL_MAX_LEN}, got {l}")
    if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != (b, l):
        raise ValueError(f"attn_inner: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_cuda(t, f"attn_inner.{name}", torch.bfloat16)
    mask = mask.to(torch.float32).contiguous()  # held in a name until the launch
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        _build.call("mm_probe_attn_inner", _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
                    _build.ptr(out), b, l, n_heads, 1.0 / HEAD_DIM ** 0.5, VARIANTS[variant],
                    _build.stream(q.device))
    _build.LAUNCHES["attn_inner"] += 1
    return out


def sdpa(q, k, v, mask, n_heads: int = 12) -> torch.Tensor:
    """One ``scaled_dot_product_attention`` call on the same function (the
    additive mask in the inputs' dtype): the library yardstick."""
    b, l, hd = q.shape

    def split(t):
        return t.view(b, l, n_heads, hd // n_heads).transpose(1, 2)

    add = ((mask.float() - 1.0) * 1e9).to(q.dtype)[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=add)
    return out.transpose(1, 2).reshape(b, l, hd)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--len", type=int, dest="length", default=200)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    b, l, h = args.rows, args.length, args.heads
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.normal(0, 0.3, (b, l, h * HEAD_DIM)).astype(np.float32)).to(device, torch.bfloat16)
    mask = torch.ones(b, l, device=device)
    flops = 4 * b * l * l * HEAD_DIM * h  # two products per head per example

    rows = {"batched(current)": lambda: attn_inner(x, x, x, mask, "batched", h),
            "batched_SOFTMAX_STUB": lambda: attn_inner(x, x, x, mask, "softmax_stub", h),
            "batched_f32_p": lambda: attn_inner(x, x, x, mask, "f32_p", h),
            "fused_mha(K13)": lambda: fa.fused_mha(x, x, x, mask, h),
            "sdpa": lambda: sdpa(x, x, x, mask, h)}
    result = {name: rate(flops, median_ms(fn, device, args.iters), "bf16", device) for name, fn in rows.items()}
    result.update(shape=[b, l, h * HEAD_DIM], device=card(device), plan=kernel_plan(l, b, h))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
