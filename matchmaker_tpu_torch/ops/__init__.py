"""Device ops of the port: hand-written CUDA kernels behind wrappers, each
with its plain PyTorch version beside it.

Dispatch rule of every wrapper: a tensor on the CPU runs the plain version;
a CUDA tensor launches the kernel or raises (there is no fallback)."""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands upcast to float32 and the product in full
    float32 (no TF32): the plain form of a bf16 x bf16 -> f32 tensor-core
    product, and of the JAX package's ``preferred_element_type=float32``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a.float(), b.float())
    finally:
        torch.set_float32_matmul_precision(prev)


def over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true IEEE division, as the kernels divide and as the CPU
    divides in both packages. PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which differs in the last bit for about
    one value in twenty; a divisor tensor on the same device keeps the
    division."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


# an f32 product of int8 codes is exact while every partial sum stays below
# 2**24: 127 * 127 * K < 2**24
_EXACT_CODES_DEPTH = (1 << 24) // (127 * 127)


def matmul_codes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) of int8 codes: the int32 sums of an int8 x int8
    product as f32, each rounded once to nearest as a kernel converts its
    int32 sums: an f32 product up to K = 1040 (127²·K < 2²⁴: exact), an f64
    one past it (exact sums, then the rounding)."""
    if a.shape[-1] <= _EXACT_CODES_DEPTH:
        return matmul_f32(a, b)
    return torch.matmul(a.double(), b.double()).float()


def topk_lowest_first(x: torch.Tensor, k: int):
    """``torch.topk(x, k, dim=1)`` with ties to the lower index, the order
    ``jax.lax.top_k`` gives (``torch.topk`` promises none on a card): each
    f32 score becomes an order-keeping int32, widened to an int64 key with
    the complement of its column below it, so no two keys tie. → (values
    f32, int64 indices), largest first."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()  # IEEE order as integer order
    col = torch.arange(x.shape[1], device=x.device)
    key = key * (1 << 32) + ((1 << 32) - 1 - col)
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(x, 1, idx), idx
