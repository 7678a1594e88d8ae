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
