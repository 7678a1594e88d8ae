"""Exact scan over a 16-bit corpus: counterpart of
``matchmaker_tpu/ops/mips_f16.py:f16_scan_topk`` — the exact fallback of
FlatIndex's binmax route for corpora too small for its candidate pool.

Plain PyTorch: both operands rounded to bf16 (as the JAX scan does) and
upcast to f32 for a full-f32 product — a bf16 ``torch.matmul`` on CUDA would
round its output to bf16, where JAX asks for f32 — then ``torch.topk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from matchmaker_tpu_torch.ops import matmul_f32


def f16_scan_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                  n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of queries (Q, D) against corpus (N, D) over bf16-rounded
    operands; rows at/after ``n_valid`` never enter. → (values f32, ids int64)."""
    n = corpus.shape[0]
    k = min(k, n)
    scores = matmul_f32(queries.to(torch.bfloat16), corpus.to(torch.bfloat16).T)
    if n_valid is not None and n_valid < n:
        scores[:, n_valid:] = float("-inf")
    return torch.topk(scores, k, dim=1)
