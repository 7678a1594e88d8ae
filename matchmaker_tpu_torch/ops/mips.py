"""Exact MIPS over a float32 corpus: counterpart of
``matchmaker_tpu/ops/mips.py:blocked_topk_scores`` (single device).

Plain PyTorch: one full-f32 product and ``torch.topk`` per corpus block, the
block winners merged by one more ``torch.topk``, so peak memory is
O(Q·block) rather than O(Q·N).
"""

from __future__ import annotations

from typing import Tuple

import torch

from matchmaker_tpu_torch.ops import matmul_f32


def blocked_topk_scores(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                        block_size: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products → (values f32, ids int64)."""
    n = corpus.shape[0]
    k = min(k, n)
    vals, ids = [], []
    for start in range(0, n, block_size):
        scores = matmul_f32(queries, corpus[start:start + block_size].T)
        v, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        vals.append(v)
        ids.append(i + start)
    v, pos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return v, torch.gather(torch.cat(ids, dim=1), 1, pos)
