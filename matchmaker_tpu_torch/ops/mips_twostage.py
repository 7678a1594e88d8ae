"""Two-stage exact MIPS: counterpart of
``matchmaker_tpu/ops/mips_twostage.py:twostage_exact_topk`` (single device;
that module has no Pallas kernel).

  stage 1  the exact int8 scan (ops/mips_quant.py:quantized_blocked_topk)
           fetches ``oversample``·k candidates a query; JAX asks for
           ``approx_max_k`` there, a TPU hardware top-k the port does not
           have, so the port's stage 1 is exact;
  stage 2  the candidates' rows are gathered and rescored in f32 against
           the int8 codes × their scales, or against the 16-bit rows of
           ``rescore_corpus``, then one top-k over the candidates, ties to
           the lower stage-1 rank (``ops.topk_lowest_first``).

Plain PyTorch: the rescore is a batched full-f32 product (``ops.matmul_f32``,
no TF32) of the gathered (Q, fetch, D) rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first
from matchmaker_tpu_torch.ops.mips_quant import quantized_blocked_topk


def twostage_exact_topk(
    queries: torch.Tensor,  # (Q, D) f32
    values: torch.Tensor,  # (N, D) int8 stage-1 corpus
    scales: torch.Tensor,  # () global or (N,) per-row f32
    k: int,
    oversample: int = 4,
    block_size: int = 131072,
    rescore_corpus: Optional[torch.Tensor] = None,  # (N, D) 16-bit or f32 rows; None: rescore the codes
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescored top-k → ((Q, k) f32 scores, int64 ids, -1 / -inf for
    empty places). ``n_valid`` masks zero-padded tail rows in stage 1."""
    n = values.shape[0]
    fetch = min(max(k * oversample, k), n)
    cand_vals, cand_idx = quantized_blocked_topk(queries, values, scales, fetch, block_size=block_size,
                                                 n_valid=n_valid)
    valid = torch.isfinite(cand_vals)
    safe_idx = cand_idx.clamp(0, n - 1)
    q = queries.float()[:, :, None]  # (Q, D, 1)
    if rescore_corpus is not None:
        exact = matmul_f32(rescore_corpus[safe_idx], q)[..., 0]
    else:
        exact = matmul_f32(values[safe_idx], q)[..., 0]
        exact = exact * (scales if scales.dim() == 0 else scales[safe_idx])
    exact = torch.where(valid, exact, float("-inf"))
    k_eff = min(k, cand_vals.shape[1])
    vals, pos = topk_lowest_first(exact, k_eff)
    idx = torch.where(torch.isfinite(vals), torch.gather(cand_idx, 1, pos), -1)
    if k_eff < k:
        vals = F.pad(vals, (0, k - k_eff), value=float("-inf"))
        idx = F.pad(idx, (0, k - k_eff), value=-1)
    return vals, idx
