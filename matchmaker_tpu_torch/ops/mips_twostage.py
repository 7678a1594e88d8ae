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
no TF32) of the gathered (Q, fetch, D) rows. :func:`sharded_twostage_topk`
runs both stages a shard on its rows and merges the partials
(parallel/mesh.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import matmul_f32, topk_lowest_first
from matchmaker_tpu_torch.ops.mips_quant import quantized_blocked_topk
from matchmaker_tpu_torch.parallel.mesh import Mesh, ShardedRows, merge_topk, n_shards, pad_partial


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


def sharded_twostage_topk(queries: torch.Tensor, values, scales, k: int, mesh: Optional[Mesh] = None,
                          rescore_corpus=None, n_valid: Optional[int] = None,
                          **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`twostage_exact_topk` over a corpus row-sharded over ``mesh``
    (``values``, per-row ``scales`` and ``rescore_corpus``
    :class:`ShardedRows` alike, or a 0-d global scale; plain tensors without
    a mesh of more than one entry): both stages a shard, each masked at its
    local validity bound, one merge."""
    if n_shards(mesh) <= 1:
        return twostage_exact_topk(queries, values, scales, k, rescore_corpus=rescore_corpus, n_valid=n_valid,
                                   **kw)
    rows = values.rows
    n_valid = rows * values.n_shards if n_valid is None else n_valid
    partials = []
    for i, (s, part) in enumerate(values):
        base = s * rows
        local_valid = min(max(n_valid - base, 0), rows)
        shard_scales = scales.parts[i] if isinstance(scales, ShardedRows) else scales.to(part.device)
        vals, idx = pad_partial(*twostage_exact_topk(
            queries.to(part.device), part, shard_scales, k, n_valid=local_valid,
            rescore_corpus=rescore_corpus.parts[i] if rescore_corpus is not None else None, **kw), k)
        partials.append((vals, torch.where(torch.isfinite(vals) & (idx >= 0), idx + base, -1)))
    return merge_topk(partials, k, queries.device)
