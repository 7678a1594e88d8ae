"""Exact MIPS over a float32 corpus: counterpart of
``matchmaker_tpu/ops/mips.py`` (``blocked_topk_scores`` and
``sharded_topk_mips``).

Plain PyTorch: one full-f32 product and ``torch.topk`` per corpus block, the
block winners merged by one more ``torch.topk``, so peak memory is
O(Q·block) rather than O(Q·N). Over a mesh each shard runs the blocked scan
on its own device with its global row offset, and the (Q, k) partials merge
into one top-k (parallel/mesh.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from matchmaker_tpu_torch.ops import matmul_f32
from matchmaker_tpu_torch.parallel.mesh import Mesh, merge_topk, n_shards, pad_partial


def blocked_topk_scores(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                        block_size: int = 65536, index_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products → (values f32, ids int64, shifted by
    ``index_offset``)."""
    n = corpus.shape[0]
    k = min(k, n)
    vals, ids = [], []
    for start in range(0, n, block_size):
        scores = matmul_f32(queries, corpus[start:start + block_size].T)
        v, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
        vals.append(v)
        ids.append(i + start)
    v, pos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
    return v, torch.gather(torch.cat(ids, dim=1), 1, pos) + index_offset


def sharded_topk_mips(queries: torch.Tensor, corpus, k: int, mesh: Optional[Mesh] = None,
                      block_size: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus row-sharded over ``mesh`` (a
    :class:`ShardedRows`; a plain tensor without a mesh of more than one
    entry). As in the JAX package, rows past the real ones are not masked
    here (the caller drops their ids)."""
    if n_shards(mesh) <= 1:
        return blocked_topk_scores(queries, corpus, k, block_size)
    partials = []
    for s, part in corpus:
        v, i = blocked_topk_scores(queries.to(part.device), part, k, block_size, index_offset=s * corpus.rows)
        partials.append(pad_partial(v, i, k))
    return merge_topk(partials, k, queries.device)
