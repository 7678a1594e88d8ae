"""Model API conventions: counterpart of ``matchmaker_tpu/models/base.py``.

Every ranker is an ``nn.Module`` whose ``forward(batch, output_secondary)``
takes a batch dict and returns an output dict:

batch keys (independent input):   query_ids, query_mask, doc_ids, doc_mask
batch keys (concatenated input):  seq_ids, seq_mask, seq_type_ids

output keys:
  "score"       (B,)  — always present
  "query_vecs"  (B, D) or (B, Lq, D)  — bi-encoders, for in-batch negatives
  "doc_vecs"    (B, D) or (B, Ld, D)
  "passage_scores" (B, C) — chunk adapters, for the passage losses
  "secondary"   dict of interpretability tensors (only when output_secondary)

Representation methods for the retrieval runtime:
  encode(ids, mask, sequence_type)  → per-sequence vectors
  aggregate(q_reps, d_reps, q_mask, d_mask) → scores (late-interaction models)
Rankers without them (the cross-encoders) refuse both.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

Batch = Dict[str, torch.Tensor]
Output = Dict[str, Any]


class Ranker(nn.Module):
    """Base class; see the module docstring for the API contract."""

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, sequence_type: str = "doc") -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} is not a dense encoder")

    def aggregate(self, q_reps, d_reps, q_mask=None, d_mask=None) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no late-interaction aggregation")
