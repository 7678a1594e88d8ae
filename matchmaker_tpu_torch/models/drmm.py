"""DRMM, histogram matching with term gating (Guo et al., CIKM'16):
counterpart of ``matchmaker_tpu/models/drmm.py``.

Each query term's cosines against the live document terms counted into
``bin_count`` bins over [-1, 1]: bin ``floor((cos + 1) · bins / 2)``,
clipped to the last bin (``torch.histc``'s rule: a cosine of exactly 1.0,
an exact match, lands in the last bin), counted by a one-hot sum, ``log1p``,
a two-layer tanh MLP; the query-term gate, a two-layer tanh MLP on the
query embedding, softmaxed over the live query terms; the score is the
gated sum. Plain PyTorch, the cosine in full f32 (``ops.matmul_f32``), as
the JAX model is jnp. A cosine within an ulp of a bin edge can land in
another bin on another device (``histogram_bins`` lets a caller count
them); the histogram has no gradient, as in the JAX model.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.encoder import Dense
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.modules.pooling import masked_softmax
from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix


def histogram_bins(match: torch.Tensor, bins: int) -> torch.Tensor:
    """(B, Lq, Ld) cosines → their int64 bin over [-1, 1]."""
    return torch.clamp(torch.floor((match + 1.0) * (bins / 2.0)).long(), 0, bins - 1)


class DRMM(Ranker):
    def __init__(self, vocab_size: int, dim: int, bin_count: int = 30, pretrained: Optional[np.ndarray] = None):
        super().__init__()
        self.bin_count = bin_count
        self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        self.match_hidden = Dense(bin_count, bin_count)
        self.match_out = Dense(bin_count, 1)
        self.gate_hidden = Dense(dim, dim)
        self.gate_out = Dense(dim, 1)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300), config.get("drmm_bins", 30),
                   pretrained)

    def histogram(self, match: torch.Tensor, d_mask: torch.Tensor) -> torch.Tensor:
        """(B, Lq, Ld) cosines → (B, Lq, bins) counts over the live document terms."""
        one_hot = F.one_hot(histogram_bins(match, self.bin_count), self.bin_count).to(match.dtype)
        return (one_hot * d_mask[:, None, :, None]).sum(dim=2)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask)
        d_emb = self.embedder(batch["doc_ids"], d_mask)
        hist = torch.log1p(self.histogram(cosine_match_matrix(q_emb, d_emb).detach(), d_mask))
        matches_per_query = torch.tanh(self.match_out(torch.tanh(self.match_hidden(hist))))  # (B, Lq, 1)
        gate_raw = torch.tanh(self.gate_out(torch.tanh(self.gate_hidden(q_emb)))).squeeze(-1)
        gates = masked_softmax(gate_raw, q_mask, dim=1)[..., None]
        out: Output = {"score": (matches_per_query * gates).sum(dim=1).squeeze(-1)}
        if output_secondary:
            out["secondary"] = {"histogram": hist, "query_gates": gates.squeeze(-1)}
        return out
