"""PACRR and CO-PACRR, position-aware convolution over the match matrix:
counterpart of ``matchmaker_tpu/models/pacrr.py``.

PACRR: the cosine match matrix, an n x n convolution per n-gram size
n = 2 .. ``max_conv_kernel_size`` (padded right and bottom only, so each
output is as large as the matrix; modules/conv.py:MatrixConv), the max over
each convolution's output channels, the k-max over every query row of the
raw matrix and of each channel max, the features weighted by a softmax of
the query idfs over the live query terms (``pacrr_apply_idf_weighting``),
then a 100 → 10 → 1 ReLU MLP. CO-PACRR adds a context channel: the cosine
of the query's mean vector against a rolling mean of ``context_pool_size``
document vectors, gathered at each k-max position, over views of the first
25/50/75/100 % of the document. The first Dense reads ``max_query_length``
rows of features: flax sizes it from the example batch, and the JAX model
keeps ``pacrr_unified_query_length`` / ``_document_length`` without using
them. Plain PyTorch, full f32 (the convolutions
and the cosine through ``ops.matmul_f32``, never TF32), as the JAX model is
jnp. Every k-max puts the lower position first among ties, as
``jax.lax.top_k`` does (``ops.topk_lowest_first``): CO-PACRR gathers the
context at those positions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.models.encoder import Dense
from matchmaker_tpu_torch.modules.conv import MatrixConv
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.modules.pooling import masked_softmax, sliding_window_mean
from matchmaker_tpu_torch.ops import topk_lowest_first
from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix


def kmax(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the top k over the last axis, largest first, the
    lower index first among ties."""
    values, idx = topk_lowest_first(x.reshape(-1, x.shape[-1]), k)
    return values.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


class PACRR(Ranker):
    def __init__(self, vocab_size: int, dim: int, query_length: int = 30, max_conv_kernel_size: int = 3,
                 conv_output_size: int = 32, kmax_pooling_size: int = 5, apply_idf_weighting: bool = True,
                 pretrained: Optional[np.ndarray] = None, features_per_row: Optional[int] = None):
        super().__init__()
        self.max_conv_kernel_size = max_conv_kernel_size
        self.kmax_pooling_size = kmax_pooling_size
        self.apply_idf_weighting = apply_idf_weighting
        self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        for n in range(2, max_conv_kernel_size + 1):
            self.add_module(f"conv_{n}", MatrixConv(1, conv_output_size, n, n))
        # the raw matrix's k-max and one per n-gram size, for every query row
        per_row = features_per_row or kmax_pooling_size * max_conv_kernel_size
        self.dense = Dense(query_length * per_row, 100)
        self.dense2 = Dense(100, 10)
        self.dense3 = ScoreLayer(10, use_bias=False)

    @staticmethod
    def pacrr_args(config, pretrained=None) -> dict:
        return dict(vocab_size=config["_vocab_size"], dim=config.get("token_embedding_size", 300),
                    query_length=config.get("max_query_length", 30),
                    max_conv_kernel_size=config.get("pacrr_max_conv_kernel_size", 3),
                    conv_output_size=config.get("pacrr_conv_output_size", 32),
                    kmax_pooling_size=config.get("pacrr_kmax_pooling_size", 5),
                    apply_idf_weighting=config.get("pacrr_apply_idf_weighting", True), pretrained=pretrained)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(**cls.pacrr_args(config, pretrained))

    def channel_maxes(self, match: torch.Tensor):
        """[(B, Lq, Ld)] the raw matrix, then each convolution's max over its
        output channels."""
        x = match[..., None]
        return [match] + [getattr(self, f"conv_{n}")(x).amax(dim=-1)
                          for n in range(2, self.max_conv_kernel_size + 1)]

    def embed_and_match(self, batch: Batch):
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask)
        d_emb = self.embedder(batch["doc_ids"], d_mask)
        return q_emb, d_emb, cosine_match_matrix(q_emb, d_emb)

    def head(self, per_query: torch.Tensor, batch: Batch) -> torch.Tensor:
        """The idf weighting and the MLP: (B, Lq, F) → (B,) scores."""
        if self.apply_idf_weighting:
            q_mask = batch["query_mask"]
            idfs = batch.get("query_idfs", torch.zeros_like(q_mask))
            per_query = per_query * masked_softmax(idfs, q_mask, dim=1)[..., None]
        h = torch.relu(self.dense(per_query.reshape(per_query.shape[0], -1)))
        h = torch.relu(self.dense2(h))
        return self.dense3(h)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        _, _, match = self.embed_and_match(batch)
        per_query = torch.cat([kmax(src, self.kmax_pooling_size)[0] for src in self.channel_maxes(match)], dim=-1)
        out: Output = {"score": self.head(per_query, batch)}
        if output_secondary:
            out["secondary"] = {}
        return out


class CoPACRR(PACRR):
    VIEW_PERCENTS = (0.25, 0.5, 0.75, 1.0)

    def __init__(self, context_pool_size: int = 6, **kw):
        per_row = len(self.VIEW_PERCENTS) * 2 * kw.get("kmax_pooling_size", 5) * kw.get("max_conv_kernel_size", 3)
        super().__init__(features_per_row=per_row, **kw)
        self.context_pool_size = context_pool_size

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(context_pool_size=config.get("copacrr_context_pool_size", 6), **cls.pacrr_args(config, pretrained))

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_emb, d_emb, match = self.embed_and_match(batch)
        q_mask = batch["query_mask"]
        # the context channel: the query's mean vector against rolling means of the document
        q_len = torch.clamp(q_mask.sum(dim=1, keepdim=True), min=1.0)
        q_context = (q_emb * q_mask[..., None]).sum(dim=1) / q_len  # (B, D)
        d_context = sliding_window_mean(d_emb, self.context_pool_size)  # (B, Ld, D)
        context_sim = cosine_match_matrix(q_context[:, None, :], d_context).squeeze(1)  # (B, Ld)
        ld = match.shape[-1]
        feats = []
        for src in self.channel_maxes(match):
            for pct in self.VIEW_PERCENTS:
                view = max(1, int(ld * pct))
                vals, idx = kmax(src[:, :, :view], self.kmax_pooling_size)
                ctx = torch.gather(context_sim[:, None, :view].expand(-1, src.shape[1], -1), 2, idx)
                feats += [vals, ctx]
        out: Output = {"score": self.head(torch.cat(feats, dim=-1), batch)}
        if output_secondary:
            out["secondary"] = {"context_sim": context_sim}
        return out
