"""TK (ECAI'20), the transformer-kernel re-ranker: counterpart of
``matchmaker_tpu/models/tk.py``.

Sinusoid positions (documents offset by 500 with ``use_diff_posencoding``)
→ the small transformer of modules/transformer.py → a learned mix of the
raw and the contextualized embeddings (``mixer``, with
``mix_hybrid_context``) → cosine match matrix → gaussian kernels with a
learned per-kernel ``kernel_alpha_scaler`` → masked log-sum pooling → a
bias-free linear layer (``kernel_bin_weights``). ``score_embeddings``
scores embeddings a caller hands in; with ``_external_embedding`` (set
under ``bert_vectors``, models/bert_vectors.py) the model holds no token
table.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.models.knrm import kernel_buffers
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder, position_buffer
from matchmaker_tpu_torch.modules.transformer import TransformerEncoder
from matchmaker_tpu_torch.ops.kernel_pooling import (
    cosine_match_matrix,
    gaussian_kernel_mus,
    gaussian_kernel_sigmas,
    kernel_pooling_features,
)


class TK(Ranker):
    def __init__(self, vocab_size: int, dim: int, kernels_mu: Optional[List[float]] = None,
                 kernels_sigma: Optional[List[float]] = None, att_heads: int = 8, att_layers: int = 2,
                 att_ff_dim: int = 100, max_length: int = 200, use_diff_posencoding: bool = True,
                 mix_hybrid_context: bool = True, pretrained: Optional[np.ndarray] = None,
                 external_embedding: bool = False):
        super().__init__()
        self.mix_hybrid_context = mix_hybrid_context
        if not external_embedding:  # a bert_vectors adapter hands in the vectors (models/bert_vectors.py)
            self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        mus = kernels_mu or gaussian_kernel_mus(11)
        sigmas = kernels_sigma or gaussian_kernel_sigmas(11)
        if len(mus) != len(sigmas):
            raise ValueError("len(kernels_mu) != len(kernels_sigma)")
        kernel_buffers(self, mus, sigmas)
        n_kernels = len(mus)
        self.register_buffer("pos_q", position_buffer(max_length, dim), persistent=False)
        # document positions offset by 500, so that queries and documents
        # share no position identity
        self.register_buffer("pos_d", position_buffer(max_length, dim, 500 if use_diff_posencoding else 0),
                             persistent=False)
        self.contextualizer = TransformerEncoder(att_layers, dim, att_heads, att_ff_dim)
        self.mixer = nn.Parameter(torch.full((1,), 0.5))
        self.kernel_alpha_scaler = nn.Parameter(torch.ones(1, 1, n_kernels))
        self.kernel_bin_weights = ScoreLayer(n_kernels, use_bias=False)

    @classmethod
    def tk_args(cls, config, pretrained=None) -> dict:
        return dict(vocab_size=config["_vocab_size"], dim=config.get("token_embedding_size", 300),
                    kernels_mu=config.get("tk_kernels_mu"), kernels_sigma=config.get("tk_kernels_sigma"),
                    att_heads=config.get("tk_att_heads", 8), att_layers=config.get("tk_att_layer", 2),
                    att_ff_dim=config.get("tk_att_ff_dim", 100), max_length=config.get("max_doc_length", 200),
                    use_diff_posencoding=config.get("tk_use_diff_posencoding", True),
                    mix_hybrid_context=config.get("tk_mix_hybrid_context", True), pretrained=pretrained,
                    external_embedding=config.get("_external_embedding", False))

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(**cls.tk_args(config, pretrained))

    def contextualize(self, emb: torch.Tensor, mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        ctx = self.contextualizer(emb + positions[None, : emb.shape[1], :], mask)
        if self.mix_hybrid_context:
            return self.mixer * emb + (1.0 - self.mixer) * ctx
        return ctx

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_emb = self.embedder(batch["query_ids"], batch["query_mask"])
        d_emb = self.embedder(batch["doc_ids"], batch["doc_mask"])
        return self.score_embeddings(q_emb, d_emb, batch["query_mask"], batch["doc_mask"], output_secondary)

    def score_embeddings(self, q_emb, d_emb, q_mask, d_mask, output_secondary: bool = False) -> Output:
        q_ctx = self.contextualize(q_emb, q_mask, self.pos_q)
        d_ctx = self.contextualize(d_emb, d_mask, self.pos_d)
        match = cosine_match_matrix(q_ctx, d_ctx)
        per_kernel = kernel_pooling_features(match, q_mask, d_mask, self.mu, self.sigma,
                                             alpha_scaler=self.kernel_alpha_scaler, mask_match_matrix=False)
        out: Output = {"score": self.kernel_bin_weights(per_kernel)}
        if output_secondary:
            out["secondary"] = {"per_kernel": per_kernel,
                                "cosine_matrix": match * d_mask[:, None, :] * q_mask[:, :, None]}
        return out
