"""Conv-KNRM, n-gram cross-match kernel pooling (Dai et al., WSDM'18):
counterpart of ``matchmaker_tpu/models/conv_knrm.py``.

Per n-gram convolutions (``conv_{n}gram``, right-padded so the output is as
long as the input, ReLU) over the query and the document embeddings, kernel
pooling on every (query n-gram, document n-gram) pair's cosine matrix, the
concatenated features → a bias-free linear layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.models.knrm import kernel_buffers
from matchmaker_tpu_torch.modules.conv import SequenceConv
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.ops.kernel_pooling import (
    cosine_match_matrix,
    gaussian_kernel_mus,
    gaussian_kernel_sigmas,
    kernel_pooling_features,
)


class ConvKNRM(Ranker):
    def __init__(self, vocab_size: int, dim: int, n_grams: int = 3, n_kernels: int = 11, conv_out_dim: int = 128,
                 pretrained: Optional[np.ndarray] = None):
        super().__init__()
        self.n_grams = n_grams
        self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        kernel_buffers(self, gaussian_kernel_mus(n_kernels), gaussian_kernel_sigmas(n_kernels))
        for n in range(1, n_grams + 1):
            self.add_module(f"conv_{n}gram", SequenceConv(dim, conv_out_dim, n))
        self.kernel_weights = ScoreLayer(n_grams * n_grams * n_kernels, use_bias=False)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300), config.get("conv_knrm_ngrams", 3),
                   config.get("conv_knrm_kernels", 11), config.get("conv_knrm_conv_out_dim", 128), pretrained)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask)
        d_emb = self.embedder(batch["doc_ids"], d_mask)
        convs = [getattr(self, f"conv_{n}gram") for n in range(1, self.n_grams + 1)]
        q_grams = [torch.relu(conv(q_emb)) for conv in convs]
        d_grams = [torch.relu(conv(d_emb)) for conv in convs]
        features = [kernel_pooling_features(cosine_match_matrix(qg, dg), q_mask, d_mask, self.mu, self.sigma,
                                            log_scale=0.01, mask_match_matrix=True)
                    for qg in q_grams for dg in d_grams]
        all_grams = torch.cat(features, dim=1)
        out: Output = {"score": self.kernel_weights(all_grams)}
        if output_secondary:
            out["secondary"] = {"per_kernel_all_grams": all_grams}
        return out
