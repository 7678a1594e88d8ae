"""KNRM, kernel pooling over a cosine match matrix (Xiong et al., SIGIR'17):
counterpart of ``matchmaker_tpu/models/knrm.py``.

The cosine matrix masked by the joint query x document mask, 11 gaussian
kernels, the sum over document positions, ``log(clamp(·, 1e-10)) · 0.01``,
the masked sum over query positions, and a bias-free linear layer
(``kernel_weights``, U(-0.014, 0.014) at init, models/weights.py). Plain
PyTorch, as the JAX package's is jnp (ops/kernel_pooling.py). With
``_external_embedding`` (set under ``bert_vectors``) it holds no token
table and scores the vectors ``score_embeddings`` is handed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.ops.kernel_pooling import (
    cosine_match_matrix,
    gaussian_kernel_mus,
    gaussian_kernel_sigmas,
    kernel_pooling_features,
)

# U(-0.014, 0.014): keeps the initial kernel-weight outputs small (the
# reference's and matchzoo's init of the kernel weights)
SMALL_UNIFORM = 0.014


def kernel_buffers(module: torch.nn.Module, mus, sigmas) -> None:
    """The kernels' centres and widths as f32 buffers ``mu`` / ``sigma``,
    outside the state_dict (they are constants of the JAX modules too)."""
    module.register_buffer("mu", torch.tensor(mus, dtype=torch.float32), persistent=False)
    module.register_buffer("sigma", torch.tensor(sigmas, dtype=torch.float32), persistent=False)


class KNRM(Ranker):
    def __init__(self, vocab_size: int, dim: int, n_kernels: int = 11, pretrained: Optional[np.ndarray] = None,
                 external_embedding: bool = False):
        super().__init__()
        if not external_embedding:  # a bert_vectors adapter hands in the vectors (models/bert_vectors.py)
            self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        kernel_buffers(self, gaussian_kernel_mus(n_kernels), gaussian_kernel_sigmas(n_kernels))
        self.kernel_weights = ScoreLayer(n_kernels, use_bias=False)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300), config.get("knrm_kernels", 11),
                   pretrained, config.get("_external_embedding", False))

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_emb = self.embedder(batch["query_ids"], batch["query_mask"])
        d_emb = self.embedder(batch["doc_ids"], batch["doc_mask"])
        return self.score_embeddings(q_emb, d_emb, batch["query_mask"], batch["doc_mask"], output_secondary)

    def score_embeddings(self, q_emb, d_emb, q_mask, d_mask, output_secondary: bool = False) -> Output:
        match = cosine_match_matrix(q_emb, d_emb)
        per_kernel = kernel_pooling_features(match, q_mask, d_mask, self.mu, self.sigma, log_scale=0.01,
                                             mask_match_matrix=True)
        out: Output = {"score": self.kernel_weights(per_kernel)}
        if output_secondary:
            out["secondary"] = {"per_kernel": per_kernel,
                                "cosine_matrix_masked": match * (q_mask[:, :, None] * d_mask[:, None, :])}
        return out
