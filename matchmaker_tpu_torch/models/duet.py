"""Duet, a local (lexical match) and a distributed (semantic) path:
counterpart of ``matchmaker_tpu/models/duet.py``.

Local: the cosine match matrix times the query idfs (1 without them), a
Dense over the document axis (the 1 x 1 convolution), flattened, two ReLU
layers. Distributed: VALID width-3 convolutions over the query and the
document embeddings (modules/conv.py, full f32), the query max-pooled to
one vector, the document max-pooled over sliding windows of
min(100, Ld − 2), their product flattened, two ReLU layers. The sum of the
paths → two ReLU layers → ReLU(out) x 0.1. The combination's kernels start
U(0, 0.01) (models/weights.py). The input widths of ``local_conv``,
``local_fc1`` and ``dist_fc1`` follow from the query and document lengths,
which flax reads off its example batch: ``max_query_length`` and
``max_doc_length``, or a chunk adapter's ``_inner_doc_length``. Plain
PyTorch, as the JAX model is jnp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.encoder import Dense
from matchmaker_tpu_torch.modules.conv import SequenceConv
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.modules.pooling import sliding_window_max
from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix


class Duet(Ranker):
    def __init__(self, vocab_size: int, dim: int, max_query_length: int = 30, max_doc_length: int = 200,
                 pretrained: Optional[np.ndarray] = None):
        super().__init__()
        h = dim
        self.embedder = TokenEmbedder(vocab_size, h, pretrained)
        self.local_conv = Dense(max_doc_length, h)  # a 1 x 1 convolution over the document axis
        self.local_fc1 = Dense(max_query_length * h, h)
        self.local_fc2 = Dense(h, h)
        self.dist_q_conv = SequenceConv(h, h, 3, valid=True)
        self.dist_q_fc = Dense(h, h)
        self.dist_d_conv = SequenceConv(h, h, 3, valid=True)
        self.dist_d_proj = Dense(h, h)
        conv_len = max_doc_length - 2
        self.dist_fc1 = Dense((conv_len - min(100, conv_len) + 1) * h, h)
        self.dist_fc2 = Dense(h, h)
        self.comb_fc1 = Dense(h, h)
        self.comb_fc2 = Dense(h, h)
        self.comb_out = Dense(h, 1)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300), config.get("max_query_length", 30),
                   config.get("_inner_doc_length", config.get("max_doc_length", 200)), pretrained)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask) * q_mask[..., None]
        d_emb = self.embedder(batch["doc_ids"], d_mask) * d_mask[..., None]

        local = cosine_match_matrix(q_emb, d_emb) * batch.get("query_idfs", torch.ones_like(q_mask))[..., None]
        h_local = torch.relu(self.local_conv(local))  # (B, Lq, H)
        h_local = torch.relu(self.local_fc1(h_local.reshape(h_local.shape[0], -1)))
        h_local = torch.relu(self.local_fc2(h_local))

        h_q = torch.relu(self.dist_q_conv(q_emb)).amax(dim=1)  # (B, H)
        h_q = torch.relu(self.dist_q_fc(h_q))
        h_d = torch.relu(self.dist_d_conv(d_emb))  # (B, Ld - 2, H)
        h_d = torch.relu(self.dist_d_proj(sliding_window_max(h_d, min(100, h_d.shape[1]))))  # (B, W, H)
        h_dist = (h_q[:, None, :] * h_d).reshape(h_d.shape[0], -1)
        h_dist = torch.relu(self.dist_fc1(h_dist))
        h_dist = torch.relu(self.dist_fc2(h_dist))

        h = torch.relu(self.comb_fc1(h_local + h_dist))
        h = torch.relu(self.comb_fc2(h))
        out: Output = {"score": torch.relu(self.comb_out(h)).squeeze(-1) * 0.1}
        if output_secondary:
            out["secondary"] = {}
        return out
