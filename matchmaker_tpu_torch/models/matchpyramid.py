"""MatchPyramid, a 2-D CNN over the cosine match matrix (Pang et al.,
AAAI'16): counterpart of ``matchmaker_tpu/models/matchpyramid.py``.

Stacked [right/bottom-padded convolution → ReLU → adaptive max pooling to
the configured size] layers over the (Lq, Ld) match matrix, flattened, then
a 100 → 10 → 1 ReLU MLP. Plain PyTorch, full f32: the cosine and every
convolution through ``ops.matmul_f32`` (modules/conv.py:MatrixConv, never
TF32), the pooling one gather a layer (modules/pooling.py).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.models.encoder import Dense
from matchmaker_tpu_torch.modules.conv import MatrixConv
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder
from matchmaker_tpu_torch.modules.pooling import adaptive_max_pool_2d
from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix


class MatchPyramid(Ranker):
    def __init__(self, vocab_size: int, dim: int, conv_output_size: Sequence[int] = (16, 16, 16),
                 conv_kernel_size: Sequence[Tuple[int, int]] = ((3, 3), (3, 3), (3, 3)),
                 adaptive_pooling_size: Sequence[Tuple[int, int]] = ((18, 90), (9, 30), (3, 10)),
                 pretrained: Optional[np.ndarray] = None):
        super().__init__()
        if not len(conv_output_size) == len(conv_kernel_size) == len(adaptive_pooling_size):
            raise ValueError("match_pyramid's conv sizes, kernel sizes and pooling sizes differ in number")
        self.adaptive_pooling_size = [tuple(p) for p in adaptive_pooling_size]
        self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        channels = [1] + list(conv_output_size)
        for i, (kh, kw) in enumerate(conv_kernel_size):
            self.add_module(f"conv_{i}", MatrixConv(channels[i], channels[i + 1], kh, kw))
        oh, ow = self.adaptive_pooling_size[-1]
        self.dense = Dense(oh * ow * channels[-1], 100)
        self.dense2 = Dense(100, 10)
        self.dense3 = ScoreLayer(10, use_bias=False)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300),
                   tuple(config.get("match_pyramid_conv_output_size", [16, 16, 16])),
                   tuple(tuple(k) for k in config.get("match_pyramid_conv_kernel_size", [[3, 3]] * 3)),
                   tuple(tuple(p) for p in config.get("match_pyramid_adaptive_pooling_size",
                                                       [[18, 90], [9, 30], [3, 10]])), pretrained)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_emb = self.embedder(batch["query_ids"], batch["query_mask"])
        d_emb = self.embedder(batch["doc_ids"], batch["doc_mask"])
        x = cosine_match_matrix(q_emb, d_emb)[..., None]  # (B, Lq, Ld, 1)
        for i, pool in enumerate(self.adaptive_pooling_size):
            x = adaptive_max_pool_2d(torch.relu(getattr(self, f"conv_{i}")(x)), pool)
        h = torch.relu(self.dense(x.reshape(x.shape[0], -1)))
        h = torch.relu(self.dense2(h))
        out: Output = {"score": self.dense3(h)}
        if output_secondary:
            out["secondary"] = {}
        return out
