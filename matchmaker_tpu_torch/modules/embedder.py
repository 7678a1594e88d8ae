"""Token embedding table and sinusoidal positions: counterpart of
``matchmaker_tpu/modules/embedder.py``.

``TokenEmbedder`` holds the ``token_embedding`` table (normal(0.1) at init,
or the ``pretrained`` matrix, e.g. GloVe's, copied in by
models/weights.py:init_parameters); its output is multiplied by the mask,
so padded positions are zero, and ``trainable=False`` detaches it. Its
gradient is dense, as in the JAX package. ``sinusoidal_positions`` is the
JAX package's numpy table, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.encoder import Embed


class TokenEmbedder(nn.Module):
    """Embedding lookup with masked (zeroed) padding positions."""

    def __init__(self, vocab_size: int, dim: int, pretrained: Optional[np.ndarray] = None, trainable: bool = True):
        super().__init__()
        if pretrained is not None and pretrained.shape != (vocab_size, dim):
            raise ValueError(f"pretrained embeddings of shape {pretrained.shape}, expected {(vocab_size, dim)}")
        self.token_embedding = Embed(vocab_size, dim)
        self.pretrained = pretrained
        self.trainable = trainable

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.token_embedding(ids)
        if not self.trainable:
            emb = emb.detach()
        return emb * mask[..., None]


def sinusoidal_positions(length: int, dim: int, offset: int = 0) -> np.ndarray:
    """Standard transformer sinusoid table, shape (length, dim).

    ``offset`` shifts the position index: TK's ``use_diff_posencoding``
    gives documents positions [offset, offset + length), so query and
    document contextualization don't share position identities."""
    positions = np.arange(offset, offset + length, dtype=np.float32)[:, None]
    half = np.arange(0, dim, 2, dtype=np.float32)
    div = np.exp(half * -(math.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(positions * div)
    table[:, 1::2] = np.cos(positions * div[: dim // 2])
    return table


def position_buffer(length: int, dim: int, offset: int = 0) -> torch.Tensor:
    """``sinusoidal_positions`` as a tensor, for a module's non-persistent buffer."""
    return torch.from_numpy(sinusoidal_positions(length, dim, offset))
