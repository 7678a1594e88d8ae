"""MLM pre-training model: counterpart of ``matchmaker_tpu/modules/mlm_head.py``.

The standard BERT head on the port's encoder: Dense → exact gelu →
LayerNorm (flax's default epsilon, 1e-6) → a projection onto the
word-embedding table (tied weights) plus a vocabulary bias. Parameters are
named after the flax tree (``mlm_transform``, ``mlm_norm``, ``mlm_bias``,
``encoder``), so a snapshot's ``encoder`` warm-starts any ranker
(training/checkpoints.py:load_encoder_subtree). The POD contrastive term on
the CLS vectors is computed in cli/pretrain.py's loss.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.models.encoder import Dense, EncoderConfig, LayerNorm, TransformerEncoderLM
from matchmaker_tpu_torch.ops import matmul_f32

_FLAX_LN_EPS = 1e-6


class MLMPretrainModel(nn.Module):
    def __init__(self, cfg: EncoderConfig, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder_cfg = cfg
        self.compute_dtype = compute_dtype
        self.encoder = TransformerEncoderLM(cfg, compute_dtype)
        self.mlm_transform = Dense(cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = LayerNorm(cfg.hidden_size)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, batch: Dict[str, torch.Tensor], output_secondary: bool = False) -> Dict[str, torch.Tensor]:
        """``mlm_logits`` (B, L, V) f32 and ``cls_vecs`` (B, H)."""
        hidden = self.encoder(batch["seq_ids"], batch["seq_mask"])
        h = self.mlm_norm(F.gelu(self.mlm_transform(hidden)), _FLAX_LN_EPS)
        logits = matmul_f32(h, self.encoder.word_embeddings.embedding.t())
        return {"mlm_logits": logits + self.mlm_bias, "cls_vecs": hidden[:, 0, :]}
