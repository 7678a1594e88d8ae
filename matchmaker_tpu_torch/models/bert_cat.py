"""BERT_CAT, the concatenated cross-encoder (monoBERT; the Margin-MSE
teacher): counterpart of ``matchmaker_tpu/models/bert_cat.py``.

One encoder pass over [CLS] q [SEP] d [SEP] (``seq_ids``, ``seq_mask``,
``seq_type_ids``), the CLS hidden state → ``score_layer`` (no bias) → the
score. The QA heads (``train_qa_spans``) are not ported yet (ROADMAP.md,
queue 1 item 6).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name


class ScoreLayer(nn.Module):
    """flax ``Dense(1)``: kernel (in, 1), with or without a bias; f32 out."""

    def __init__(self, in_features: int, use_bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, 1))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.float(), self.kernel)
        if hasattr(self, "bias"):
            y = y + self.bias
        return y.squeeze(-1)


def compute_dtype_of(config) -> torch.dtype:
    return torch.bfloat16 if config.get("use_fp16", True) else torch.float32


class BertCat(Ranker):
    def __init__(self, encoder_cfg: EncoderConfig, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.compute_dtype = compute_dtype
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        self.score_layer = ScoreLayer(encoder_cfg.hidden_size, use_bias=False)

    @classmethod
    def from_config(cls, config, pretrained=None):
        if config.get("train_qa_spans", False):
            raise NotImplementedError("the QA heads of bert_cat (train_qa_spans) are not ported yet "
                                      "(ROADMAP.md, queue 1 item 6)")
        return cls(encoder_config_from_model_name(config), compute_dtype_of(config))

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        hidden = self.encoder(batch["seq_ids"], batch["seq_mask"], batch.get("seq_type_ids"))
        cls_vec = hidden[:, 0, :]
        out: Output = {"score": self.score_layer(cls_vec)}
        if output_secondary:
            out["secondary"] = {"cls_vector": cls_vec}
        return out
