"""BERT_CAT, the concatenated cross-encoder (monoBERT; the Margin-MSE
teacher): counterpart of ``matchmaker_tpu/models/bert_cat.py``.

One encoder pass over [CLS] q [SEP] d [SEP] (``seq_ids``, ``seq_mask``,
``seq_type_ids``), the CLS hidden state → ``score_layer`` (no bias) → the
score. With ``train_qa_spans`` the extractive-QA heads of the multi-task
training: ``qa_span_layer``, a Dense(2) over every hidden state, gives the
start and end logits (padding at -1e9, as the JAX model's ``neg``), and
``answerability_layer``, a Dense(2) over the CLS state, the answerability
logits; both f32 products, as ``score_layer``'s.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name
from matchmaker_tpu_torch.ops import matmul_f32


class HeadLayer(nn.Module):
    """flax ``Dense(n)`` with a bias over f32 inputs: kernel (in, n); the
    product in full f32 (``ops.matmul_f32``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_f32(x, self.kernel) + self.bias


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
    def __init__(self, encoder_cfg: EncoderConfig, compute_dtype: torch.dtype = torch.bfloat16,
                 qa_head: bool = False):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.compute_dtype = compute_dtype
        self.qa_head = qa_head
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        self.score_layer = ScoreLayer(encoder_cfg.hidden_size, use_bias=False)
        if qa_head:
            self.qa_span_layer = HeadLayer(encoder_cfg.hidden_size, 2)
            self.answerability_layer = HeadLayer(encoder_cfg.hidden_size, 2)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(encoder_config_from_model_name(config), compute_dtype_of(config),
                   config.get("train_qa_spans", False))

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        hidden = self.encoder(batch["seq_ids"], batch["seq_mask"], batch.get("seq_type_ids"))
        cls_vec = hidden[:, 0, :]
        out: Output = {"score": self.score_layer(cls_vec)}
        if self.qa_head:
            span_logits = self.qa_span_layer(hidden)  # (B, L, 2)
            neg = (1.0 - batch["seq_mask"]) * -1e9
            out["qa_logits_start"] = span_logits[..., 0] + neg
            out["qa_logits_end"] = span_logits[..., 1] + neg
            out["answerability_logits"] = self.answerability_layer(cls_vec)
        if output_secondary:
            out["secondary"] = {"cls_vector": cls_vec}
        return out
