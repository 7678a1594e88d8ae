"""PreTTR, a split transformer whose lower document layers can be cached:
counterpart of ``matchmaker_tpu/models/prettr.py``.

Query and document run layers ``0 .. join_layer_idx`` apart (the document's
position ids start at the query length), their hidden states are joined
and run through the remaining layers together, and the CLS hidden state →
``score_layer`` (no bias) → the score. Every layer runs as in a full
encoder pass: the fused halves (K1/K2, K11/K12 under autograd) where
configured, at the towers' lengths and the joined one.
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer, compute_dtype_of
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name


class PreTTR(Ranker):
    def __init__(self, encoder_cfg: EncoderConfig, join_layer_idx: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.join_layer_idx = join_layer_idx
        self.compute_dtype = compute_dtype
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        self.score_layer = ScoreLayer(encoder_cfg.hidden_size, use_bias=False)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(encoder_config_from_model_name(config), config.get("prettr_join_layer_idx", 3),
                   compute_dtype_of(config))

    def _lower(self, ids, mask, offset: int = 0) -> torch.Tensor:
        """A tower: embeddings (positions from ``offset``) through the first
        ``join_layer_idx`` layers."""
        x = self.encoder.embed(ids, position_offset=offset)
        return self.encoder.encode_layers(x, mask, 0, self.join_layer_idx)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_ids, q_mask = batch["query_ids"], batch["query_mask"]
        d_ids, d_mask = batch["doc_ids"], batch["doc_mask"]
        q_low = self._lower(q_ids, q_mask)
        d_low = self._lower(d_ids, d_mask, offset=q_ids.shape[1])
        joined = torch.cat([q_low, d_low], dim=1)
        joined_mask = torch.cat([q_mask, d_mask], dim=1)
        hidden = self.encoder.encode_layers(joined, joined_mask, self.join_layer_idx, self.encoder_cfg.num_layers)
        out: Output = {"score": self.score_layer(hidden[:, 0, :])}
        if output_secondary:
            out["secondary"] = {}
        return out
