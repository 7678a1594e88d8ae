"""PARADE, passage representation aggregation (Li et al., 2020):
counterpart of ``matchmaker_tpu/models/parade.py``.

The document is cut into chunks (``idcm_chunk_size`` + 2·``idcm_overlap``
tokens) and every (query, chunk) pair is cross-encoded in one (B·C)-row
batch; the chunks' CLS vectors (empty chunks zeroed) are aggregated by a
small transformer over [``agg_cls`` ‖ chunk vectors] taking its first
output (``parade_aggregate_type: tf``, modules/transformer.py, empty chunks
masked) or by a max over the non-empty chunks (``max``: −inf where every
chunk is empty, as in the JAX package); ``score_reduction`` (with a bias)
gives the score.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.adapters import chunk_document
from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer, compute_dtype_of
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name
from matchmaker_tpu_torch.modules.transformer import TransformerEncoder


class Parade(Ranker):
    def __init__(self, encoder_cfg: EncoderConfig, aggregate_type: str = "tf", aggregate_layers: int = 2,
                 chunk_size: int = 50, overlap: int = 7, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if aggregate_type not in ("tf", "max"):
            raise ValueError(f"parade_aggregate_type {aggregate_type!r}: expected 'tf' or 'max'")
        self.encoder_cfg = encoder_cfg
        self.aggregate_type = aggregate_type
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.compute_dtype = compute_dtype
        hid = encoder_cfg.hidden_size
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        if aggregate_type == "tf":
            self.aggregator = TransformerEncoder(aggregate_layers, hid, encoder_cfg.num_heads,
                                                 encoder_cfg.intermediate_size)
            self.agg_cls = nn.Parameter(torch.empty(1, 1, hid))
        self.score_reduction = ScoreLayer(hid, use_bias=True)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(encoder_config_from_model_name(config), config.get("parade_aggregate_type", "tf"),
                   config.get("parade_aggregate_layers", 2), config.get("idcm_chunk_size", 50),
                   config.get("idcm_overlap", 7), compute_dtype_of(config))

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        chunks, mask_chunks, non_empty = chunk_document(batch["doc_ids"], batch["doc_mask"], self.chunk_size,
                                                        self.overlap)
        b, c, ext = chunks.shape
        q_ids = torch.repeat_interleave(batch["query_ids"], c, dim=0)
        q_mask = torch.repeat_interleave(batch["query_mask"], c, dim=0)
        seq_ids = torch.cat([q_ids, chunks.reshape(b * c, ext)], dim=1)
        seq_mask = torch.cat([q_mask, mask_chunks.reshape(b * c, ext)], dim=1)
        cls_vecs = self.encoder(seq_ids, seq_mask)[:, 0, :].reshape(b, c, -1)
        cls_vecs = cls_vecs * non_empty[..., None]
        if self.aggregate_type == "tf":
            agg_in = torch.cat([self.agg_cls.expand(b, 1, cls_vecs.shape[-1]), cls_vecs], dim=1)
            agg_mask = torch.cat([torch.ones(b, 1, device=cls_vecs.device), non_empty.float()], dim=1)
            agg_vec = self.aggregator(agg_in, agg_mask)[:, 0, :]
        else:
            agg_vec = torch.where(non_empty[..., None], cls_vecs, float("-inf")).amax(dim=1)
        out: Output = {"score": self.score_reduction(agg_vec)}
        if output_secondary:
            out["secondary"] = {"chunk_cls": cls_vecs}
        return out
