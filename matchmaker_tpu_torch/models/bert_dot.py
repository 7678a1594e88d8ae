"""BERT_DOT dense bi-encoder: counterpart of ``matchmaker_tpu/models/bert_dot.py``.

Independent query/doc encoder passes, the CLS vector (optionally linearly
compressed, optionally L2-normalised), dot-product score.
``BertDotDualEncoder`` keeps separate query and document towers.
``forward_triple`` is the training step's packed triple forward: one query
pass and one 2B-row pass over the positive and negative documents.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from matchmaker_tpu_torch.models.base import Ranker
from matchmaker_tpu_torch.models.encoder import (
    Dense,
    EncoderConfig,
    TransformerEncoderLM,
    encoder_config_from_model_name,
)


def _kwargs_from_config(config, return_vecs: bool) -> dict:
    return dict(
        encoder_cfg=encoder_config_from_model_name(config),
        compress_dim=config.get("bert_dot_compress_dim", -1),
        return_vecs=return_vecs,
        compute_dtype=torch.bfloat16 if config.get("use_fp16", True) else torch.float32,
        normalize=config.get("bert_dot_normalize", False),
    )


class _DotEncoder(Ranker):
    """CLS → optional compressor → optional normalisation; dot scores."""

    def __init__(self, encoder_cfg: EncoderConfig, compress_dim: int = -1, return_vecs: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16, normalize: bool = False):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.compress_dim = compress_dim
        self.return_vecs = return_vecs
        self.compute_dtype = compute_dtype
        self.normalize = normalize
        if compress_dim > -1:
            self.compressor = Dense(encoder_cfg.hidden_size, compress_dim)

    def tower(self, sequence_type: str) -> TransformerEncoderLM:
        raise NotImplementedError

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, sequence_type: str = "doc") -> torch.Tensor:
        vec = self.tower(sequence_type)(ids, mask)[:, 0, :]
        if self.compress_dim > -1:
            vec = self.compressor(vec)
        if self.normalize:
            vec = vec / torch.clamp(vec.float().norm(dim=-1, keepdim=True), min=1e-6).to(vec.dtype)
        return vec

    def forward(self, batch: Dict[str, torch.Tensor], output_secondary: bool = False) -> Dict[str, torch.Tensor]:
        q_vecs = self.encode(batch["query_ids"], batch["query_mask"], "query")
        d_vecs = self.encode(batch["doc_ids"], batch["doc_mask"], "doc")
        out = self._outputs(q_vecs, d_vecs)
        if output_secondary:
            out["secondary"] = {}
        return out

    def _outputs(self, q_vecs: torch.Tensor, d_vecs: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"score": (q_vecs.float() * d_vecs.float()).sum(dim=-1)}
        if self.return_vecs:
            out["query_vecs"] = q_vecs
            out["doc_vecs"] = d_vecs
        return out

    def forward_triple(self, batch: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Packed triple forward: the query tower runs once and the positive
        and negative documents go through one 2B-row encode. Returns
        (pos_out, neg_out) with ``forward``'s keys."""
        q_vecs = self.encode(batch["query_ids"], batch["query_mask"], "query")
        d_ids = torch.cat([batch["doc_pos_ids"], batch["doc_neg_ids"]], dim=0)
        d_mask = torch.cat([batch["doc_pos_mask"], batch["doc_neg_mask"]], dim=0)
        d_vecs = self.encode(d_ids, d_mask, "doc")
        b = q_vecs.shape[0]
        return self._outputs(q_vecs, d_vecs[:b]), self._outputs(q_vecs, d_vecs[b:])


class BertDot(_DotEncoder):
    """One shared encoder tower for queries and documents."""

    def __init__(self, encoder_cfg: EncoderConfig, **kw):
        super().__init__(encoder_cfg, **kw)
        self.encoder = TransformerEncoderLM(encoder_cfg, self.compute_dtype)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(**_kwargs_from_config(
            config, config.get("in_batch_negatives", False) or config.get("_always_return_vecs", False)))

    def tower(self, sequence_type: str) -> TransformerEncoderLM:
        return self.encoder


class BertDotDualEncoder(_DotEncoder):
    """DPR-style: separate query and document towers."""

    def __init__(self, encoder_cfg: EncoderConfig, **kw):
        super().__init__(encoder_cfg, **kw)
        self.query_encoder = TransformerEncoderLM(encoder_cfg, self.compute_dtype)
        self.doc_encoder = TransformerEncoderLM(encoder_cfg, self.compute_dtype)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(**_kwargs_from_config(config, config.get("in_batch_negatives", False)))

    def tower(self, sequence_type: str) -> TransformerEncoderLM:
        return self.query_encoder if sequence_type == "query" else self.doc_encoder
