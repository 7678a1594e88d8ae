"""ColBERT late-interaction ranker: counterpart of
``matchmaker_tpu/models/colbert.py``.

Per-token encoder vectors, a linear compressor to ``colbert_compression_dim``
(f32, flax ``Dense`` promotion), optional L2 normalisation
(``colbert_normalize``), vectors zeroed by mask when encoding for storage
(``sequence_type`` ``doc_encode`` / ``query_encode``), MaxSim scoring
(ops/maxsim.py) and the in-batch all-pairs MaxSim (K14 on a card; under
autograd its training form and backward kernel), the per-query-term MaxSim
scores (``return_per_term``, for term-level distillation) and the training
step's packed triple forward (``forward_triple``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from matchmaker_tpu_torch.models.base import Ranker
from matchmaker_tpu_torch.models.encoder import Dense, EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name
from matchmaker_tpu_torch.ops import matmul_f32
from matchmaker_tpu_torch.ops.maxsim import NEG_FILL, maxsim_all_pairs, maxsim_pairwise


class ColBert(Ranker):
    def __init__(self, encoder_cfg: EncoderConfig, compression_dim: int = 768, return_vecs: bool = True,
                 return_per_term: bool = False, compute_dtype: torch.dtype = torch.bfloat16,
                 normalize: bool = False):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.compression_dim = compression_dim
        self.return_vecs = return_vecs
        self.return_per_term = return_per_term
        self.compute_dtype = compute_dtype
        self.normalize = normalize
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        self.compressor = Dense(encoder_cfg.hidden_size, compression_dim)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(
            encoder_cfg=encoder_config_from_model_name(config),
            compression_dim=config.get("colbert_compression_dim", 768),
            return_vecs=config.get("in_batch_negatives", False),
            return_per_term=config.get("dynamic_teacher_per_term_scores", False)
            or config.get("colbert_per_term_scores", False),
            compute_dtype=torch.bfloat16 if config.get("use_fp16", True) else torch.float32,
            normalize=config.get("colbert_normalize", False),
        )

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, sequence_type: str = "n/a") -> torch.Tensor:
        """(B, L) ids and mask → (B, L, compression_dim) f32 token vectors."""
        vecs = self.compressor(self.encoder(ids, mask))
        if self.normalize:
            vecs = vecs / torch.clamp(vecs.float().norm(dim=-1, keepdim=True), min=1e-6).to(vecs.dtype)
        if sequence_type in ("doc_encode", "query_encode"):
            vecs = vecs * mask[..., None]
        return vecs

    def aggregate(self, q_reps: torch.Tensor, d_reps: torch.Tensor, q_mask=None, d_mask=None) -> torch.Tensor:
        """Score pre-encoded vectors whose padding was zeroed at encode time."""
        return matmul_f32(q_reps, d_reps.transpose(-1, -2)).amax(dim=-1).sum(dim=-1)

    def inbatch_aggregate(self, q_vecs: torch.Tensor, q_mask: torch.Tensor, d_vecs: torch.Tensor,
                          d_mask: torch.Tensor) -> torch.Tensor:
        """(Bq, Bd) all-pairs MaxSim (the dynamic teacher's matrix)."""
        return maxsim_all_pairs(q_vecs, d_vecs, q_mask, d_mask)

    def _outputs(self, q_vecs, q_mask, d_vecs, d_mask) -> dict:
        out = {"score": maxsim_pairwise(q_vecs, d_vecs, q_mask, d_mask)}
        if self.return_per_term:
            # each query token's MaxSim contribution (the dynamic teacher's per-term scores)
            per_term = matmul_f32(q_vecs, d_vecs.transpose(-1, -2))
            per_term = torch.where(d_mask[:, None, :] > 0, per_term, NEG_FILL)
            out["per_term_scores"] = per_term.amax(dim=-1) * q_mask
        if self.return_vecs:
            out["query_vecs"] = q_vecs
            out["doc_vecs"] = d_vecs
            out["query_vecs_mask"] = q_mask
            out["doc_vecs_mask"] = d_mask
        return out

    def forward(self, batch: Dict[str, torch.Tensor], output_secondary: bool = False) -> dict:
        q_vecs = self.encode(batch["query_ids"], batch["query_mask"])
        d_vecs = self.encode(batch["doc_ids"], batch["doc_mask"])
        out = self._outputs(q_vecs, batch["query_mask"], d_vecs, batch["doc_mask"])
        if output_secondary:
            out["secondary"] = {}
        return out

    def forward_triple(self, batch: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
        """Packed triple forward: the query tokens encoded once, the positive
        and negative documents in one 2B-row encoder pass; the MaxSim runs per
        half. Returns (pos_out, neg_out) with ``forward``'s keys."""
        q_vecs = self.encode(batch["query_ids"], batch["query_mask"])
        d_ids = torch.cat([batch["doc_pos_ids"], batch["doc_neg_ids"]], dim=0)
        d_mask = torch.cat([batch["doc_pos_mask"], batch["doc_neg_mask"]], dim=0)
        d_vecs = self.encode(d_ids, d_mask)
        b = q_vecs.shape[0]
        q_mask = batch["query_mask"]
        return (self._outputs(q_vecs, q_mask, d_vecs[:b], d_mask[:b]),
                self._outputs(q_vecs, q_mask, d_vecs[b:], d_mask[b:]))
