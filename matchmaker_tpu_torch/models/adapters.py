"""MaxP / MeanP chunk adapters, wrapping a ranker over document chunks:
counterpart of ``matchmaker_tpu/models/adapters.py``.

Documents are cut into overlapping chunks (``idcm_chunk_size`` +
2·``idcm_overlap`` tokens), the inner model scores every (query, chunk)
pair, and the document's score is the max (or the mean) over its non-empty
chunks. As in the JAX package, every chunk runs in one (B·C)-row batch and
the empty ones are masked out of the pooling. A concatenated inner model
(``BertCat``) takes [query ‖ chunk] with type id 1 on the chunk's live
tokens. ``passage_scores`` gives the per-chunk scores for the passage
losses.
"""

from __future__ import annotations

import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.modules.pooling import unfold_chunks

NEG_SENTINEL = -9000.0


def chunk_document(doc_ids: torch.Tensor, doc_mask: torch.Tensor, chunk_size: int, overlap: int):
    """(B, Ld) → (B, C, ext) id and mask chunks, and (B, C) non-empty flags."""
    chunks = unfold_chunks(doc_ids[..., None], chunk_size, overlap).squeeze(-1)
    mask_chunks = unfold_chunks(doc_mask[..., None], chunk_size, overlap).squeeze(-1)
    inner = mask_chunks[:, :, overlap: overlap + chunk_size]
    return chunks, mask_chunks, inner.sum(dim=-1) > 0


class ChunkPoolAdapter(Ranker):
    def __init__(self, inner: Ranker, inner_input: str = "independent", chunk_size: int = 50, overlap: int = 7,
                 pool: str = "max", return_passage_scores: bool = False):
        super().__init__()
        self.inner = inner
        self.inner_input = inner_input
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.pool = pool
        self.return_passage_scores = return_passage_scores

    @classmethod
    def from_config(cls, config, inner: Ranker, pool: str = "max"):
        return cls(inner, "concatenated" if type(inner).__name__ in ("BertCat",) else "independent",
                   config.get("idcm_chunk_size", 50), config.get("idcm_overlap", 7), pool,
                   config.get("train_pairwise_distillation_on_passages", False))

    def _chunk_batches(self, batch: Batch):
        chunks, mask_chunks, non_empty = chunk_document(batch["doc_ids"], batch["doc_mask"], self.chunk_size,
                                                        self.overlap)
        b, c, ext = chunks.shape
        flat_ids = chunks.reshape(b * c, ext)
        flat_mask = mask_chunks.reshape(b * c, ext)
        q_ids = torch.repeat_interleave(batch["query_ids"], c, dim=0)
        q_mask = torch.repeat_interleave(batch["query_mask"], c, dim=0)
        if self.inner_input == "concatenated":
            type_ids = torch.cat([torch.zeros_like(q_ids), (flat_mask > 0).to(q_ids.dtype)], dim=1)
            inner_batch = {"seq_ids": torch.cat([q_ids, flat_ids], dim=1),
                           "seq_mask": torch.cat([q_mask, flat_mask], dim=1), "seq_type_ids": type_ids}
        else:
            inner_batch = {"query_ids": q_ids, "query_mask": q_mask, "doc_ids": flat_ids, "doc_mask": flat_mask}
        return inner_batch, non_empty, b, c

    def passage_scores(self, batch: Batch) -> torch.Tensor:
        """(B, C) per-chunk scores, empty chunks 0."""
        inner_batch, non_empty, b, c = self._chunk_batches(batch)
        return self.inner(inner_batch)["score"].reshape(b, c) * non_empty

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        inner_batch, non_empty, b, c = self._chunk_batches(batch)
        scores = self.inner(inner_batch)["score"].reshape(b, c)
        if self.pool == "max":
            score = torch.where(non_empty, scores, NEG_SENTINEL).amax(dim=-1)
        else:
            counts = torch.clamp(non_empty.sum(dim=-1), min=1)
            score = (scores * non_empty).sum(dim=-1) / counts
        out: Output = {"score": score}
        if self.return_passage_scores:
            out["passage_scores"] = scores * non_empty
        if output_secondary:
            out["secondary"] = {"passage_scores": scores * non_empty, "packed_indices": non_empty}
        return out

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, sequence_type: str = "doc") -> torch.Tensor:
        """Chunk-wise representations for maxP dense retrieval: a query's
        as the inner model encodes it, a document's (B, C, D) chunk vectors
        (empty chunks zero)."""
        if sequence_type == "query":
            return self.inner.encode(ids, mask, sequence_type)
        chunks, mask_chunks, non_empty = chunk_document(ids, mask, self.chunk_size, self.overlap)
        b, c, ext = chunks.shape
        reps = self.inner.encode(chunks.reshape(b * c, ext), mask_chunks.reshape(b * c, ext), "doc")
        return reps.reshape(b, c, -1) * non_empty[..., None]
