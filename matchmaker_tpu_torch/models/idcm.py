"""IDCM (SIGIR'21), the intra-document cascade: counterpart of
``matchmaker_tpu/models/idcm.py``.

The document is cut into chunks (``idcm_chunk_size`` 50 + 2 x
``idcm_overlap`` 7); a cheap sampler scores every (query, chunk) pair, and
BERT (``TransformerEncoderLM``: K1/K2 forward and K11/K12 backward with
``encoder_fused_attention`` on a card) scores [query ‖ chunk] for the top
``idcm_sample_n`` chunks; the score is a learned-weight sum over the sorted
top ``idcm_top_k_chunks`` BERT chunk scores. ``idcm_sample_n: -1`` runs
BERT on every chunk (stage 1, trained with a passage loss). With
``idcm_train_selection`` (stage 2) BERT scores every chunk without
gradient and the sampler learns to rank chunks as BERT does (``mseloss``,
``kldivloss``, ``crossentropy`` or ``lambdaloss``: ``selection_loss``,
over the global batch where the batch carries the train step's
``global_batch``);
``bert_part_cached`` in the batch replays BERT's chunk scores from a
replay cache (utils/replay_cache.py) in place of computing them.

The sampler (``idcm_sample_context``): ``ck`` (a width-3 convolution over
the encoder's detached embeddings), ``ck-small`` (a projection to 384, then
a convolution to 128) or ``tk`` (a projection to 384 and a one-layer
transformer); the contexts L2-normalised, 11 fixed kernels (sigma 0.1)
with a learned alpha, ``log(clamp(·, 1e-4))``, a linear layer. The query's
context is computed once and repeated over its chunks (the JAX package
computes it for every chunk; the rows are the same).

Selection takes the top ``sample_n`` chunks by a stable descending sort:
``jax.lax.top_k`` puts the lower index first among ties, and empty chunks
(all at the sentinel) tie whenever a document has fewer live chunks than
``sample_n``; ``torch.topk`` promises no order among ties on a card.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from matchmaker_tpu_torch.losses.global_batch import LOCAL, GlobalBatch
from matchmaker_tpu_torch.losses.listwise import kldiv_teacher_list, lambda_loss, soft_cross_entropy
from matchmaker_tpu_torch.models.adapters import NEG_SENTINEL, chunk_document
from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer, compute_dtype_of
from matchmaker_tpu_torch.models.encoder import (Dense, EncoderConfig, TransformerEncoderLM,
                                                 encoder_config_from_model_name)
from matchmaker_tpu_torch.models.knrm import kernel_buffers
from matchmaker_tpu_torch.modules.conv import SequenceConv
from matchmaker_tpu_torch.modules.transformer import TransformerEncoder
from matchmaker_tpu_torch.ops import matmul_f32
from matchmaker_tpu_torch.ops.kernel_pooling import kernel_activations, l2_normalize_rows

_CK_MUS = [1.0, 0.9, 0.7, 0.5, 0.3, 0.1, -0.1, -0.3, -0.5, -0.7, -0.9]
_CK_SIGMAS = [0.1] * 11
SAMPLE_CONTEXTS = ("ck", "ck-small", "tk")
SAMPLE_TRAIN_TYPES = ("mseloss", "kldivloss", "crossentropy", "lambdaloss")


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, largest first, the
    lower index first among ties (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]


class IDCM(Ranker):
    def __init__(self, encoder_cfg: EncoderConfig, chunk_size: int = 50, overlap: int = 7, top_k_chunks: int = 3,
                 sample_n: int = 3, sample_context: str = "ck", sample_train_type: str = "kldivloss",
                 train_selection: bool = False, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if sample_context not in SAMPLE_CONTEXTS:
            raise ValueError(f"idcm_sample_context {sample_context!r}: expected one of {SAMPLE_CONTEXTS}")
        if sample_train_type not in SAMPLE_TRAIN_TYPES:
            raise ValueError(f"unknown sample_train_type {sample_train_type}")
        self.encoder_cfg = encoder_cfg
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.top_k_chunks = top_k_chunks
        self.sample_n = sample_n
        self.sample_context = sample_context
        self.sample_train_type = sample_train_type
        self.train_selection = train_selection
        h = encoder_cfg.hidden_size
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)
        self.classification_layer = ScoreLayer(h, use_bias=True)
        self.top_k_scoring = nn.Parameter(torch.ones(1, top_k_chunks))
        if sample_context == "ck-small":
            self.sample_projector = Dense(h, 384)
            self.sample_cnn3 = SequenceConv(384, 128, 3)
        elif sample_context == "ck":
            self.sample_cnn3 = SequenceConv(h, h, 3)
        else:
            self.tk_projector = Dense(h, 384)
            self.tk_contextualizer = TransformerEncoder(1, 384, 8, 384)
        self.sampling_binweights = ScoreLayer(11, use_bias=True)
        self.kernel_alpha_scaler = nn.Parameter(torch.ones(1, 1, 11))
        kernel_buffers(self, _CK_MUS, _CK_SIGMAS)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(encoder_config_from_model_name(config), config.get("idcm_chunk_size", 50),
                   config.get("idcm_overlap", 7), config.get("idcm_top_k_chunks", 3), config.get("idcm_sample_n", 3),
                   config.get("idcm_sample_context", "ck"), config.get("idcm_sample_train_type", "kldivloss"),
                   config.get("idcm_train_selection", False), compute_dtype_of(config))

    # ------------------------------------------------------------------
    def _ck_context(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.encoder.embed(ids).detach()
        if self.sample_context == "ck-small":
            ctx = torch.relu(self.sample_cnn3(self.sample_projector(emb)))
        elif self.sample_context == "ck":
            ctx = torch.relu(self.sample_cnn3(emb))
        else:
            ctx = self.tk_contextualizer(self.tk_projector(emb), mask)
        return l2_normalize_rows(ctx)

    def _sampling_scores(self, q_ids, q_mask, chunk_ids, chunk_mask, n_chunks: int) -> torch.Tensor:
        """CK kernel-pooling scores of every (query, chunk) pair: (B·C,)."""
        q_ctx = torch.repeat_interleave(self._ck_context(q_ids, q_mask), n_chunks, dim=0)
        d_ctx = self._ck_context(chunk_ids, chunk_mask)
        match = matmul_f32(q_ctx, d_ctx.transpose(1, 2))
        acts = kernel_activations(match, self.mu, self.sigma) * chunk_mask[:, None, :, None]
        kernel_res = torch.log(torch.clamp(acts.sum(dim=2) * self.kernel_alpha_scaler, min=1e-4))
        kernel_res = kernel_res * torch.repeat_interleave(q_mask, n_chunks, dim=0)[..., None]
        return self.sampling_binweights(kernel_res.sum(dim=1))

    def _bert_chunk_scores(self, q_ids, q_mask, chunk_ids, chunk_mask) -> torch.Tensor:
        """BERT's score of each [query ‖ chunk]; without autograd where the
        scores' gradient is stopped (every path but ``sample_n`` -1), so the
        encoder keeps no activations for a backward that never comes."""
        seq_ids = torch.cat([q_ids, chunk_ids], dim=1)
        seq_mask = torch.cat([q_mask, chunk_mask], dim=1)
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.sample_n == -1):
            return self.classification_layer(self.encoder(seq_ids, seq_mask)[:, 0, :])

    def _final_score(self, chunk_scores: torch.Tensor, valid_chunks: torch.Tensor) -> torch.Tensor:
        """The sorted top-k weighted sum, empty chunks at the sentinel and
        counted as 0."""
        masked = torch.where(valid_chunks, chunk_scores, NEG_SENTINEL)
        if masked.shape[1] < self.top_k_chunks:
            masked = nn.functional.pad(masked, (0, self.top_k_chunks - masked.shape[1]), value=NEG_SENTINEL)
        top = torch.topk(masked, self.top_k_chunks, dim=1).values
        top = torch.where(top <= NEG_SENTINEL + 100.0, 0.0, top)
        return (top * self.top_k_scoring).sum(dim=1)

    def _selection_loss(self, sampling: torch.Tensor, bert_scores: torch.Tensor, non_empty: torch.Tensor,
                        gb: GlobalBatch):
        target = (bert_scores * non_empty).detach()
        valid = non_empty.float()
        kind = self.sample_train_type
        if kind == "mseloss":
            return (((sampling - target) * valid) ** 2).sum() / torch.clamp(gb.count(valid.sum()), min=1.0)
        if kind == "kldivloss":
            return kldiv_teacher_list(sampling, target, valid, gb)
        masked_target = torch.where(valid > 0, target, NEG_SENTINEL)
        if kind == "crossentropy":
            return soft_cross_entropy(sampling, torch.softmax(masked_target, dim=-1), valid, gb)
        ranks = torch.argsort(torch.argsort(-masked_target, dim=1, stable=True), dim=1, stable=True)
        gains = torch.clamp(self.sample_n - ranks, min=0).float() * valid
        return lambda_loss(sampling, gains, valid, scheme="ndcgLoss2", gb=gb)

    # ------------------------------------------------------------------
    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_ids, q_mask = batch["query_ids"], batch["query_mask"]
        chunks, mask_chunks, non_empty = chunk_document(batch["doc_ids"], batch["doc_mask"], self.chunk_size,
                                                        self.overlap)
        b, c, ext = chunks.shape
        flat_ids = chunks.reshape(b * c, ext)
        flat_mask = mask_chunks.reshape(b * c, ext)
        out: Output = {}

        if self.sample_n > -1:
            sampling = self._sampling_scores(q_ids, q_mask, flat_ids, flat_mask, c).reshape(b, c) * non_empty
            out["sampling_scores"] = sampling

        if self.sample_n > -1 and not self.train_selection:
            # the cascade: BERT on the selected top chunks only
            k = min(self.sample_n, c)
            sel_idx = top_indices(torch.where(non_empty, sampling, NEG_SENTINEL), k)  # (B, k)
            sel_flat = (sel_idx + torch.arange(b, device=sel_idx.device)[:, None] * c).reshape(-1)
            sel_valid = torch.gather(non_empty, 1, sel_idx)
            bert_scores = self._bert_chunk_scores(torch.repeat_interleave(q_ids, k, dim=0),
                                                  torch.repeat_interleave(q_mask, k, dim=0), flat_ids[sel_flat],
                                                  flat_mask[sel_flat]).reshape(b, k).detach()
            out["score"] = self._final_score(bert_scores, sel_valid)
            out["passage_scores"] = bert_scores * sel_valid
        else:
            # BERT on every chunk (stage 1 with sample_n -1, stage 2's
            # selection training), or its scores replayed from a cache
            if "bert_part_cached" in batch:
                bert_scores = batch["bert_part_cached"]
            else:
                bert_scores = self._bert_chunk_scores(torch.repeat_interleave(q_ids, c, dim=0),
                                                      torch.repeat_interleave(q_mask, c, dim=0), flat_ids,
                                                      flat_mask).reshape(b, c)
            if self.sample_n > -1:
                bert_scores = bert_scores.detach()
            out["score"] = self._final_score(bert_scores, non_empty)
            out["passage_scores"] = bert_scores * non_empty
            if self.sample_n > -1 and self.train_selection:
                out["selection_loss"] = self._selection_loss(sampling, bert_scores, non_empty,
                                                             batch.get("global_batch", LOCAL))

        if output_secondary:
            out["secondary"] = {"packed_indices": non_empty, "bert_scores": out["passage_scores"],
                                "sampling_scores": out.get("sampling_scores",
                                                           torch.zeros(b, c, device=flat_ids.device))}
        return out


class IDCMInferenceOnly(IDCM):
    """The exportable cascade-only variant (the same module)."""
