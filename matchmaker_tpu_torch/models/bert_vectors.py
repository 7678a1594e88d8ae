"""``token_embedder_type: bert_vectors``: a transformer encoder as the
contextual embedding source of the TK / KNRM family: counterpart of
``matchmaker_tpu/models/bert_vectors.py``.

``ContextualVectorsAdapter`` wraps a ranker that has ``score_embeddings``
(built with ``_external_embedding``, so it holds no token table) and hands
it the encoder's per-token vectors (f32, padded positions zero) in place of
its embedding lookup. The encoder is named ``encoder``, so ``init_params``
fills it from a local checkpoint (``bert_pretrained_model``) as it fills
BERT_DOT's. With ``train_embedding: false`` (the default) the encoder runs
under ``torch.no_grad()``, JAX's ``stop_gradient``: on a card its fused
halves launch the forward kernels (K1/K2) only, never the backward ones
(K11/K12), and no gradient reaches it. With ``train_embedding: true`` it
trains with the ranker, through the differentiable halves.
"""

from __future__ import annotations

import contextlib

import torch

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import compute_dtype_of
from matchmaker_tpu_torch.models.encoder import EncoderConfig, TransformerEncoderLM, encoder_config_from_model_name


class ContextualVectorsAdapter(Ranker):
    def __init__(self, inner: Ranker, encoder_cfg: EncoderConfig, trainable: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not hasattr(inner, "score_embeddings"):
            raise ValueError(f"bert_vectors requires a model with score_embeddings (tk/knrm); got "
                             f"{type(inner).__name__}")
        self.inner = inner
        self.encoder_cfg = encoder_cfg
        self.trainable = trainable
        self.encoder = TransformerEncoderLM(encoder_cfg, compute_dtype)

    @classmethod
    def from_config(cls, config, inner):
        return cls(inner, encoder_config_from_model_name(config), config.get("train_embedding", False),
                   compute_dtype_of(config))

    def vectors(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with contextlib.nullcontext() if self.trainable else torch.no_grad():
            vecs = self.encoder(ids, mask)
        return vecs.float() * mask[..., None]

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_vecs = self.vectors(batch["query_ids"], batch["query_mask"])
        d_vecs = self.vectors(batch["doc_ids"], batch["doc_mask"])
        return self.inner.score_embeddings(q_vecs, d_vecs, batch["query_mask"], batch["doc_mask"], output_secondary)
