"""TK-Sparse (CIKM'20), TK with a learned per-document-term stop-word gate:
counterpart of ``matchmaker_tpu/models/tk_sparse.py``.

TK's contextualization; a tanh → relu MLP (``stop_word_reducer``,
``stop_word_reducer2`` with its bias 1 at init) over a separately mixed
document representation (``mixer_stop``) gives a non-negative gate per
document term, which multiplies the kernel activations after the gaussian
kernels (so the exact-match kernel cannot count a removed word). The gate is
returned as ``sparsity`` for the L1 sparsity loss
(training/train_step.py, ``minimize_sparsity_weight``);
``reanimate_gate_bias`` raises the gate's bias to leave an all-zero
collapse.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.base import Batch, Output
from matchmaker_tpu_torch.models.encoder import Dense
from matchmaker_tpu_torch.models.tk import TK
from matchmaker_tpu_torch.ops.kernel_pooling import cosine_match_matrix, kernel_activations


class TKSparse(TK):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        dim = self.pos_q.shape[1]
        self.mixer_stop = nn.Parameter(torch.full((1,), 0.5))
        self.stop_word_reducer = Dense(dim, 100)
        self.stop_word_reducer2 = Dense(100, 1)

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask)
        d_emb = self.embedder(batch["doc_ids"], d_mask)

        q_ctx = self.contextualize(q_emb, q_mask, self.pos_q)
        d_ctx_raw = self.contextualizer(d_emb + self.pos_d[None, : d_emb.shape[1], :], d_mask)
        d_ctx = self.mixer * d_emb + (1.0 - self.mixer) * d_ctx_raw

        joint_mask = q_mask[:, :, None] * d_mask[:, None, :]
        match = cosine_match_matrix(q_ctx, d_ctx) * joint_mask
        acts = kernel_activations(match, self.mu, self.sigma)

        # the stop-word gate on a separately mixed document representation
        d_stop_in = self.mixer_stop * d_emb + (1.0 - self.mixer_stop) * d_ctx_raw
        gate = torch.relu(self.stop_word_reducer2(torch.tanh(self.stop_word_reducer(d_stop_in)))).squeeze(-1)
        gate = gate * d_mask  # (B, Ld)

        acts = acts * joint_mask[..., None] * gate[:, None, :, None]
        per_kernel_query = acts.sum(dim=2) * self.kernel_alpha_scaler.reshape(1, 1, -1)
        log_pkq = torch.log(torch.clamp(per_kernel_query, min=1e-10)) * q_mask[..., None]
        per_kernel = log_pkq.sum(dim=1)
        out: Output = {"score": self.kernel_bin_weights(per_kernel), "sparsity": gate}
        if output_secondary:
            out["secondary"] = {"per_kernel": per_kernel, "cosine_matrix_masked": match,
                                "document_stop_words": gate}
        return out


@torch.no_grad()
def reanimate_gate_bias(model: TKSparse, added_bias: float) -> None:
    """Raise the gate's bias by ``added_bias``, in place (the JAX package's
    functional ``reanimate_gate_bias`` on a param tree)."""
    model.stop_word_reducer2.bias.add_(added_bias)
