"""TKL (SIGIR'20), TK for long documents over overlapping chunk windows:
counterpart of ``matchmaker_tpu/models/tkl.py``.

The document is cut into overlapping chunks (``tkl_chunk_size`` 40 +
2 x ``tkl_overlap`` 5, modules/pooling.py:unfold_chunks), every chunk
contextualized by the TK transformer in one batch (empty chunks computed
and masked, not packed, as in the JAX package), the kernel activations of
the chunks' inner tokens against the query reassembled over the whole
document, pooled over sliding windows (``tkl_sliding_window_size`` 30,
stride 2) with a saturation (``log``, ``idf``, ``embedding`` or
``linear``), scored per window, and the top ``tkl_top_k_chunks`` (3)
non-overlapping regions with their ±2 neighbours weighted by the learned
``chunk_scoring``. ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does.

``linear``: the window's ``saturation_linear`` output times the sum of its
clamped kernel sums, plus ``saturation_linear2``'s, for every kernel. The
JAX package's expression for it does not broadcast and raises for every
input (ROADMAP.md §3); the port computes it per window.

``idf`` / ``embedding`` raise the kernel sums, clamped at 1e-10, to a
learned power, as the JAX package does: under a negative exponent a sum of
0 (the exact-match kernel's, almost everywhere; every kernel's past a
document's end) overflows to inf, and the masks' multiply or the sum over
queries turns it into NaN (ROADMAP.md §3).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.models.base import Batch, Output, Ranker
from matchmaker_tpu_torch.models.bert_cat import ScoreLayer
from matchmaker_tpu_torch.models.encoder import Dense, LayerNorm
from matchmaker_tpu_torch.models.knrm import kernel_buffers
from matchmaker_tpu_torch.modules.embedder import TokenEmbedder, position_buffer
from matchmaker_tpu_torch.modules.pooling import unfold_chunks
from matchmaker_tpu_torch.modules.transformer import LN_EPS, TransformerEncoder
from matchmaker_tpu_torch.ops.kernel_pooling import (
    cosine_match_matrix,
    gaussian_kernel_mus,
    gaussian_kernel_sigmas,
    kernel_activations,
)

SATURATIONS = ("log", "idf", "embedding", "linear")


class TKL(Ranker):
    def __init__(self, vocab_size: int, dim: int, kernels_mu: Optional[List[float]] = None,
                 kernels_sigma: Optional[List[float]] = None, att_heads: int = 8, att_layers: int = 2,
                 att_ff_dim: int = 100, chunk_size: int = 40, overlap: int = 5, sliding_window_size: int = 30,
                 sliding_window_stride: int = 2, top_k_chunks: int = 3, saturation: str = "log",
                 pretrained: Optional[np.ndarray] = None):
        super().__init__()
        if saturation not in SATURATIONS:
            raise ValueError(f"tkl_saturation {saturation!r}: expected one of {SATURATIONS}")
        self.dim = dim
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.sliding_window_size = sliding_window_size
        self.sliding_window_stride = sliding_window_stride
        self.top_k_chunks = top_k_chunks
        self.saturation = saturation
        self.embedder = TokenEmbedder(vocab_size, dim, pretrained)
        mus = kernels_mu or gaussian_kernel_mus(11)
        sigmas = kernels_sigma or gaussian_kernel_sigmas(11)
        kernel_buffers(self, mus, sigmas)
        n_kernels = len(mus)
        self.register_buffer("pos_q", position_buffer(512, dim), persistent=False)
        self.register_buffer("pos_d", position_buffer(chunk_size + 2 * overlap, dim), persistent=False)
        self.contextualizer = TransformerEncoder(att_layers, dim, att_heads, att_ff_dim)
        self.mixer = nn.Parameter(torch.full((1,), 0.5))
        self.kernel_mult = nn.Parameter(torch.ones(1))
        self.chunk_scoring = nn.Parameter(torch.ones(1, top_k_chunks * 5))
        self.kernel_weights = ScoreLayer(n_kernels, use_bias=False)
        if saturation != "log":
            self.saturation_linear = Dense(2, 1)
            self.saturation_linear2 = Dense(2, 1)
            if saturation != "linear":
                self.saturation_linear3 = Dense(2, 1)
            if saturation == "embedding":
                self.sat_emb_reduce1 = Dense(dim, 1)
                self.sat_normer = LayerNorm(2)

    @classmethod
    def from_config(cls, config, pretrained=None):
        return cls(config["_vocab_size"], config.get("token_embedding_size", 300), config.get("tk_kernels_mu"),
                   config.get("tk_kernels_sigma"), config.get("tk_att_heads", 8), config.get("tk_att_layer", 2),
                   config.get("tk_att_ff_dim", 100), config.get("tkl_chunk_size", 40), config.get("tkl_overlap", 5),
                   config.get("tkl_sliding_window_size", 30), 2, config.get("tkl_top_k_chunks", 3),
                   config.get("tkl_saturation", "log"), pretrained)

    def contextualize(self, emb, mask, positions):
        ctx = self.contextualizer(emb + positions[None, : emb.shape[1], :], mask)
        return self.mixer * emb + (1.0 - self.mixer) * ctx

    def saturate(self, per_kernel_query: torch.Tensor, win_lengths: torch.Tensor, q_ctx: torch.Tensor,
                 q_mask: torch.Tensor, query_idfs: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, Lq, W, K) window kernel sums, (B, Lq, W) live-token counts →
        the saturated (B, Lq, W, K) features, before the masks."""
        if self.saturation == "log":
            return torch.log(torch.clamp(per_kernel_query * self.kernel_mult[0], min=1e-10))
        ones = torch.ones_like(win_lengths)
        if self.saturation == "embedding":
            influence_a = self.sat_emb_reduce1(q_ctx).squeeze(-1)[:, :, None] * ones
        else:  # idf, linear
            idfs = query_idfs if query_idfs is not None else torch.zeros_like(q_mask)
            influence_a = torch.relu(idfs)[:, :, None] * ones
        influencer = torch.stack([influence_a, win_lengths.float()], dim=-1)
        if self.saturation == "embedding":
            influencer = self.sat_normer(influencer, LN_EPS)
        sat1 = self.saturation_linear(influencer).squeeze(-1)
        clamped = torch.clamp(per_kernel_query, min=1e-10)
        if self.saturation == "linear":
            sat2 = self.saturation_linear2(influencer).squeeze(-1)
            sat = sat1 * clamped.sum(dim=-1) + sat2
            return sat[..., None].expand(per_kernel_query.shape)
        sat2 = 1.0 / self.saturation_linear2(influencer).squeeze(-1)
        sat3 = self.saturation_linear3(influencer).squeeze(-1)
        return sat1[..., None] * clamped ** sat2[..., None] - sat3[..., None]

    def forward(self, batch: Batch, output_secondary: bool = False) -> Output:
        q_mask, d_mask = batch["query_mask"], batch["doc_mask"]
        q_emb = self.embedder(batch["query_ids"], q_mask)
        d_emb = self.embedder(batch["doc_ids"], d_mask)
        b, lq = q_mask.shape

        q_ctx = self.contextualize(q_emb, q_mask, self.pos_q)

        # ---- the chunks, every one computed, the empty ones masked
        chunks = unfold_chunks(d_emb, self.chunk_size, self.overlap)  # (B, C, ext, D)
        chunk_mask = unfold_chunks(d_mask[..., None], self.chunk_size, self.overlap).squeeze(-1)
        n_chunks, ext = chunks.shape[1], chunks.shape[2]
        flat = chunks.reshape(b * n_chunks, ext, self.dim)
        flat_mask = chunk_mask.reshape(b * n_chunks, ext)
        flat_ctx = self.contextualize(flat, flat_mask, self.pos_d)
        inner = flat_ctx[:, self.overlap: self.overlap + self.chunk_size, :]
        inner_mask = flat_mask[:, self.overlap: self.overlap + self.chunk_size]

        # ---- kernel activations of each chunk against its query, reassembled
        q_rep = torch.repeat_interleave(q_ctx, n_chunks, dim=0)
        match = cosine_match_matrix(q_rep, inner)  # (B·C, Lq, chunk)
        acts = kernel_activations(match, self.mu, self.sigma) * inner_mask[:, None, :, None]
        acts = acts.reshape(b, n_chunks, lq, self.chunk_size, -1).permute(0, 2, 1, 3, 4)
        acts = acts.reshape(b, lq, n_chunks * self.chunk_size, -1)  # (B, Lq, Ld', K)

        # ---- sliding-window pooling over document positions
        win, stride = self.sliding_window_size, self.sliding_window_stride
        if acts.shape[2] < win:
            acts = F.pad(acts, (0, 0, 0, win - acts.shape[2]))
        windows = acts.unfold(2, win, stride)  # (B, Lq, W, K, win), a view
        per_kernel_query = windows.sum(dim=-1)  # (B, Lq, W, K)
        win_lengths = (windows.sum(dim=3) != 0).sum(dim=-1)  # (B, Lq, W)

        sat = self.saturate(per_kernel_query, win_lengths, q_ctx, q_mask, batch.get("query_idfs"))
        sat = sat * q_mask[:, :, None, None] * (win_lengths > 0)[..., None]
        per_kernel = sat.sum(dim=1)  # (B, W, K)
        window_scores = self.kernel_weights(per_kernel)  # (B, W)

        # ---- top-k non-overlapping regions with ±2 neighbours
        if window_scores.shape[1] < self.top_k_chunks:
            window_scores = F.pad(window_scores, (0, self.top_k_chunks - window_scores.shape[1]))
        scores_sentinel = torch.where(window_scores == 0, -9900.0, window_scores)
        w = scores_sentinel.shape[1]
        positions = torch.arange(w, device=window_scores.device)[None, :]
        region_scores = scores_sentinel
        top_idx = []
        for c in range(self.top_k_chunks):
            best = torch.argmax(region_scores, dim=1)
            top_idx.append(best)
            in_region = (positions - best[:, None]).abs() < win / 2
            region_scores = torch.where(in_region, -10001.0 - c, region_scores)
        top_idx = torch.stack(top_idx, dim=1)  # (B, k)
        neighbors = torch.cat([top_idx, top_idx - 1, top_idx + 1, top_idx - 2, top_idx + 2], dim=1)
        neighbors = torch.clamp(neighbors, 0, w - 1)
        gathered = torch.gather(scores_sentinel, 1, neighbors)
        gathered = torch.where(gathered <= -9900.0, 0.0, gathered)
        out: Output = {"score": (gathered * self.chunk_scoring).sum(dim=1)}
        if output_secondary:
            out["secondary"] = {"window_scores": torch.where(scores_sentinel <= -9900.0, 0.0, scores_sentinel),
                                "top_non_overlapping_idx": top_idx}
        return out
