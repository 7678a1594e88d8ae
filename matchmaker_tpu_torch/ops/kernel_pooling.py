"""Gaussian kernel pooling (the KNRM / TK / TKL scoring core): counterpart of
``matchmaker_tpu/ops/kernel_pooling.py``.

Cosine match matrix → per-kernel gaussian activation
``exp(-(cos - mu)^2 / (2 sigma^2))`` → masked sum over document positions →
``log(clamp(x, 1e-10))`` (optionally scaled) → masked sum over query
positions. The JAX package computes all of it in jnp, outside any Pallas
kernel, so it is plain PyTorch here too. The cosine's product is full f32
(``ops.matmul_f32``, never TF32): the exact-match kernel has sigma 1e-4, and
a cosine off by 1e-3 turns it off for identical tokens.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from matchmaker_tpu_torch.ops import matmul_f32


def gaussian_kernel_mus(n_kernels: int) -> List[float]:
    """Kernel centers: 1.0 (exact match) + evenly spaced bin middles over [-1, 1]."""
    mus = [1.0]
    if n_kernels == 1:
        return mus
    bin_size = 2.0 / (n_kernels - 1)
    mus.append(1.0 - bin_size / 2)
    for i in range(1, n_kernels - 1):
        mus.append(mus[i] - bin_size)
    return mus


def gaussian_kernel_sigmas(n_kernels: int, sigma: float = None) -> List[float]:
    """Tiny sigma for the exact-match kernel, half-bin sigma for the rest."""
    if n_kernels == 1:
        return [0.0001]
    bin_size = 2.0 / (n_kernels - 1)
    return [0.0001] + [sigma if sigma is not None else 0.5 * bin_size] * (n_kernels - 1)


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(Σx² + eps): unlike norm-then-divide (``F.normalize``), the
    gradient stays finite at all-zero (padded) rows."""
    return x * torch.rsqrt((x ** 2).sum(dim=-1, keepdim=True) + eps)


def cosine_match_matrix(q_emb: torch.Tensor, d_emb: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, Lq, D) x (B, Ld, D) → (B, Lq, Ld) cosine similarities, f32."""
    return matmul_f32(l2_normalize_rows(q_emb, eps), l2_normalize_rows(d_emb, eps).transpose(-1, -2))


def kernel_activations(match: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(B, Lq, Ld) → (B, Lq, Ld, K) gaussian activations."""
    diff = match[..., None] - mu.reshape(1, 1, 1, -1)
    return torch.exp(-(diff ** 2) / (2.0 * sigma.reshape(1, 1, 1, -1) ** 2))


def kernel_pooling_features(match: torch.Tensor, q_mask: torch.Tensor, d_mask: torch.Tensor, mu: torch.Tensor,
                            sigma: torch.Tensor, alpha_scaler: Optional[torch.Tensor] = None,
                            log_scale: float = 1.0, mask_match_matrix: bool = True) -> torch.Tensor:
    """The pooling pipeline: (B, Lq, Ld) match + masks → (B, K) features.

    ``mask_match_matrix=True`` multiplies the match matrix by the joint mask
    before the kernels (KNRM); TK masks only the activations. Both zero
    padded activations by ``d_mask`` and padded queries by ``q_mask``."""
    if mask_match_matrix:
        match = match * (q_mask[:, :, None] * d_mask[:, None, :])
    acts = kernel_activations(match, mu, sigma)
    acts = acts * d_mask[:, None, :, None]
    per_kernel_query = acts.sum(dim=2)  # (B, Lq, K)
    if alpha_scaler is not None:
        per_kernel_query = per_kernel_query * alpha_scaler.reshape(1, 1, -1)
    log_pkq = torch.log(torch.clamp(per_kernel_query, min=1e-10)) * log_scale
    log_pkq = log_pkq * q_mask[..., None]
    return log_pkq.sum(dim=1)  # (B, K)
