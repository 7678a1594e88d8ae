"""Small from-scratch transformer encoder: counterpart of
``matchmaker_tpu/modules/transformer.py``, in plain PyTorch.

PARADE's chunk aggregator (models/parade.py). The JAX package computes it
in flax outside any Pallas kernel, so its products are ``F.linear`` /
``torch.matmul`` here too. Post-norm, flax semantics: self-attention
(separate Q/K/V/out projections with biases; the query scaled by
1/sqrt(head width) before QKᵀ; masked keys set to the f32 minimum, a large
finite negative, so a row whose keys are all masked attends uniformly
instead of turning NaN) → residual + LayerNorm (epsilon 1e-6, flax's
default) → ReLU feed-forward → residual + LayerNorm. Dropout is 0, as the
JAX package instantiates it.

Parameters are named after the flax tree (``layer_0.self_attention.query.kernel``
for ``layer_0/self_attention/query/kernel``); the attention kernels are kept
(out, in), as ``F.linear`` takes them (models/weights.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.models.encoder import Dense, LayerNorm

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def padding_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) key mask → (B, 1, 1, L) boolean attention mask (True = attend)."""
    return (mask > 0)[:, None, None, :]


class _Projection(nn.Module):
    """A ``DenseGeneral`` kernel stored (out, in) with its flattened bias."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = out_features = dim)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = _Projection(dim, dim)
        self.key = _Projection(dim, dim)
        self.value = _Projection(dim, dim)
        self.out = _Projection(dim, dim)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        b, l, dim = x.shape
        h = self.num_heads
        d = dim // h
        q = self.query(x).reshape(b, l, h, d)
        k = self.key(x).reshape(b, l, h, d)
        v = self.value(x).reshape(b, l, h, d)
        q = q / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = torch.where(attn_mask, s, torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, l, dim)
        return self.out(o)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.self_attention = SelfAttention(dim, num_heads)
        self.attention_norm = LayerNorm(dim)
        self.ff_in = Dense(dim, ff_dim)
        self.ff_out = Dense(ff_dim, dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention_norm(x + self.self_attention(x, padding_attention_mask(mask)), LN_EPS)
        h = self.ff_out(torch.relu(self.ff_in(x)))
        return self.ff_norm(x + h, LN_EPS)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(dim, num_heads, ff_dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, dim); mask (B, L), >0 = real token."""
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x
