"""Transformer encoder (BERT/DistilBERT layout): counterpart of
``matchmaker_tpu/models/encoder.py``.

Post-norm: embeddings (word + position [+ token type]) → LayerNorm →
N × [self-attention → add & LN → GELU MLP → add & LN]. Parameters are f32
and named after the flax param tree (``layer_0.attention.query.kernel`` for
``layer_0/attention/query/kernel``), with the attention kernels stored 2-D
(see models/weights.py). Activations run in ``compute_dtype``; the output is
f32.

``fused_attention`` runs each layer as the two fused halves of
ops/fused_attention.py (the hand-written CUDA kernels on a card, bf16 only);
with autograd on they are the differentiable halves of ops/fused_backward.py,
whose backward is a hand-written kernel too. Otherwise the layer follows the
flax modules' dtype semantics in plain PyTorch, differentiated by autograd.

No dropout is applied: like the JAX package's BERT_DOT training, every pass
is deterministic (see ROADMAP.md §3); a non-deterministic pass with dropout
> 0 warns on the fused layers, as the JAX package does, and is refused on the
unfused ones, whose dropout is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.ops.fused_attention import fused_attention_block_qkv, fused_mlp_block
from matchmaker_tpu_torch.ops.fused_backward import fused_attention_block_qkv_train, fused_mlp_block_train

_warned_fused_dropout = False


def _warn_fused_dropout_noop():
    """One-time warning: fused layers silently skip dropout while training.

    The fused layer halves (ops/fused_attention.py / fused_backward.py) do not
    implement attention or hidden dropout; a user training with
    ``dropout > 0`` and ``encoder_fused_attention: true`` must see the
    regularization change."""
    global _warned_fused_dropout
    if not _warned_fused_dropout:
        _warned_fused_dropout = True
        warnings.warn(
            "encoder_fused_attention is enabled with dropout > 0 in a "
            "non-deterministic (training) pass: dropout is a NO-OP inside the "
            "fused layers. Set dropout: 0.0 to silence, or disable "
            "encoder_fused_attention to train with dropout.",
            UserWarning,
            stacklevel=3,
        )


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6  # distilbert default
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 0  # 2 for bert, 0 for distilbert
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    # LayerNorms (and the residual stream) in compute_dtype instead of f32
    norms_in_compute_dtype: bool = False
    # each layer as the two fused halves (ops/fused_attention.py)
    fused_attention: bool = False
    # int8 inference kernels of the JAX package; not ported yet (ROADMAP.md)
    int8_mlp: bool = False
    int8_attention: bool = False
    # TPU tile geometry of the JAX kernels; kept for config parity, unused here
    fused_block_b: int = 8
    fused_ff_chunks: int = 4

    @classmethod
    def distilbert(cls, **kw):
        return cls(**{**dict(num_layers=6, type_vocab_size=0), **kw})

    @classmethod
    def bert_base(cls, **kw):
        return cls(**{**dict(num_layers=12, type_vocab_size=2), **kw})

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        defaults = dict(
            vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=128,
        )
        return cls(**{**defaults, **kw})

    @classmethod
    def mini(cls, **kw):
        """4-layer/256-hidden encoder (~11M params), the from-scratch tier."""
        defaults = dict(
            hidden_size=256, num_layers=4, num_heads=4,
            intermediate_size=1024, max_position_embeddings=512,
        )
        return cls(**{**defaults, **kw})


def encoder_config_from_model_name(config) -> EncoderConfig:
    """The encoder size from ``bert_pretrained_model`` (name heuristics) plus
    the YAML inference options, as in the JAX package."""
    name = str(config.get("bert_pretrained_model", "distilbert-base-uncased"))
    if os.path.isdir(name):
        raise NotImplementedError(
            "reading a Hugging Face checkpoint's config is not ported yet (ROADMAP.md)")
    if "tiny" in name:
        cfg = EncoderConfig.tiny()
    elif "mini" in name:
        cfg = EncoderConfig.mini()
    elif "distilbert" in name:
        cfg = EncoderConfig.distilbert()
    else:
        cfg = EncoderConfig.bert_base()
    overrides = {}
    if config.get("encoder_bf16_norms"):
        overrides["norms_in_compute_dtype"] = True
    if config.get("encoder_fused_attention"):
        overrides["fused_attention"] = True
    if config.get("encoder_int8_mlp"):
        overrides.update(fused_attention=True, int8_mlp=True)
    if config.get("encoder_int8"):
        overrides.update(fused_attention=True, int8_mlp=True, int8_attention=True)
    if config.get("encoder_fused_block_b"):
        overrides["fused_block_b"] = int(config["encoder_fused_block_b"])
    if config.get("encoder_fused_ff_chunks"):
        overrides["fused_ff_chunks"] = int(config["encoder_fused_ff_chunks"])
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


class Dense(nn.Module):
    """kernel (in, out) + bias, flax ``Dense`` semantics: inputs, kernel and
    bias cast to ``dtype`` (default: promoted) before the product."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.matmul(x.to(dtype), self.kernel.to(dtype)) + self.bias.to(dtype)


class LayerNorm(nn.Module):
    """scale + bias, flax ``LayerNorm`` semantics: f32 statistics
    (E[x²] − E[x]²), output in ``dtype`` (default: promoted with f32)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, eps: float, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + eps) * self.scale) + self.bias
        return y.to(dtype or torch.promote_types(x.dtype, self.scale.dtype))


class Embed(nn.Module):
    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class Attention(nn.Module):
    """Q/K/V/out projections under flax ``MultiHeadDotProductAttention``'s names."""

    def __init__(self, hidden: int):
        super().__init__()
        self.query = Dense(hidden, hidden)
        self.key = Dense(hidden, hidden)
        self.value = Dense(hidden, hidden)
        self.out = Dense(hidden, hidden)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, compute_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        hid, ff = cfg.hidden_size, cfg.intermediate_size
        self.attention = Attention(hid)
        self.attention_norm = LayerNorm(hid)
        self.mlp_in = Dense(hid, ff)
        self.mlp_out = Dense(ff, hid)
        self.mlp_norm = LayerNorm(hid)
        self._fused_cache = None

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """x (B, L, HID); key_mask (B, L) f32, 1 = real token."""
        if self.cfg.fused_attention:
            return self._fused(x, key_mask)
        cfg, cd = self.cfg, self.compute_dtype
        ln_dtype = cd if cfg.norms_in_compute_dtype else None
        x = self.attention_norm(x + self._attention(x, key_mask), cfg.layer_norm_eps, ln_dtype)
        h = self.mlp_out(F.gelu(self.mlp_in(x, cd)), cd)
        return self.mlp_norm(x + h, cfg.layer_norm_eps, ln_dtype)

    def _attention(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        cd, a = self.compute_dtype, self.attention
        b, l, hid = x.shape
        h = self.cfg.num_heads
        d = hid // h
        q = a.query(x, cd).reshape(b, l, h, d) / torch.tensor(math.sqrt(d), dtype=cd)
        k = a.key(x, cd).reshape(b, l, h, d)
        v = a.value(x, cd).reshape(b, l, h, d)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = torch.where(key_mask[:, None, None, :] > 0, s, torch.finfo(cd).min)
        p = torch.softmax(s, dim=-1).to(cd)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, l, hid)
        return a.out(o, cd)

    def _fused_weights(self):
        """The fused halves' weights: Q/K/V packed, kernels in the compute
        dtype. With autograd they are built on every call, so the packing
        and casts carry gradients back to the f32 parameters. Without
        autograd they are built once and kept until a parameter moves
        (``.to``) or is written (``load_state_dict``), which changes its data
        pointer or version counter."""
        cd, a = self.compute_dtype, self.attention
        params = (a.query.kernel, a.key.kernel, a.value.kernel, a.query.bias, a.key.bias, a.value.bias,
                  a.out.kernel, self.mlp_in.kernel, self.mlp_out.kernel)
        key = tuple((p.data_ptr(), p._version) for p in params)
        if torch.is_grad_enabled() or self._fused_cache is None or self._fused_cache[0] != key:
            with torch.inference_mode(False):  # plain tensors, usable outside inference mode too
                wqkv = torch.cat([a.query.kernel, a.key.kernel, a.value.kernel], dim=1).to(cd)
                bqkv = torch.cat([a.query.bias, a.key.bias, a.value.bias])
                weights = (wqkv, bqkv, a.out.kernel.to(cd), self.mlp_in.kernel.to(cd), self.mlp_out.kernel.to(cd))
            if torch.is_grad_enabled():
                return weights
            self._fused_cache = (key, weights)
        return self._fused_cache[1]

    def _fused(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """The two fused halves: under autograd the differentiable ones (K1/K2
        forward, K12/K11 backward on a card); without it the forward kernels
        alone on cached weights."""
        cfg, cd, a = self.cfg, self.compute_dtype, self.attention
        wqkv, bqkv, wo, w1, w2 = self._fused_weights()
        grad = torch.is_grad_enabled()
        attention = fused_attention_block_qkv_train if grad else fused_attention_block_qkv
        mlp = fused_mlp_block_train if grad else fused_mlp_block
        x = attention(
            x.to(cd), wqkv, bqkv, wo, a.out.bias, key_mask, cfg.num_heads,
            self.attention_norm.scale, self.attention_norm.bias, cfg.layer_norm_eps)
        return mlp(
            x.to(cd), w1, self.mlp_in.bias, w2, self.mlp_out.bias,
            self.mlp_norm.scale, self.mlp_norm.bias, cfg.layer_norm_eps)


class TransformerEncoderLM(nn.Module):
    def __init__(self, cfg: EncoderConfig, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.int8_mlp or cfg.int8_attention:
            raise NotImplementedError("the int8 encoder kernels are not ported yet (ROADMAP.md)")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_norm = LayerNorm(cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, compute_dtype))

    def embed(self, ids: torch.Tensor, type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """word + position (+ type) embeddings → LayerNorm."""
        cfg = self.cfg
        positions = torch.arange(ids.shape[1], device=ids.device)
        x = self.word_embeddings(ids) + self.position_embeddings(positions)[None]
        if cfg.type_vocab_size > 0:
            if type_ids is None:
                type_ids = torch.zeros_like(ids)
            x = x + self.token_type_embeddings(type_ids)
        ln_dtype = self.compute_dtype if cfg.norms_in_compute_dtype else None
        return self.embeddings_norm(x, cfg.layer_norm_eps, ln_dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None, deterministic: bool = True) -> torch.Tensor:
        """Final hidden states (B, L, H), f32; mask (B, L), >0 = real token.
        ``deterministic=False`` asks for dropout, which the port does not
        apply: the fused layers warn once (as the JAX package's do), the
        unfused ones raise."""
        if not deterministic and self.cfg.dropout > 0:
            if not self.cfg.fused_attention:
                raise NotImplementedError(
                    "dropout on the unfused encoder is not ported yet (ROADMAP.md, queue 1 item 2)")
            _warn_fused_dropout_noop()
        key_mask = (mask > 0).float()
        x = self.embed(ids, type_ids).to(self.compute_dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_mask)
        return x.float()
