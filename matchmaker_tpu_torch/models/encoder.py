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
whose backward is a hand-written kernel too. ``int8_mlp`` /
``int8_attention`` swap a half for its int8 counterpart of
ops/fused_int8.py when autograd is off (the JAX rule "int8 and
deterministic"): weights quantized per output column from the f32
parameters, kept until a parameter moves. The int8 halves are forward-only,
so with autograd on an int8 flag is refused. Otherwise the layer follows the
flax modules' dtype semantics in plain PyTorch, differentiated by autograd.

Dropout runs where the flax modules put it, on a pass with
``deterministic=False`` (no entry point of either package trains so; every
trainer pass is deterministic, see ROADMAP.md §3): after the embeddings'
LayerNorm on every path; on the unfused layers also on the attention
probabilities (flax's ``broadcast_dropout``: one keep mask over the (query,
key) plane, shared by the batch and the heads) and on the MLP output before
its residual. The fused halves apply none and warn once, as the JAX
package's do. The keep masks come from an explicit ``torch.Generator`` (the
``generator`` argument, else the module's own, seeded from
``dropout_seed``); jax.random's bits are not reproduced, only their law.
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

from matchmaker_tpu_torch.ops.fused_attention import (
    card_width,
    fused_attention_block_qkv,
    fused_mlp_block,
    pad_attention_heads,
    pad_attention_hidden,
    pad_mlp_hidden,
)
from matchmaker_tpu_torch.ops.fused_backward import fused_attention_block_qkv_train, fused_mlp_block_train
from matchmaker_tpu_torch.ops.fused_int8 import (
    fused_attention_int8_block_qkv_kmajor,
    fused_mlp_int8_block_kmajor,
    kmajor_attention_weights,
    kmajor_codes,
    pad_int8_attention,
    pad_int8_mlp,
    quantize_weights_per_col,
)

_warned_fused_dropout = False


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator, shape=None) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate) in x's dtype, the keep mask drawn from
    ``generator``. ``shape``: the keep mask's shape, broadcast against x
    (flax's ``broadcast_dropout`` of the attention probabilities, where the
    multiplier keep / (1 - rate) is formed in x's dtype first)."""
    keep_prob = 1.0 - rate
    keep = torch.empty(shape if shape is not None else x.shape, device=x.device).bernoulli_(keep_prob,
                                                                                           generator=generator)
    if shape is not None:
        return x * (keep.to(x.dtype) / torch.tensor(keep_prob, dtype=x.dtype, device=x.device))
    return torch.where(keep.bool(), x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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
    # int8 inference halves (ops/fused_int8.py), without autograd only
    int8_mlp: bool = False
    int8_attention: bool = False
    # TPU tile geometry of the JAX kernels; kept for config parity, unused
    # here (the int8 halves use the JAX kernels' defaults: 4 FF chunks,
    # 2 heads a group, as the JAX encoder passes neither)
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
    """The encoder size from ``bert_pretrained_model`` (a local Hugging Face
    checkpoint directory's ``config.json``, else name heuristics) plus the
    YAML inference options, as in the JAX package."""
    name = str(config.get("bert_pretrained_model", "distilbert-base-uncased"))
    if os.path.isdir(name):
        from matchmaker_tpu_torch.models.hf_import import load_hf_encoder_config

        cfg = load_hf_encoder_config(name)
    elif "tiny" in name:
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
        self._int8_cache = None

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, L, HID); key_mask (B, L) f32, 1 = real token. ``generator``:
        apply dropout from it (a non-deterministic pass; the fused halves
        apply none)."""
        if self.cfg.fused_attention:
            return self._fused(x, key_mask)
        cfg, cd = self.cfg, self.compute_dtype
        ln_dtype = cd if cfg.norms_in_compute_dtype else None
        x = self.attention_norm(x + self._attention(x, key_mask, generator), cfg.layer_norm_eps, ln_dtype)
        h = self.mlp_out(F.gelu(self.mlp_in(x, cd)), cd)
        if generator is not None:
            h = dropout(h, cfg.dropout, generator)
        return self.mlp_norm(x + h, cfg.layer_norm_eps, ln_dtype)

    def _attention(self, x: torch.Tensor, key_mask: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        if generator is not None:
            p = dropout(p, self.cfg.dropout, generator, shape=(1, 1, l, l))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, l, hid)
        return a.out(o, cd)

    def _fused_weights(self):
        """The fused halves' weights: Q/K/V packed, kernels in the compute
        dtype, the heads zero-padded to a width the card's attention core is
        instanced for where they are narrower (26 → 32, 8 → 16, 80 → 128;
        the plain versions take them so as well: ``pad_attention_heads``);
        on a card also the hidden and FF widths zero-padded to the next
        multiple of 8 the products run them at (``card_width``). With
        autograd they are built on every call, so the packing, padding and
        casts carry gradients back to the f32 parameters. Without autograd
        they are built once and kept until a parameter moves (``.to``) or is
        written (``load_state_dict``), which changes its data pointer or
        version counter."""
        cd, a = self.compute_dtype, self.attention
        params = (a.query.kernel, a.key.kernel, a.value.kernel, a.query.bias, a.key.bias, a.value.bias,
                  a.out.kernel, self.mlp_in.kernel, self.mlp_out.kernel)
        key = tuple((p.data_ptr(), p._version) for p in params)
        if torch.is_grad_enabled() or self._fused_cache is None or self._fused_cache[0] != key:
            with torch.inference_mode(False):  # plain tensors, usable outside inference mode too
                wqkv = torch.cat([a.query.kernel, a.key.kernel, a.value.kernel], dim=1).to(cd)
                bqkv = torch.cat([a.query.bias, a.key.bias, a.value.bias])
                wqkv, bqkv, wo = pad_attention_heads(wqkv, bqkv, a.out.kernel.to(cd), self.cfg.num_heads)
                w1, w2 = self.mlp_in.kernel.to(cd), self.mlp_out.kernel.to(cd)
                if wqkv.is_cuda:
                    hid = card_width(self.cfg.hidden_size)
                    wqkv, wo = pad_attention_hidden(wqkv, wo, hid)
                    w1, w2 = pad_mlp_hidden(w1, w2, hid, card_width(self.cfg.intermediate_size))
                weights = (wqkv, bqkv, wo, w1, w2)
            if torch.is_grad_enabled():
                return weights
            self._fused_cache = (key, weights)
        return self._fused_cache[1]

    def _int8_weights(self):
        """The int8 halves' weights: per-output-column codes and f32 scales
        quantized from the f32 parameters (as the JAX encoder does, not from
        their bf16 casts), Q/K/V packed, each weight's codes K-major ((OUT,
        IN) contiguous, the transpose of ``quantize_weights_per_col``'s) as
        the card's int8 products read them, then padded with zero codes of
        scale 1 and bias 0 (``pad_int8_attention``, ``pad_int8_mlp``): each
        head to an instanced width, x's contraction, each FF chunk and each
        head group's Wo columns to whole 64-code steps. Built without
        autograd, kept until a parameter moves or is written, like
        :meth:`_fused_weights`."""
        a = self.attention
        kernels = (a.query.kernel, a.key.kernel, a.value.kernel, a.out.kernel, self.mlp_in.kernel,
                   self.mlp_out.kernel)
        biases = (a.query.bias, a.key.bias, a.value.bias)
        key = tuple((p.data_ptr(), p._version) for p in kernels + biases + (self.mlp_in.bias,))
        if self._int8_cache is None or self._int8_cache[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                q, k, v, o, w1, w2 = (quantize_weights_per_col(p) for p in kernels)
                wqkv_t, sqkv, bqkv, wo_t, so, _ = kmajor_attention_weights(*q, *k, *v, *o, *biases, None)
                wqkv_t, sqkv, bqkv, wo_t = pad_int8_attention(wqkv_t, sqkv, bqkv, wo_t, self.cfg.num_heads)
                w1_t, s1, b1, w2_t = pad_int8_mlp(kmajor_codes(w1[0]), w1[1], self.mlp_in.bias.detach().float(),
                                                  kmajor_codes(w2[0]))
                weights = dict(wqkv_t=wqkv_t, sqkv=sqkv, bqkv=bqkv, wo_t=wo_t, so=so, w1_t=w1_t, s1=s1, b1=b1,
                               w2_t=w2_t, s2=w2[1])
            self._int8_cache = (key, weights)
        return self._int8_cache[1]

    def _fused(self, x: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
        """The two fused halves: under autograd the differentiable ones (K1/K2
        forward, K12/K11 backward on a card); without it the forward kernels
        alone on cached weights, int8 ones (K10/K9) where a flag asks."""
        cfg, cd, a = self.cfg, self.compute_dtype, self.attention
        grad = torch.is_grad_enabled()
        if grad and (cfg.int8_mlp or cfg.int8_attention):
            raise NotImplementedError(
                "the int8 layer halves are forward-only: run int8_mlp / int8_attention without autograd "
                "(torch.no_grad or torch.inference_mode); see ROADMAP.md §3")
        q8 = self._int8_weights() if cfg.int8_mlp or cfg.int8_attention else None
        if not (cfg.int8_mlp and cfg.int8_attention):  # a bf16 half runs
            wqkv, bqkv, wo, w1, w2 = self._fused_weights()
        ln1 = (self.attention_norm.scale, self.attention_norm.bias, cfg.layer_norm_eps)
        ln2 = (self.mlp_norm.scale, self.mlp_norm.bias, cfg.layer_norm_eps)
        head_dim = cfg.hidden_size // cfg.num_heads
        if cfg.int8_attention:
            x = fused_attention_int8_block_qkv_kmajor(x.to(cd), q8["wqkv_t"], q8["sqkv"], q8["bqkv"], q8["wo_t"],
                                                      q8["so"], a.out.bias, key_mask, cfg.num_heads, *ln1,
                                                      head_dim=head_dim)
        else:
            attention = fused_attention_block_qkv_train if grad else fused_attention_block_qkv
            x = attention(x.to(cd), wqkv, bqkv, wo, a.out.bias, key_mask, cfg.num_heads, *ln1, head_dim=head_dim)
        if cfg.int8_mlp:
            return fused_mlp_int8_block_kmajor(x.to(cd), q8["w1_t"], q8["s1"], q8["b1"], q8["w2_t"],
                                               q8["s2"], self.mlp_out.bias, *ln2)
        mlp = fused_mlp_block_train if grad else fused_mlp_block
        return mlp(x.to(cd), w1, self.mlp_in.bias, w2, self.mlp_out.bias, *ln2)


class TransformerEncoderLM(nn.Module):
    def __init__(self, cfg: EncoderConfig, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = Embed(cfg.max_position_embeddings, cfg.hidden_size)
        if cfg.type_vocab_size > 0:
            self.token_type_embeddings = Embed(cfg.type_vocab_size, cfg.hidden_size)
        self.embeddings_norm = LayerNorm(cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, compute_dtype))
        # the keep masks of a non-deterministic pass given no generator
        self.dropout_seed = 0
        self._dropout_generator = None

    def _dropout_rng(self, deterministic: bool, generator: Optional[torch.Generator],
                     device: torch.device) -> Optional[torch.Generator]:
        """The generator a pass draws its keep masks from, or None where it
        applies no dropout (deterministic, or rate 0)."""
        if deterministic or self.cfg.dropout <= 0:
            return None
        if generator is not None:
            return generator
        g = self._dropout_generator
        if g is None or g.device != torch.device(device):
            g = self._dropout_generator = torch.Generator(device=device).manual_seed(self.dropout_seed)
        return g

    def embed(self, ids: torch.Tensor, type_ids: Optional[torch.Tensor] = None, skip_position: bool = False,
              position_offset: int = 0, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """word (+ position, + type) embeddings → LayerNorm → dropout (a
        non-deterministic pass, on every path). ``position_offset`` shifts
        the position ids (PreTTR's document tower starts at the query
        length); ``skip_position`` leaves the position embeddings out."""
        cfg = self.cfg
        x = self.word_embeddings(ids)
        if not skip_position:
            positions = torch.arange(ids.shape[1], device=ids.device) + position_offset
            x = x + self.position_embeddings(positions)[None]
        if cfg.type_vocab_size > 0:
            if type_ids is None:
                type_ids = torch.zeros_like(ids)
            x = x + self.token_type_embeddings(type_ids)
        ln_dtype = self.compute_dtype if cfg.norms_in_compute_dtype else None
        x = self.embeddings_norm(x, cfg.layer_norm_eps, ln_dtype)
        g = self._dropout_rng(deterministic, generator, ids.device)
        return x if g is None else dropout(x, cfg.dropout, g)

    def encode_layers(self, x: torch.Tensor, mask: torch.Tensor, start: int, end: int, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Layers [start, end) on embedded inputs x (B, L, H); mask (B, L), >0
        = real token; f32 out. Each layer runs as in a full pass (the fused
        halves where configured), so PreTTR's towers and its join take the
        same kernels."""
        g = self._dropout_rng(deterministic, generator, x.device)
        if g is not None and self.cfg.fused_attention:
            _warn_fused_dropout_noop()
        key_mask = (mask > 0).float()
        x = x.to(self.compute_dtype).contiguous()
        for i in range(start, end):
            x = getattr(self, f"layer_{i}")(x, key_mask, g)
        return x.float()

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True, num_layers: Optional[int] = None, skip_position: bool = False,
                position_offset: int = 0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Final hidden states (B, L, H), f32; mask (B, L), >0 = real token;
        ``num_layers`` runs only the first N layers. ``deterministic=False``
        applies dropout as the flax modules do (the fused layers apply none
        and warn once), its keep masks drawn from ``generator`` (default: the
        module's own)."""
        g = self._dropout_rng(deterministic, generator, ids.device)
        x = self.embed(ids, type_ids, skip_position, position_offset, deterministic, g)
        return self.encode_layers(x, mask, 0, self.cfg.num_layers if num_layers is None else num_layers,
                                  deterministic, g)
