"""Parameters of the port's models: initialisation, the JAX package's param
tree → ``state_dict``, and ``.npz`` files.

The port names each parameter after its flax path with ``.`` for ``/``
(``encoder/layer_0/attention/query/kernel`` →
``encoder.layer_0.attention.query.kernel``). The attention projections are
stored 2-D, with the reshapes of ``matchmaker_tpu/models/encoder.py``
(FusedMHABlock): query/key/value kernels (hid, h, d) → (hid, hid), their
biases (h, d) → (hid,), the out kernel (h, d, hid) → (hid, hid). The
``self_attention`` projections of modules/transformer.py (flax
``MultiHeadDotProductAttention``'s ``DenseGeneral`` kernels, PARADE's
aggregator) are stored as ``F.linear`` reads them, (out, in): query/key/value
(D, h, d) → (h·d, D), out (h, d, D) → (D, h·d), biases flattened. Every
other parameter keeps its flax shape: ColBERT's ``compressor`` kernel (hid,
dim) and bias, the re-rankers' ``score_layer`` / ``score_reduction`` kernels
(hid, 1), PARADE's ``agg_cls`` (1, 1, hid), the MLM head's ``mlm_transform``
/ ``mlm_norm`` and its top-level vocabulary bias ``mlm_bias``
(``modules/mlm_head.py``). A flax ``nn.Conv`` kernel (n, in, out) is
stored (out, in, n), as ``nn.Conv1d`` stores its weight (Conv-KNRM's
``conv_{n}gram``, IDCM's ``sample_cnn3``, Duet's VALID ``dist_q_conv`` /
``dist_d_conv``: modules/conv.py); a 2-D one keeps flax's (kh, kw, in, out)
(PACRR's ``conv_{n}``, MatchPyramid's ``conv_{i}``), as do the classic
models' Dense kernels (in, out). The kernel-pooling
family's scalars and rows (``mixer``, ``mixer_stop``,
``kernel_alpha_scaler``, ``kernel_mult``, ``chunk_scoring``,
``top_k_scoring``), the token table
(``embedder/token_embedding/embedding``) and the uncertainty weighting's
``mtl_log_vars`` (3,) at the top level of a QA-trained model keep their
flax shapes. A chunk adapter's inner model sits under ``inner``, a
``bert_vectors`` adapter's under ``inner`` beside its ``encoder``. A
``.npz`` holds the port's arrays keyed by the flax path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# flax's truncated-normal variance scaling divides by this (std of a unit
# normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978
# the JAX modules' own initialisers, by the parameter's last two path parts
# (or its name): U(lo, hi) kernels of the kernel-pooling heads and of
# Duet's combination layers, the constants of the learned scalars and rows,
# TK-Sparse's gate bias 1, the uncertainty weighting's log-variances 0, the
# token table's normal(0.1)
_UNIFORM = {"kernel_weights.kernel": (-0.014, 0.014), "kernel_bin_weights.kernel": (-0.014, 0.014),
            "sampling_binweights.kernel": (-0.01, 0.01), "comb_fc1.kernel": (0.0, 0.01),
            "comb_fc2.kernel": (0.0, 0.01), "comb_out.kernel": (0.0, 0.01)}
_CONSTANT = {"mixer": 0.5, "mixer_stop": 0.5, "kernel_alpha_scaler": 1.0, "kernel_mult": 1.0, "chunk_scoring": 1.0,
             "top_k_scoring": 1.0, "stop_word_reducer2.bias": 1.0, "mtl_log_vars": 0.0}


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested param dict → {"a/b/c": array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _port_shape(path: str, arr: np.ndarray) -> np.ndarray:
    parts = path.split("/")
    if len(parts) >= 3 and parts[-3] == "self_attention":
        proj, leaf = parts[-2], parts[-1]
        if leaf == "bias":
            return arr.reshape(-1)
        if proj == "out":  # (h, d, D) → (D, h·d)
            return arr.reshape(-1, arr.shape[-1]).T
        return arr.reshape(arr.shape[0], -1).T  # (D, h, d) → (h·d, D)
    if len(parts) >= 3 and parts[-3] == "attention":
        proj, leaf = parts[-2], parts[-1]
        if proj == "out" and leaf == "kernel" and arr.ndim == 3:  # (h, d, hid)
            return arr.reshape(-1, arr.shape[-1])
        if proj in ("query", "key", "value"):
            if leaf == "kernel" and arr.ndim == 3:  # (hid, h, d)
                return arr.reshape(arr.shape[0], -1)
            if leaf == "bias" and arr.ndim == 2:  # (h, d)
                return arr.reshape(-1)
    if parts[-1] == "kernel" and arr.ndim == 3:  # a Conv's (n, in, out)
        return arr.transpose(2, 1, 0)
    return arr


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree (arrays or numpy) → the port's state_dict."""
    return {
        path.replace("/", "."): torch.from_numpy(np.array(_port_shape(path, arr), dtype=np.float32))
        for path, arr in flatten_params(params).items()
    }


def _flax_shape(path: str, arr: np.ndarray, heads: Dict[str, int]) -> np.ndarray:
    """Undo :func:`_port_shape`: ``heads`` maps the path of each attention
    module (an encoder layer's ``attention``, a ``self_attention``) to its
    head count, which the 2-D port shapes no longer carry."""
    parts = path.split("/")
    owner = "/".join(parts[:-2])
    if len(parts) >= 3 and parts[-3] in ("attention", "self_attention") and owner in heads:
        h, (proj, leaf) = heads[owner], parts[-2:]
        if parts[-3] == "self_attention":
            if leaf == "bias":
                return arr if proj == "out" else arr.reshape(h, -1)
            if proj == "out":  # (D, h·d) → (h, d, D)
                return arr.T.reshape(h, -1, arr.shape[0])
            return arr.T.reshape(arr.shape[1], h, -1)  # (h·d, D) → (D, h, d)
        if proj == "out":
            return arr.reshape(h, -1, arr.shape[-1]) if leaf == "kernel" else arr
        return arr.reshape(arr.shape[0], h, -1) if leaf == "kernel" else arr.reshape(h, -1)
    if parts[-1] == "kernel" and arr.ndim == 3:  # a Conv's (out, in, n) → (n, in, out)
        return arr.transpose(2, 1, 0)
    return arr


def state_dict_to_flax(model: nn.Module) -> Dict:
    """The inverse of :func:`flax_to_state_dict`: the model's parameters as
    the JAX package's nested param tree of f32 numpy arrays, at flax's
    shapes (the attention kernels 3-D, the convolutions (n, in, out)), keys
    sorted at every level as ``jax.device_get`` leaves a param tree."""
    from matchmaker_tpu_torch.models.encoder import EncoderLayer
    from matchmaker_tpu_torch.modules.transformer import SelfAttention

    heads = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, EncoderLayer):
            heads[f"{path}/attention" if path else "attention"] = module.cfg.num_heads
        elif isinstance(module, SelfAttention):
            heads[path] = module.num_heads
    tree: Dict = {}
    for key, value in model.state_dict().items():
        path = key.replace(".", "/")
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(_flax_shape(path, value.detach().cpu().float().numpy(), heads))

    def ordered(node):
        return {k: ordered(node[k]) for k in sorted(node)} if isinstance(node, dict) else node

    return ordered(tree)


def save_npz(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    np.savez(path, **{k.replace(".", "/"): v.detach().cpu().float().numpy() for k, v in state_dict.items()})


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k.replace("/", "."): torch.from_numpy(np.array(data[k])) for k in data.files}


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialiser distributions, drawn from ``generator``:
    kernels lecun-normal (truncated normal, std sqrt(1/fan_in)/0.8796,
    cut at ±2 std; fan_in the input width, rows of an (in, out) kernel,
    columns of an (out, in) ``self_attention`` one, in x n of an (out, in, n)
    convolution, kh x kw x in of a (kh, kw, in, out) one), embeddings normal with std sqrt(1/features), PARADE's
    ``agg_cls`` normal with std 0.02, biases zero, LayerNorm scales one; the
    kernel-pooling family's own (``_UNIFORM``, ``_CONSTANT``, the token
    table normal(0.1)), then a ``TokenEmbedder``'s ``pretrained`` matrix
    (GloVe) copied into its table."""
    from matchmaker_tpu_torch.modules.embedder import TokenEmbedder

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        last_two = ".".join(name.split(".")[-2:])
        if last_two in _UNIFORM:
            p.uniform_(*_UNIFORM[last_two], generator=generator)
        elif leaf in _CONSTANT or last_two in _CONSTANT:
            p.fill_(_CONSTANT.get(last_two, _CONSTANT.get(leaf)))
        elif last_two == "token_embedding.embedding":
            p.normal_(0.0, 0.1, generator=generator)
        elif leaf == "kernel" and p.dim() in (3, 4):  # a convolution's (out, in, n) or (kh, kw, in, out)
            fan_in = p.shape[1] * p.shape[2] if p.dim() == 3 else p.shape[0] * p.shape[1] * p.shape[2]
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        elif leaf == "kernel":
            fan_in = p.shape[1] if ".self_attention." in name else p.shape[0]
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        elif leaf == "embedding":
            p.normal_(0.0, (1.0 / p.shape[1]) ** 0.5, generator=generator)
        elif leaf == "agg_cls":
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias" or leaf.endswith("_bias"):  # mlm_bias: the MLM head's vocabulary bias
            p.zero_()
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    for module in model.modules():
        if isinstance(module, TokenEmbedder) and module.pretrained is not None:
            module.token_embedding.embedding.copy_(torch.from_numpy(module.pretrained))
