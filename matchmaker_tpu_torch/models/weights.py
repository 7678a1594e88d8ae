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
(``modules/mlm_head.py``). A chunk adapter's inner model sits under
``inner``. A ``.npz`` holds the port's arrays keyed by the flax path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# flax's truncated-normal variance scaling divides by this (std of a unit
# normal truncated to [-2, 2])
_TRUNC_STD = 0.87962566103423978


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
    return arr


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's param tree (arrays or numpy) → the port's state_dict."""
    return {
        path.replace("/", "."): torch.from_numpy(np.array(_port_shape(path, arr), dtype=np.float32))
        for path, arr in flatten_params(params).items()
    }


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
    columns of an (out, in) ``self_attention`` one), embeddings normal with
    std sqrt(1/features), PARADE's ``agg_cls`` normal with std 0.02, biases
    zero, LayerNorm scales one."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
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
