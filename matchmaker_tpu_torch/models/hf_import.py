"""Hugging Face checkpoint import: counterpart of
``matchmaker_tpu/models/hf_import.py``, without ``transformers``.

A local checkpoint directory of the BERT or DistilBERT family is read as it
lies: ``config.json`` with ``json`` (the :class:`EncoderConfig`, as the JAX
package's ``load_hf_encoder_config`` builds it), the weights from
``model.safetensors`` (parsed here: an 8-byte little-endian header length, a
JSON header of dtype / shape / byte offsets, then the raw buffer) or else
from ``pytorch_model.bin`` (``torch.load(..., weights_only=True)``). The
base-model prefix (``distilbert.``, ``bert.``) is stripped, and the tensors
are mapped onto the port's encoder state dict (models/encoder.py), as
``hf_state_dict_to_encoder_params`` maps them onto the flax tree: every
kernel (in, out), the attention projections 2-D (models/weights.py).

Nothing is downloaded. A hub name resolves only to a snapshot already in the
local Hugging Face cache (``HF_HUB_CACHE``, ``HF_HOME/hub`` or
``~/.cache/huggingface/hub``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

from matchmaker_tpu_torch.models.encoder import EncoderConfig

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_BASE_PREFIXES = ("distilbert.", "bert.")

# the transformers config classes' defaults, for keys a config.json leaves out
_DISTILBERT_DEFAULTS = dict(vocab_size=30522, dim=768, n_layers=6, n_heads=12, hidden_dim=3072,
                            max_position_embeddings=512, dropout=0.1)
_BERT_DEFAULTS = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                      intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
                      layer_norm_eps=1e-12, hidden_dropout_prob=0.1)


def _hub_cache_roots():
    if os.environ.get("HF_HUB_CACHE"):
        yield os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        yield os.path.join(os.environ["HF_HOME"], "hub")
    yield os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def resolve_checkpoint_dir(path_or_name: str) -> Optional[str]:
    """The local directory of a checkpoint: the path itself when it is a
    directory, else the snapshot of a hub name already in the local cache
    (the one ``refs/main`` names, else any holding a ``config.json``); None
    when there is none."""
    if not path_or_name:
        return None
    if os.path.isdir(path_or_name):
        return path_or_name
    if os.path.isabs(path_or_name) or path_or_name.count("/") > 1:
        return None
    for root in _hub_cache_roots():
        repo = os.path.join(root, "models--" + path_or_name.replace("/", "--"))
        snapshots = os.path.join(repo, "snapshots")
        if not os.path.isdir(snapshots):
            continue
        candidates = sorted(os.listdir(snapshots))
        ref = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref):
            with open(ref, encoding="utf-8") as f:
                candidates.insert(0, f.read().strip())
        for snap in candidates:
            if os.path.isfile(os.path.join(snapshots, snap, "config.json")):
                return os.path.join(snapshots, snap)
    return None


def encoder_checkpoint_available(path_or_name: str) -> bool:
    """True if a checkpoint can be read without network access."""
    return resolve_checkpoint_dir(path_or_name) is not None


def _read_config_json(path: str) -> dict:
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        return json.load(f)


def load_hf_encoder_config(path_or_name: str) -> EncoderConfig:
    """The :class:`EncoderConfig` of a checkpoint's ``config.json``."""
    path = resolve_checkpoint_dir(path_or_name)
    if path is None:
        raise FileNotFoundError(f"no local Hugging Face checkpoint {path_or_name!r}")
    hf = _read_config_json(path)
    if hf.get("model_type", "bert") == "distilbert":
        hf = {**_DISTILBERT_DEFAULTS, **hf}
        return EncoderConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["dim"], num_layers=hf["n_layers"],
            num_heads=hf["n_heads"], intermediate_size=hf["hidden_dim"],
            max_position_embeddings=hf["max_position_embeddings"], type_vocab_size=0, dropout=hf["dropout"])
    hf = {**_BERT_DEFAULTS, **hf}
    return EncoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"], intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"], type_vocab_size=hf["type_vocab_size"],
        layer_norm_eps=hf["layer_norm_eps"], dropout=hf["hidden_dropout_prob"])


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as stored (dtype and bits)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode("utf-8"))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                         offset=begin).reshape(shape).clone()
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` as a ``.safetensors`` file (the format
    :func:`read_safetensors` parses)."""
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, chunks, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def read_checkpoint_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint directory's weights by Hugging Face name: from
    ``model.safetensors`` when it exists (as ``transformers`` prefers it),
    else ``pytorch_model.bin``; base-model prefix stripped, the old
    LayerNorm names ``gamma`` / ``beta`` read as ``weight`` / ``bias``."""
    st, bin_ = os.path.join(path, "model.safetensors"), os.path.join(path, "pytorch_model.bin")
    if os.path.isfile(st):
        sd = read_safetensors(st)
    elif os.path.isfile(bin_):
        sd = torch.load(bin_, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{path}: neither model.safetensors nor pytorch_model.bin")
    out = {}
    for key, value in sd.items():
        for prefix in _BASE_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.endswith(".gamma"):
            key = key[: -len(".gamma")] + ".weight"
        elif key.endswith(".beta"):
            key = key[: -len(".beta")] + ".bias"
        out[key] = value
    return out


def hf_state_dict_to_encoder_state(sd: Dict[str, torch.Tensor], cfg: EncoderConfig,
                                   model_type: str) -> Dict[str, torch.Tensor]:
    """Hugging Face names → the port's ``TransformerEncoderLM`` state dict
    (f32; Linear weights (out, in) transposed to kernels (in, out))."""
    def f32(key):
        return sd[key].to(torch.float32)

    def dense(w_key, b_key):
        return {"kernel": f32(w_key).t().contiguous(), "bias": f32(b_key)}

    def norm(prefix):
        return {"scale": f32(f"{prefix}.weight"), "bias": f32(f"{prefix}.bias")}

    if model_type == "distilbert":
        layer_names = dict(layer="transformer.layer.{i}", query="attention.q_lin", key="attention.k_lin",
                           value="attention.v_lin", out="attention.out_lin", attention_norm="sa_layer_norm",
                           mlp_in="ffn.lin1", mlp_out="ffn.lin2", mlp_norm="output_layer_norm")
    else:
        layer_names = dict(layer="encoder.layer.{i}", query="attention.self.query", key="attention.self.key",
                           value="attention.self.value", out="attention.output.dense",
                           attention_norm="attention.output.LayerNorm", mlp_in="intermediate.dense",
                           mlp_out="output.dense", mlp_norm="output.LayerNorm")
    tree = {
        "word_embeddings": {"embedding": f32("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": f32("embeddings.position_embeddings.weight")},
        "embeddings_norm": norm("embeddings.LayerNorm"),
    }
    if model_type != "distilbert" and cfg.type_vocab_size > 0:
        tree["token_type_embeddings"] = {"embedding": f32("embeddings.token_type_embeddings.weight")}
    for i in range(cfg.num_layers):
        pre = layer_names["layer"].format(i=i)

        def lin(part):
            return dense(f"{pre}.{layer_names[part]}.weight", f"{pre}.{layer_names[part]}.bias")

        tree[f"layer_{i}"] = {
            "attention": {p: lin(p) for p in ("query", "key", "value", "out")},
            "attention_norm": norm(f"{pre}.{layer_names['attention_norm']}"),
            "mlp_in": lin("mlp_in"), "mlp_out": lin("mlp_out"),
            "mlp_norm": norm(f"{pre}.{layer_names['mlp_norm']}"),
        }
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = v

    walk(tree, "")
    return flat


def load_hf_encoder(path_or_name: str) -> Tuple[EncoderConfig, Dict[str, torch.Tensor]]:
    """(EncoderConfig, the encoder's state dict) from a local checkpoint."""
    path = resolve_checkpoint_dir(path_or_name)
    if path is None:
        raise FileNotFoundError(f"no local Hugging Face checkpoint {path_or_name!r}")
    cfg = load_hf_encoder_config(path)
    model_type = _read_config_json(path).get("model_type", "bert")
    return cfg, hf_state_dict_to_encoder_state(read_checkpoint_state_dict(path), cfg, model_type)


def save_hf_checkpoint(path: str, config: dict, state_dict: Dict[str, torch.Tensor], safetensors: bool) -> None:
    """A checkpoint directory as ``save_pretrained`` lays it out:
    ``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``
    (``state_dict`` keyed by Hugging Face names)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2)
    if safetensors:
        write_safetensors(os.path.join(path, "model.safetensors"), state_dict)
    else:
        torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))


def seeded_distilbert_checkpoint(cfg: EncoderConfig, seed: int) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """(config.json dict, state dict by Hugging Face names) of a DistilBERT
    of ``cfg``'s size with weights drawn from ``seed`` (normal(0, 0.02),
    LayerNorms one and zero), for tests and smoke runs without a download."""
    g = torch.Generator().manual_seed(seed)
    hid, ff = cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"embeddings.word_embeddings.weight": normal(cfg.vocab_size, hid),
          "embeddings.position_embeddings.weight": normal(cfg.max_position_embeddings, hid),
          "embeddings.LayerNorm.weight": torch.ones(hid), "embeddings.LayerNorm.bias": torch.zeros(hid)}
    for i in range(cfg.num_layers):
        pre = f"transformer.layer.{i}"
        for name, (o, n) in (("attention.q_lin", (hid, hid)), ("attention.k_lin", (hid, hid)),
                             ("attention.v_lin", (hid, hid)), ("attention.out_lin", (hid, hid)),
                             ("ffn.lin1", (ff, hid)), ("ffn.lin2", (hid, ff))):
            sd[f"{pre}.{name}.weight"] = normal(o, n)
            sd[f"{pre}.{name}.bias"] = normal(o)
        for name in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{pre}.{name}.weight"] = 1.0 + normal(hid)
            sd[f"{pre}.{name}.bias"] = normal(hid)
    config = {"model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": cfg.vocab_size,
              "dim": hid, "n_layers": cfg.num_layers, "n_heads": cfg.num_heads, "hidden_dim": ff,
              "max_position_embeddings": cfg.max_position_embeddings, "dropout": 0.0,
              "attention_dropout": 0.0, "activation": "gelu", "sinusoidal_pos_embds": False}
    return config, {k: v.contiguous() for k, v in sd.items()}
