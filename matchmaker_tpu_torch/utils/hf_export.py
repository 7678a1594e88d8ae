"""Export a trained encoder as a Hugging Face checkpoint folder: counterpart
of ``matchmaker_tpu/utils/hf_export.py``, without ``transformers``.

The inverse of models/hf_import.py. The model's first encoder tower
(``encoder``, else ``query_encoder``) goes out under Hugging Face's
DistilBERT or BERT names, each Linear weight (out, in) the transpose of the
port's kernel (in, out), every tensor f32, in ``model.safetensors``
(models/hf_import.py:write_safetensors) beside a ``config.json`` of the
architecture's fields (what ``save_pretrained`` writes and
``load_hf_encoder_config`` reads). As the JAX export does, the other
top-level parameters (the score or compression heads) go to
``head_weights.npz`` under their flax paths, in the port's snapshot layout
(models/weights.py, the flax shapes for Dense heads), and
``export-info.json`` lists the Hugging Face model's tensors the folder does
not hold (``missing_keys``: BERT's pooler, or token types for an encoder
without them), which ``transformers`` initialises afresh on loading.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Union

import numpy as np
import torch

from matchmaker_tpu_torch.models.encoder import EncoderConfig
from matchmaker_tpu_torch.models.hf_import import write_safetensors

_TOWERS = ("encoder", "query_encoder", "doc_encoder")
# Hugging Face layer names of (query, key, value, out, attention_norm, mlp_in, mlp_out, mlp_norm)
_LAYER_NAMES = {
    "distilbert": ("transformer.layer.{i}", "attention.q_lin", "attention.k_lin", "attention.v_lin",
                   "attention.out_lin", "sa_layer_norm", "ffn.lin1", "ffn.lin2", "output_layer_norm"),
    "bert": ("encoder.layer.{i}", "attention.self.query", "attention.self.key", "attention.self.value",
             "attention.output.dense", "attention.output.LayerNorm", "intermediate.dense", "output.dense",
             "output.LayerNorm"),
}


def encoder_state_to_hf_state_dict(enc: Mapping[str, torch.Tensor], cfg: EncoderConfig,
                                   model_type: str) -> Dict[str, torch.Tensor]:
    """The port's ``TransformerEncoderLM`` state dict (keys without the tower
    prefix) → f32 tensors under Hugging Face names."""
    def f32(key):
        return enc[key].detach().cpu().float().contiguous()

    layer, *parts = _LAYER_NAMES["distilbert" if model_type == "distilbert" else "bert"]
    sd = {"embeddings.word_embeddings.weight": f32("word_embeddings.embedding"),
          "embeddings.position_embeddings.weight": f32("position_embeddings.embedding")}
    if model_type != "distilbert" and cfg.type_vocab_size > 0:
        sd["embeddings.token_type_embeddings.weight"] = f32("token_type_embeddings.embedding")
    sd["embeddings.LayerNorm.weight"] = f32("embeddings_norm.scale")
    sd["embeddings.LayerNorm.bias"] = f32("embeddings_norm.bias")
    ours = ("attention.query", "attention.key", "attention.value", "attention.out", "attention_norm", "mlp_in",
            "mlp_out", "mlp_norm")
    for i in range(cfg.num_layers):
        pre = layer.format(i=i)
        for port, hf in zip(ours, parts):
            if port.endswith("norm"):
                sd[f"{pre}.{hf}.weight"] = f32(f"layer_{i}.{port}.scale")
            else:
                sd[f"{pre}.{hf}.weight"] = f32(f"layer_{i}.{port}.kernel").t().contiguous()
            sd[f"{pre}.{hf}.bias"] = f32(f"layer_{i}.{port}.bias")
    return sd


def hf_config(cfg: EncoderConfig, model_type: str) -> dict:
    """``config.json`` of a DistilBERT or BERT of ``cfg``'s size."""
    if model_type == "distilbert":
        return {"model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": cfg.vocab_size,
                "dim": cfg.hidden_size, "n_layers": cfg.num_layers, "n_heads": cfg.num_heads,
                "hidden_dim": cfg.intermediate_size, "max_position_embeddings": cfg.max_position_embeddings,
                "dropout": cfg.dropout, "attention_dropout": cfg.dropout, "activation": "gelu",
                "sinusoidal_pos_embds": False, "initializer_range": 0.02, "pad_token_id": 0,
                "torch_dtype": "float32"}
    return {"model_type": "bert", "architectures": ["BertModel"], "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": max(cfg.type_vocab_size, 1), "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": "gelu", "hidden_dropout_prob": cfg.dropout, "attention_probs_dropout_prob": cfg.dropout,
            "initializer_range": 0.02, "pad_token_id": 0, "position_embedding_type": "absolute",
            "torch_dtype": "float32"}


def export_to_huggingface(model: Union[torch.nn.Module, Mapping[str, torch.Tensor]], encoder_cfg: EncoderConfig,
                          out_dir: str, model_type: str = "distilbert") -> str:
    """Write a Hugging Face checkpoint folder from a trained model (or its
    state dict); returns ``out_dir``."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else dict(model)
    tower = next((t for t in ("encoder", "query_encoder") if any(k.startswith(t + ".") for k in state)), None)
    if tower is None:
        raise ValueError("no encoder tower found in the model's parameters")
    enc = {k[len(tower) + 1:]: v for k, v in state.items() if k.startswith(tower + ".")}
    sd = encoder_state_to_hf_state_dict(enc, encoder_cfg, model_type)
    os.makedirs(out_dir, exist_ok=True)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd)
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf_config(encoder_cfg, model_type), f, indent=2)
    missing = []
    if model_type != "distilbert":
        if encoder_cfg.type_vocab_size == 0:
            missing.append("embeddings.token_type_embeddings.weight")
        missing += ["pooler.dense.weight", "pooler.dense.bias"]
    heads = {k.replace(".", "/"): v.detach().cpu().float().numpy() for k, v in state.items()
             if k.split(".", 1)[0] not in _TOWERS}
    if heads:
        np.savez(os.path.join(out_dir, "head_weights.npz"), **heads)
    with open(os.path.join(out_dir, "export-info.json"), "w", encoding="utf-8") as f:
        json.dump({"missing_keys": missing, "unexpected_keys": []}, f)
    return out_dir
