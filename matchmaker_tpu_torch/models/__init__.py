"""Model factory: counterpart of ``matchmaker_tpu/models/__init__.py``.

The BERT_DOT family and ColBERT are ported; every other model raises
``NotImplementedError`` (the queue is in ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.bert_dot import BertDot, BertDotDualEncoder
from matchmaker_tpu_torch.models.colbert import ColBert
from matchmaker_tpu_torch.models.weights import init_parameters

_REGISTRY = {
    "bert_dot": BertDot,
    "bert_dot_dualencoder": BertDotDualEncoder,
    "colbert": ColBert,
}


def model_base_name(name: str) -> str:
    """Strip adapter prefixes: ``maxP->bert_dot`` → ``bert_dot``."""
    return name.split("->")[-1].strip().lower()


def get_model(config, tokenizer) -> nn.Module:
    """The model module named by ``config['model']``, parameters uninitialised."""
    name = model_base_name(config["model"])
    if "->" in config["model"] or name not in _REGISTRY:
        raise NotImplementedError(f"model {config['model']!r} is not ported yet (ROADMAP.md)")
    if config.get("token_embedder_type") in ("embedding", "bert_embedding", "bert_vectors"):
        raise NotImplementedError(
            f"token_embedder_type {config['token_embedder_type']!r} is not ported yet (ROADMAP.md)")
    model = _REGISTRY[name].from_config(config)
    vocab = model.encoder_cfg.vocab_size
    if tokenizer.vocab_size > vocab:
        raise ValueError(f"tokenizer vocabulary {tokenizer.vocab_size} exceeds the encoder's {vocab}")
    return model


def _hf_checkpoint_available(name: str) -> bool:
    if os.path.isdir(name):
        return True
    try:
        from transformers import AutoConfig

        AutoConfig.from_pretrained(name, local_files_only=True)
        return True
    except (ImportError, OSError, ValueError):
        return False


def init_params(model: nn.Module, config, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill the model's parameters with the JAX package's initialisers from
    ``generator``; returns its state_dict. A locally available Hugging Face
    checkpoint (which the JAX package would load) is refused: its import is
    not ported yet, and the port never silently serves other weights."""
    name = str(config.get("bert_pretrained_model", ""))
    if name and _hf_checkpoint_available(name):
        raise NotImplementedError(
            f"loading the Hugging Face checkpoint {name!r} is not ported yet (ROADMAP.md)")
    init_parameters(model, generator)
    return model.state_dict()
