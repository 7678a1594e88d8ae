"""Model factory: counterpart of ``matchmaker_tpu/models/__init__.py``.

Every model of the JAX package is ported: the BERT_DOT family, ColBERT,
the transformer re-rankers (BERT_CAT with its QA heads, PreTTR, PARADE),
the kernel-pooling family (KNRM, Conv-KNRM, TK, TKL, TK-Sparse), IDCM, the
classic interaction models (PACRR, CO-PACRR, DRMM, MatchPyramid, Duet), the
``maxP->`` / ``meanP->`` chunk adapters around any of them, and the token
embedders. The vocabulary models take ``token_embedder_type: embedding``
with an optional text-format ``pre_trained_embedding`` file (GloVe's
format, ``load_glove_embeddings``); ``bert_embedding``, a local Hugging Face
checkpoint's word-embedding table as their (trainable) table, its width as
``token_embedding_size`` (the upstream embedder's behaviour; the JAX
factory raises "Model not known" there, ROADMAP.md §3); ``bert_vectors``,
a transformer's contextual vectors in place of the table for a model with
``score_embeddings`` (models/bert_vectors.py). A local Hugging Face
checkpoint named by ``bert_pretrained_model`` is imported into every
encoder of the model (models/hf_import.py). With ``train_qa_spans`` and
``qa_uncertainty_weighting`` (default on) the model carries the
uncertainty weighting's learned log-variances ``mtl_log_vars`` (3,) at its
top level, where the JAX trainer puts them in the param tree: the
optimizer trains them, the snapshots keep them, and a run folder's config
rebuilds them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from matchmaker_tpu_torch.models.adapters import ChunkPoolAdapter
from matchmaker_tpu_torch.models.bert_cat import BertCat
from matchmaker_tpu_torch.models.bert_dot import BertDot, BertDotDualEncoder
from matchmaker_tpu_torch.models.bert_vectors import ContextualVectorsAdapter
from matchmaker_tpu_torch.models.colbert import ColBert
from matchmaker_tpu_torch.models.conv_knrm import ConvKNRM
from matchmaker_tpu_torch.models.drmm import DRMM
from matchmaker_tpu_torch.models.duet import Duet
from matchmaker_tpu_torch.models.encoder import encoder_config_from_model_name
from matchmaker_tpu_torch.models.hf_import import encoder_checkpoint_available, load_hf_encoder
from matchmaker_tpu_torch.models.idcm import IDCM, IDCMInferenceOnly
from matchmaker_tpu_torch.models.knrm import KNRM
from matchmaker_tpu_torch.models.matchpyramid import MatchPyramid
from matchmaker_tpu_torch.models.pacrr import PACRR, CoPACRR
from matchmaker_tpu_torch.models.parade import Parade
from matchmaker_tpu_torch.models.prettr import PreTTR
from matchmaker_tpu_torch.models.tk import TK
from matchmaker_tpu_torch.models.tk_sparse import TKSparse
from matchmaker_tpu_torch.models.tkl import TKL
from matchmaker_tpu_torch.models.weights import init_parameters

_REGISTRY = {
    "bert_cat": BertCat,
    "bert_dot": BertDot,
    "bert_dot_dualencoder": BertDotDualEncoder,
    "colbert": ColBert,
    "parade": Parade,
    "prettr": PreTTR,
    "idcm": IDCM,
    "idcm_inference_only": IDCMInferenceOnly,
    "knrm": KNRM,
    "conv_knrm": ConvKNRM,
    "tk": TK,
    "tkl": TKL,
    "tk_sparse": TKSparse,
    "pacrr": PACRR,
    "co_pacrr": CoPACRR,
    "drmm": DRMM,
    "matchpyramid": MatchPyramid,
    "duet": Duet,
}
_ENCODER_SLOTS = ("encoder", "query_encoder", "doc_encoder")


def model_base_name(name: str) -> str:
    """Strip adapter prefixes: ``maxP->bert_dot`` → ``bert_dot``."""
    return name.split("->")[-1].strip().lower()


def load_glove_embeddings(path: str, vocab, dim: int) -> np.ndarray:
    """Text-format embedding file (``token v1 v2 ...``) → (vocab, dim) matrix.
    Unseen tokens get small random vectors; PAD row stays zero."""
    rng = np.random.default_rng(42)
    mat = rng.normal(0.0, 0.1, size=(len(vocab), dim)).astype(np.float32)
    mat[0] = 0.0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) != dim + 1:
                continue
            tok = parts[0]
            if tok in vocab.token_to_id:
                mat[vocab.token_to_id[tok]] = np.asarray(parts[1:], dtype=np.float32)
    return mat


def get_model(config, tokenizer) -> nn.Module:
    """The model module named by ``config['model']``, parameters uninitialised."""
    name = model_base_name(config["model"])
    wrapper = config["model"].split("->")[0].strip().lower() if "->" in config["model"] else None
    if name not in _REGISTRY:
        raise ValueError(f"Model not known: {config['model']}")
    if wrapper not in (None, "maxp", "meanp"):
        raise ValueError(f"unknown model adapter {wrapper!r} in {config['model']!r}")
    # as in the JAX package: the vocabulary models size their token table by
    # ``_vocab_size``; the encoder models ignore it and ``pretrained``
    cfg = dict(config, _vocab_size=tokenizer.vocab_size)
    if wrapper is not None:  # the inner model sees chunks (Duet's widths follow their length)
        cfg["_inner_doc_length"] = config.get("idcm_chunk_size", 50) + 2 * config.get("idcm_overlap", 7)
    embedder = config.get("token_embedder_type")
    pretrained = None
    if embedder == "embedding" and config.get("pre_trained_embedding"):
        pretrained = load_glove_embeddings(config["pre_trained_embedding"], tokenizer.vocab,
                                           config.get("token_embedding_size", 300))
    elif embedder == "bert_embedding":
        # a checkpoint's word-embedding table as the model's table
        # (upstream modules/bert_embedding_token_embedder.py)
        checkpoint = str(config.get("bert_pretrained_model", ""))
        if checkpoint and encoder_checkpoint_available(checkpoint):
            pretrained = load_hf_encoder(checkpoint)[1]["word_embeddings.embedding"].numpy()
            cfg["token_embedding_size"] = pretrained.shape[1]
    if embedder == "bert_vectors":
        cfg.update(_external_embedding=True, token_embedding_size=encoder_config_from_model_name(config).hidden_size)
        model = ContextualVectorsAdapter.from_config(cfg, _REGISTRY[name].from_config(cfg, pretrained))
    else:
        model = _REGISTRY[name].from_config(cfg, pretrained)
    encoder_cfg = getattr(model, "encoder_cfg", None)
    if encoder_cfg is not None and tokenizer.vocab_size > encoder_cfg.vocab_size:
        raise ValueError(f"tokenizer vocabulary {tokenizer.vocab_size} exceeds the encoder's {encoder_cfg.vocab_size}")
    if wrapper is not None:
        model = ChunkPoolAdapter.from_config(config, model, pool=wrapper[:-1])
    if config.get("train_qa_spans", False) and config.get("qa_uncertainty_weighting", True):
        # [ranking, qa span, answerability] (the JAX trainer's params["mtl_log_vars"])
        model.register_parameter("mtl_log_vars", nn.Parameter(torch.zeros(3)))
    return model


@torch.no_grad()
def init_params(model: nn.Module, config, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill the model's parameters with the JAX package's initialisers from
    ``generator``; where ``bert_pretrained_model`` names a locally available
    Hugging Face checkpoint, every encoder (``encoder``, ``query_encoder``,
    ``doc_encoder``, also inside a chunk adapter's ``inner``) takes its
    tensors instead. Returns the model's state_dict."""
    init_parameters(model, generator)
    name = str(config.get("bert_pretrained_model", ""))
    if config.get("token_embedder_type") != "embedding" and name and encoder_checkpoint_available(name):
        _, enc = load_hf_encoder(name)
        state = model.state_dict()
        graft = {}
        for key in state:
            parts = key.split(".")
            for i, part in enumerate(parts[:-1]):
                if part in _ENCODER_SLOTS:
                    rest = ".".join(parts[i + 1:])
                    if rest not in enc or tuple(enc[rest].shape) != tuple(state[key].shape):
                        raise ValueError(f"the checkpoint {name!r} holds no encoder tensor {rest!r} of shape "
                                         f"{tuple(state[key].shape)}")
                    graft[key] = enc[rest]
                    break
        model.load_state_dict(graft, strict=False)
    return model.state_dict()


def example_batch(config, batch_size: int = 2) -> Dict[str, np.ndarray]:
    """Zero batch with the model input's keys and shapes."""
    max_q = config.get("max_query_length", 30)
    max_d = config.get("max_doc_length", 200)
    if config.get("model_input_type") == "concatenated":
        length = max_q + max_d
        return {
            "seq_ids": np.zeros((batch_size, length), np.int32),
            "seq_mask": np.ones((batch_size, length), np.float32),
            "seq_type_ids": np.zeros((batch_size, length), np.int32),
        }
    return {
        "query_ids": np.zeros((batch_size, max_q), np.int32),
        "query_mask": np.ones((batch_size, max_q), np.float32),
        "doc_ids": np.zeros((batch_size, max_d), np.int32),
        "doc_mask": np.ones((batch_size, max_d), np.float32),
    }
