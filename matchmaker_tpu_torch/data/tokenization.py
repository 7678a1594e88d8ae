"""Tokenizer factory of the port: counterpart of
``matchmaker_tpu/data/tokenization.py:build_tokenizer`` for transformer
models.

The tokenizers themselves are the JAX package's (jax-free on import): a
locally available Hugging Face tokenizer, otherwise the offline
``HashBertTokenizer`` sized to the port's encoder vocabulary so ids stay in
range.
"""

from __future__ import annotations

from matchmaker_tpu.data.tokenization import HashBertTokenizer, HuggingfaceTokenizer

from matchmaker_tpu_torch.models.encoder import encoder_config_from_model_name


def build_tokenizer(config):
    kind = config.get("token_embedder_type", "huggingface_bpe")
    if kind == "embedding":
        raise NotImplementedError("vocabulary-embedding models are not ported yet (ROADMAP.md)")
    name = config.get("bert_pretrained_model", "distilbert-base-uncased")
    try:
        return HuggingfaceTokenizer(name)
    except (ImportError, OSError, ValueError):
        # zero-egress fallback, as in the JAX package
        return HashBertTokenizer(encoder_config_from_model_name(config).vocab_size)
