"""MLM masked-sequence batches for encoder pre-training.

Contract: reference dataloaders/mlm_masked_sequence_loader.py:26-256 —
whole-word masking over ``id \t text`` collections (mask decisions are made
per *word* and extended across all of the word's subword tokens,
mlm_masked_sequence_loader.py:143-165), with the BERT recipe (80% → [MASK],
10% → random token, 10% → unchanged) and an optional frequency-biased
sampling mode (``tf`` / ``log-tf``): rarer words are masked more, with the
per-token probability normalized to a mean of ``mask_prob`` and capped at
0.9 (:167-185). Labels = original ids at masked positions, -100 elsewhere.

(The reference's pre-train.py driver is broken — imports a nonexistent module,
SURVEY.md §2.1; this pipeline + cli/pretrain.py is the working equivalent.)

Word boundaries come from character offsets (tokens whose spans touch belong
to one word) so the grouping works for any tokenizer that implements
``encode_with_offsets`` — no dependence on "##" surface conventions.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Dict, Iterator, List, Optional

import numpy as np

from matchmaker_tpu_torch.data.batching import pad_to_batch
from matchmaker_tpu_torch.data.readers import read_id_sequences

IGNORE_LABEL = -100


def word_groups_from_offsets(offsets, text: Optional[str] = None) -> List[List[int]]:
    """Group token positions into whole words via char offsets: a token whose
    span starts exactly where the previous one ended is a continuation
    (wordpiece "##" pieces are contiguous; words are separated by spaces).

    With ``text`` given, a contiguous boundary only continues a word when the
    characters on both sides are alphanumeric and at least one is ASCII — so
    punctuation glued to a word ("hello,") starts its own group and
    per-character tokenizations of unsegmented CJK text don't collapse into
    one giant group (each CJK token is its own word, matching BERT's
    char-level treatment). Known limitation: non-ASCII alphabetic scripts
    (e.g. Cyrillic) split at subword boundaries."""
    groups: List[List[int]] = []
    cur: List[int] = []
    prev_end = None
    for i, off in enumerate(offsets):
        if off is None:  # special token / padding
            if cur:
                groups.append(cur)
                cur = []
            prev_end = None
            continue
        contiguous = prev_end is not None and off[0] == prev_end
        if contiguous and text is not None:
            before = text[prev_end - 1] if prev_end - 1 < len(text) and prev_end > 0 else ""
            after = text[off[0]] if off[0] < len(text) else ""
            contiguous = (
                bool(before) and bool(after)
                and before.isalnum() and after.isalnum()
                and (before.isascii() or after.isascii())
            )
        if contiguous:
            cur.append(i)
        else:
            if cur:
                groups.append(cur)
            cur = [i]
        prev_end = off[1]
    if cur:
        groups.append(cur)
    return groups


def _random_token(rng: random.Random, vocab_size: int) -> int:
    return rng.randrange(1000, vocab_size) if vocab_size > 1000 else rng.randrange(4, vocab_size)


def mask_whole_words(
    ids: np.ndarray,
    mask: np.ndarray,
    offsets,
    rng: random.Random,
    mask_token_id: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    special_ids: Optional[set] = None,
    token_counter: Optional[Counter] = None,
    bias_sampling: str = "none",
    text: Optional[str] = None,
):
    """Whole-word BERT masking; returns (masked_ids, labels).

    One mask decision and one action roll per word; the action applies to every
    subword of the word (reference :143-165). ``bias_sampling`` ∈ {"none",
    "tf", "log-tf"}: with a shared ``token_counter`` (updated here), the mask
    probability per word is ∝ 1/tf (log2 for "log-tf"), mean-normalized to
    ``mask_prob`` and capped at 0.9 (reference :167-185). ``text`` refines
    word boundaries (see word_groups_from_offsets)."""
    special_ids = special_ids or {0, 100, 101, 102, 103}
    masked = ids.copy()
    labels = np.full_like(ids, IGNORE_LABEL)

    groups = [
        g
        for g in word_groups_from_offsets(offsets, text)
        if all(mask[i] > 0 and ids[i] not in special_ids for i in g)
    ]
    if not groups:
        return masked, labels

    if bias_sampling in ("tf", "log-tf") and token_counter is not None:
        # running term frequency over the stream (reference keeps one counter
        # for the whole reader, :137-141)
        for g in groups:
            for i in g:
                token_counter[int(ids[i])] += 1
        tfs = np.array([token_counter[int(ids[g[0]])] for g in groups], dtype=np.float64)
        if bias_sampling == "log-tf":
            tfs = np.log2(np.maximum(tfs, 2.0))
        # probability ∝ 1/tf, mean-normalized to mask_prob, capped at 0.9
        # (the normalization makes any constant prefactor irrelevant)
        prob = 1.0 / tfs
        prob = prob * (mask_prob / max(prob.mean(), 1e-12))
        prob = np.minimum(prob, 0.9)
    else:
        prob = np.full(len(groups), mask_prob)

    for g, p in zip(groups, prob):
        if rng.random() >= p:
            continue
        roll = rng.random()
        for i in g:
            labels[i] = ids[i]
            if roll < 0.8:
                masked[i] = mask_token_id
            elif roll < 0.9:
                masked[i] = _random_token(rng, vocab_size)
    return masked, labels


def mask_tokens(
    ids: np.ndarray,
    mask: np.ndarray,
    rng: random.Random,
    mask_token_id: int,
    vocab_size: int,
    mask_prob: float = 0.15,
    special_ids: Optional[set] = None,
):
    """Per-subword BERT masking (``mlm_mask_whole_words: false``);
    returns (masked_ids, labels)."""
    special_ids = special_ids or {0, 100, 101, 102, 103}
    masked = ids.copy()
    labels = np.full_like(ids, IGNORE_LABEL)
    for i in range(len(ids)):
        if mask[i] == 0 or ids[i] in special_ids:
            continue
        if rng.random() < mask_prob:
            labels[i] = ids[i]
            roll = rng.random()
            if roll < 0.8:
                masked[i] = mask_token_id
            elif roll < 0.9:
                masked[i] = _random_token(rng, vocab_size)
    return masked, labels


def mlm_training_loader(
    config,
    tokenizer,
    path: str,
    batch_size: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    batch_size = batch_size or config.get("batch_size_train", 32)
    max_len = config.get("max_doc_length", 200)
    mask_prob = config.get("mlm_mask_probability", 0.15)
    whole_words = config.get("mlm_mask_whole_words", True)
    bias_sampling = str(config.get("mlm_bias_sampling_method", "none")).lower()
    rng = random.Random(config.get("random_seed", 42))
    mask_id = getattr(tokenizer, "mask_token_id", 103)
    token_counter: Counter = Counter()

    buf = []
    for _sid, text in read_id_sequences(path):
        if whole_words:
            ids, mask, offsets = tokenizer.encode_with_offsets(text, max_len)
            masked, labels = mask_whole_words(
                ids, mask, offsets, rng, mask_id, tokenizer.vocab_size, mask_prob,
                token_counter=token_counter, bias_sampling=bias_sampling,
                text=text,
            )
        else:
            ids, mask = tokenizer.encode(text, max_len)
            masked, labels = mask_tokens(ids, mask, rng, mask_id, tokenizer.vocab_size, mask_prob)
        buf.append({"seq_ids": masked, "seq_mask": mask, "mlm_labels": labels})
        if len(buf) == batch_size:
            batch = {k: np.stack([s[k] for s in buf]) for k in buf[0]}
            buf.clear()
            yield pad_to_batch(batch, batch_size)
    if buf:
        batch = {k: np.stack([s[k] for s in buf]) for k in buf[0]}
        yield pad_to_batch(batch, batch_size)
