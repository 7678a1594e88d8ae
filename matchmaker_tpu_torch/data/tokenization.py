"""Host-side tokenization producing fixed-shape int32 arrays: the port's copy
of ``matchmaker_tpu/data/tokenization.py``.

- ``Vocabulary`` / ``VocabTokenizer``: word tokenization and a vocabulary
  lookup (ids 0/1 reserved for PAD/OOV) for the vocabulary-embedding models
  (KNRM, TK, ...), with ``mask_oov`` and a per-token idf table
  (``idf_path``, TKL's ``query_idfs``);
- ``HuggingfaceTokenizer``: a locally available Hugging Face ``AutoTokenizer``
  (``transformers`` imported when one is built);
- ``HashBertTokenizer``: the offline stand-in with BERT's special-token
  layout, words hashed into the vocabulary;
- ``build_tokenizer``: the factory, keyed on ``token_embedder_type``.

Everything returns (ids, mask) numpy arrays already padded to the configured
max length.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

PAD_ID = 0
OOV_ID = 1

_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


class WhitespaceTokenizer:
    """Word/punctuation splitter (BlingFire-equivalent behavior for IR text)."""

    def tokenize(self, text: str) -> List[str]:
        return _WORD_RE.findall(text.lower())


class Vocabulary:
    """token -> id mapping with reserved PAD=0 and OOV=1."""

    def __init__(self, tokens: Optional[Iterable[str]] = None):
        self.token_to_id: Dict[str, int] = {"@@PADDING@@": PAD_ID, "@@UNKNOWN@@": OOV_ID}
        if tokens is not None:
            for t in tokens:
                self.add(t)

    def add(self, token: str) -> int:
        if token not in self.token_to_id:
            self.token_to_id[token] = len(self.token_to_id)
        return self.token_to_id[token]

    def __len__(self) -> int:
        return len(self.token_to_id)

    def __getitem__(self, token: str) -> int:
        return self.token_to_id.get(token, OOV_ID)

    @classmethod
    def from_file(cls, path: str) -> "Vocabulary":
        """One token per line (reference vocab-file format, preprocessing/generate_vocab.py)."""
        v = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                tok = line.rstrip("\n")
                if tok and tok not in ("@@PADDING@@", "@@UNKNOWN@@"):
                    v.add(tok)
        return v

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for tok, idx in sorted(self.token_to_id.items(), key=lambda kv: kv[1]):
                if idx >= 2:
                    f.write(tok + "\n")


class VocabTokenizer:
    """Whitespace tokenization + vocab lookup → fixed-shape (ids, mask).

    ``mask_oov`` replicates the reference's GloVe-model mask rule of treating
    OOV like padding in the match matrix (modules/neuralIR_encoder.py:29-43).
    """

    def __init__(self, vocab: Vocabulary, mask_oov: bool = False, idf_path: Optional[str] = None):
        self.vocab = vocab
        self.words = WhitespaceTokenizer()
        self.mask_oov = mask_oov
        # per-token idf table for PACRR/CO-PACRR/Duet (reference
        # models/all.py:106-117 loads idfs as a 1-dim pretrained embedding)
        self.idf_lookup: Optional[np.ndarray] = None
        if idf_path:
            self.idf_lookup = np.zeros(len(vocab), dtype=np.float32)
            with open(idf_path, "r", encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split(" ")
                    if len(parts) == 2 and parts[0] in vocab.token_to_id:
                        self.idf_lookup[vocab.token_to_id[parts[0]]] = float(parts[1])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_id(self) -> int:
        return PAD_ID

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full(max_length, PAD_ID, dtype=np.int32)
        toks = self.words.tokenize(text)[:max_length]
        for i, t in enumerate(toks):
            ids[i] = self.vocab[t]
        mask = ids != PAD_ID
        if self.mask_oov:
            mask &= ids != OOV_ID
        return ids, mask.astype(np.float32)

    def encode_with_offsets(self, text: str, max_length: int):
        ids, mask = self.encode(text, max_length)
        offsets = [(m.start(), m.end()) for m in _WORD_RE.finditer(text.lower())][:max_length]
        offsets += [None] * (max_length - len(offsets))
        return ids, mask, offsets

    def encode_batch(self, texts, max_length: int):
        ids = np.full((len(texts), max_length), PAD_ID, dtype=np.int32)
        for t, text in enumerate(texts):
            toks = self.words.tokenize(text)[:max_length]
            for i, tok in enumerate(toks):
                ids[t, i] = self.vocab[tok]
        mask = ids != PAD_ID
        if self.mask_oov:
            mask &= ids != OOV_ID
        return ids, mask.astype(np.float32)

    def encode_pair(self, query: str, doc: str, max_q: int, max_d: int):
        raise NotImplementedError("embedding-based models use independent inputs")


def char_spans_to_token_labels(
    spans_str: str,
    offsets,  # list of (char_start, char_end) per doc token, None for specials
    position_offset: int,
    max_spans: int = 4,
):
    """``"start,end start2,end2"`` char spans → fixed-size token-index label
    arrays (padding -1) + answerability flag (reference
    concatenated_reranking_loader.py:96-131)."""
    starts = np.full(max_spans, -1, dtype=np.int32)
    ends = np.full(max_spans, -1, dtype=np.int32)
    has_answer = 0
    if spans_str:
        has_answer = 1
        for si, span in enumerate(spans_str.split()[:max_spans]):
            s_char, e_char = (int(x) for x in span.split(",")[:2])
            got_start = False
            last_i = None
            for i, off in enumerate(offsets):
                if off is None:
                    continue
                _, tok_end = off
                last_i = i
                if not got_start and tok_end >= s_char:
                    starts[si] = position_offset + i
                    got_start = True
                if tok_end >= e_char:
                    ends[si] = position_offset + i
                    break
            else:
                if got_start and last_i is not None:  # span cut by truncation
                    ends[si] = position_offset + last_i
            if starts[si] >= 0 and ends[si] < 0:
                ends[si] = starts[si]
    return starts, ends, has_answer


class HuggingfaceTokenizer:
    """HF AutoTokenizer wrapper with fixed-length padding.

    ``encode`` → single sequence (bi-encoders); ``encode_pair`` → one
    concatenated sequence with token-type ids (cross-encoders), mirroring the
    independent/concatenated reader split (utils/input_pipeline.py:150-171).
    """

    def __init__(self, model_name_or_path: str):
        from transformers import AutoTokenizer

        try:
            # local/cached first — avoids a slow network timeout in
            # zero-egress environments
            self.tok = AutoTokenizer.from_pretrained(
                model_name_or_path, use_fast=True, local_files_only=True
            )
        except Exception:
            if os.environ.get("MM_TPU_ALLOW_HUB_DOWNLOAD"):
                self.tok = AutoTokenizer.from_pretrained(model_name_or_path, use_fast=True)
            else:
                raise

    @property
    def vocab_size(self) -> int:
        return self.tok.vocab_size

    @property
    def pad_id(self) -> int:
        return self.tok.pad_token_id or 0

    @property
    def mask_token_id(self) -> int:
        return self.tok.mask_token_id

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        out = self.tok(
            text, max_length=max_length, truncation=True, padding="max_length", return_tensors="np"
        )
        ids = out["input_ids"][0].astype(np.int32)
        mask = out["attention_mask"][0].astype(np.float32)
        return ids, mask

    def encode_pair(self, query: str, doc: str, max_q: int, max_d: int):
        out = self.tok(
            query,
            doc,
            max_length=max_q + max_d,
            truncation="only_second",
            padding="max_length",
            return_tensors="np",
        )
        ids = out["input_ids"][0].astype(np.int32)
        mask = out["attention_mask"][0].astype(np.float32)
        type_ids = out.get("token_type_ids")
        if type_ids is None:
            type_ids = np.zeros_like(ids)
        else:
            type_ids = type_ids[0].astype(np.int32)
        return ids, mask, type_ids

    def batch_encode(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        out = self.tok(
            texts, max_length=max_length, truncation=True, padding="max_length", return_tensors="np"
        )
        return out["input_ids"].astype(np.int32), out["attention_mask"].astype(np.float32)

    def encode_batch(self, texts, max_length: int):
        return self.batch_encode(list(texts), max_length)

    def encode_with_offsets(self, text: str, max_length: int):
        out = self.tok(
            text, max_length=max_length, truncation=True, padding="max_length",
            return_tensors="np", return_offsets_mapping=True,
        )
        ids = out["input_ids"][0].astype(np.int32)
        mask = out["attention_mask"][0].astype(np.float32)
        offsets = [
            None if (s == 0 and e == 0) else (int(s), int(e))
            for s, e in out["offset_mapping"][0]
        ]
        return ids, mask, offsets


class HashBertTokenizer:
    """Offline BERT-style tokenizer: word split + deterministic hash vocab.

    Stand-in when no HF tokenizer files are available (zero-egress
    environments): same special-token layout as bert/distilbert vocabularies
    (PAD=0, UNK=100, CLS=101, SEP=102, MASK=103), words hashed into the
    remaining id space with crc32. Architecturally exercises the exact same
    model path; only the token identities differ from a real WordPiece vocab.
    """

    PAD, UNK, CLS, SEP, MASK = 0, 100, 101, 102, 103

    def __init__(self, vocab_size: int = 30522):
        self._vocab_size = vocab_size
        # keep the bert special-token id range reserved; shrink for tiny vocabs
        self._reserved = 1000 if vocab_size > 2000 else 104
        self.words = WhitespaceTokenizer()

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def pad_id(self) -> int:
        return self.PAD

    @property
    def mask_token_id(self) -> int:
        return self.MASK

    def _word_id(self, word: str) -> int:
        import zlib

        return self._reserved + (zlib.crc32(word.encode("utf-8")) % (self._vocab_size - self._reserved))

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full(max_length, self.PAD, dtype=np.int32)
        toks = [self.CLS] + [self._word_id(w) for w in self.words.tokenize(text)]
        toks = toks[: max_length - 1] + [self.SEP]
        ids[: len(toks)] = toks
        mask = (ids != self.PAD).astype(np.float32)
        return ids, mask

    def encode_batch(self, texts, max_length: int):
        ids = np.full((len(texts), max_length), self.PAD, dtype=np.int32)
        for t, text in enumerate(texts):
            toks = [self.CLS] + [self._word_id(w) for w in self.words.tokenize(text)]
            toks = toks[: max_length - 1] + [self.SEP]
            ids[t, : len(toks)] = toks
        mask = (ids != self.PAD).astype(np.float32)
        return ids, mask

    def encode_with_offsets(self, text: str, max_length: int):
        ids, mask = self.encode(text, max_length)
        words = [(m.start(), m.end()) for m in _WORD_RE.finditer(text.lower())][: max_length - 2]
        offsets: list = [None] + words + [None]  # CLS ... SEP
        offsets += [None] * (max_length - len(offsets))
        return ids, mask, offsets[:max_length]

    def encode_pair(self, query: str, doc: str, max_q: int, max_d: int):
        total = max_q + max_d
        q = [self._word_id(w) for w in self.words.tokenize(query)][: max_q - 2]
        d = [self._word_id(w) for w in self.words.tokenize(doc)][: total - len(q) - 3]
        toks = [self.CLS] + q + [self.SEP] + d + [self.SEP]
        ids = np.full(total, self.PAD, dtype=np.int32)
        type_ids = np.zeros(total, dtype=np.int32)
        ids[: len(toks)] = toks
        type_ids[len(q) + 2 : len(toks)] = 1
        mask = (np.arange(total) < len(toks)).astype(np.float32)
        return ids, mask, type_ids


# the files a Hugging Face tokenizer is read from; a checkpoint directory
# holding none of them has no vocabulary
_TOKENIZER_FILES = ("tokenizer.json", "vocab.txt", "vocab.json", "spiece.model", "sentencepiece.bpe.model")


def build_tokenizer(config):
    """Tokenizer factory keyed on ``token_embedder_type``: a vocabulary
    tokenizer for ``embedding`` (``vocab_directory`` or ``vocab_path``), a
    local Hugging Face tokenizer, else the hash-vocab tokenizer sized to the encoder's
    vocabulary so ids stay in range (zero-egress fallback, as in the JAX
    package). A checkpoint directory without a vocabulary file takes the
    hash tokenizer too: some ``transformers`` versions raise there, others
    build a tokenizer of its five special tokens alone, which maps every
    word to [UNK]."""
    kind = config.get("token_embedder_type", "huggingface_bpe")
    if kind == "embedding":
        vocab_path = config.get("vocab_directory") or config.get("vocab_path")
        if vocab_path is None:
            raise ValueError("embedding token_embedder_type requires vocab_path")
        return VocabTokenizer(Vocabulary.from_file(vocab_path), mask_oov=config.get("mask_oov", False),
                              idf_path=config.get("idf_path"))
    name = config.get("bert_pretrained_model", "distilbert-base-uncased")
    if not (os.path.isdir(name) and not any(os.path.isfile(os.path.join(name, f)) for f in _TOKENIZER_FILES)):
        try:
            return HuggingfaceTokenizer(name)
        except (ImportError, OSError, ValueError, TypeError):  # TypeError: a directory without a vocabulary
            pass
    from matchmaker_tpu_torch.models.encoder import encoder_config_from_model_name

    return HashBertTokenizer(encoder_config_from_model_name(config).vocab_size)
