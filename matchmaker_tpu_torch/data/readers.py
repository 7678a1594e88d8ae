"""TSV line parsers for the matchmaker data formats: the port's copy of
``matchmaker_tpu/data/readers.py``.

Format contract (reference documentation/data_format.md and the readers in
matchmaker/dataloaders/):

- training triples (independent_training_loader.py:100-134):
    3 col:  query \t doc_pos \t doc_neg
    5 col (scores):  pos_score \t neg_score \t query \t doc_pos \t doc_neg
    5 col (titles):  query \t pos_title \t doc_pos \t neg_title \t doc_neg
    7 col:  pos_score \t pos_psg_scores \t neg_score \t neg_psg_scores \t q \t d+ \t d-
    4 col (qa): qa_spans_pos \t query \t doc_pos \t doc_neg
- re-ranking tuples (independent_reranking_loader.py:85-92):
    4 col: query_id \t doc_id \t query \t doc
    5 col: query_id \t doc_id \t query \t doc_title \t doc
- id sequences (id_sequence_loader.py:54-55): id \t text

Parsers are plain generators over file lines; optional data augmentation
(sentence shuffle/reverse/rotate) matches independent_training_loader.py:144-165.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


@dataclass
class TripleSample:
    query: str
    doc_pos: str
    doc_neg: str
    pos_score: Optional[float] = None
    neg_score: Optional[float] = None
    pos_passage_scores: Optional[List[float]] = None
    neg_passage_scores: Optional[List[float]] = None
    pos_title: Optional[str] = None
    neg_title: Optional[str] = None
    qa_spans_pos: Optional[str] = None


@dataclass
class ReRankSample:
    query_id: str
    doc_id: str
    query: str
    doc: str
    doc_title: Optional[str] = None


def augment_document(aug_type: str, doc: str, rng: random.Random) -> str:
    """Sentence-level augmentation (shuffle / reverse / rotate)."""
    if not aug_type or aug_type == "none":
        return doc
    sents = _SENT_SPLIT.split(doc)
    if aug_type == "shuffle_sent":
        rng.shuffle(sents)
    elif aug_type == "reverse_sent":
        sents = sents[::-1]
    elif aug_type == "rotate_sent":
        pivot = rng.randrange(len(sents)) if sents else 0
        sents = sents[pivot:] + sents[:pivot]
    else:
        raise ValueError(f"unknown augmentation '{aug_type}'")
    return " ".join(sents)


def read_triples(
    path: str,
    with_scores: bool = False,
    with_qa: bool = False,
    augmentation: str = "none",
    seed: int = 42,
) -> Iterator[TripleSample]:
    rng = random.Random(seed)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if with_qa:
                if len(parts) != 4:
                    raise ValueError(f"invalid qa triple line: {line!r}")
                sample = TripleSample(query=parts[1], doc_pos=parts[2], doc_neg=parts[3], qa_spans_pos=parts[0])
            elif with_scores:
                if len(parts) == 5:
                    sample = TripleSample(
                        query=parts[2], doc_pos=parts[3], doc_neg=parts[4],
                        pos_score=float(parts[0]), neg_score=float(parts[1]),
                    )
                elif len(parts) == 7:
                    sample = TripleSample(
                        query=parts[4], doc_pos=parts[5], doc_neg=parts[6],
                        pos_score=float(parts[0]), neg_score=float(parts[2]),
                        pos_passage_scores=[float(x) for x in parts[1].split()],
                        neg_passage_scores=[float(x) for x in parts[3].split()],
                    )
                else:
                    raise ValueError(f"invalid scored triple line: {line!r}")
            else:
                if len(parts) == 3:
                    sample = TripleSample(query=parts[0], doc_pos=parts[1], doc_neg=parts[2])
                elif len(parts) == 5:
                    sample = TripleSample(
                        query=parts[0], doc_pos=parts[2], doc_neg=parts[4],
                        pos_title=parts[1], neg_title=parts[3],
                    )
                else:
                    raise ValueError(f"invalid triple line: {line!r}")
            if augmentation != "none":
                sample.doc_pos = augment_document(augmentation, sample.doc_pos, rng)
                sample.doc_neg = augment_document(augmentation, sample.doc_neg, rng)
            yield sample


def read_reranking_tuples(path: str) -> Iterator[ReRankSample]:
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) == 4:
                yield ReRankSample(query_id=parts[0], doc_id=parts[1], query=parts[2], doc=parts[3])
            elif len(parts) == 5:
                yield ReRankSample(
                    query_id=parts[0], doc_id=parts[1], query=parts[2], doc_title=parts[3], doc=parts[4]
                )
            else:
                raise ValueError(f"invalid reranking line: {line!r}")


def read_id_sequences(path: str) -> Iterator[tuple]:
    """``id \t text`` lines (collection / query files)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                raise ValueError(f"invalid id-sequence line: {line!r}")
            yield parts[0], parts[1]
