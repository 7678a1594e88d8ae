"""Synthetic planted-relevance corpora at scale.

The effectiveness north star (BERT_DOT MS MARCO-dev MRR@10 ≥ 0.34,
reference README.md:148-165) needs real data this environment doesn't have;
this generator is the closeable half of that gap (VERDICT r2 missing-1): a
pinned-seed corpus with *known* ranking structure — every evaluation query
has exactly one lexically-aligned relevant document among topically-random
distractors, so a trained bi-encoder's MRR has a known ceiling of 1.0 and a
regression floor can be asserted end-to-end (train → encode → index →
search → MRR) without external data.

Scales to whatever doc count the harness asks for; tests/make_tiny_dataset
keeps the tiny fixture variant for fast unit tests.
"""

from __future__ import annotations

import os
import random
from typing import Dict

N_TOPIC = 400
N_NOISE = 400


def make_planted_corpus(
    out_dir: str,
    n_train_queries: int = 2000,
    n_eval_queries: int = 200,
    n_docs: int = 100_000,
    triples_per_query: int = 3,
    seed: int = 7,
) -> Dict[str, str]:
    """Write train triples, eval queries/qrels, and an ``n_docs`` collection.

    Corpus = one planted relevant doc per eval query + random-noise
    distractors up to ``n_docs``. Relevant docs repeat their query's topic
    words; distractors draw from a disjoint noise vocabulary, so a lexical
    match is necessary and sufficient — MRR ceiling 1.0."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)

    topic_words = [f"topic{i}" for i in range(N_TOPIC)]
    noise_words = [f"noise{i}" for i in range(N_NOISE)]

    def make_query(qi: int) -> str:
        rng_q = random.Random(seed * 131071 + qi)
        return " ".join(rng_q.sample(topic_words, 3))

    def rel_doc(query: str) -> str:
        words = query.split() * 3 + rng.sample(topic_words, 4)
        rng.shuffle(words)
        return " ".join(words)

    def irrel_doc() -> str:
        return " ".join(rng.sample(noise_words, 12))

    paths = {
        "train_tsv": os.path.join(out_dir, "train.tsv"),
        "qrels": os.path.join(out_dir, "qrels.txt"),
        "vocab": os.path.join(out_dir, "vocab.txt"),
        "collection": os.path.join(out_dir, "collection.tsv"),
        "queries": os.path.join(out_dir, "queries.tsv"),
    }

    with open(paths["vocab"], "w") as f:
        for w in topic_words + noise_words:
            f.write(w + "\n")

    with open(paths["train_tsv"], "w") as f:
        for qi in range(n_train_queries):
            q = make_query(qi)
            for _ in range(triples_per_query):
                f.write(f"{q}\t{rel_doc(q)}\t{irrel_doc()}\n")

    with open(paths["queries"], "w") as fq:
        rel_lines = []
        for qi in range(n_eval_queries):
            q = make_query(10_000_000 + qi)  # disjoint from train queries
            qid = f"q{qi}"
            fq.write(f"{qid}\t{q}\n")
            rel_lines.append((qid, rel_doc(q)))

    with open(paths["collection"], "w") as f:
        doc_id = 0
        # relevant docs scattered at pinned pseudo-random positions
        rel_positions = sorted(rng.sample(range(n_docs), len(rel_lines)))
        rel_iter = iter(zip(rel_positions, rel_lines))
        next_rel = next(rel_iter, None)
        with open(paths["qrels"], "w") as fr:
            for pos in range(n_docs):
                if next_rel is not None and pos == next_rel[0]:
                    qid, text = next_rel[1]
                    fr.write(f"{qid} 0 d{doc_id} 1\n")
                    next_rel = next(rel_iter, None)
                else:
                    text = irrel_doc()
                f.write(f"d{doc_id}\t{text}\n")
                doc_id += 1
    return paths


def make_planted_tas_corpus(
    out_dir: str,
    n_train_queries: int = 1000,
    n_eval_queries: int = 100,
    n_docs: int = 100_000,
    triples_per_query: int = 3,
    negs_per_query: int = 8,
    seed: int = 7,
    n_topics: int = None,
    words_per_topic: int = 40,
) -> Dict[str, str]:
    """Planted corpus with the EXTRA artifacts the full TAS-Balanced recipe
    needs (reference distillation pipeline, SURVEY §3.4): id'd train queries,
    each train query's relevant doc planted IN the collection, and an id-based
    candidate-pair file (``qid pos_pid neg_pid`` per line) for a teacher to
    score into ``pairs_with_teacher_scores.tsv``.

    The synthetic language is TOPIC-STRUCTURED (round 4): an i.i.d.-word
    corpus has nothing for MLM pretraining to learn (measured: flat loss at
    the unigram entropy), leaves a raw anisotropic encoder (every CLS pair
    at cosine ~1.0 → k-means degenerates to ONE cluster and ranking losses
    saturate — the whole recipe collapsed at 100k scale). Here every
    distractor doc samples words from ONE latent topic (with repetition:
    within-doc co-occurrence is learnable), each query takes one word from
    THREE distinct topics, and its planted doc is the only document
    containing all three (single-topic distractors can match at most one) —
    so the MRR ceiling stays ~1.0, MLM learns real topic geometry, query
    k-means recovers genuine cluster structure (the TAS-B contract), and
    same-topic hard negatives share a word with the query without being
    relevant."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)

    if n_topics is None:
        n_topics = max(4, min(50, n_train_queries // 16))
    topics = [
        [f"w{t}_{i}" for i in range(words_per_topic)] for t in range(n_topics)
    ]

    def make_query(qi: int):
        rng_q = random.Random(seed * 131071 + qi)
        tri = rng_q.sample(range(n_topics), 3)
        return " ".join(topics[t][rng_q.randrange(words_per_topic)] for t in tri), tri

    def rel_doc(query: str, tri) -> str:
        # the ONLY doc with all 3 cross-topic query words; repeated 3x so a
        # frequency-aware scorer separates it even from word-collision docs
        words = query.split() * 3 + [topics[t][rng.randrange(words_per_topic)] for t in tri]
        rng.shuffle(words)
        return " ".join(words)

    def irrel_doc() -> str:
        # single-topic doc, words drawn WITH replacement (repetition = the
        # co-occurrence signal MLM pretraining learns)
        pool = topics[rng.randrange(n_topics)]
        return " ".join(pool[rng.randrange(words_per_topic)] for _ in range(12))

    paths = {
        "train_tsv": os.path.join(out_dir, "train.tsv"),
        "train_queries": os.path.join(out_dir, "queries_train.tsv"),
        "candidates": os.path.join(out_dir, "candidates.tsv"),
        "qrels": os.path.join(out_dir, "qrels.txt"),
        "collection": os.path.join(out_dir, "collection.tsv"),
        "queries": os.path.join(out_dir, "queries.tsv"),
    }

    train_raw = {f"t{qi}": make_query(qi) for qi in range(n_train_queries)}
    eval_raw = {f"q{qi}": make_query(10_000_000 + qi) for qi in range(n_eval_queries)}
    train_q = {k: v[0] for k, v in train_raw.items()}
    eval_q = {k: v[0] for k, v in eval_raw.items()}

    # collection: one planted rel doc per (train + eval) query at pinned
    # pseudo-random positions, distractors elsewhere
    rel_lines = [(qid, rel_doc(text, tri))
                 for qid, (text, tri) in list(train_raw.items()) + list(eval_raw.items())]
    assert len(rel_lines) < n_docs, "need room for distractors"
    rel_positions = sorted(rng.sample(range(n_docs), len(rel_lines)))
    pid_of_query: Dict[str, str] = {}
    pids_of_topic: Dict[int, list] = {t: [] for t in range(n_topics)}
    with open(paths["collection"], "w") as f:
        rel_iter = iter(zip(rel_positions, rel_lines))
        next_rel = next(rel_iter, None)
        for pos in range(n_docs):
            if next_rel is not None and pos == next_rel[0]:
                qid, text = next_rel[1]
                pid_of_query[qid] = f"d{pos}"
                next_rel = next(rel_iter, None)
            else:
                topic = rng.randrange(n_topics)
                pool = topics[topic]
                text = " ".join(pool[rng.randrange(words_per_topic)] for _ in range(12))
                pids_of_topic[topic].append(f"d{pos}")
            f.write(f"d{pos}\t{text}\n")

    with open(paths["queries"], "w") as f:
        for qid, text in eval_q.items():
            f.write(f"{qid}\t{text}\n")
    with open(paths["qrels"], "w") as f:
        for qid in eval_q:
            f.write(f"{qid} 0 {pid_of_query[qid]} 1\n")
    with open(paths["train_queries"], "w") as f:
        for qid, text in train_q.items():
            f.write(f"{qid}\t{text}\n")

    # HARD negatives: other queries' relevant docs (same topic vocabulary,
    # wrong topics — the planted analog of MS MARCO's BM25-retrieved
    # negatives). Noise-only negatives make pos/neg separable WITHOUT the
    # query (pos = topic words, neg = disjoint noise vocab), which gives
    # margin-based distillation a query-independent shortcut and teaches the
    # student nothing about matching — measured MRR collapse in round 4.
    collection_text = {}
    with open(paths["collection"]) as f:
        for line in f:
            pid, text = line.rstrip("\n").split("\t")
            collection_text[pid] = text
    train_qids = list(train_q.keys())

    def hard_neg_pid(qid: str) -> str:
        other = train_qids[rng.randint(0, len(train_qids) - 1)]
        while other == qid:
            other = train_qids[rng.randint(0, len(train_qids) - 1)]
        return pid_of_query[other]

    def same_topic_doc(qid: str) -> str:
        # a doc from one of the query's own topics: topically close, shares
        # at most that one topic's words — the hardest non-relevant negative
        pool = topics[rng.choice(train_raw[qid][1])]
        return " ".join(pool[rng.randrange(words_per_topic)] for _ in range(12))

    with open(paths["train_tsv"], "w") as f:
        for qid, qtext in train_q.items():
            pos_text = collection_text[pid_of_query[qid]]
            for t in range(triples_per_query):
                neg_text = (
                    collection_text[hard_neg_pid(qid)] if t % 2 == 0
                    else same_topic_doc(qid)
                )
                f.write(f"{qtext}\t{pos_text}\t{neg_text}\n")

    # id-based candidate pairs for the TAS pairs file (teacher scores them):
    # a margin-diverse negative mix — other queries' rel docs (hard), the
    # query's own-topic distractors (hard, topical), random docs (easy) —
    # so the sampler's 10 margin-percentile bins carry real spread
    with open(paths["candidates"], "w") as f:
        for qid in train_q:
            pos_pid = pid_of_query[qid]
            for t in range(negs_per_query):
                if t % 4 == 3:  # every 4th: random distractor
                    neg_pid = f"d{rng.randint(0, n_docs - 1)}"
                    while neg_pid == pos_pid:
                        neg_pid = f"d{rng.randint(0, n_docs - 1)}"
                elif t % 4 == 2:  # own-topic distractor
                    own = pids_of_topic[rng.choice(train_raw[qid][1])]
                    neg_pid = own[rng.randrange(len(own))] if own else hard_neg_pid(qid)
                else:
                    neg_pid = hard_neg_pid(qid)
                f.write(f"{qid}\t{pos_pid}\t{neg_pid}\n")
    return paths
