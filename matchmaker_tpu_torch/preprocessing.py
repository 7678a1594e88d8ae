"""Offline data preparation tools: counterpart of
``matchmaker_tpu/preprocessing.py``, copied with only the imports changed.

Covers the reference's ``preprocessing/`` script battery (SURVEY.md §2.9) as
one CLI with subcommands:

- ``training-triples``: sample (query, pos, neg) triples from a first-stage
  candidate file + qrels + text collections
  (reference generate_training_input_from_candidate_set.py).
- ``validation-tuples``: build re-ranking eval tuples ``qid did qtext dtext``
  from a candidate set (generate_validation_input_from_candidate_set.py:1-135).
- ``vocab``: build a vocabulary file from collection+queries
  (generate_vocab.py).
- ``idf``: compute idf values over the collection (generate_idf.py).
- ``split-queries``: deterministic query-file split (query splitting scripts).
- ``intersect-qrels``: keep only queries present in both qrels and query file.

Usage: python -m matchmaker_tpu_torch.preprocessing <subcommand> --help
"""

from __future__ import annotations

import argparse
import math
import random
import sys
from collections import Counter
from typing import Dict

from matchmaker_tpu_torch.data.tokenization import WhitespaceTokenizer
from matchmaker_tpu_torch.experiment import parse_candidate_set
from matchmaker_tpu_torch.metrics.ir_metrics import load_qrels


def _read_tsv(path: str) -> Dict[str, str]:
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def cmd_training_triples(args) -> int:
    qrels = load_qrels(args.qrels)
    candidates = parse_candidate_set(args.candidates, args.depth)
    queries = _read_tsv(args.queries)
    collection = _read_tsv(args.collection)
    rng = random.Random(args.seed)
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for qid, cands in candidates.items():
            if qid not in qrels or qid not in queries:
                continue
            positives = [d for d in qrels[qid] if d in collection]
            negatives = [d for d in cands if d not in qrels[qid] and d in collection]
            if not positives or not negatives:
                continue
            for _ in range(args.triples_per_query):
                pos = rng.choice(positives)
                neg = rng.choice(negatives)
                out.write(f"{queries[qid]}\t{collection[pos]}\t{collection[neg]}\n")
                n += 1
    print(f"wrote {n} triples -> {args.out}")
    return 0


def cmd_validation_tuples(args) -> int:
    candidates = parse_candidate_set(args.candidates, args.depth)
    queries = _read_tsv(args.queries)
    collection = _read_tsv(args.collection)
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for qid, cands in candidates.items():
            if qid not in queries:
                continue
            for did, _rank in sorted(cands.items(), key=lambda kv: kv[1]):
                if did in collection:
                    out.write(f"{qid}\t{did}\t{queries[qid]}\t{collection[did]}\n")
                    n += 1
    print(f"wrote {n} tuples -> {args.out}")
    return 0


def cmd_vocab(args) -> int:
    tok = WhitespaceTokenizer()
    counts: Counter = Counter()
    for path in args.inputs:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                text = parts[1] if len(parts) >= 2 else parts[0]
                counts.update(tok.tokenize(text))
    with open(args.out, "w", encoding="utf-8") as out:
        for token, c in counts.most_common():
            if c >= args.min_count:
                out.write(token + "\n")
    print(f"wrote vocab ({sum(1 for c in counts.values() if c >= args.min_count)} tokens) -> {args.out}")
    return 0


def cmd_idf(args) -> int:
    tok = WhitespaceTokenizer()
    doc_freq: Counter = Counter()
    n_docs = 0
    with open(args.collection, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            n_docs += 1
            doc_freq.update(set(tok.tokenize(parts[1])))
    with open(args.out, "w", encoding="utf-8") as out:
        for token, df in doc_freq.most_common():
            idf = math.log((n_docs + 1) / (df + 1))
            out.write(f"{token} {idf}\n")
    print(f"wrote idf for {len(doc_freq)} tokens over {n_docs} docs -> {args.out}")
    return 0


def cmd_split_queries(args) -> int:
    queries = list(_read_tsv(args.queries).items())
    rng = random.Random(args.seed)
    rng.shuffle(queries)
    cut = int(len(queries) * args.fraction)
    for path, part in ((args.out_a, queries[:cut]), (args.out_b, queries[cut:])):
        with open(path, "w", encoding="utf-8") as out:
            for qid, text in part:
                out.write(f"{qid}\t{text}\n")
    print(f"split {len(queries)} queries -> {cut} / {len(queries) - cut}")
    return 0


def cmd_intersect_qrels(args) -> int:
    qrels = load_qrels(args.qrels)
    queries = _read_tsv(args.queries)
    keep = set(qrels) & set(queries)
    with open(args.out_queries, "w", encoding="utf-8") as out:
        for qid in keep:
            out.write(f"{qid}\t{queries[qid]}\n")
    print(f"kept {len(keep)} of {len(queries)} queries")
    return 0


def _parse_trec_run_line(line: str):
    """TREC run line (6-col ``qid Q0 did rank score tag``) or 4-col
    ``qid did rank score``; returns (qid, did, rank) or None."""
    parts = line.split()
    if len(parts) >= 6:
        return parts[0], parts[2], int(parts[3])
    if len(parts) == 4:
        return parts[0], parts[1], int(parts[2])
    return None


def cmd_smart_earlystopping(args) -> int:
    """Validation subset for smart early stopping (reference
    generate_smart_earlystopping_retrieval.py): bin queries into 5 buckets by
    a per-query baseline metric, sample evenly across buckets, emit tuples
    from the candidate file (≤ max rank) plus every judged positive."""
    import numpy as np

    qrels = load_qrels(args.qrels)
    collection = _read_tsv(args.collection)
    queries = _read_tsv(args.queries)
    metrics: Dict[str, float] = {}
    with open(args.candidate_metric, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                metrics[parts[0]] = float(parts[1])
    rng = random.Random(args.seed)

    values = np.array(list(metrics.values()))
    lo, hi = values.min(), values.max()
    edges = np.arange(lo, hi, max((hi - lo) / 5, 1e-12))
    indices = np.digitize(values, edges)
    bins = [[] for _ in range(5)]
    for i, qid in enumerate(metrics):
        bins[min(indices[i] - 1, 4)].append(qid)
    per_bin = args.n_queries // 5
    sampled = set()
    for b in bins:
        sampled.update(rng.sample(b, min(len(b), per_bin)))
    print(f"sampled {len(sampled)} queries across 5 metric bins")

    known = set()
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        with open(args.candidates, "r", encoding="utf-8") as f:
            for line in f:
                parsed = _parse_trec_run_line(line)
                if parsed is None:
                    continue
                qid, did, rank = parsed
                if qid not in sampled or rank > args.max_rank:
                    continue
                if (qid, did) in known or qid not in queries or did not in collection:
                    continue
                known.add((qid, did))
                out.write(f"{qid}\t{did}\t{queries[qid]}\t{collection[did]}\n")
                n += 1
        for qid in sampled:
            for did in qrels.get(qid, {}):
                if (qid, did) not in known and qid in queries and did in collection:
                    known.add((qid, did))
                    out.write(f"{qid}\t{did}\t{queries[qid]}\t{collection[did]}\n")
                    n += 1
    print(f"wrote {n} tuples -> {args.out}")
    return 0


def cmd_validation_from_n_candidates(args) -> int:
    """Merge several candidate runs into one deduplicated tuple file
    (reference generate_validation_from_n_candidate_sets.py)."""
    collection = _read_tsv(args.collection)
    queries = _read_tsv(args.queries)
    known = set()
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for path in args.candidates:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    parsed = _parse_trec_run_line(line)
                    if parsed is None:
                        continue
                    qid, did, _ = parsed
                    if (qid, did) in known or qid not in queries or did not in collection:
                        continue
                    known.add((qid, did))
                    out.write(f"{qid}\t{did}\t{queries[qid]}\t{collection[did]}\n")
                    n += 1
    print(f"wrote {n} deduped tuples from {len(args.candidates)} runs -> {args.out}")
    return 0


def cmd_msmarco_qidpid(args) -> int:
    """Text triples → id triples by reverse lookup over collection/queries
    (reference msmarco_makeqidpid.py)."""
    q_rev = {text: qid for qid, text in _read_tsv(args.queries).items()}
    p_rev = {text: pid for pid, text in _read_tsv(args.collection).items()}
    n = skipped = 0
    with open(args.triples, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            q, pos, neg = parts[0], parts[1], parts[2]
            if q in q_rev and pos in p_rev and neg in p_rev:
                out.write(f"{q_rev[q]}\t{p_rev[pos]}\t{p_rev[neg]}\n")
                n += 1
            else:
                skipped += 1
    print(f"wrote {n} id triples ({skipped} unmatched) -> {args.out}")
    return 0


def cmd_msmarco_qa_qrels(args) -> int:
    """MS MARCO QA json (query_id + passages[].is_selected) → qrels of
    selected passages (reference msmarco_generate_qrel.py). Accepts both the
    column-oriented pandas json layout and a list of records."""
    import json

    with open(args.inp, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict) and "query_id" in data:
        # column-oriented: {"query_id": {row: id}, "passages": {row: [...]}}
        rows = [
            (data["query_id"][k], data["passages"][k]) for k in data["query_id"]
        ]
    else:
        rows = [(r["query_id"], r["passages"]) for r in data]
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for qid, passages in rows:
            for p_i, passage in enumerate(passages):
                if passage.get("is_selected") == 1:
                    out.write(f"{qid} 0 {passage.get('passage_id', p_i)} 1\n")
                    n += 1
    print(f"wrote {n} qrels -> {args.out}")
    return 0


def cmd_validation_from_qrels(args) -> int:
    """Eval tuples for every judged (query, doc) pair
    (reference generate_validation_input_from_qrels.py)."""
    qrels = load_qrels(args.qrels)
    queries = _read_tsv(args.queries)
    collection = _read_tsv(args.collection)
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for qid, docs in qrels.items():
            if qid not in queries:
                continue
            for did in docs:
                if did in collection:
                    out.write(f"{qid}\t{did}\t{queries[qid]}\t{collection[did]}\n")
                    n += 1
    print(f"wrote {n} tuples -> {args.out}")
    return 0


def cmd_triples_from_ids(args) -> int:
    """Id triples (`qid pid+ pid-`) → text triples
    (reference convert_formats/create_train_from_ids.py)."""
    queries = _read_tsv(args.queries)
    collection = _read_tsv(args.collection)
    n = skipped = 0
    with open(args.triples, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            qid, pos, neg = parts[0], parts[1], parts[2]
            if qid in queries and pos in collection and neg in collection:
                out.write(f"{queries[qid]}\t{collection[pos]}\t{collection[neg]}\n")
                n += 1
            else:
                skipped += 1
    print(f"wrote {n} text triples ({skipped} unmatched) -> {args.out}")
    return 0


def cmd_find_missing_queries(args) -> int:
    """Queries absent from a train-triples id file
    (reference find_missing_queries.py)."""
    train_qids = set()
    with open(args.train_ids, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts:
                train_qids.add(parts[0])
    n = 0
    with open(args.queries, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            qid = line.split("\t", 1)[0]
            if qid not in train_qids:
                out.write(line)
                n += 1
    print(f"wrote {n} missing queries -> {args.out}")
    return 0


def cmd_fix_unicode(args) -> int:
    """Mojibake/control-char cleanup per tsv field (reference
    fix_unicode_text.py uses ftfy; here: NFC normalization + control strip,
    with ftfy applied when available)."""
    import unicodedata

    try:
        import ftfy  # optional, not in the base image

        fix = ftfy.fix_text
    except ImportError:
        def fix(s):
            return unicodedata.normalize("NFC", s)
    n = 0
    with open(args.inp, "r", encoding="utf-8", errors="replace") as f, \
         open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            fields = [
                "".join(ch for ch in fix(p) if ch == "\t" or not unicodedata.category(ch).startswith("C"))
                .replace("\t", " ").rstrip()
                for p in line.rstrip("\n").split("\t")
            ]
            out.write("\t".join(fields) + "\n")
            n += 1
    print(f"cleaned {n} lines -> {args.out}")
    return 0


def cmd_doc_to_mlm_passages(args) -> int:
    """Long documents → passage-sized blocks for MLM pre-training
    (reference msmarco_doc_to_mlm_passages.py: sentence-greedy packing into
    [min_words, max_words] blocks, capped per doc)."""
    import re as _re

    sent_split = _re.compile(r"(?<=[.!?])\s+")
    n_docs = n_blocks = 0
    with open(args.inp, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            n_docs += 1
            doc_id, text = parts[0], parts[1][:200_000]
            blocks, cur, cur_words = [], [], 0
            for sent in sent_split.split(text):
                words = sent.split()
                if cur_words + len(words) < args.max_words:
                    cur.extend(words)
                    cur_words += len(words)
                else:
                    if cur_words >= args.min_words:
                        blocks.append(" ".join(cur))
                    cur, cur_words = list(words), len(words)
                if len(blocks) >= args.max_blocks:
                    break
            if cur_words >= args.min_words and len(blocks) < args.max_blocks:
                blocks.append(" ".join(cur))
            for bi, block in enumerate(blocks):
                out.write(f"{doc_id}_{bi}\t{block}\n")
                n_blocks += 1
    print(f"split {n_docs} docs into {n_blocks} passages -> {args.out}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(prog="matchmaker_tpu_torch.preprocessing")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("training-triples")
    p.add_argument("--candidates", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--depth", type=int, default=100)
    p.add_argument("--triples-per-query", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_training_triples)

    p = sub.add_parser("validation-tuples")
    p.add_argument("--candidates", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--depth", type=int, default=100)
    p.set_defaults(fn=cmd_validation_tuples)

    p = sub.add_parser("vocab")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--min-count", type=int, default=5)
    p.set_defaults(fn=cmd_vocab)

    p = sub.add_parser("idf")
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_idf)

    p = sub.add_parser("split-queries")
    p.add_argument("--queries", required=True)
    p.add_argument("--out-a", required=True)
    p.add_argument("--out-b", required=True)
    p.add_argument("--fraction", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_split_queries)

    p = sub.add_parser("intersect-qrels")
    p.add_argument("--qrels", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--out-queries", required=True)
    p.set_defaults(fn=cmd_intersect_qrels)

    p = sub.add_parser("smart-earlystopping")
    p.add_argument("--candidates", required=True)
    p.add_argument("--candidate-metric", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n-queries", type=int, default=4000)
    p.add_argument("--max-rank", type=int, default=100)
    p.add_argument("--seed", type=int, default=208973249)
    p.set_defaults(fn=cmd_smart_earlystopping)

    p = sub.add_parser("validation-from-n-candidates")
    p.add_argument("--candidates", nargs="+", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_validation_from_n_candidates)

    p = sub.add_parser("msmarco-qidpid")
    p.add_argument("--triples", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_msmarco_qidpid)

    p = sub.add_parser("msmarco-qa-qrels")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_msmarco_qa_qrels)

    p = sub.add_parser("validation-from-qrels")
    p.add_argument("--qrels", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_validation_from_qrels)

    p = sub.add_parser("triples-from-ids")
    p.add_argument("--triples", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_triples_from_ids)

    p = sub.add_parser("find-missing-queries")
    p.add_argument("--queries", required=True)
    p.add_argument("--train-ids", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_find_missing_queries)

    p = sub.add_parser("fix-unicode")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_fix_unicode)

    p = sub.add_parser("doc-to-mlm-passages")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-words", type=int, default=130)
    p.add_argument("--min-words", type=int, default=80)
    p.add_argument("--max-blocks", type=int, default=60)
    p.set_defaults(fn=cmd_doc_to_mlm_passages)

    args = parser.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
