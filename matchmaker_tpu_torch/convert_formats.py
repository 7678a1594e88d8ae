"""Dataset format converters → the framework's canonical TSV formats:
counterpart of ``matchmaker_tpu/convert_formats.py``, copied as it is.

Covers the reference's ``preprocessing/convert_formats/*`` battery
(SURVEY.md §2.9) for the common public datasets:

- ``msmarco-doc``: MS MARCO document corpus (`docid \t url \t title \t body`)
  → `id \t title body` collection.
- ``trec-sgml``: TREC SGML document collections (Robust04-style
  <DOC><DOCNO><TEXT> markup) → `id \t text`.
- ``squad``: SQuAD v1/v2 JSON → QA training triples
  (`qa_spans \t question \t context_pos \t context_neg`) and/or QA eval tuples
  with gold answers.
- ``cord19``: CORD-19 metadata.csv → `id \t title abstract`.
- ``openwebtext``: directory of .txt files → `id \t text` (MLM pre-training).
- ``trec-qrels``: pass/normalize qrel variants into 4-col TREC format.
- ``trec-car``: TREC CAR paragraph CBOR corpus → `id \t text` (first-party
  CBOR reader — reference trec_car_create_collection.py depends on
  trec-car-tools; this needs no dependency).
- ``trec-car-queries``: CAR topic/qrel files → `qid \t query` with URL
  decoding (trec_car_create_eval.py).
- ``antique-qrels``: shift ANTIQUE's 1-4 grades down by 2, clamped at 0
  (antique_normalize_qrels.py).
- ``antique-train``: training triples from a TREC candidate file + graded
  qrels — positive sampled from qrels with a strictly higher grade than the
  unjudged candidate (antique_create_train_input.py).
- ``tripclick-train``: click-log training triples — for every qrel-positive
  doc sample up to N negatives from the query's candidate list
  (tripclick_create_train_input.py).

Usage: python -m matchmaker_tpu_torch.convert_formats <subcommand> --help
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
import re
import sys


def cmd_msmarco_doc(args) -> int:
    n = 0
    with open(args.inp, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            doc_id, _url, title, body = parts[0], parts[1], parts[2], parts[3]
            text = f"{title} {body}".strip().replace("\t", " ")
            out.write(f"{doc_id}\t{text}\n")
            n += 1
    print(f"converted {n} docs -> {args.out}")
    return 0


_DOC_RE = re.compile(r"<DOC>(.*?)</DOC>", re.S)
_DOCNO_RE = re.compile(r"<DOCNO>\s*(.*?)\s*</DOCNO>", re.S)
_TEXT_RE = re.compile(r"<TEXT>(.*?)</TEXT>", re.S)
_TAG_RE = re.compile(r"<[^>]+>")


def cmd_trec_sgml(args) -> int:
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for path in args.inputs:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                content = f.read()
            for doc in _DOC_RE.finditer(content):
                block = doc.group(1)
                docno = _DOCNO_RE.search(block)
                if not docno:
                    continue
                texts = _TEXT_RE.findall(block)
                text = " ".join(_TAG_RE.sub(" ", t) for t in texts)
                text = " ".join(text.split()).replace("\t", " ")
                if text:
                    out.write(f"{docno.group(1)}\t{text}\n")
                    n += 1
    print(f"converted {n} docs -> {args.out}")
    return 0


def cmd_squad(args) -> int:
    with open(args.inp, "r", encoding="utf-8") as f:
        data = json.load(f)["data"]
    contexts = []  # (id, text)
    qas = []  # (qa_id, question, context_idx, [(start, end)], [answer texts])
    for article in data:
        for para in article["paragraphs"]:
            ctx_idx = len(contexts)
            contexts.append((f"ctx{ctx_idx}", para["context"].replace("\t", " ").replace("\n", " ")))
            for qa in para["qas"]:
                spans = []
                answers = []
                for ans in qa.get("answers", []):
                    start = ans["answer_start"]
                    spans.append((start, start + len(ans["text"])))
                    answers.append(ans["text"])
                qas.append((qa["id"], qa["question"].replace("\t", " "), ctx_idx, spans, answers))

    rng = random.Random(args.seed)
    n = 0
    if args.triples_out:
        with open(args.triples_out, "w", encoding="utf-8") as out:
            for qa_id, question, ctx_idx, spans, _ in qas:
                neg_idx = rng.randrange(len(contexts))
                while neg_idx == ctx_idx and len(contexts) > 1:
                    neg_idx = rng.randrange(len(contexts))
                span_str = " ".join(f"{s},{e}" for s, e in spans[: args.max_spans])
                out.write(f"{span_str}\t{question}\t{contexts[ctx_idx][1]}\t{contexts[neg_idx][1]}\n")
                n += 1
        print(f"wrote {n} qa triples -> {args.triples_out}")
    if args.tuples_out:
        with open(args.tuples_out, "w", encoding="utf-8") as out, open(
            args.answers_out or args.tuples_out + ".answers.json", "w", encoding="utf-8"
        ) as ans_out:
            gold = {}
            for qa_id, question, ctx_idx, _, answers in qas:
                out.write(f"{qa_id}\t{contexts[ctx_idx][0]}\t{question}\t{contexts[ctx_idx][1]}\n")
                gold[qa_id] = answers
            json.dump(gold, ans_out)
        print(f"wrote {len(qas)} qa tuples -> {args.tuples_out}")
    return 0


def cmd_cord19(args) -> int:
    n = 0
    with open(args.inp, newline="", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for row in csv.DictReader(f):
            doc_id = row.get("cord_uid") or row.get("sha") or ""
            title = (row.get("title") or "").replace("\t", " ")
            abstract = (row.get("abstract") or "").replace("\t", " ")
            if doc_id and (title or abstract):
                out.write(f"{doc_id}\t{title} {abstract}\n".replace("\n ", " ").rstrip() + "\n")
                n += 1
    print(f"converted {n} docs -> {args.out}")
    return 0


def cmd_openwebtext(args) -> int:
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for root, _dirs, files in os.walk(args.inp):
            for fname in sorted(files):
                if not fname.endswith(".txt"):
                    continue
                with open(os.path.join(root, fname), "r", encoding="utf-8", errors="replace") as f:
                    text = " ".join(f.read().split()).replace("\t", " ")
                if text:
                    out.write(f"owt{n}\t{text[: args.max_chars]}\n")
                    n += 1
    print(f"converted {n} documents -> {args.out}")
    return 0


def cmd_trec_qrels(args) -> int:
    """Normalize qrel variants (comma/tab/space separated) to 4-col TREC."""
    n = 0
    with open(args.inp, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = re.split(r"[,\t ]+", line.strip())
            if len(parts) == 4:
                qid, it, did, grade = parts
            elif len(parts) == 3:
                qid, did, grade = parts
                it = "0"
            else:
                continue
            out.write(f"{qid} {it} {did} {grade}\n")
            n += 1
    print(f"normalized {n} qrels -> {args.out}")
    return 0


# --------------------------------------------------------------------------
# TREC CAR: first-party minimal CBOR reader (RFC 8949 subset) — replaces the
# reference's trec-car-tools dependency (trec_car_create_collection.py).


class _CborReader:
    """Streaming decoder for the CBOR subset trec-car files use: ints, byte/
    text strings, (indefinite) arrays, maps, tags, floats, break."""

    def __init__(self, fh):
        self.fh = fh

    def _byte(self):
        b = self.fh.read(1)
        if not b:
            raise EOFError
        return b[0]

    def _uint(self, info):
        if info < 24:
            return info
        n = {24: 1, 25: 2, 26: 4, 27: 8}[info]
        return int.from_bytes(self.fh.read(n), "big")

    _BREAK = object()

    def decode(self):
        ib = self._byte()
        major, info = ib >> 5, ib & 0x1F
        if major == 0:  # unsigned int
            return self._uint(info)
        if major == 1:  # negative int
            return -1 - self._uint(info)
        if major == 2:  # byte string
            if info == 31:  # indefinite
                chunks = []
                while True:
                    v = self.decode()
                    if v is self._BREAK:
                        return b"".join(chunks)
                    chunks.append(v)
            return self.fh.read(self._uint(info))
        if major == 3:  # text string
            if info == 31:
                chunks = []
                while True:
                    v = self.decode()
                    if v is self._BREAK:
                        return "".join(chunks)
                    chunks.append(v)
            return self.fh.read(self._uint(info)).decode("utf-8", errors="replace")
        if major == 4:  # array
            if info == 31:
                items = []
                while True:
                    v = self.decode()
                    if v is self._BREAK:
                        return items
                    items.append(v)
            return [self.decode() for _ in range(self._uint(info))]
        if major == 5:  # map
            n = self._uint(info) if info != 31 else None
            out = {}
            if n is None:
                while True:
                    k = self.decode()
                    if k is self._BREAK:
                        return out
                    out[k] = self.decode()
            for _ in range(n):
                k = self.decode()
                out[k] = self.decode()
            return out
        if major == 6:  # tag: skip the tag number, return the content
            self._uint(info)
            return self.decode()
        # major 7: simple values / floats / break
        if info == 20:
            return False
        if info == 21:
            return True
        if info in (22, 23):
            return None
        if info == 25:
            import struct

            return struct.unpack(">e", self.fh.read(2))[0]
        if info == 26:
            import struct

            return struct.unpack(">f", self.fh.read(4))[0]
        if info == 27:
            import struct

            return struct.unpack(">d", self.fh.read(8))[0]
        if info == 31:
            return self._BREAK
        return self._uint(info)

    def iter_values(self):
        while True:
            try:
                yield self.decode()
            except EOFError:
                return


def _car_body_text(body) -> str:
    """ParaText [1, text] → text; ParaLink [2, page, ..., anchor] → anchor
    (the last string element), matching trec-car-tools get_text()."""
    if not isinstance(body, list) or not body:
        return ""
    strings = [x.decode("utf-8", "replace") if isinstance(x, bytes) else x
               for x in body if isinstance(x, (str, bytes))]
    if not strings:
        return ""
    return strings[0] if body[0] == 1 else strings[-1]


def iter_car_paragraphs(path: str):
    """Yield (paragraph_id, text) from a TREC CAR paragraph CBOR file
    (Paragraph = [0, id, [bodies...]]; reference trec_car_create_collection.py)."""
    with open(path, "rb") as f:
        for value in _CborReader(f).iter_values():
            if not isinstance(value, list) or len(value) < 3:
                continue
            pid = value[1]
            if isinstance(pid, bytes):
                pid = pid.decode("ascii", "replace")
            bodies = value[2] if isinstance(value[2], list) else []
            text = "".join(_car_body_text(b) for b in bodies)
            yield str(pid), text


def cmd_trec_car(args) -> int:
    n = 0
    with open(args.out, "w", encoding="utf-8") as out:
        for pid, text in iter_car_paragraphs(args.inp):
            out.write(pid + "\t" + text.replace("\t", " ").replace("\n", " ") + "\n")
            n += 1
    print(f"converted {n} paragraphs -> {args.out}")
    return 0


def cmd_trec_car_queries(args) -> int:
    """CAR topics/qrels → `qid \t query` with URL decoding
    (reference trec_car_create_eval.py:36-52)."""
    import urllib.parse

    known = set()
    n = 0
    with open(args.inp, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.split()  # handles space- AND tab-separated qrel lines
            qid = parts[0] if parts else ""
            if not qid or qid in known:
                continue
            known.add(qid)
            query = urllib.parse.unquote(qid).replace("enwiki:", "").replace("/", " ")
            out.write(qid + "\t" + query.replace("\t", " ").replace("\n", " ").strip() + "\n")
            n += 1
    print(f"converted {n} queries -> {args.out}")
    return 0


def cmd_antique_qrels(args) -> int:
    """ANTIQUE grades 1-4 → max(grade-2, 0) (antique_normalize_qrels.py)."""
    n = 0
    with open(args.inp, "r", encoding="utf-8") as f, open(args.out, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            parts[3] = str(max(int(parts[3]) - 2, 0))
            out.write(" ".join(parts) + "\n")
            n += 1
    print(f"normalized {n} qrels -> {args.out}")
    return 0


def _read_tsv_map(path):
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def _read_graded_qrels(path):
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"[\t ]+", line.strip())
            if len(parts) >= 4:
                out.setdefault(parts[0], {})[parts[2]] = int(float(parts[3]))
    return out


def cmd_antique_train(args) -> int:
    """Graded-qrel triples: candidate doc = negative, positive drawn from the
    query's qrels with a strictly higher grade (antique_create_train_input.py:
    84-130)."""
    rng = random.Random(args.seed)
    collection = _read_tsv_map(args.collection)
    queries = _read_tsv_map(args.queries)
    qrels = _read_graded_qrels(args.qrels)
    kept = skipped = 0
    with open(args.candidates, "r", encoding="utf-8") as f, \
         open(args.out, "w", encoding="utf-8") as out, \
         (open(args.out_ids, "w", encoding="utf-8") if args.out_ids else _NullFile()) as out_ids:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, neg_did = parts[0], parts[2]
            if qid not in queries or qid not in qrels or neg_did not in collection:
                skipped += 1
                continue
            neg_grade = qrels[qid].get(neg_did, 0)
            pool = [d for d, g in qrels[qid].items()
                    if g > neg_grade and d != neg_did and d in collection]
            if not pool:
                skipped += 1
                continue
            pos_did = rng.choice(pool)
            out.write("\t".join([queries[qid], collection[pos_did], collection[neg_did]]) + "\n")
            out_ids.write("\t".join([qid, pos_did, neg_did]) + "\n")
            kept += 1
    print(f"kept {kept} triples ({skipped} skipped) -> {args.out}")
    return 0


def cmd_tripclick_train(args) -> int:
    """Click-log triples: every qrel doc is a positive; up to N negatives
    sampled from the query's candidate list (tripclick_create_train_input.py:
    84-120)."""
    rng = random.Random(args.seed)
    collection = _read_tsv_map(args.collection)
    queries = _read_tsv_map(args.queries)
    qrels = _read_graded_qrels(args.qrels)
    candidates = {}
    with open(args.candidates, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                candidates.setdefault(parts[0], []).append(parts[2])
    kept = collisions = 0
    with open(args.out, "w", encoding="utf-8") as out, \
         (open(args.out_ids, "w", encoding="utf-8") if args.out_ids else _NullFile()) as out_ids:
        for qid, docs in qrels.items():
            if qid not in queries or qid not in candidates:
                continue
            d_set = set(docs)
            for pos_did in docs:
                if pos_did not in collection:
                    continue
                for neg_did in rng.sample(candidates[qid], min(args.negatives, len(candidates[qid]))):
                    if neg_did in d_set or neg_did not in collection:
                        collisions += 1
                        continue
                    out.write("\t".join([queries[qid], collection[pos_did], collection[neg_did]]) + "\n")
                    out_ids.write("\t".join([qid, pos_did, neg_did]) + "\n")
                    kept += 1
    print(f"kept {kept} triples ({collisions} collisions) -> {args.out}")
    return 0


class _NullFile:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def write(self, *_):
        pass


def main() -> int:
    parser = argparse.ArgumentParser(prog="matchmaker_tpu_torch.convert_formats")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("msmarco-doc")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_msmarco_doc)

    p = sub.add_parser("trec-sgml")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_trec_sgml)

    p = sub.add_parser("squad")
    p.add_argument("--inp", required=True)
    p.add_argument("--triples-out")
    p.add_argument("--tuples-out")
    p.add_argument("--answers-out")
    p.add_argument("--max-spans", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_squad)

    p = sub.add_parser("cord19")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_cord19)

    p = sub.add_parser("openwebtext")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--max-chars", type=int, default=100000)
    p.set_defaults(fn=cmd_openwebtext)

    p = sub.add_parser("trec-qrels")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_trec_qrels)

    p = sub.add_parser("trec-car")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_trec_car)

    p = sub.add_parser("trec-car-queries")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_trec_car_queries)

    p = sub.add_parser("antique-qrels")
    p.add_argument("--inp", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_antique_qrels)

    p = sub.add_parser("antique-train")
    p.add_argument("--candidates", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--out-ids")
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_antique_train)

    p = sub.add_parser("tripclick-train")
    p.add_argument("--candidates", required=True)
    p.add_argument("--collection", required=True)
    p.add_argument("--queries", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--out-ids")
    p.add_argument("--negatives", type=int, default=20)
    p.add_argument("--seed", type=int, default=42)
    p.set_defaults(fn=cmd_tripclick_train)

    args = parser.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
