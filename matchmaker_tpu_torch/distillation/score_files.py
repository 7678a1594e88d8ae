"""Teacher score-file utilities: ensembling and text↔id conversion.

Contract: reference distillation/teacher_scores_ensemble.py:59-102 (mean
ensemble of several teachers' score files keyed by the (query, pos, neg)
triple), teacher_textscore_to_ids.py / teacher_id_to_text.py (convert between
5-col text triples and id-based ``pos_score neg_score q_id pos_id neg_id``
pair files using collection/query tsv lookups).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _read_id_file(path: str) -> Dict[str, str]:
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                out[parts[0]] = parts[1]
    return out


def ensemble_score_files(paths: List[str], out_path: str) -> int:
    """Mean-ensemble scored triple files; rows matched by (q, d+, d-) text."""
    scores: Dict[Tuple[str, str, str], List[Tuple[float, float]]] = {}
    order: List[Tuple[str, str, str]] = []
    for pi, path in enumerate(paths):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 5:
                    continue
                key = (parts[2], parts[3], parts[4])
                if pi == 0:
                    order.append(key)
                    scores[key] = []
                if key in scores:
                    scores[key].append((float(parts[0]), float(parts[1])))
    n = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for key in order:
            entries = scores[key]
            if len(entries) != len(paths):
                continue  # only fully-covered rows are ensembled
            pos = sum(e[0] for e in entries) / len(entries)
            neg = sum(e[1] for e in entries) / len(entries)
            out.write(f"{pos}\t{neg}\t{key[0]}\t{key[1]}\t{key[2]}\n")
            n += 1
    return n


def text_scores_to_ids(
    scores_path: str, queries_path: str, collection_path: str, out_path: str
) -> int:
    """5-col text file → ``pos neg q_id pos_id neg_id`` (TAS-B pair format)."""
    q_by_text = {v: k for k, v in _read_id_file(queries_path).items()}
    d_by_text = {v: k for k, v in _read_id_file(collection_path).items()}
    n = 0
    with open(scores_path, "r", encoding="utf-8") as f, open(out_path, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 5:
                continue
            q, dp, dn = parts[2], parts[3], parts[4]
            if q in q_by_text and dp in d_by_text and dn in d_by_text:
                out.write(f"{parts[0]} {parts[1]} {q_by_text[q]} {d_by_text[dp]} {d_by_text[dn]}\n")
                n += 1
    return n


def id_scores_to_text(
    scores_path: str, queries_path: str, collection_path: str, out_path: str
) -> int:
    """Inverse of :func:`text_scores_to_ids`."""
    queries = _read_id_file(queries_path)
    collection = _read_id_file(collection_path)
    n = 0
    with open(scores_path, "r", encoding="utf-8") as f, open(out_path, "w", encoding="utf-8") as out:
        for line in f:
            parts = line.split()
            if len(parts) != 5:
                continue
            q, dp, dn = parts[2], parts[3], parts[4]
            if q in queries and dp in collection and dn in collection:
                out.write(f"{parts[0]}\t{parts[1]}\t{queries[q]}\t{collection[dp]}\t{collection[dn]}\n")
                n += 1
    return n
