"""Loader factory and device prefetch: the port's copy of
``matchmaker_tpu/data/loaders.py``.

File + tokenizer + config → iterator of fixed-shape numpy batches
(reference utils/input_pipeline.py:37-148): ``triple_training_loader``
(static triples, optional teacher scores), ``reranking_inference_loader``
(q/d tuples with ids) and ``single_sequence_loader`` (id \t text
corpus/query encoding). Batches are produced on the host and overlapped with
device compute by :func:`device_prefetch`, which places them as torch
tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.data.batching import pad_to_batch
from matchmaker_tpu_torch.data.readers import read_id_sequences, read_reranking_tuples, read_triples


def _is_concatenated(config) -> bool:
    return config.get("model_input_type", "independent") == "concatenated"


def _encode_query_aug(tokenizer, text: str, max_len: int, n_mask: int):
    """ColBERT-style query augmentation: append n_mask [MASK] tokens
    (reference independent_training_loader.py:176-182)."""
    ids, mask = tokenizer.encode(text, max_len)
    if n_mask > 0 and hasattr(tokenizer, "mask_token_id"):
        length = int(mask.sum())
        end = min(length + n_mask, max_len)
        ids[length:end] = tokenizer.mask_token_id
        mask[length:end] = 1.0
    return ids, mask


def triple_training_loader(
    config,
    tokenizer,
    path: str,
    batch_size: Optional[int] = None,
    process_stride: Optional[Tuple[int, int]] = None,
    skip_batches: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield training batches from a pre-generated triple file.

    ``process_stride=(pid, n_proc)``: multi-process data slicing BEFORE
    tokenization — sample i belongs to local batch i // batch_size, and this
    process keeps only batches where (i // batch_size) % n_proc == pid (the
    same assignment as islice-ing the batch stream, but the skipped samples
    never reach the tokenizer: each extra process used to re-tokenize the
    WHOLE file to discard (n_proc-1)/n_proc of it).

    ``skip_batches``: drop this process's first N batches without tokenizing
    them (mid-epoch resume fast-forward; see Trainer.resume_from_train_state).
    """
    batch_size = batch_size or config.get("batch_size_train", 32)
    max_q = config.get("max_query_length", 30)
    max_d = config.get("max_doc_length", 200)
    with_scores = config.get("train_pairwise_distillation", False)
    with_qa = config.get("train_qa_spans", False)
    n_qa_spans = config.get("max_qa_spans", 4)
    concat = _is_concatenated(config)
    q_aug = config.get("query_augment_mask_number", 0)

    buf: List[dict] = []

    def flush():
        batch: Dict[str, np.ndarray] = {}
        for key in buf[0]:
            batch[key] = np.stack([s[key] for s in buf])
        buf.clear()
        return pad_to_batch(batch, batch_size)

    def keep_samples(samples):
        pid, n_proc = process_stride if process_stride else (0, 1)
        kept = 0
        for i, s in enumerate(samples):
            if (i // batch_size) % n_proc != pid:
                continue
            if kept < skip_batches * batch_size:
                kept += 1
                continue
            yield s

    for sample in keep_samples(read_triples(
        path,
        with_scores=with_scores,
        with_qa=with_qa,
        augmentation=config.get("train_data_augment", "none"),
        seed=config.get("random_seed", 42),
    )):
        if with_qa:
            # QA multi-task: concatenated [q-enc ‖ d-enc] with char-span → token
            # labels on the positive doc (reference independent_training_loader
            # qa path + concatenated_reranking_loader.py:96-131)
            from matchmaker_tpu_torch.data.tokenization import char_spans_to_token_labels

            q_ids, q_mask = tokenizer.encode(sample.query, max_q)
            p_ids, p_mask, p_offsets = tokenizer.encode_with_offsets(sample.doc_pos, max_d)
            n_ids, n_mask = tokenizer.encode(sample.doc_neg, max_d)
            qa_start, qa_end, has_answer = char_spans_to_token_labels(
                sample.qa_spans_pos, p_offsets, position_offset=max_q, max_spans=n_qa_spans
            )
            type_q = np.zeros(max_q, np.int32)
            type_pd = (p_mask > 0).astype(np.int32)
            type_nd = (n_mask > 0).astype(np.int32)
            row = {
                "pos_ids": np.concatenate([q_ids, p_ids]),
                "pos_mask": np.concatenate([q_mask, p_mask]),
                "pos_type_ids": np.concatenate([type_q, type_pd]),
                "neg_ids": np.concatenate([q_ids, n_ids]),
                "neg_mask": np.concatenate([q_mask, n_mask]),
                "neg_type_ids": np.concatenate([type_q, type_nd]),
                "qa_start": qa_start,
                "qa_end": qa_end,
                "qa_has_answer": np.int32(has_answer),
            }
            buf.append(row)
            if len(buf) == batch_size:
                yield flush()
            continue
        if sample.pos_title and config.get("use_title_body_sep", False):
            # title-aware documents (reference use_title_body_sep semantics)
            sample.doc_pos = f"{sample.pos_title} {sample.doc_pos}"
            sample.doc_neg = f"{sample.neg_title} {sample.doc_neg}"
        if concat:
            pos_ids, pos_mask, pos_type = tokenizer.encode_pair(sample.query, sample.doc_pos, max_q, max_d)
            neg_ids, neg_mask, neg_type = tokenizer.encode_pair(sample.query, sample.doc_neg, max_q, max_d)
            row = {
                "pos_ids": pos_ids, "pos_mask": pos_mask, "pos_type_ids": pos_type,
                "neg_ids": neg_ids, "neg_mask": neg_mask, "neg_type_ids": neg_type,
            }
        else:
            q_ids, q_mask = _encode_query_aug(tokenizer, sample.query, max_q, q_aug)
            p_ids, p_mask = tokenizer.encode(sample.doc_pos, max_d)
            n_ids, n_mask = tokenizer.encode(sample.doc_neg, max_d)
            row = {
                "query_ids": q_ids, "query_mask": q_mask,
                "doc_pos_ids": p_ids, "doc_pos_mask": p_mask,
                "doc_neg_ids": n_ids, "doc_neg_mask": n_mask,
            }
            idf = getattr(tokenizer, "idf_lookup", None)
            if idf is not None:
                row["query_idfs"] = idf[q_ids]
        if with_scores:
            row["pos_score"] = np.float32(sample.pos_score or 0.0)
            row["neg_score"] = np.float32(sample.neg_score or 0.0)
            if sample.pos_passage_scores is not None:
                n_psg = config.get("max_training_passages", 8)

                def pad_psg(scores):
                    arr = np.zeros(n_psg, np.float32)
                    arr[: min(len(scores), n_psg)] = scores[:n_psg]
                    return arr

                row["pos_passage_scores"] = pad_psg(sample.pos_passage_scores)
                row["neg_passage_scores"] = pad_psg(sample.neg_passage_scores)
        buf.append(row)
        if len(buf) == batch_size:
            yield flush()
    if buf:
        yield flush()


def reranking_inference_loader(
    config,
    tokenizer,
    path: str,
    batch_size: Optional[int] = None,
) -> Iterator[Tuple[Dict[str, np.ndarray], List[str], List[str]]]:
    """Yield (batch, query_ids, doc_ids) for re-ranking evaluation."""
    batch_size = batch_size or config.get("batch_size_eval", 64)
    max_q = config.get("max_query_length", 30)
    max_d = config.get("max_doc_length", 200)
    concat = _is_concatenated(config)
    # length buckets: shorter docs batch at a smaller static doc length — a few
    # extra XLA compiles buy ~2x eval throughput (TPU answer to the reference's
    # MaxTokensBatchSampler bucketing, utils/input_pipeline.py:140-142)
    buckets = sorted(set(config.get("eval_length_buckets", []) or []) | {max_d})
    buckets = [b for b in buckets if b <= max_d]

    state = {b: {"buf": [], "qids": [], "dids": []} for b in buckets}

    def flush(bucket):
        s = state[bucket]
        batch = {key: np.stack([row[key] for row in s["buf"]]) for key in s["buf"][0]}
        out = (pad_to_batch(batch, batch_size), list(s["qids"]), list(s["dids"]))
        s["buf"].clear()
        s["qids"].clear()
        s["dids"].clear()
        return out

    def pick_bucket(n_tokens: int) -> int:
        for b in buckets:
            if n_tokens <= b:
                return b
        return buckets[-1]

    words = None
    for sample in read_reranking_tuples(path):
        if len(buckets) > 1:
            if words is None:
                from matchmaker_tpu_torch.data.tokenization import WhitespaceTokenizer

                words = WhitespaceTokenizer()
            bucket = pick_bucket(len(words.tokenize(sample.doc)) + 2)
        else:
            bucket = buckets[-1]
        if concat:
            ids, mask, type_ids = tokenizer.encode_pair(sample.query, sample.doc, max_q, bucket)
            row = {"seq_ids": ids, "seq_mask": mask, "seq_type_ids": type_ids}
        else:
            q_ids, q_mask = tokenizer.encode(sample.query, max_q)
            d_ids, d_mask = tokenizer.encode(sample.doc, bucket)
            row = {
                "query_ids": q_ids, "query_mask": q_mask,
                "doc_ids": d_ids, "doc_mask": d_mask,
            }
            idf = getattr(tokenizer, "idf_lookup", None)
            if idf is not None:
                row["query_idfs"] = idf[q_ids]
        s = state[bucket]
        s["buf"].append(row)
        s["qids"].append(sample.query_id)
        s["dids"].append(sample.doc_id)
        if len(s["buf"]) == batch_size:
            yield flush(bucket)
    for bucket in buckets:
        if state[bucket]["buf"]:
            yield flush(bucket)


def single_sequence_loader(
    config,
    tokenizer,
    path: str,
    sequence_type: str = "doc",
    batch_size: Optional[int] = None,
) -> Iterator[Tuple[Dict[str, np.ndarray], List[str]]]:
    """Yield (batch, sequence_ids) for corpus/query encoding
    (reference utils/input_pipeline.py:37-66)."""
    batch_size = batch_size or config.get("batch_size_inference", 128)
    max_len = (
        config.get("max_query_length", 30)
        if sequence_type == "query"
        else config.get("max_doc_length", 200)
    )
    q_aug = config.get("query_augment_mask_number", 0) if sequence_type == "query" else 0

    texts: List[str] = []
    seq_ids: List[str] = []
    # batch tokenization (HF fast / native / vectorized vocab) — the host-side
    # throughput matters at corpus-encoding rates (§docs/tpu_design.md)
    batch_encode = getattr(tokenizer, "encode_batch", None) if q_aug <= 0 else None

    def flush():
        if batch_encode is not None:
            ids, mask = batch_encode(texts, max_len)
            batch = {"seq_ids": ids.astype(np.int32), "seq_mask": mask.astype(np.float32)}
        else:
            encoded = [_encode_query_aug(tokenizer, t, max_len, q_aug) for t in texts]
            batch = {
                "seq_ids": np.stack([e[0] for e in encoded]),
                "seq_mask": np.stack([e[1] for e in encoded]),
            }
        out = (pad_to_batch(batch, batch_size), list(seq_ids))
        texts.clear()
        seq_ids.clear()
        return out

    for sid, text in read_id_sequences(path):
        texts.append(text)
        seq_ids.append(sid)
        if len(texts) == batch_size:
            yield flush()
    if texts:
        yield flush()


def _place(item: Any, device: torch.device) -> Any:
    if isinstance(item, np.ndarray):
        t = torch.from_numpy(item)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(item, dict):
        return {k: _place(v, device) for k, v in item.items()}
    if isinstance(item, tuple):
        return tuple(_place(v, device) for v in item)
    if isinstance(item, list):
        return [_place(v, device) for v in item]
    return item


def device_prefetch(iterator: Iterable, device: torch.device, n_prefetch: int = 2) -> Iterator:
    """Run the host pipeline in a background thread and keep ``n_prefetch``
    items ahead, their numpy arrays already on ``device`` (pinned host
    memory and non-blocking copies on the current stream for a GPU). An
    exception in the pipeline is raised here, in the consumer. Under a
    process group the items are this process's own rows (the loaders'
    ``process_stride``) and ``device`` its own card: the placement is
    process-local, as JAX's ``place_local_rows``, and nothing crosses
    processes here."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=n_prefetch)
    end = object()
    failure = []

    def worker():
        try:
            for item in iterator:
                q.put(_place(item, device))
        except Exception as exc:  # handed to the consumer, raised there
            failure.append(exc)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        yield item
    t.join()
    if failure:
        raise failure[0]
