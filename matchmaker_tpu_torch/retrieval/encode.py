"""Corpus encoding into on-disk vector blocks: counterpart of
``matchmaker_tpu/retrieval/encode.py``, with the same files:
``token_reps_N.npy`` blocks of ``token_block_size`` rows, ``doc_infos.npz``
(sequence id → (block, start, end)) and ``encode_meta.json``.
Multi-vector models (ColBERT's per-token vectors) keep each sequence's
non-zero rows (the first row of a sequence without one), as the JAX package
does.

Under a process group (parallel/multihost.py) each process encodes every
N-th batch, the batches of a round are gathered in batch order, and the
primary process alone writes the blocks, so the files are those of one
process; every process returns the same ``doc_infos``.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, single_sequence_loader
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.parallel import multihost


class BlockWriter:
    """Append rows into fixed-size .npy blocks; rows never span blocks."""

    def __init__(self, folder: str, dim: int, block_rows: int, dtype=np.float16):
        self.folder = folder
        self.dim = dim
        self.block_rows = block_rows
        self.dtype = dtype
        self.block_num = 0
        self.row_in_block = 0
        self._block: Optional[np.ndarray] = None
        os.makedirs(folder, exist_ok=True)

    def append(self, rows: np.ndarray) -> Tuple[int, int, int]:
        """Write rows; returns (block, start, end)."""
        n = rows.shape[0]
        if n > self.block_rows:
            raise ValueError("single sequence larger than block size")
        if self._block is not None and self.row_in_block + n > self.block_rows:
            self.flush()
        if self._block is None:
            self._block = np.zeros((self.block_rows, self.dim), dtype=self.dtype)
        start = self.row_in_block
        self._block[start:start + n] = rows
        self.row_in_block += n
        return self.block_num, start, start + n

    def flush(self) -> None:
        if self._block is None:
            return
        if multihost.is_primary():  # one writer; every process keeps the same count
            np.save(os.path.join(self.folder, f"token_reps_{self.block_num}.npy"),
                    self._block[:self.row_in_block])
        self.block_num += 1
        self.row_in_block = 0
        self._block = None


def encode_corpus(encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], config, tokenizer,
                  input_path: str, out_folder: str, device: torch.device,
                  sequence_type: str = "doc") -> Dict[str, tuple]:
    """Encode an ``id \\t text`` file into blocks + doc_infos; returns doc_infos.
    ``encode_fn(ids, mask)`` → (B, D) vectors or (B, L, D) per-token vectors."""
    perf = PerformanceMonitor.get()
    dtype = np.float16 if config.get("token_dtype", "float16") == "float16" else np.float32
    block_rows = config.get("token_block_size", 50000)
    writer: Optional[BlockWriter] = None
    doc_infos: Dict[str, tuple] = {}
    n_seqs = 0

    loader = single_sequence_loader(config, tokenizer, input_path, sequence_type)
    perf.start_block("encode")
    for seq_ids, reps in _encoded_batches(encode_fn, loader, device):
        if writer is None:
            writer = BlockWriter(out_folder, reps.shape[-1], block_rows, dtype)
        if reps.ndim == 3:
            for sid, vecs in zip(seq_ids, reps):
                kept = vecs[np.abs(vecs).sum(axis=-1) > 0]
                doc_infos[sid] = writer.append((kept if kept.shape[0] else vecs[:1]).astype(dtype))
            n_seqs += len(seq_ids)
            continue
        rows = reps.astype(dtype)
        i = 0
        while i < len(seq_ids):
            take = min(writer.block_rows - writer.row_in_block, len(seq_ids) - i) \
                or min(writer.block_rows, len(seq_ids) - i)
            block, start, _ = writer.append(rows[i:i + take])
            for j, sid in enumerate(seq_ids[i:i + take]):
                doc_infos[sid] = (block, start + j, start + j + 1)
            i += take
        n_seqs += len(seq_ids)
    writer.flush()
    perf.stop_block("encode", n_seqs)

    if multihost.is_primary():
        np.savez_compressed(
            os.path.join(out_folder, "doc_infos.npz"),
            ids=np.array(list(doc_infos.keys())),
            spans=np.array(list(doc_infos.values()), dtype=np.int64),
        )
        with open(os.path.join(out_folder, "encode_meta.json"), "w") as f:
            json.dump({"dim": writer.dim, "dtype": str(np.dtype(dtype)), "blocks": writer.block_num,
                       "sequences": n_seqs}, f)
    multihost.barrier()  # the files are there for every process
    return doc_infos


def _encoded_batches(encode_fn, loader, device):
    """(sequence ids, host vectors) of every batch in order; under a process
    group each process encodes every N-th batch and a round's batches are
    gathered on every process."""
    n_proc, rank = multihost.process_count(), multihost.process_index()
    batches = device_prefetch(itertools.islice(loader, rank, None, n_proc), device)
    while True:
        item = next(batches, None)
        if item is not None:
            batch, seq_ids = item
            item = (list(seq_ids), encode_fn(batch["seq_ids"], batch["seq_mask"])[:len(seq_ids)].float().cpu().numpy())
        round_items = multihost.all_gather_objects(item)
        if all(r is None for r in round_items):
            return
        yield from (r for r in round_items if r is not None)


def load_encoded(folder: str) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate blocks → (vectors (N, D), row → sequence id)."""
    with open(os.path.join(folder, "encode_meta.json")) as f:
        meta = json.load(f)
    blocks = [np.load(os.path.join(folder, f"token_reps_{i}.npy")) for i in range(meta["blocks"])]
    vectors = np.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]
    data = np.load(os.path.join(folder, "doc_infos.npz"), allow_pickle=True)
    ids, spans = data["ids"], data["spans"]
    row_ids = np.empty(vectors.shape[0], dtype=ids.dtype)
    block_offsets = np.cumsum([0] + [b.shape[0] for b in blocks])
    for sid, (block, start, end) in zip(ids, spans):
        base = block_offsets[block]
        row_ids[base + start:base + end] = sid
    return vectors, row_ids
