"""Fixed-shape batch collation: the port's copy of
``matchmaker_tpu/data/batching.py``.

TPU programs are traced once per shape, so every batch that reaches the device
has the same static shape: text is padded to the configured max lengths and the
final partial batch of a file is padded with all-zero rows plus a ``valid``
mask (instead of the dynamic bucketed batching the reference gets from
AllenNLP's MaxTokensBatchSampler, utils/input_pipeline.py:140-142).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def collate_text(encoded: Sequence[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-sample (ids, mask) pairs into (B, L) arrays."""
    ids = np.stack([e[0] for e in encoded])
    mask = np.stack([e[1] for e in encoded])
    return ids, mask


def pad_to_batch(batch: Dict[str, np.ndarray], batch_size: int) -> Dict[str, np.ndarray]:
    """Pad every array's leading dim to ``batch_size``; adds/extends ``valid``."""
    n = next(iter(batch.values())).shape[0]
    if "valid" not in batch:
        batch["valid"] = np.ones(n, dtype=np.float32)
    if n == batch_size:
        return batch
    if n > batch_size:
        raise ValueError(f"batch of {n} exceeds batch_size {batch_size}")
    out = {}
    for k, v in batch.items():
        pad_width = [(0, batch_size - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out


def stack_samples(arrays: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = arrays[0].keys()
    return {k: np.stack([a[k] for a in arrays]) for k in keys}
