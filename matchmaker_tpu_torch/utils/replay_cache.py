"""Cross-experiment order-replay tensor cache.

Contract: reference utils/cross_experiment_cache.py:10-89 — caches expensive
intermediate tensors (IDCM's per-chunk BERT scores) across experiments on
numpy memmap blocks, replayed in the exact same iteration order; used via the
``submodel_*_cache_path`` configs (reference eval.py:65-67, train.py:180-182).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_BLOCK_FLOATS = 20_000_000  # reference: 20M floats per block


class CrossExperimentReplayCache:
    def __init__(self, cache_path: str, write: bool):
        self.cache_path = cache_path
        self.write = write
        self.block_idx = 0
        self.offset = 0
        self._blocks = []
        self._meta_path = os.path.join(cache_path, "cache-meta.json")
        os.makedirs(cache_path, exist_ok=True)
        if not write:
            with open(self._meta_path) as f:
                self._meta = json.load(f)
            self._blocks = [
                np.load(os.path.join(cache_path, f"cache_block_{i}.npy"), mmap_mode="r")
                for i in range(self._meta["blocks"])
            ]
        else:
            self._shapes = []
            self._current = np.zeros(_BLOCK_FLOATS, dtype=np.float32)

    # -- write path ---------------------------------------------------------
    def cache(self, tensor: np.ndarray) -> None:
        flat = np.asarray(tensor, dtype=np.float32).ravel()
        if self.offset + flat.size > _BLOCK_FLOATS:
            self._flush_block()
        self._current[self.offset : self.offset + flat.size] = flat
        self._shapes.append((self.block_idx, self.offset, list(tensor.shape)))
        self.offset += flat.size

    def _flush_block(self) -> None:
        np.save(
            os.path.join(self.cache_path, f"cache_block_{self.block_idx}.npy"),
            self._current[: self.offset],
        )
        self.block_idx += 1
        self.offset = 0
        self._current = np.zeros(_BLOCK_FLOATS, dtype=np.float32)

    def finish(self) -> None:
        if self.write:
            self._flush_block()
            with open(self._meta_path, "w") as f:
                json.dump({"blocks": self.block_idx, "shapes": self._shapes}, f)

    # -- read path ----------------------------------------------------------
    def get_next(self) -> Optional[np.ndarray]:
        shapes = self._meta["shapes"]
        if self.offset >= len(shapes):
            return None
        block, start, shape = shapes[self.offset]
        self.offset += 1
        size = int(np.prod(shape))
        return np.asarray(self._blocks[block][start : start + size]).reshape(shape)


class RunningAverage:
    """Ring-buffer running mean (reference utils/running_average.py:3-21) —
    loss/cluster-difficulty telemetry."""

    def __init__(self, size: int = 100):
        self.buffer = np.zeros(size, dtype=np.float64)
        self.count = 0
        self.size = size

    def add(self, value: float) -> float:
        self.buffer[self.count % self.size] = value
        self.count += 1
        return self.mean()

    def mean(self) -> float:
        n = min(self.count, self.size)
        return float(self.buffer[:n].mean()) if n else 0.0
