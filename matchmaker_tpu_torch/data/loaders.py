"""Device prefetch: counterpart of ``matchmaker_tpu/data/loaders.py:device_prefetch``.

The loaders themselves are the JAX package's host code (jax-free on import);
they yield numpy batches. ``single_sequence_loader`` is re-exported here so
the port reaches it through one module.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from matchmaker_tpu.data.loaders import single_sequence_loader

__all__ = ["device_prefetch", "single_sequence_loader"]


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
    exception in the pipeline is raised here, in the consumer."""
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
