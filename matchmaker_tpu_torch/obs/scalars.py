"""Training-scalar telemetry: counterpart of ``matchmaker_tpu/obs/scalars.py``.

``ScalarWriter`` (TensorBoard + CSV sinks) is the JAX package's own, which
is jax-free; :func:`collect_learned_scalars` walks a model's
``named_parameters()`` instead of a param tree.
"""

from __future__ import annotations

from typing import Dict

import torch

from matchmaker_tpu.obs.scalars import ScalarWriter

__all__ = ["ScalarWriter", "collect_learned_scalars"]


def collect_learned_scalars(model: torch.nn.Module, max_size: int = 16) -> Dict[str, float]:
    """Every float parameter with at most ``max_size`` elements whose leaf
    name is not ``bias``/``scale``/``embedding``/``kernel``, keyed by its
    flax-style path (``a/b/c``, elements as ``a/b/c/i``)."""
    out: Dict[str, float] = {}
    for name, p in model.named_parameters():
        if not p.dtype.is_floating_point or p.numel() > max_size:
            continue
        path = name.replace(".", "/")
        if path.rsplit("/", 1)[-1] in ("bias", "scale", "embedding", "kernel"):
            continue
        vals = p.detach().float().reshape(-1).cpu().tolist()
        if len(vals) == 1:
            out[path] = vals[0]
        else:
            for i, v in enumerate(vals):
                out[f"{path}/{i}"] = v
    return out
