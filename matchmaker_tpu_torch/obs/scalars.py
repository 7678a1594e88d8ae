"""Training-scalar telemetry: counterpart of ``matchmaker_tpu/obs/scalars.py``.

``ScalarWriter`` (TensorBoard + CSV sinks) is a copy of the JAX package's:
every scalar goes to TensorBoard (when available) and to a long-format
``{prefix}-scalars.csv`` (step, name, value) in the run folder.
:func:`collect_learned_scalars` walks a model's ``named_parameters()``
instead of a param tree.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, TextIO

import torch


class ScalarWriter:
    def __init__(self, run_folder: str, enable_tensorboard: bool = True):
        self.run_folder = run_folder
        self._tb = None
        self._csv: Dict[str, TextIO] = {}
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(run_folder, "tensorboard"))
            except Exception:
                self._tb = None

    def _csv_sink(self, prefix: str) -> Optional[TextIO]:
        if prefix not in self._csv:
            try:
                path = os.path.join(self.run_folder, f"{prefix}-scalars.csv")
                fresh = not os.path.exists(path)
                f = open(path, "a", encoding="utf-8")
                if fresh:
                    f.write("step,name,value\n")
                self._csv[prefix] = f
            except Exception:
                self._csv[prefix] = None
        return self._csv[prefix]

    def write(self, scalars: Dict[str, float], step: int, prefix: str = "train") -> None:
        csv = self._csv_sink(prefix)
        for k, v in scalars.items():
            try:
                fv = float(v)
            except Exception:
                continue
            if self._tb is not None:
                try:
                    self._tb.add_scalar(f"{prefix}/{k}", fv, step)
                except Exception:
                    pass
            if csv is not None:
                csv.write(f"{step},{k},{fv}\n")

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        for f in self._csv.values():
            if f is not None:
                f.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        for f in self._csv.values():
            if f is not None:
                f.close()
        self._csv.clear()


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
