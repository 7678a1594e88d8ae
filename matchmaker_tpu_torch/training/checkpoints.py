"""Checkpointing: counterpart of ``matchmaker_tpu/training/checkpoints.py``.

- best-model snapshots are ``.npz`` files of the parameters keyed by their
  flax paths (models/weights.py), which the port's dense-retrieval CLI loads
  (``trained_model``), with best-checkpoint rotation;
- :func:`load_encoder_subtree` grafts a snapshot's encoder into a ranker
  whose heads stay fresh (``warmstart_encoder_path``, e.g. from an MLM
  pre-train run of cli/pretrain.py);
- :class:`TrainStateCheckpointer` keeps the full train state for a mid-run
  resume: model and optimizer state, step, epoch and the batches consumed in
  that epoch (the data cursor), one ``torch.save`` file per step.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from matchmaker_tpu_torch.models.weights import load_npz, save_npz

BEST_MODEL = "best-model.npz"


def save_params(path: str, model: torch.nn.Module) -> None:
    save_npz(path, model.state_dict())


def load_params(path: str, model: torch.nn.Module) -> None:
    """Load a ``.npz`` snapshot into the model (strict: same parameter set)."""
    model.load_state_dict(load_npz(path))


_ENCODER_SLOTS = ("encoder", "query_encoder", "doc_encoder")


def load_encoder_subtree(path: str, model: torch.nn.Module) -> None:
    """Copy the ``encoder`` tensors of a ``.npz`` snapshot (all of it when it
    has no ``encoder`` subtree) into every encoder slot of ``model``
    (``encoder`` / ``query_encoder`` / ``doc_encoder``); every other
    parameter keeps its value. The snapshot must hold each tensor of a
    slot, at its shape."""
    saved = load_npz(path)
    prefix = "encoder." if any(k.startswith("encoder.") for k in saved) else ""
    enc = {k[len(prefix):]: v for k, v in saved.items() if k.startswith(prefix)}
    state = model.state_dict()
    slots = sorted({k.split(".", 1)[0] for k in state if k.split(".", 1)[0] in _ENCODER_SLOTS})
    if not slots:
        raise ValueError(f"no encoder subtree in the model to graft {path} into")
    graft = {}
    for slot in slots:
        for key, value in state.items():
            if key.startswith(slot + "."):
                name = key[len(slot) + 1:]
                if name not in enc or tuple(enc[name].shape) != tuple(value.shape):
                    raise ValueError(f"{path}: no encoder tensor {name!r} of shape {tuple(value.shape)}")
                graft[key] = enc[name]
    model.load_state_dict(graft, strict=False)


def rotate_best(run_folder: str, n_best: int) -> None:
    """best-model.npz → best-model-2.npz → ... (keeps ``n_best`` snapshots)."""
    if n_best <= 1:
        return
    for i in range(n_best - 1, 0, -1):
        src = os.path.join(run_folder, f"best-model-{i}.npz" if i > 1 else BEST_MODEL)
        dst = os.path.join(run_folder, f"best-model-{i + 1}.npz")
        if os.path.exists(src):
            os.replace(src, dst)


class TrainStateCheckpointer:
    """Full train-state snapshots under ``directory/step_N.pt``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees a half-written file

    def restore(self, step: int, map_location=None) -> Dict[str, Any]:
        # the file holds tensors and plain Python containers that this class wrote
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".pt"):
                try:
                    steps.append(int(name[len("step_"):-len(".pt")]))
                except ValueError:
                    pass
        return max(steps) if steps else None
