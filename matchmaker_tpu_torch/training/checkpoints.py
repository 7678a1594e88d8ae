"""Checkpointing: counterpart of ``matchmaker_tpu/training/checkpoints.py``.

- best-model snapshots are ``.npz`` files of the parameters keyed by their
  flax paths (models/weights.py), which the port's dense-retrieval CLI loads
  (``trained_model``), with best-checkpoint rotation;
- a JAX run's ``best-model.flax`` (``flax.serialization.to_bytes`` of its
  param tree: msgpack) loads wherever a snapshot does: :func:`read_flax` is
  a msgpack decoder written here (the card machine has no ``msgpack``),
  :func:`write_flax` writes the bytes ``to_bytes`` writes for the same tree,
  :func:`resolve_snapshot` picks the file of a run folder (``.npz`` first);
- :func:`load_encoder_subtree` grafts a snapshot's encoder into a ranker
  whose heads stay fresh (``warmstart_encoder_path``, e.g. from an MLM
  pre-train run of cli/pretrain.py);
- :class:`TrainStateCheckpointer` keeps the full train state for a mid-run
  resume: model and optimizer state, step, epoch and the batches consumed in
  that epoch (the data cursor), one ``torch.save`` file per step.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

# state_dict_to_flax is re-exported: a JAX run's file is written as write_flax(path, state_dict_to_flax(model))
from matchmaker_tpu_torch.models.weights import flax_to_state_dict, load_npz, save_npz, state_dict_to_flax  # noqa: F401
from matchmaker_tpu_torch.parallel import multihost

BEST_MODEL = "best-model.npz"
BEST_MODEL_FLAX = "best-model.flax"

# flax.serialization: a leaf over this many bytes is written as a dict of
# flattened chunks (msgpack's objects stop at 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---- msgpack, as flax.serialization writes and reads it ----------------------

def _unpack(buf: memoryview, i: int):
    """One msgpack object of ``buf`` at ``i`` → (object, next offset)."""
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if b <= 0x8F:
        return _unpack_map(buf, i, b & 0x0F)
    if b <= 0x9F:
        return _unpack_array(buf, i, b & 0x0F)
    if b <= 0xBF:
        n = b & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        w = 1 << (b - 0xC4)
        n = int.from_bytes(buf[i:i + w], "big")
        return bytes(buf[i + w:i + w + n]), i + w + n
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        w = 1 << (b - 0xC7)
        n = int.from_bytes(buf[i:i + w], "big")
        return _ext(struct.unpack_from(">b", buf, i + w)[0], buf[i + w + 1:i + w + 1 + n]), i + w + 1 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, i)[0], i + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, i)[0], i + 8
    if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
        fmt = ">" + "BHIQbhiq"[b - 0xCC]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
        n = 1 << (b - 0xD4)
        return _ext(struct.unpack_from(">b", buf, i)[0], buf[i + 1:i + 1 + n]), i + 1 + n
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        w = 1 << (b - 0xD9)
        n = int.from_bytes(buf[i:i + w], "big")
        return str(buf[i + w:i + w + n], "utf-8"), i + w + n
    if b in (0xDC, 0xDD):
        w = 2 if b == 0xDC else 4
        return _unpack_array(buf, i + w, int.from_bytes(buf[i:i + w], "big"))
    if b in (0xDE, 0xDF):
        w = 2 if b == 0xDE else 4
        return _unpack_map(buf, i + w, int.from_bytes(buf[i:i + w], "big"))
    raise ValueError(f"not a msgpack type byte: 0x{b:02x} at offset {i - 1}")


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        key, i = _unpack(buf, i)
        out[key], i = _unpack(buf, i)
    return out, i


def _unpack_array(buf, i, n):
    out = []
    for _ in range(n):
        item, i = _unpack(buf, i)
        out.append(item)
    return out, i


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's array encoding: msgpack (shape, dtype name, C-order bytes).
    bfloat16, which numpy lacks, widens to float32 (exactly)."""
    (shape, dtype, raw), _ = _unpack(data, 0)
    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if raw else torch.empty(0, dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        (re, im), _ = _unpack(data, 0)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code} in a flax file")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax(path: str) -> Dict[str, Any]:
    """A ``.flax`` file (``flax.serialization.to_bytes`` of a param tree) →
    its nested dict of numpy arrays, chunked leaves joined again."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    tree, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{path}: {len(buf) - end} bytes after the msgpack object")
    return _unchunk(tree)


def _pack_len(out: bytearray, n: int, small: Optional[int], small_max: int, codes, widths=(1, 2, 4)) -> None:
    """A length header: the fix form (``small`` | n) up to ``small_max``,
    else the first of ``codes`` whose width holds n."""
    if small is not None and n <= small_max:
        out.append(small | n)
        return
    for code, w in zip(codes, widths):
        if n < 1 << (8 * w):
            out.append(code)
            out += n.to_bytes(w, "big")
            return
    raise ValueError(f"msgpack object of length {n} too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"), (0, 0xFFFF, 0xCD, ">H"),
                              (-0x8000, -1, 0xD1, ">h"), (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (-0x80000000, -1, 0xD2, ">i"), (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_array_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: packb((shape, dtype name, bytes))."""
    out = bytearray()
    _pack_len(out, 3, 0x90, 15, (0xDC, 0xDD), (2, 4))
    _pack_len(out, arr.ndim, 0x90, 15, (0xDC, 0xDD), (2, 4))
    for d in arr.shape:
        _pack_int(out, int(d))
    _pack(out, arr.dtype.name)
    raw = np.ascontiguousarray(arr).tobytes("C")
    _pack_len(out, len(raw), None, -1, (0xC4, 0xC5, 0xC6))
    out += raw
    return bytes(out)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 15, (0xDE, 0xDF), (2, 4))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _pack_array_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _pack_array_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"write_flax: cannot serialize {type(obj).__name__}")


def _flax_tree(tree, max_chunk_bytes: int):
    """The tree as ``to_bytes`` packs it: string keys in the tree's own
    order, tensors as numpy, leaves over ``max_chunk_bytes`` as flax's
    chunked dicts."""
    if isinstance(tree, dict):
        return {str(k): _flax_tree(v, max_chunk_bytes) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > max_chunk_bytes:
        size = max(1, int(max_chunk_bytes / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, flat.size, size))}}
    return tree


def write_flax(path: str, tree, max_chunk_bytes: int = MAX_CHUNK_SIZE) -> None:
    """Write a nested dict of arrays as ``flax.serialization.to_bytes`` would
    (the same bytes, keys in the tree's order). JAX's ``save_params`` packs
    its tree after ``jax.device_get``, which sorts the keys: the sorted tree
    :func:`state_dict_to_flax` gives is written as it writes it."""
    out = bytearray()
    _pack(out, _flax_tree(tree, max_chunk_bytes))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)


# ---- snapshots ---------------------------------------------------------------

_said_both = set()


def resolve_snapshot(path: str) -> str:
    """The weights file of ``path``: the file itself, or in a run folder its
    ``best-model.npz``, else its ``best-model.flax`` (a JAX run). Where a
    folder holds both, the ``.npz`` wins, said once a folder."""
    if not os.path.isdir(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no weights at {path} (expected a snapshot file, or a folder holding "
                                    f"{BEST_MODEL} or {BEST_MODEL_FLAX})")
        return path
    npz, flax = os.path.join(path, BEST_MODEL), os.path.join(path, BEST_MODEL_FLAX)
    if os.path.isfile(npz):
        if os.path.isfile(flax) and path not in _said_both:
            _said_both.add(path)
            warnings.warn(f"{path} holds both {BEST_MODEL} and {BEST_MODEL_FLAX}: loading {BEST_MODEL}",
                          stacklevel=3)
        return npz
    if os.path.isfile(flax):
        return flax
    raise FileNotFoundError(f"no weights in {path} (expected {BEST_MODEL} or {BEST_MODEL_FLAX})")


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a snapshot: a ``.npz``, a ``.flax`` (through
    ``flax_to_state_dict``), or a run folder holding either."""
    path = resolve_snapshot(path)
    if path.endswith(".flax"):
        return flax_to_state_dict(read_flax(path))
    return load_npz(path)


def save_params(path: str, model: torch.nn.Module) -> None:
    save_npz(path, model.state_dict())


def load_params(path: str, model: torch.nn.Module) -> None:
    """Load a snapshot (``.npz``, ``.flax`` or a run folder) into the model
    (strict: same parameter set)."""
    model.load_state_dict(load_state(path))


_ENCODER_SLOTS = ("encoder", "query_encoder", "doc_encoder")


def load_encoder_subtree(path: str, model: torch.nn.Module) -> None:
    """Copy the ``encoder`` tensors of a snapshot (``.npz``, ``.flax`` or a
    run folder; all of it when it has no ``encoder`` subtree) into every
    encoder slot of ``model`` (``encoder`` / ``query_encoder`` /
    ``doc_encoder``); every other parameter keeps its value. The snapshot
    must hold each tensor of a slot, at its shape."""
    saved = load_state(path)
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
    """Full train-state snapshots under ``directory/step_N.pt``. Under a
    process group a save is collective: the primary process writes (the
    parameters and optimizer state are the same on every process), then
    every process waits at a barrier, so each can read the snapshot and
    the data cursor on resume (the JAX package's collective orbax save)."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        if multihost.is_primary():
            tmp = self._path(step) + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self._path(step))  # a reader never sees a half-written file
        multihost.barrier()

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
