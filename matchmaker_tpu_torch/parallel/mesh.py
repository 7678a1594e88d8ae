"""Device mesh and sharding helpers: counterpart of
``matchmaker_tpu/parallel/mesh.py``.

A :class:`Mesh` is a grid of ``torch.device`` entries with named axes, the
analog of JAX's single-controller ``Mesh`` and of faiss's multi-GPU index:

- corpus rows shard over every entry of the mesh (:func:`corpus_axes`):
  entry s holds rows [s·rows, (s+1)·rows) of the padded corpus
  (:func:`shard_rows`), searches them, and the (Q, k) partials merge into
  one top-k (:func:`merge_topk`), ties to the lower place in the
  shard-major concatenation, as ``lax.top_k`` orders JAX's merge;
- batches split over the mesh's distinct devices, each holding a replica of
  the parameters (:func:`batch_sharding`, :func:`shard_params`).

Entries may repeat: eight ``torch.device("cpu")`` entries stand in for the
JAX tests' eight virtual CPU devices, and four ``cuda:0`` entries run the
sharded routes on one card (four shards, four scan launches, one merge).
Shards that share a device are row views of one upload, not copies.

Under a process group (parallel/multihost.py) the mesh spans the processes:
process p holds entries [p·n_local, (p+1)·n_local) of the flat order, its
own card's entries, and the merge all-gathers the partials of every process
first. Parameters never shard inside a process: the port trains one process
a card (ROADMAP.md §3).
"""

from __future__ import annotations

import copy
import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from matchmaker_tpu_torch.ops import topk_lowest_first
from matchmaker_tpu_torch.parallel import multihost


class Mesh:
    """Named axes over this process's device entries (flat order
    ``local_devices``) and, under a process group, every process's: the
    global flat order is process-major."""

    def __init__(self, local_devices: Sequence, axis_names: Sequence[str], shape: Sequence[int],
                 process_count: int = 1, process_index: int = 0):
        self.local_devices = [torch.device(d) for d in local_devices]
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {self.axis_names}")
        if math.prod(shape) != len(self.local_devices) * process_count:
            raise ValueError(f"mesh shape {tuple(shape)} holds {math.prod(shape)} entries, not "
                             f"{len(self.local_devices)} x {process_count} processes")
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.process_count = process_count
        self.process_index = process_index

    @property
    def size(self) -> int:
        return len(self.local_devices) * self.process_count

    @property
    def first_shard(self) -> int:
        """Global index of this process's first entry."""
        return self.process_index * len(self.local_devices)

    @property
    def distinct_devices(self) -> List[torch.device]:
        out = []
        for d in self.local_devices:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, local={[str(d) for d in self.local_devices]}, "
                f"process {self.process_index}/{self.process_count})")


def make_mesh(axis_names: Sequence[str] = ("data",), devices: Optional[Iterable] = None,
              shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A mesh over the given devices, else over ``device`` when it names
    one (``cpu``, ``cuda:1``), this rank's card (a process group), or every
    visible card. The CPU only when asked for: ``cuda`` (the default)
    without a visible card raises. One axis takes every entry; more axes
    need ``shape``."""
    n_proc, pid = multihost.process_count(), multihost.process_index()
    if devices is None:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {device} asked for, but no CUDA card is visible "
                               "(device: cpu runs on the CPU)")
        if device.type == "cpu" or device.index is not None:
            devices = [device]
        elif n_proc > 1:
            devices = [multihost.rank_device(pid)]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("multi-axis mesh requires an explicit shape")
        shape = (len(devices) * n_proc,)
    return Mesh(devices, axis_names, shape, n_proc, pid)


def corpus_axes(mesh: Mesh):
    """The axes corpus rows shard over: all of them, as one composite axis."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else names


def axis_size(mesh: Mesh, axis) -> int:
    """Entries along ``axis`` (a name or a tuple of names)."""
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return int(mesh.shape[axis])


def n_shards(mesh: Optional[Mesh]) -> int:
    """Shards of a corpus over ``mesh``: the size of its corpus axes."""
    return 1 if mesh is None else axis_size(mesh, corpus_axes(mesh))


class BatchSharding:
    """Rows of a batch split over the mesh's distinct local devices, in
    contiguous runs (the first devices take one row more when the rows do
    not divide)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)

    def split(self, n_rows: int) -> List[Tuple[int, int]]:
        n = len(self.devices)
        per, extra = divmod(n_rows, n)
        bounds, lo = [], 0
        for i in range(n):
            hi = lo + per + (1 if i < extra else 0)
            bounds.append((lo, hi))
            lo = hi
        return bounds


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Split the leading (batch) dimension over the mesh's distinct devices."""
    return BatchSharding(mesh.distinct_devices)


def shard_params(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One replica of ``module`` a distinct device of the mesh (the first is
    ``module`` itself, moved to the first device)."""
    devices = mesh.distinct_devices
    replicas = [module.to(devices[0])]
    for d in devices[1:]:
        replicas.append(copy.deepcopy(module).to(d))
    return replicas


_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.int8: np.int8,
                 torch.int32: np.int32, torch.int64: np.int64}


def host_rows(array: np.ndarray, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``array`` as a contiguous CPU tensor, cast to ``dtype`` on the host
    where numpy has that type, so the upload moves the stored bytes only
    (bfloat16 is cast on the device after the upload)."""
    return torch.from_numpy(np.ascontiguousarray(array, dtype=_NUMPY_DTYPES.get(dtype)))


class ShardedRows:
    """This process's shards of one row-padded array: ``parts[i]`` is global
    shard ``first + i``, ``rows`` rows each, of ``n_shards`` in all."""

    def __init__(self, parts: List[torch.Tensor], rows: int, first: int, n_shards: int):
        self.parts, self.rows, self.first, self.n_shards = parts, rows, first, n_shards

    def __iter__(self):
        for i, part in enumerate(self.parts):
            yield self.first + i, part

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts)


def shard_rows(mesh: Mesh, array, dtype: Optional[torch.dtype] = None,
               padded_rows: Optional[int] = None) -> ShardedRows:
    """Split ``array`` (numpy or tensor), zero-padded to ``padded_rows``
    rows (a multiple of the mesh size; default its own rows), into this
    process's row shards, each on its mesh entry's device, cast to
    ``dtype``. Consecutive entries on one device are views of one upload;
    a CUDA view starts 16-byte aligned (the scans build TMA descriptors on
    it), which the callers' padding grains keep."""
    real = array.shape[0]
    n = real if padded_rows is None else padded_rows
    size = mesh.size
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} mesh entries")
    rows = n // size
    local = mesh.local_devices
    parts: List[torch.Tensor] = []
    i = 0
    while i < len(local):
        j = i
        while j + 1 < len(local) and local[j + 1] == local[i]:
            j += 1
        lo, hi = (mesh.first_shard + i) * rows, (mesh.first_shard + j + 1) * rows
        block = array[min(lo, real):min(hi, real)]
        block = host_rows(block, dtype) if isinstance(block, np.ndarray) else block
        block = block.to(local[i])
        if dtype is not None:
            block = block.to(dtype)
        if block.shape[0] < hi - lo:  # the zero rows past the real ones
            block = torch.cat([block, block.new_zeros((hi - lo - block.shape[0],) + tuple(block.shape[1:]))])
        block = block.contiguous()
        for s in range(j - i + 1):
            view = block[s * rows:(s + 1) * rows]
            if view.is_cuda and view.numel() and view.data_ptr() % 16:
                raise ValueError(f"shard {mesh.first_shard + i + s}: a {rows}-row view is not 16-byte aligned")
            parts.append(view)
        i = j + 1
    return ShardedRows(parts, rows, mesh.first_shard, size)


def pad_partial(vals: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's (Q, < k) partial padded to (Q, k) with -inf / -1."""
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return vals, ids


def merge_topk(partials: List[Tuple[torch.Tensor, torch.Tensor]], k: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One top-k over every shard's (Q, k) partial, this process's moved to
    ``device`` and, under a process group, every process's gathered first
    (process-major, so the concatenation is shard-major); ties go to the
    lower place, as ``lax.top_k`` merges JAX's shards. → (values, ids)"""
    vals = torch.cat([v.to(device) for v, _ in partials], dim=1)
    ids = torch.cat([i.to(device) for _, i in partials], dim=1)
    if multihost.is_distributed():
        vals = torch.cat(multihost.all_gather(vals), dim=1)
        ids = torch.cat(multihost.all_gather(ids), dim=1)
    v, pos = topk_lowest_first(vals, min(k, vals.shape[1]))
    return v, torch.gather(ids, 1, pos)
