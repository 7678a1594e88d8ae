"""Multi-process bootstrap and collectives: counterpart of
``matchmaker_tpu/parallel/multihost.py`` on ``torch.distributed``.

The JAX package wires its processes into one runtime whose devices every
program spans. PyTorch keeps one process a card instead (DDP's idiom): each
process runs the same CLI on its own card, and the processes meet in
collectives of one ``torch.distributed`` process group.

Launch contract (the JAX package's): every process gets

    MATCHMAKER_COORDINATOR   host:port of process 0 (required to activate)
    MATCHMAKER_NUM_PROCESSES total process count
    MATCHMAKER_PROCESS_ID    this process's rank (0-based)

and, when the processes span more than one host, the count on each host:

    MATCHMAKER_LOCAL_PROCESSES  processes on this host (else torchrun's
                                LOCAL_WORLD_SIZE; else all of them, one host)

and :func:`maybe_initialize_distributed` calls
``torch.distributed.init_process_group(init_method="tcp://host:port")``.
``MATCHMAKER_MULTIHOST=tpu_pod`` (a TPU pod's metadata server) means nothing
on a GPU machine and is refused.

Backend rule (printed at start-up): ``nccl`` when every rank has a card of
its own (CUDA is available and this host's process count is at most its
visible cards), else ``gloo``: on the CPU, and for two or more ranks on one
card, which NCCL refuses ("Duplicate GPU detected"). Every host must run
the same number of processes, so that every rank takes the same backend,
and ranks are numbered host by host. A gloo group's collectives on CUDA
tensors go through host memory (:func:`all_gather`, :func:`all_reduce_sum`
copy there and back); the compute stays on the card. A rank's card is
``cuda:(rank % device_count)``, made the current device.

Data placement: each process reads only its rows of the global batch (the
loaders' ``process_stride``); :func:`per_process_batch` and
:func:`process_shard_bounds` are the arithmetic, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch


def _dist():
    import torch.distributed as dist

    return dist


def local_process_count(n_processes: int) -> int:
    """Processes on this host: ``MATCHMAKER_LOCAL_PROCESSES``, else
    ``LOCAL_WORLD_SIZE``, else ``n_processes`` (every process on one host)."""
    for name in ("MATCHMAKER_LOCAL_PROCESSES", "LOCAL_WORLD_SIZE"):
        if os.environ.get(name):
            return int(os.environ[name])
    return n_processes


def backend_rule(n_local: int) -> str:
    """``nccl`` when each of this host's ``n_local`` ranks can have a card
    of its own, else ``gloo``."""
    if torch.cuda.is_available() and n_local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: Optional[int] = None) -> torch.device:
    """The card of a rank: ``cuda:(rank % device_count)``."""
    rank = process_index() if rank is None else rank
    if not torch.cuda.is_available():
        raise RuntimeError(f"process {rank} asked for a CUDA card, but none is visible (device: cpu runs on the CPU)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def maybe_initialize_distributed(config=None) -> bool:
    """Join the process group when the launch contract's variables are set;
    a no-op (False) without them. Idempotent. ``config``'s ``device: cpu``
    keeps the ranks on the CPU (gloo, no card chosen)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = os.environ.get("MATCHMAKER_COORDINATOR")
    if os.environ.get("MATCHMAKER_MULTIHOST", "") == "tpu_pod":
        raise ValueError("MATCHMAKER_MULTIHOST=tpu_pod reads a TPU pod's metadata server, which a GPU machine "
                         "has not: launch one process a card with MATCHMAKER_COORDINATOR, "
                         "MATCHMAKER_NUM_PROCESSES and MATCHMAKER_PROCESS_ID")
    if not coordinator:
        return False
    num = int(os.environ["MATCHMAKER_NUM_PROCESSES"])
    pid = int(os.environ["MATCHMAKER_PROCESS_ID"])
    on_cpu = config is not None and str(config.get("device", "cuda")).startswith("cpu")
    name = "gloo" if on_cpu else backend_rule(local_process_count(num))
    on_card = torch.cuda.is_available() and not on_cpu
    if on_card:
        torch.cuda.set_device(rank_device(pid))
    dist.init_process_group(name, init_method=f"tcp://{coordinator}", world_size=num, rank=pid)
    where = str(rank_device(pid)) if on_card else "cpu"
    print(f"[multihost] process {pid}/{num} up on {where}, backend {name} "
          f"(nccl when every rank has a card of its own, else gloo)", flush=True)
    return True


def is_distributed() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns logging and run-folder writes."""
    return process_index() == 0


def backend() -> Optional[str]:
    dist = _dist()
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def per_process_batch(global_batch: int) -> int:
    """Rows this process produces of a ``global_batch``-row batch; the
    global batch must divide evenly (an imbalance would skew the in-batch
    negatives and the gradient average)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def process_shard_bounds(n_items: int, n_processes: Optional[int] = None,
                         pid: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of the ``n_items`` this process owns; the remainder goes to
    the last process, every item to exactly one."""
    n = n_processes if n_processes is not None else process_count()
    p = pid if pid is not None else process_index()
    per = n_items // n
    lo = p * per
    hi = n_items if p == n - 1 else lo + per
    return lo, hi


def on_primary(fn):
    """``fn()`` run by the primary process alone, its (picklable) result
    handed to every process: e.g. the run folder the primary creates."""
    if not is_distributed():
        return fn()
    box = [fn() if is_primary() else None]
    _dist().broadcast_object_list(box, src=0)
    return box[0]


def all_gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` outside a
    process group)."""
    if not is_distributed():
        return [obj]
    out = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def barrier() -> None:
    if is_distributed():
        _dist().barrier()


def _via_host(t: torch.Tensor) -> bool:
    return t.is_cuda and backend() == "gloo"


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's tensor (same shape on every rank), in rank order, on
    ``t``'s device; ``[t]`` outside a process group. No gradient."""
    if not is_distributed():
        return [t]
    src = t.detach().cpu() if _via_host(t) else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(process_count())]
    _dist().all_gather(out, src)
    return [o.to(t.device) for o in out]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t`` (a new tensor on ``t``'s device)."""
    if not is_distributed():
        return t
    buf = t.detach().cpu().clone() if _via_host(t) else t.detach().clone()
    _dist().all_reduce(buf)
    return buf.to(t.device)


class _GatherWithGrad(torch.autograd.Function):
    """Concatenation of every rank's rows along dim 0, in rank order; the
    backward gives each rank the sum over ranks of the gradient at its own
    rows (each rank's loss reads every rank's rows)."""

    @staticmethod
    def forward(ctx, t):
        ctx.rows = t.shape[0]
        return torch.cat(all_gather(t), dim=0)

    @staticmethod
    def backward(ctx, grad):
        lo = process_index() * ctx.rows
        return all_reduce_sum(grad.contiguous())[lo:lo + ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` concatenated in rank order, differentiable
    (``t`` itself outside a process group)."""
    if not is_distributed():
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherWithGrad.apply(t)
    return torch.cat(all_gather(t), dim=0)


def _reduce_gradients(params: Sequence[torch.Tensor], extra: Optional[torch.Tensor], divisor: int):
    if not is_distributed():
        return extra
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1).float() for g in grads] + ([extra.float().reshape(-1)] if extra is not None else [])
    if not parts:
        return extra
    flat = all_reduce_sum(torch.cat(parts))
    if divisor != 1:
        flat = flat / divisor
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()
    return flat[start:] if extra is not None else None


def average_gradients(params: Sequence[torch.Tensor], extra: Optional[torch.Tensor] = None):
    """Average every parameter's gradient over the ranks in one all-reduce,
    in place; ``extra`` (a float vector) rides along and comes back
    averaged. → the averaged ``extra`` (None without one)."""
    return _reduce_gradients(params, extra, process_count())


def sum_gradients(params: Sequence[torch.Tensor], extra: Optional[torch.Tensor] = None):
    """Sum every parameter's gradient over the ranks in one all-reduce, in
    place; ``extra`` rides along and comes back summed: the train step's,
    whose losses are each process's share of one mean over the global batch
    (losses/global_batch.py). → the summed ``extra`` (None without one)."""
    return _reduce_gradients(params, extra, 1)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` from rank ``src``, in place."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if _via_host(t):
                buf = t.detach().cpu()
                _dist().broadcast(buf, src)
                t.copy_(buf)
            else:
                _dist().broadcast(t.data, src)


def all_have(flag: bool, device: Optional[torch.device] = None) -> bool:
    """True when ``flag`` holds on every rank (an all-reduce of 0/1)."""
    if not is_distributed():
        return flag
    dev = torch.device("cpu") if backend() == "gloo" or device is None else device
    t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=dev)
    _dist().all_reduce(t)
    return int(t.item()) == 0


def lockstep(iterator, device: Optional[torch.device] = None):
    """Items of ``iterator`` while every rank still has one: ranks whose
    loaders hold one batch more than others stop together (a step that one
    rank skipped would leave the others waiting in its collectives)."""
    it = iter(iterator)
    while True:
        try:
            item, have = next(it), True
        except StopIteration:
            item, have = None, False
        if not all_have(have, device):
            return
        yield item


def shutdown() -> None:
    """Leave the process group (the end of a CLI run)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
