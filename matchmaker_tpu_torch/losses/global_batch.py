"""Means over a batch that is split across processes.

JAX's multi-process step is one program over the global batch: each loss is
one mean over every process's rows (``matchmaker_tpu/losses/pairwise.py``
``_masked_mean``). In the port each process steps on its own rows, so a
loss term divides this process's sum by the global batch's count, and the
step sums the processes' gradients: the shares add up to JAX's mean
whatever each process holds of a padded last batch, none included.

The train step builds a :class:`GlobalBatch` once a step and hands it to
the losses; :data:`LOCAL` (one process, the default) divides by the
process's own counts, as the single-process losses always have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


def _own(n: torch.Tensor) -> torch.Tensor:
    return n


@dataclass(frozen=True)
class GlobalBatch:
    # the global batch's count of valid rows, all-reduced once before the forward
    valid_rows: Optional[torch.Tensor] = None
    # every process holds as many rows: the global batch's rows are a process's x this
    processes: int = 1
    # a count of this process's valid elements -> the global batch's (an all-reduce)
    count: Callable[[torch.Tensor], torch.Tensor] = _own

    def valid_count(self, valid: torch.Tensor) -> torch.Tensor:
        """The global batch's valid rows, of which ``valid`` is this
        process's (B,) mask."""
        return valid.sum() if self.valid_rows is None else self.valid_rows

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """This process's share of the mean over every process's
        equal-shaped ``t``."""
        return t.mean() if self.processes == 1 else t.sum() / (t.numel() * self.processes)

    def rows(self, n: int) -> int:
        """The global batch's rows, of which a process holds ``n``."""
        return n * self.processes

    @property
    def share(self) -> float:
        """A process's share of a term that every process computes whole."""
        return 1.0 / self.processes


LOCAL = GlobalBatch()
