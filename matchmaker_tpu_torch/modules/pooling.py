"""Pooling / misc NN utilities shared by the classic IR models: counterpart
of ``matchmaker_tpu/modules/pooling.py``, in plain PyTorch.

``unfold_chunks`` cuts the chunk models' documents (models/adapters.py,
models/parade.py); the rest serves the kernel-pooling family."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def masked_softmax(x: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over ``dim`` with masked entries excluded."""
    neg = torch.where(mask > 0, 0.0, -1e9)
    shifted = x + neg
    e = torch.exp(shifted - shifted.amax(dim=dim, keepdim=True).detach())
    e = e * (mask > 0)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1e-10)


def topk_values(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """Top-k values (sorted descending) along ``dim``, moved to the last axis."""
    if dim != -1:
        x = torch.movedim(x, dim, -1)
    return torch.topk(x, k, dim=-1).values


def _adaptive_windows(n: int, out: int, device):
    """Cell i of an adaptive pooling spans [floor(i·n/out), ceil((i+1)·n/out)):
    (out, width) indices of each cell's positions (clamped past its end) and
    which of them lie inside it."""
    starts = torch.tensor([(i * n) // out for i in range(out)], device=device)
    ends = torch.tensor([-(-((i + 1) * n) // out) for i in range(out)], device=device)
    width = int((ends - starts).max())
    idx = starts[:, None] + torch.arange(width, device=device)[None, :]
    return torch.minimum(idx, ends[:, None] - 1), idx < ends[:, None]


def adaptive_max_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """AdaptiveMaxPool2d on (B, H, W, C): cell (i, j) spans [floor(i·H/oh),
    ceil((i+1)·H/oh)) x [floor(j·W/ow), ceil((j+1)·W/ow)). All cells in one
    gather, the positions outside a cell set to -inf; the gradient of the
    max is split evenly among a cell's ties, as jnp's is."""
    rows, row_in = _adaptive_windows(x.shape[1], out_hw[0], x.device)
    cols, col_in = _adaptive_windows(x.shape[2], out_hw[1], x.device)
    cells = x[:, rows][:, :, :, cols]  # (B, oh, kh, ow, kw, C)
    inside = row_in[:, :, None, None] & col_in[None, None, :, :]
    return cells.masked_fill(~inside[None, ..., None], float("-inf")).amax(dim=(2, 4))  # (B, oh, ow, C)


def sliding_window_max(x: torch.Tensor, window: int, stride: int = 1) -> torch.Tensor:
    """1D max pooling over the middle axis of (B, L, C), no padding."""
    return x.unfold(1, window, stride).amax(dim=-1)


def sliding_window_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Right-padded rolling mean over axis 1 of (B, L, C), output length L."""
    padded = F.pad(x, (0, 0, 0, window - 1))
    return padded.unfold(1, window, 1).sum(dim=-1) / window


def unfold_chunks(x: torch.Tensor, chunk: int, overlap: int) -> torch.Tensor:
    """Split (B, L, ...) into overlapping windows of ``overlap + chunk +
    overlap`` with stride ``chunk``: (B, n_chunks, ext, ...), zero padded
    ``overlap`` in front and up to ``n_chunks·chunk + overlap`` behind."""
    l = x.shape[1]
    ext = chunk + 2 * overlap
    n_chunks = -(-l // chunk)
    pad_len = overlap + n_chunks * chunk + overlap - l
    widths = [0, 0] * (x.dim() - 2) + [overlap, pad_len - overlap]
    padded = F.pad(x, widths)
    return torch.stack([padded[:, i * chunk: i * chunk + ext] for i in range(n_chunks)], dim=1)
