"""flax ``nn.Conv`` channels last, over a sequence (Conv-KNRM's n-gram
convolutions, IDCM's CK sampler convolution, Duet's VALID convolutions) and
over a match matrix (PACRR's and MatchPyramid's n x n convolutions).

flax's explicit padding ``[(0, n - 1)]`` pads right (and bottom) only, so
the output is as large as the input; ``nn.Conv1d(padding=...)`` would pad
both sides. ``"VALID"`` pads nothing. The input is promoted with the f32
parameters, as flax does. The product is a sum of full-f32 products of the
shifted input (``ops.matmul_f32``), one a kernel tap, never TF32: these
convolutions read cosine matrices and feed the kernel pooling's
exact-match kernel (sigma 1e-4), where an exact match sits at 1.0, and
cuDNN's f32 convolutions run as TF32 by default on a card. A sequence
kernel is stored (out, in, n), as ``nn.Conv1d`` stores its weight (flax's
(n, in, out), models/weights.py); a matrix kernel keeps flax's (kh, kw,
in, out).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import matmul_f32


class SequenceConv(nn.Module):
    def __init__(self, in_features: int, out_features: int, width: int, valid: bool = False):
        super().__init__()
        self.width = width
        self.valid = valid
        self.kernel = nn.Parameter(torch.empty(out_features, in_features, width))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, in) → (B, L, out), f32; ``valid``: (B, L - width + 1, out)."""
        if self.valid:
            padded, length = x.float(), x.shape[1] - self.width + 1
        else:
            padded, length = F.pad(x.float(), (0, 0, 0, self.width - 1)), x.shape[1]
        y = matmul_f32(padded[:, :length], self.kernel[:, :, 0].t())
        for j in range(1, self.width):
            y = y + matmul_f32(padded[:, j: j + length], self.kernel[:, :, j].t())
        return y + self.bias


class MatrixConv(nn.Module):
    """A (kh, kw) convolution over (B, H, W, in), padded right and bottom
    (flax ``padding=[(0, kh - 1), (0, kw - 1)]``) → (B, H, W, out), f32."""

    def __init__(self, in_features: int, out_features: int, kh: int, kw: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        kh, kw = self.kernel.shape[:2]
        padded = F.pad(x.float(), (0, 0, 0, kw - 1, 0, kh - 1))
        y = self.bias
        for a in range(kh):
            for b in range(kw):
                y = y + matmul_f32(padded[:, a: a + h, b: b + w], self.kernel[a, b])
        return y
