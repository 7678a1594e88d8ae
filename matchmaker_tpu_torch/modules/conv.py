"""flax ``nn.Conv`` over a sequence, channels last: Conv-KNRM's n-gram
convolutions and IDCM's CK sampler convolution.

flax pads ``[(0, n - 1)]``, right only, so the output is as long as the
input; ``nn.Conv1d(padding=...)`` would pad both sides. The input is
promoted with the f32 parameters, as flax does. The product is a sum of
``n`` full-f32 products of the shifted input (``ops.matmul_f32``), never
TF32: these convolutions feed the kernel pooling's exact-match kernel
(sigma 1e-4), and cuDNN's f32 convolutions run as TF32 by default on a
card. The kernel is stored (out, in, n), as ``nn.Conv1d`` stores its
weight (flax's (n, in, out), models/weights.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from matchmaker_tpu_torch.ops import matmul_f32


class SequenceConv(nn.Module):
    def __init__(self, in_features: int, out_features: int, width: int):
        super().__init__()
        self.width = width
        self.kernel = nn.Parameter(torch.empty(out_features, in_features, width))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, in) → (B, L, out), f32."""
        length = x.shape[1]
        padded = F.pad(x.float(), (0, 0, 0, self.width - 1))
        y = matmul_f32(padded[:, :length], self.kernel[:, :, 0].t())
        for j in range(1, self.width):
            y = y + matmul_f32(padded[:, j: j + length], self.kernel[:, :, j].t())
        return y + self.bias
