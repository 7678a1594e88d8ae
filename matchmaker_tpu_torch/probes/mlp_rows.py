"""The row-packed fused MLP probe: counterpart of
``benchmarks/mlp_rows_probe.py`` and of its TPU kernels K17
(``_mlp_kernel_rows2d``) and K18 (``_mlp_kernel_rowsblk``).

Both compute the MLP half y = LN(x + gelu(x·W1 + b1)·W2 + b2) (eps 1e-12)
on x (B, L, 768) bf16, W1 (768, FF) and W2 (FF, 768) bf16 in the JAX
probe's layout, f32 biases and LayerNorm parameters; gelu is the one K2
takes for the dtype (the FMA-only polynomial for bf16). They differ in how
they pad the rows, and the wrappers keep the JAX paddings and slices:

- :func:`mlp_rows2d` (K17) pads L to a multiple of 8 and B to a multiple of
  ``block_b``, then runs whole padded examples as rows;
- :func:`mlp_rowsblk` (K18) flattens x to (B·L, 768) rows and pads them to
  a multiple of ``block_r`` (1024 or 2048).

CUDA tensors run both through one kernel, ``csrc/probe_mlp_rows.cu``, whose
row tile ``row_tile`` (16, 32 or 64 rows a block) keeps gelu(x·W1 + b1) and
the pre-LN sums on chip; CPU tensors run :func:`reference_mlp_rows` on the
padded rows.

    python -m matchmaker_tpu_torch.probes.mlp_rows [--batch 128] [--iters 30] [--device cpu]

times, at the JAX probe's training shapes (2·batch, 200) and (batch, 32),
K2's ``fused_mlp_block`` (``prod_3d``), each wrapper at each row tile
(``rows2d``, ``rowsblk_1024``, ``rowsblk_2048``, keyed by ``r16``/``r32``/
``r64``) and the plain chain of two bf16 ``torch.matmul`` calls, gelu and
``layer_norm`` (``chain``: no single PyTorch call computes the function),
and prints one JSON line: per shape each row's {ms, tflops, eff_vs_peak}
against the H100's 989 TFLOP/s and its max |y − y_prod_3d|.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from matchmaker_tpu_torch.ops import _build
from matchmaker_tpu_torch.ops import fused_attention as fa
from matchmaker_tpu_torch.probes import card, device_of, median_ms, rate

ROW_TILES = (16, 32, 64)
_KERNEL_HID = 768
_KERNEL_FF_CHUNK = 128


def reference_mlp_rows(x, w1, b1, w2, b2, g, be, ln_eps: float = 1e-12) -> torch.Tensor:
    """Plain version of K17 and K18 (padding changes no live row): K2's,
    f32 sums of both products, gelu for x's dtype, the gelu output rounded
    to x's dtype, the LayerNorm in f32; (..., L, HID) in x's dtype."""
    return fa.reference_mlp_block(x, w1, b1, w2, b2, g, be, ln_eps)


def _mlp_rows(x2, w1, b1, w2, b2, g, be, ln_eps, row_tile, counter):
    """(N, HID) rows through the kernel on the card, the plain version on
    the CPU."""
    if not x2.is_cuda:
        return reference_mlp_rows(x2[None], w1, b1, w2, b2, g, be, ln_eps)[0]
    n, hid = x2.shape
    ff = w1.shape[1]
    if (hid != _KERNEL_HID or ff % _KERNEL_FF_CHUNK or tuple(w1.shape) != (hid, ff) or tuple(w2.shape) != (ff, hid)
            or b1.numel() != ff or any(t.numel() != hid for t in (b2, g, be))):
        raise ValueError(f"{counter}: the CUDA kernel takes hid {_KERNEL_HID}, FF % {_KERNEL_FF_CHUNK} == 0 and "
                         f"matching weights, got x {tuple(x2.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
                         f"b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}, g {tuple(g.shape)}, be {tuple(be.shape)}")
    if row_tile not in ROW_TILES:
        raise ValueError(f"{counter}: row_tile is one of {ROW_TILES}, got {row_tile}")
    x2 = x2.contiguous()
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        _build.check_cuda(t, f"{counter}.{name}", torch.bfloat16)
    # held in names until the launch: the kernel reads them on the stream
    vecs = [t.to(torch.float32).contiguous() for t in (b1, b2, g, be)]
    with torch.cuda.device(x2.device):
        out = torch.empty_like(x2)
        _build.call("mm_probe_mlp_rows", _build.ptr(x2), _build.ptr(w1), _build.ptr(vecs[0]), _build.ptr(w2),
                    _build.ptr(vecs[1]), _build.ptr(vecs[2]), _build.ptr(vecs[3]), _build.ptr(out), n, ff,
                    float(ln_eps), row_tile, _build.stream(x2.device))
    _build.LAUNCHES[counter] += 1
    return out


def mlp_rows2d(x, w1, b1, w2, b2, g, be, ln_eps: float = 1e-12, block_b: int = 8, row_tile: int = 64):
    """K17: L padded to a multiple of 8, B to a multiple of ``block_b``,
    whole padded examples as rows; the output sliced back to (B, L, HID)."""
    b, l, hid = x.shape
    l_pad = -(-l // 8) * 8
    b_pad = -(-b // block_b) * block_b
    if (l_pad, b_pad) != (l, b):
        x = torch.nn.functional.pad(x, (0, 0, 0, l_pad - l, 0, b_pad - b))
    out = _mlp_rows(x.reshape(b_pad * l_pad, hid), w1, b1, w2, b2, g, be, ln_eps, row_tile, "mlp_rows2d")
    return out.reshape(b_pad, l_pad, hid)[:b, :l]


def mlp_rowsblk(x, w1, b1, w2, b2, g, be, ln_eps: float = 1e-12, block_r: int = 1024, row_tile: int = 64):
    """K18: x flattened to (B·L, HID) rows padded to a multiple of
    ``block_r``; the output sliced back to (B, L, HID)."""
    b, l, hid = x.shape
    n = b * l
    n_pad = -(-n // block_r) * block_r
    x2 = x.reshape(n, hid)
    if n_pad != n:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, n_pad - n))
    out = _mlp_rows(x2, w1, b1, w2, b2, g, be, ln_eps, row_tile, "mlp_rowsblk")
    return out[:n].reshape(b, l, hid)


def matmul_chain(x, w1, b1, w2, b2, g, be, ln_eps: float = 1e-12) -> torch.Tensor:
    """The same function as plain library calls in x's dtype: two
    ``torch.matmul``, gelu, the residual and ``layer_norm`` (the yardstick
    the probe times; the port never calls it)."""
    h = torch.nn.functional.gelu(torch.matmul(x, w1).float() + b1).to(x.dtype)
    acc = torch.matmul(h, w2).float() + b2 + x.float()
    return torch.nn.functional.layer_norm(acc, (x.shape[-1],), g, be, ln_eps).to(x.dtype)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hid", type=int, default=_KERNEL_HID)
    ap.add_argument("--ff", type=int, default=3072)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    hid, ff = args.hid, args.ff
    rng = np.random.default_rng(args.seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device, dtype)

    bf = torch.bfloat16
    w1, w2 = t(rng.normal(0, 0.02, (hid, ff)), bf), t(rng.normal(0, 0.02, (ff, hid)), bf)
    b1, b2 = t(rng.normal(0, 0.02, (ff,))), t(rng.normal(0, 0.02, (hid,)))
    g, be = torch.ones(hid, device=device), torch.zeros(hid, device=device)
    weights = (w1, b1, w2, b2, g, be)

    shapes = []
    for b, l in ((2 * args.batch, 200), (args.batch, 32)):  # the packed triple's docs, then its queries
        x = t(rng.normal(0, 1, (b, l, hid)), bf)
        flops = 4 * b * l * hid * ff  # two products, 2 flops a multiply-add
        rows = {"prod_3d": lambda: fa.fused_mlp_block(x, *weights)}
        for r in ROW_TILES:
            rows[f"rows2d/r{r}"] = lambda r=r: mlp_rows2d(x, *weights, row_tile=r)
            for block_r in (1024, 2048):
                rows[f"rowsblk_{block_r}/r{r}"] = lambda r=r, br=block_r: mlp_rowsblk(x, *weights, block_r=br,
                                                                                         row_tile=r)
        rows["chain"] = lambda: matmul_chain(x, *weights)
        ref = rows["prod_3d"]().float()
        entry = {"shape": [b, l, hid], "gflop": flops / 1e9}
        for name, fn in rows.items():
            timed = rate(flops, median_ms(fn, device, args.iters), "bf16", device)
            timed["max_abs_vs_prod_3d"] = float((fn().float() - ref).abs().max())
            key, _, tile = name.partition("/")
            if tile:
                entry.setdefault(key, {})[tile] = timed
            else:
                entry[key] = timed
        shapes.append(entry)
    result = {"shapes": shapes, "device": card(device)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
