#!/usr/bin/env python3
"""The LayerNorm backward of K11 and K12, two checkouts on one card, in turns.

    python3 tools/ln_bwd_ab.py BASE_DIR NEW_DIR [--turns ABBA] [--reps 20] [--out ab.json]

Each turn imports the port from one checkout (its kernels built from that
checkout's sources into its own ``build/``), runs K11's training forward
and then its backward (``ops/fused_backward.py:mlp_block_bwd``, one C call)
at every (hidden, B, L) of ``SHAPES`` under torch.profiler, and reports
the device time of the LayerNorm-backward kernels alone (the kernels whose
names hold ``ln_bwd``) per call, and the whole call's device time. The
widths are the ones the warp-a-row kernel served before any width past
1,024 ran: TinyBERT's 312 (a masked tail), DistilBERT's 768 and
BERT-large's 1,024, at the training shapes (64, 200) and (32, 30) and the
encode shape (256, 128). ``--device cpu --tiny`` rehearses the turns on
the CPU (the plain versions; no device times).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ab_turns  # noqa: E402

SHAPES = [(hid, b, l) for hid in (312, 768, 1024) for b, l in ((64, 200), (32, 30), (256, 128))]
TINY = [(40, 2, 5), (64, 3, 7)]


def _ln_ms(prof_rows, reps):
    ln = sum(us for name, us, _ in prof_rows if "ln_bwd" in name)
    return ln / 1e3 / reps, sum(us for _, us, _ in prof_rows) / 1e3 / reps


def run_turn(checkout: str, reps: int, device: str, tiny: bool) -> dict:
    ab_turns.import_port(checkout)
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_backward as fb

    dev = torch.device(device)
    if dev.type == "cuda":
        _build.library()
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import chip_smoke
    ln, call = {}, {}
    for hid, b, l in TINY if tiny else SHAPES:
        ff = 4 * hid
        g = torch.Generator(device=dev).manual_seed(hid + b + l)

        def rand(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=g, device=dev) * std).to(dtype)

        x, dy = rand(b, l, hid), rand(b, l, hid)
        w1, w2 = rand(hid, ff, std=hid ** -0.5), rand(ff, hid, std=ff ** -0.5)
        b1, b2 = rand(ff, std=0.05, dtype=torch.float32), rand(hid, std=0.05, dtype=torch.float32)
        gamma, beta = rand(hid, std=0.1, dtype=torch.float32) + 1, rand(hid, std=0.1, dtype=torch.float32)
        _, saved = fb.mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta)
        key = f"hid {hid} B {b} L {l}"
        fn = lambda: fb.mlp_block_bwd(x, w1, b1, w2, gamma, dy, saved)  # noqa: E731
        if dev.type != "cuda":
            fn()
            ln[key] = call[key] = None
            continue
        from torch.profiler import ProfilerActivity, profile

        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ln[key], call[key] = _ln_ms(chip_smoke._kernel_times(prof), reps)
    return {"ms": ln, "call_device_ms": call, "shapes": [list(s) for s in (TINY if tiny else SHAPES)]}


if __name__ == "__main__":
    sys.exit(ab_turns.main(argparse.ArgumentParser(description=__doc__,
                                                   formatter_class=argparse.RawDescriptionHelpFormatter),
                           run_turn, kinds=("call_device_ms",)))
