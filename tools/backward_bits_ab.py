#!/usr/bin/env python3
"""Whether two checkouts' backward halves (K11, K12) give the same bits.

    python3 tools/backward_bits_ab.py OLD NEW

OLD and NEW are checkouts of the port (for instance the parent commit
unpacked with ``git archive`` under ``build/``). Each runs in its own
process (each builds its own kernels): K11 and K12 at DistilBERT width
(hidden 768, 12 heads, FF 3,072) over (64, 200) rows, one example's keys
masked past 120, inputs from a seeded generator on the card, after each
half's training forward. Prints whether every gradient is equal bit for
bit and a JSON line last; exit 1 if any differs. Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HID, FF, HEADS, B, L = 768, 3072, 12, 64, 200
NAMES = ("mlp.dx", "mlp.dw1", "mlp.db1", "mlp.dw2", "mlp.db2", "mlp.dg", "mlp.dbe", "attn.dx", "attn.dwqkv",
         "attn.dbqkv", "attn.dwo", "attn.dbo", "attn.dg", "attn.dbe")


def one_tree(tree: str, out: str) -> None:
    """K11 and K12 of the checkout ``tree`` on the seeded inputs, saved to ``out``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from matchmaker_tpu_torch.ops import fused_backward as fb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * shape[0] ** -0.5).to(torch.bfloat16)

    def v(n, std=0.05, mean=0.0):
        return torch.randn(n, generator=g, device=dev) * std + mean

    x, dy = w(B, L, HID) * HID ** 0.5, w(B, L, HID) * HID ** 0.5
    wqkv, bqkv, wo, bo = w(HID, 3 * HID), v(3 * HID), w(HID, HID), v(HID)
    w1, b1, w2, b2 = w(HID, FF), v(FF), w(FF, HID), v(HID)
    ga, ba, gm, bm = v(HID, 0.1, 1.0), v(HID, 0.1), v(HID, 0.1, 1.0), v(HID, 0.1)
    mask = torch.ones(B, L, device=dev)
    mask[0, 120:] = 0
    _, m_saved = fb.mlp_block_fwd(x, w1, b1, w2, b2, gm, bm)
    _, a_saved = fb.attention_block_fwd(x, wqkv, bqkv, wo, bo, mask, HEADS, ga, ba)
    grads = (list(fb.mlp_block_bwd(x, w1, b1, w2, gm, dy, m_saved))
             + list(fb.attention_block_bwd(x, wqkv, bqkv, wo, mask, HEADS, ga, dy, a_saved)))
    torch.save([t.cpu() for t in grads], out)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) == 3 and args[0] == "--one":
        one_tree(args[1], args[2])
        return 0
    if len(args) != 2:
        print(__doc__)
        return 2
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.pt") for i in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--one", tree, out])
                 for tree, out in zip(args, outs)]
        codes = [p.wait() for p in procs]
        if any(codes):
            print(f"a tree failed: exit codes {codes}")
            return 1
        old, new = (torch.load(o) for o in outs)
    same = {name: bool(torch.equal(a, b)) for name, a, b in zip(NAMES, old, new)}
    for name, eq in same.items():
        print(f"{name}: {'identical' if eq else 'DIFFERS'}")
    print(json.dumps({"identical": all(same.values()), "gradients": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
