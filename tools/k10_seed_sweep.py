#!/usr/bin/env python3
"""Seed sweep of the int8 halves' card test (K10, K9) on one card.

    python3 tools/k10_seed_sweep.py [--seeds 32] [--out FILE]

For every case of ``tests/test_torch_kernels_cuda.py::test_int8_halves_kernels_match_plain``
((B, L) x (HID, FF)) and every seed in ``range(--seeds)`` plus the test's
own, the inputs come from that test's ``_int8_case`` (seeded
``torch.Generator``s). K10 and K9 and their plain versions each run twice.
Per case: whether each gave the same bits twice, the mean and max
|kernel - plain| of the first runs, and the seeds past the test's 5e-5
mean bar. K9 at every shape up to (16, 77) and past the bar: its gelu
codes and scales against the card's, for the plain version (whose gelu
fuses its multiply-adds as the kernel does) and for the same with them
rounded twice. For K10 each seed past the bar is broken into stages: the card path's
launches (x's codes, the QKV product, the attention core, the core's codes
and scales, the pre-LN sums, the output) against the plain version's same
stages, and the plain version's tail run from the card's attention-core
output (when that tail equals the kernel's output, the flips come from
the core). The card's name and power limit, one line per case, then one
JSON line; the whole record goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(b, l, hid, ff) for hid, ff in ((768, 3072), (1024, 4096))
         for b, l in ((4, 128), (3, 200), (5, 30), (256, 128), (16, 77), (1, 5))]
MEAN_BAR = 5e-5


def _card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def plain_stages(x, wqq, sq, wkq, sk, wvq, sv, woq, so, bq, bk, bv, bo, mask, n_heads, ln_scale, ln_bias,
                 core=None, group_heads=2):
    """``fused_int8.reference_attention_int8_block`` step for step, its
    stages kept; ``core`` (M, HID) f32 takes the place of the attention
    core's output when given."""
    import torch

    from matchmaker_tpu_torch.ops import matmul_codes, matmul_f32
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.ops.fused_attention import _layer_norm_f32

    b, l, hid = x.shape
    d = hid // n_heads
    xf = x.float().reshape(b * l, hid)
    neg = (mask.float() - 1.0) * 1e9
    acc = xf + bo.float()
    xq, rs = fi._quant_rows(xf)
    gw = group_heads * d
    qkv, cores, aqs, ass = [[], [], []], [], [], []
    for g in range(n_heads // group_heads):
        gl = slice(g * gw, (g + 1) * gw)

        def proj(wq_, s_, b_):
            h = (matmul_codes(xq, wq_[:, gl]) * (rs * s_[gl].float()) + b_[gl].float()).to(x.dtype)
            return h.reshape(b, l, group_heads, d).transpose(1, 2)

        qg, kg, vg = proj(wqq, sq, bq), proj(wkq, sk, bk), proj(wvq, sv, bv)
        for i, t in enumerate((qg, kg, vg)):
            qkv[i].append(t.transpose(1, 2).reshape(b * l, gw))
        if core is None:
            s = matmul_f32(qg, kg.transpose(-1, -2)) * (1.0 / d ** 0.5)
            s = s + neg[:, None, None, :]
            s = s - s.amax(dim=-1, keepdim=True)
            p = torch.exp(s)
            p = p / p.sum(dim=-1, keepdim=True)
            a = matmul_f32(p, vg).transpose(1, 2).reshape(b * l, gw)
        else:
            a = core[:, gl]
        aq, as_ = fi._quant_rows(a)
        cores.append(a)
        aqs.append(aq)
        ass.append(as_)
        acc = acc + matmul_codes(aq, woq[gl, :]) * (as_ * so.float())
    out = _layer_norm_f32(acc, ln_scale, ln_bias, 1e-12).to(x.dtype).reshape(b, l, hid)
    return {"xq": xq, "rs": rs, "qkv": torch.cat([torch.cat(t, dim=1) for t in qkv], dim=1),
            "core": torch.cat(cores, dim=1), "aq": torch.cat(aqs, dim=1), "as": torch.cat(ass, dim=1),
            "acc": acc, "out": out}


def card_stages(x, wqkv_t, sqkv, bqkv, wo_t, so, bo, mask, n_heads, ln_scale, ln_bias, group_heads=2):
    """``fused_int8._attention_int8_cuda``'s launches one by one, each
    output kept."""
    import torch

    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_int8 as fi

    b, l, hid = x.shape
    m = b * l
    d = hid // n_heads
    gw = group_heads * d
    sqkv, bqkv, so, bo, mask, ln_scale, ln_bias = (t.float().contiguous() for t in
                                                   (sqkv, bqkv, so, bo, mask, ln_scale, ln_bias))
    xq, rs = fi._quant_groups_cuda(x.reshape(m, hid), 1)
    qkv = torch.empty((b, l, 3 * hid), dtype=torch.bfloat16, device=x.device)
    fi._gemm_s8(xq, wqkv_t, rs, sqkv, bqkv, qkv, fi._EPI_S8_BIAS_BF16, hid)
    core = torch.empty((m, hid), dtype=torch.float32, device=x.device)
    _build.call("mm_attention_core_f32", _build.ptr(qkv), _build.ptr(mask), _build.ptr(core), b, l, n_heads, d,
                1.0 / d ** 0.5, _build.stream(x.device))
    aq, as_ = fi._quant_groups_cuda(core, n_heads // group_heads)
    acc = torch.empty((m, hid), dtype=torch.float32, device=x.device)
    fi._gemm_s8(aq, wo_t, as_, so, bo, acc, fi._EPI_S8_CHUNKS_RESID_F32, gw, resid=x)
    out = torch.empty_like(x)
    _build.call("mm_layernorm", _build.ptr(acc), _build.ptr(ln_scale), _build.ptr(ln_bias), _build.ptr(out), m,
                hid, 1e-12, _build.stream(x.device))
    torch.cuda.synchronize()
    return {"xq": xq, "rs": rs, "qkv": qkv.reshape(m, 3 * hid), "core": core, "aq": aq, "as": as_, "acc": acc,
            "out": out}


def mlp_plain_stages(x, w1q, s1, b1, w2q, s2, b2, ln_scale, ln_bias, gelu, hq=None, hs=None, ff_chunks=4):
    """``fused_int8.reference_mlp_int8_block`` step for step with the given
    gelu, its codes and scales kept; ``hq`` / ``hs`` (the card's) take the
    place of the gelu output's codes when given."""
    import torch

    from matchmaker_tpu_torch.ops import matmul_codes
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.ops.fused_attention import _layer_norm_f32

    b, l, hid = x.shape
    xf = x.float().reshape(b * l, hid)
    xq, rs = fi._quant_rows(xf)
    ch = w1q.shape[1] // ff_chunks
    acc = xf + b2.float()
    codes, scales = [], []
    for c in range(ff_chunks):
        sl = slice(c * ch, (c + 1) * ch)
        if hq is None:
            h = matmul_codes(xq, w1q[:, sl]) * (rs * s1[sl].float()) + b1[sl].float()
            cq, cs = fi._quant_rows(gelu(h))
        else:
            cq, cs = hq[:, sl], hs[:, c:c + 1]
        codes.append(cq)
        scales.append(cs)
        acc = acc + matmul_codes(cq, w2q[sl, :]) * (cs * s2.float())
    out = _layer_norm_f32(acc, ln_scale, ln_bias, 1e-12).to(x.dtype).reshape(b, l, hid)
    return {"hq": torch.cat(codes, dim=1), "hs": torch.cat(scales, dim=1), "acc": acc, "out": out}


def k9_breakdown(mlp, ln, x, got, want) -> dict:
    """The W1 kernel's gelu codes and scales against the plain version's
    (its gelu's multiply-adds fused as the kernel's, ``fma``) and against the
    plain version with the gelu's multiply-adds rounded twice (``unfused``,
    the plain version before the sweep found the difference); the plain tail
    from the card's codes against the kernel."""
    import torch

    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from matchmaker_tpu_torch.ops.fused_attention import _gelu_poly

    m, hid = x.shape[0] * x.shape[1], x.shape[2]
    w1q, s1, b1 = mlp[0], mlp[1].float().contiguous(), mlp[2].float().contiguous()
    xq, rs = fi._quant_groups_cuda(x.reshape(m, hid), 1)
    hq, hs = fi._gemm_s8_gelu_quant(xq, fi.kmajor_codes(w1q), rs, s1, b1, 4)
    torch.cuda.synchronize()
    out = {}
    for tag, gelu in (("unfused", _gelu_poly), ("fma", fi._gelu_poly_fma)):
        st = mlp_plain_stages(x, *mlp, *ln, gelu)
        out[tag] = {"hq": _diff(hq, st["hq"]), "hs": _diff(hs, st["hs"]),
                    "out_vs_kernel": _diff(st["out"], got)}
    out["plain_stages_equal_plain"] = bool(torch.equal(mlp_plain_stages(x, *mlp, *ln, fi._gelu_poly_fma)["out"],
                                                       want))
    out["plain_tail_from_card_codes_vs_kernel"] = _diff(mlp_plain_stages(x, *mlp, *ln, None, hq, hs)["out"], got)
    return out


def _diff(a, b) -> dict:
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return {"differing": int((a != b).sum()), "of": a.numel(), "max_abs": float(d.max()),
            "mean_abs": float(d.mean())}


def k10_breakdown(attn, ln, x, mask, heads, got, want) -> dict:
    """Stage by stage, the card path against the plain version."""
    import torch

    from matchmaker_tpu_torch.ops import fused_int8 as fi

    card = card_stages(x, *fi.kmajor_attention_weights(*attn), mask, heads, *ln)
    plain = plain_stages(x, *attn, mask, heads, *ln)
    tail = plain_stages(x, *attn, mask, heads, *ln, core=card["core"])
    out = {name: _diff(card[name], plain[name]) for name in ("xq", "rs", "qkv", "core", "aq", "as", "acc", "out")}
    out["card_stages_equal_kernel"] = bool(torch.equal(card["out"].reshape(got.shape), got))
    out["plain_stages_equal_plain"] = bool(torch.equal(plain["out"], want))
    out["plain_tail_from_card_core_vs_kernel"] = _diff(tail["out"].reshape(got.shape), got)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=32)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "k10_seed_sweep.json"))
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k10_seed_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from matchmaker_tpu_torch.ops import _build
    from matchmaker_tpu_torch.ops import fused_int8 as fi
    from test_torch_kernels_cuda import _int8_case

    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda")
    _build.library()
    card = _card_line()
    print(card)
    record = {"card": card, "torch": torch.__version__, "seeds": args.seeds, "mean_bar": MEAN_BAR, "cases": []}
    for b, l, hid, ff in CASES:
        heads = hid // 64
        case = {"b": b, "l": l, "hid": hid, "ff": ff, "runs": []}
        for seed in list(range(args.seeds)) + [b * 1000 + l]:
            attn, mlp, ln, x, mask = _int8_case(b, l, hid, ff, device, seed)
            run = {"seed": seed}
            for tag, kernel, plain, rest in (
                    ("k10", fi.fused_attention_int8_block, fi.reference_attention_int8_block,
                     (*attn, mask, heads, *ln)),
                    ("k9", fi.fused_mlp_int8_block, fi.reference_mlp_int8_block, (*mlp, *ln))):
                k1, k2 = kernel(x, *rest), kernel(x, *rest)
                p1, p2 = plain(x, *rest), plain(x, *rest)
                torch.cuda.synchronize()
                d = (k1.float() - p1.float()).abs()
                run[tag] = {"kernel_steady": bool(torch.equal(k1, k2)), "plain_steady": bool(torch.equal(p1, p2)),
                            "mean_abs": float(d.mean()), "max_abs": float(d.max()),
                            "differing": int((k1 != p1).sum()), "of": k1.numel()}
                if tag == "k10" and run[tag]["mean_abs"] > MEAN_BAR:
                    run[tag]["stages"] = k10_breakdown(attn, ln, x, mask, heads, k1, p1)
                if tag == "k9" and (run[tag]["mean_abs"] > MEAN_BAR or b * l <= 16 * 77):
                    run[tag]["stages"] = k9_breakdown(mlp, ln, x, k1, p1)
            case["runs"].append(run)
        for tag in ("k10", "k9"):
            runs = [r[tag] for r in case["runs"]]
            case[tag] = {"kernel_steady": all(r["kernel_steady"] for r in runs),
                         "plain_steady": all(r["plain_steady"] for r in runs),
                         "worst_mean_abs": max(r["mean_abs"] for r in runs),
                         "seeds_past_bar": [r_["seed"] for r_, r in zip(case["runs"], runs)
                                            if r["mean_abs"] > MEAN_BAR],
                         "test_seed_mean_abs": runs[-1]["mean_abs"]}
        staged = [r["k9"]["stages"] for r in case["runs"] if "stages" in r["k9"]]
        if staged:
            case["k9"]["gelu_codes_differing"] = {
                tag: sum(st[tag]["hq"]["differing"] for st in staged) for tag in ("unfused", "fma")}
            case["k9"]["gelu_scales_differing"] = {
                tag: sum(st[tag]["hs"]["differing"] for st in staged) for tag in ("unfused", "fma")}
            case["k9"]["worst_mean_abs_fma"] = max(st["fma"]["out_vs_kernel"]["mean_abs"] for st in staged)
            case["k9"]["tail_from_card_codes_exact"] = all(
                st["plain_tail_from_card_codes_vs_kernel"]["differing"] == 0 for st in staged)
        print(f"B={b} L={l} HID={hid}: " + "; ".join(
            f"{tag} steady kernel {case[tag]['kernel_steady']} plain {case[tag]['plain_steady']}, worst mean |d| "
            f"{case[tag]['worst_mean_abs']:.3g}, test seed {case[tag]['test_seed_mean_abs']:.3g}, past the bar "
            f"{case[tag]['seeds_past_bar']}" for tag in ("k10", "k9"))
            + ("; k9 gelu codes / scales differing from the card: unfused gelu {}, fma gelu {}; worst mean |d| "
               "with the fma gelu {:.3g}; plain tail from the card's codes exact {}".format(
                   *(f"{case['k9']['gelu_codes_differing'][t]} / {case['k9']['gelu_scales_differing'][t]}"
                     for t in ("unfused", "fma")), case["k9"]["worst_mean_abs_fma"],
                   case["k9"]["tail_from_card_codes_exact"]) if "gelu_codes_differing" in case["k9"] else ""))
        record["cases"].append(case)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({c_key: [{k: c[k] for k in ("b", "l", "hid", "k10", "k9")} for c in record["cases"]]
                      for c_key in ("cases",)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
