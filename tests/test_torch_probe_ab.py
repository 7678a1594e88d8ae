"""tools/probe_ab.py, rehearsed on the CPU at a tiny size: both turns run
in their own processes against a checkout's port (the turn loop of
tools/ab_turns.py), and the summary holds each checkout's time of K15's
three variants and K13 at both shapes, of K16 at both shapes, and of K17,
K18, K2 and the chain of PyTorch calls at both MLP shapes (on the CPU the
plain versions run), the agreements each turn checked, the bounds, and no
device time off the card."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ("(2, 9)", "(2, 7, masked)")
MLP_SHAPES = ("(2, 9)", "(2, 7)")
KERNELS = tuple(f"K15 {v} {s}" for s in SHAPES for v in ("batched", "f32_p", "softmax_stub")) + (
    "K16 (40, 64, 24)", "K16 (9, 32, 8)") + tuple(f"{k} {s}" for s in MLP_SHAPES
                                                  for k in ("K17 mlp_rows2d", "K18 mlp_rowsblk"))
YARDSTICKS = tuple(f"K13 fused_mha {s}" for s in SHAPES) + tuple(f"{k} {s}" for s in MLP_SHAPES
                                                                 for k in ("K2 fused_mlp_block", "chain"))


def test_probe_ab_times_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "probe_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--reps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    saved = json.loads(out.read_text())
    assert summary == saved["summary"] and summary["turns"] == "AB"
    assert [t["turn"] for t in saved["turns"]] == ["A", "B"]
    for turn in saved["turns"]:
        for name in KERNELS:
            assert turn["bound_ms"][name] > 0, name
            check = turn["checks"][name]
            assert check.get("exact") or (check["min_row_cosine"] >= 0.999 and check["max_abs_err"] <= 0.1), name
        assert turn["checks"]["K15 f32_p (2, 9) vs f32-P plain, mean |d|"] == 0.0
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT
        for name in KERNELS + YARDSTICKS:
            assert means[name] > 0 and means["device_ms"][name] is None, name
        assert not any(name.startswith(("sdpa", "torch._int_mm")) for name in means)


def test_probe_ab_refuses_turns_other_than_a_and_b(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "probe_ab.py"), ROOT, ROOT, "--device", "cpu",
                           "--turns", "AC"], capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 2 and "turns of A and B" in proc.stderr
