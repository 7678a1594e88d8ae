"""tools/ln_bwd_ab.py rehearsed on the CPU at a tiny size: both turns run in
their own processes against a checkout's port (the plain versions: no
device times), and the summary holds each checkout's row of each shape."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import ln_bwd_ab  # noqa: E402


def test_ln_bwd_ab_runs_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ln_bwd_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--reps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    saved = json.loads(out.read_text())
    assert summary == saved["summary"] and [t["turn"] for t in saved["turns"]] == ["A", "B"]
    keys = {f"hid {h} B {b} L {l}" for h, b, l in ln_bwd_ab.TINY}
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT and {k for k in means if k.startswith("hid")} == keys
        assert set(means["call_device_ms"]) == keys


def test_ln_bwd_ab_widths_are_the_ones_the_warp_kernel_served():
    assert {h for h, _, _ in ln_bwd_ab.SHAPES} == {312, 768, 1024}
