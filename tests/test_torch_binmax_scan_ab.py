"""tools/binmax_scan_ab.py, rehearsed on the CPU at a tiny size: both turns
run in their own processes against a checkout's port, and the summary holds
each checkout's time of the K3, K7 and K8 scans at per_bin 2 and 8, of K4
and K6 at each shape the paths launch them, of the bf16, int8 and mixed
FlatIndex searches and of ColBERT's per-token search (on the CPU the plain
versions run); K4's and K6's host times a call, and no device time off the
card."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL2_UNPACK = ("K4 w32 per_bin 8", "K4 w128 per_bin 8", "K6 level2 32", "K6 two-stage", "K4 w32 1M search",
                 "K6 1M search", "K4 w128 colbert", "K6 colbert")
TIMES = ("K3 per_bin 2", "K3 per_bin 8", "K7 per_bin 2", "K7 per_bin 8", "K8 per_bin 2", "K8 per_bin 8",
         "bf16 search", "int8 search", "mixed search", "colbert per-token search") + LEVEL2_UNPACK


def test_binmax_scan_ab_times_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "binmax_scan_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--reps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    saved = json.loads(out.read_text())
    assert summary == saved["summary"]
    assert [t["turn"] for t in saved["turns"]] == ["A", "B"]
    for turn in saved["turns"]:
        assert turn["scan_shape"] == [8192, 64, 16] and turn["search_shape"] == [32_768, 64, 256, 10]
        assert turn["colbert_shape"] == [20_000, 32, 128, 48]
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT
        for name in TIMES:
            assert means[name] > 0, name
        for name in LEVEL2_UNPACK:
            assert means["host_ms"][name] > 0 and means["device_ms"][name] is None, name
