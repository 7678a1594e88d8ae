"""tools/binmax_scan_ab.py, rehearsed on the CPU at a tiny size: both turns
run in their own processes against a checkout's port, and the summary holds
each checkout's time of the K3 and K7 scans at per_bin 2 and 8 and of the
bf16 and int8 FlatIndex searches (on the CPU the plain versions run)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("K3 per_bin 2", "K3 per_bin 8", "K7 per_bin 2", "K7 per_bin 8", "bf16 search", "int8 search")


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
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT
        for name in TIMES:
            assert means[name] > 0, name
