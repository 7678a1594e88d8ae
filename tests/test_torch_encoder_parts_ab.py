"""tools/encoder_parts_ab.py, rehearsed on the CPU at a tiny size: both turns
run in their own processes against a checkout's port, and the summary holds
each checkout's time of each encoder half, bf16 and int8 (on the CPU the
plain versions run, so there are no launches to time one by one)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_encoder_parts_ab_times_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "encoder_parts_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--reps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    saved = json.loads(out.read_text())
    assert summary == saved["summary"]
    assert [t["turn"] for t in saved["turns"]] == ["A", "B"]
    for letter in "AB":
        means = summary["means"][letter]
        for half in ("fused_attention_block", "fused_mlp_block", "fused_attention_int8_block",
                     "fused_mlp_int8_block"):
            assert means[half]["ms"] > 0
            assert means[half]["parts"] == []  # the plain versions launch no kernel
