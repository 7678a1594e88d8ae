"""tools/train_step_ab.py, rehearsed on the CPU at a tiny size: both turns run
in their own processes against a checkout's port, and the summary holds
each checkout's step time and the host's time for each part of the step."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_step_ab_times_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "train_step_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--steps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    assert summary == json.loads(out.read_text())["summary"]
    turns = json.loads(out.read_text())["turns"]
    assert [t["turn"] for t in turns] == ["A", "B"]
    for letter in "AB":
        means = summary["means"][letter]
        assert means["step_ms"] > 0 and means["triples_per_s"] > 0
        assert set(means["host_ms"]) == {"forward_and_loss", "backward", "norm_and_update"}
        assert abs(sum(means["host_ms"].values()) - means["host_ms_total"]) < 1e-6
        assert means["kernel_ms"] is None and means["busy"] is None  # no card, no profile
