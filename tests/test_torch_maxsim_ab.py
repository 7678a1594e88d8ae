"""tools/maxsim_ab.py, rehearsed on the CPU at a tiny size: both turns run in
their own processes against a checkout's port and a token store the script
writes once, and the summary holds each checkout's time of K14 at its two
shapes and of the rescore of a query batch (on the CPU the plain versions
run; this checkout has the batched rescore)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("K14 all pairs", "K14 one query's rescore", "rescore of 16 queries")


def test_maxsim_ab_times_two_checkouts_in_turns(tmp_path):
    out = tmp_path / "ab.json"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "maxsim_ab.py"), ROOT, ROOT,
                           "--device", "cpu", "--tiny", "--reps", "1", "--turns", "AB", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2] == "cpu"
    summary = json.loads(lines[-1])
    saved = json.loads(out.read_text())
    assert summary == saved["summary"]
    assert [t["turn"] for t in saved["turns"]] == ["A", "B"]
    assert saved["turns"][0]["top_score"] == saved["turns"][1]["top_score"]  # the same seeded data
    for turn in saved["turns"]:
        assert turn["rescore_form"] == "batched" and turn["sizes"]["all_pairs"] == [4, 8, 16, 24, 64]
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT
        for name in TIMES:
            assert means[name] > 0, name
