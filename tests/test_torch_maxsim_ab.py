"""tools/maxsim_ab.py, rehearsed on the CPU at a tiny size: both turns run in
their own processes against a checkout's port and a token store the script
writes once, and the summary holds each checkout's time of K14 at its two
shapes, of the training form and the backward at the training shapes and
of the rescore of a query batch, their ratios, and whether K14's serving
launches and the training kernels gave the same bits in every turn (on the
CPU the plain versions run; this checkout has the batched rescore)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import maxsim_ab  # noqa: E402

TIMES = ("K14 all pairs", "K14 all pairs, device", "K14 one query's rescore", "training form [4, 6, 8, 24, 64]",
         "backward [4, 6, 8, 24, 64]", "training form [8, 6, 16, 24, 64]", "backward [8, 6, 16, 24, 64]",
         "K14 gathered, device", "rescore of 16 queries", "K14 all pairs [4, 6, 8, 24, 64], device")


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
    assert summary["serving_bits_identical"] is True and summary["training_bits_identical"] is True
    assert set(saved["turns"][0]["training_digests"]) == {
        "training form [4, 6, 8, 24, 64]", "backward [4, 6, 8, 24, 64]", "ties [4, 6, 8, 24, 64]",
        "training form [8, 6, 16, 24, 64]", "backward [8, 6, 16, 24, 64]"}
    assert set(saved["turns"][0]["serving_digests"]) == {"all pairs [4, 8, 16, 24, 64] fill -1000.0",
                                                         "all pairs [3, 5, 7, 13, 64] fill -1000.0", "gathered"}
    for turn in saved["turns"]:
        assert turn["rescore_form"] == "batched" and turn["sizes"]["all_pairs"] == [4, 8, 16, 24, 64]
    for letter in "AB":
        means = summary["means"][letter]
        assert means["checkout"] == ROOT
        for name in TIMES:
            assert means[name] > 0, name
    assert set(summary["means"]["B/A"]) == set(TIMES)


def test_maxsim_ab_shapes_are_chip_smokes():
    """The serving shapes whose bits the turns compare are phase 3's K14
    shapes, and the training shapes are among phase 3's training shapes
    with ColBERT's fill."""
    assert maxsim_ab.FULL["serving"] == chip_smoke.FULL["maxsim_shapes"]
    train = {tuple(s[:5]) for s in chip_smoke.FULL["maxsim_train_shapes"] if s[5] == -1000.0}
    assert set(maxsim_ab.FULL["train"]) <= train
