"""The port's TAS-Balanced recipe (cli/tasb_recipe.py) and effectiveness
check (cli/effectiveness_check.py) end to end on the CPU, at a tiny scale:
every stage runs through the port's entry points (MLM pre-training, the
baseline BERT_DOT and its query clusters, the ColBERT teacher, the pair
scoring, the TAS-Balanced student with the dynamic in-batch teacher, then
encode → binmax index → search → metrics) and leaves its artefacts; stage
resume reuses them. The effectiveness floors at scale are checked on the
card (chip_smoke.py) and in PERF.md."""

import json
import os

from matchmaker_tpu_torch.cli.effectiveness_check import run_check
from matchmaker_tpu_torch.cli.tasb_recipe import run_recipe
from matchmaker_tpu_torch.ops import _build

_TINY = dict(model_name="tiny-test", n_docs=400, n_train_queries=48, n_eval_queries=10, mlm_steps=6,
             teacher_epochs=2, tas_batches_per_epoch=6, student_epochs=1, batch_size=16, n_clusters=4,
             teacher_lr=1e-3, student_lr=1e-3, device="cpu")


def test_tasb_recipe_runs_every_stage_and_resumes(tmp_path):
    _build.reset_launches()
    out = run_recipe(str(tmp_path), **_TINY)
    assert all(v == 0 for v in _build.LAUNCHES.values())  # the CPU: plain versions only
    assert out["QueriesRanked"] == 10 and 0.0 <= out["MRR@10"] <= 1.0 and 0.0 <= out["Recall@100"] <= 1.0
    with open(tmp_path / "tasb_recipe_result.json") as f:
        assert json.load(f)["MRR@10"] == out["MRR@10"]
    assert set(out["timings_s"]) == {"corpus", "mlm_pretrain", "clusters", "teacher_train", "pair_scoring",
                                     "student_train", "retrieval"}
    for sub in ("mlm_run", "baseline_bert_dot", "colbert_teacher", "student_run"):
        assert os.path.isfile(tmp_path / sub / "best-model.npz"), sub
    for sub in ("baseline_bert_dot", "colbert_teacher", "student_run"):
        with open(tmp_path / sub / "config.yaml") as f:  # JSON, which YAML readers read
            assert json.load(f)["model"] in ("bert_dot", "colbert")
    assert os.path.isfile(tmp_path / "retrieval_run" / "planted-metrics.csv")
    with open(tmp_path / "pairs_with_teacher_scores.tsv") as f:
        lines = f.read().splitlines()
    assert len(lines) == 48 * 8 and all(len(line.split()) == 5 for line in lines)
    with open(tmp_path / "query_clusters.tsv") as f:
        clusters = [line.split() for line in f]
    assert 1 <= len(clusters) <= 4 and sum(map(len, clusters)) == 48

    # resume: every trained stage is reused, only the corpus and the retrieval rerun
    stamp = os.path.getmtime(tmp_path / "student_run" / "best-model.npz")
    again = run_recipe(str(tmp_path), resume=True, **_TINY)
    assert os.path.getmtime(tmp_path / "student_run" / "best-model.npz") == stamp
    assert again["MRR@10"] == out["MRR@10"]


def test_effectiveness_check_completes_at_a_tiny_scale(tmp_path):
    out = run_check(str(tmp_path), n_docs=300, n_train_queries=40, n_eval_queries=10, epochs=1, device="cpu")
    assert out["QueriesRanked"] == 10 and 0.0 <= out["MRR@10"] <= 1.0
    assert os.path.isfile(tmp_path / "train_run" / "best-model.npz")
    assert os.path.isfile(tmp_path / "retrieval_run" / "planted-metrics.csv")
