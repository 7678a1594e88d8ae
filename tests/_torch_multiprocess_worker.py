"""One process of the port's two-process CPU runs (tests/test_torch_multiprocess.py).

Started once a rank with MATCHMAKER_COORDINATOR, MATCHMAKER_NUM_PROCESSES
and MATCHMAKER_PROCESS_ID set; the processes join one gloo group on the CPU
and, in one launch, run: one BERT_DOT and one ColBERT train step with
in-batch negatives on their halves of a global batch, and on padded
global batches; the eval step on a
13-row batch; a Trainer run stopped at step 2 with a train-state snapshot,
resumed, and an uninterrupted run of the same config; and
cli.dense_retrieval's run.
Rank 0 writes what the test compares under the work directory.

    python tests/_torch_multiprocess_worker.py <work dir>
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from matchmaker_tpu_torch.cli.dense_retrieval import run as dense_retrieval  # noqa: E402
from matchmaker_tpu_torch.losses import get_loss  # noqa: E402
from matchmaker_tpu_torch.models.bert_dot import BertDot  # noqa: E402
from matchmaker_tpu_torch.models.colbert import ColBert  # noqa: E402
from matchmaker_tpu_torch.models.weights import load_npz, save_npz  # noqa: E402
from matchmaker_tpu_torch.parallel import multihost  # noqa: E402
from matchmaker_tpu_torch.training.optim import build_optimizer  # noqa: E402
from matchmaker_tpu_torch.training.train_step import make_eval_step, make_train_step  # noqa: E402
from matchmaker_tpu_torch.training.trainer import Trainer  # noqa: E402


def _local(batch, rank, n_proc):
    rows = next(iter(batch.values())).shape[0] // n_proc
    return {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]) for k, v in batch.items()}


def main() -> int:
    work = sys.argv[1]
    with open(os.path.join(work, "configs.json")) as f:
        configs = json.load(f)
    assert multihost.maybe_initialize_distributed({"device": "cpu"})
    rank, n_proc = multihost.process_index(), multihost.process_count()
    assert multihost.backend() == "gloo" and n_proc == 2

    # one train step on this rank's half of the global batch: BERT_DOT
    # (pairwise in-batch loss), ColBERT (listwise over the all-pairs MaxSim)
    # and on the padded global batches (process 1 holding one valid row, or none)
    runs = [("colbert", ColBert, ""), ("colbert", ColBert, "_padded"), ("step", BertDot, "_padded"),
            ("step", BertDot, "_empty"), ("step", BertDot, "")]
    for name, cls, suffix in runs:
        batch = dict(np.load(os.path.join(work, f"batch{suffix}.npz")))
        cfg = configs[name]
        model = cls.from_config(cfg)
        model.load_state_dict(load_npz(os.path.join(work, f"start_{name}.npz")))
        step = make_train_step(model, get_loss(cfg), build_optimizer(cfg, model), cfg)
        stats = step(_local(batch, rank, n_proc))
        if rank == 0:
            save_npz(os.path.join(work, f"{name}{suffix}_params.npz"), model.state_dict())
            with open(os.path.join(work, f"{name}{suffix}_stats.json"), "w") as f:
                json.dump({k: float(v) for k, v in stats.items()}, f)
    # the eval step over 13 rows: padded to 14, a slice a process, gathered
    eval_batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, "eval_batch.npz")).items()}
    model.eval()
    scores = make_eval_step(model)(eval_batch)["score"]
    if rank == 0:
        np.save(os.path.join(work, "eval_scores.npy"), scores.numpy())

    # the Trainer: stopped at step 2 and resumed, against one uninterrupted run
    for name, max_batches, resume in (("split", 2, False), ("split", 0, True), ("straight", 0, False)):
        folder = os.path.join(work, name)
        multihost.on_primary(lambda: os.makedirs(folder, exist_ok=True))
        config = dict(configs["trainer"], max_training_batches=max_batches)
        trainer = Trainer(config, folder)
        if resume:
            assert trainer.resume_from_train_state() and trainer.global_step == 2
        trainer.train()
        if rank == 0 and not (name == "split" and not resume):
            save_npz(os.path.join(work, f"trainer_{name}.npz"), trainer.model.state_dict())
            with open(os.path.join(work, f"trainer_{name}.json"), "w") as f:
                json.dump({"global_step": trainer.global_step, "best_metric": trainer.best_metric}, f)

    # dense retrieval: the mesh spans the two processes (a shard each)
    folder = os.path.join(work, "dense")
    multihost.on_primary(lambda: os.makedirs(folder, exist_ok=True))
    assert dense_retrieval("encode+index+search", configs["dense"], folder) == 0
    multihost.barrier()
    print(f"[worker p{rank}] TORCH_MULTIPROCESS_OK", flush=True)
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
