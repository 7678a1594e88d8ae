"""The training driver: counterpart of ``matchmaker_tpu/training/trainer.py``,
one process a device.

Config-driven build (BERT_DOT, ColBERT or a transformer re-ranker; a local
Hugging Face checkpoint in ``bert_pretrained_model`` fills every encoder,
``warmstart_model_path`` loads a whole ``.npz`` snapshot and
``warmstart_encoder_path`` grafts an encoder snapshot, e.g. an MLM
pre-train's, into the fresh model), epoch
loop over the triple loader (``data/loaders.py:triple_training_loader``),
with ``dynamic_sampler: true`` the TAS-Balanced sampler
(``data/tas_balanced.py``) or with ``dynamic_sampler: listwise`` the list
sampler (``data/list_sampler.py``: ``queries_per_batch`` lists of
``list_size`` documents from the qrels and a candidate run, for the
top-level listwise losses), ``tas_batches_per_epoch`` batches an epoch,
batches placed on the device ahead by ``device_prefetch`` and, with
``dynamic_teacher``, scored by the dynamic teacher
(``distillation/dynamic_teacher.py``) before the step, continuous validation every ``validate_every_n_batches``
and at each epoch's end with best-checkpoint saving and rotation, early
stopping, the loss CSV every 100 steps, ``max_training_batches``, an
optional full train-state snapshot with the mid-epoch data cursor, a device
out-of-memory step skipped unless two fail within four steps,
``submodel_train_cache_path`` (IDCM's chunk scores written to a replay cache
by the first run, replayed into the batches of every later one in the same
order, utils/replay_cache.py), then the final
validation/test/leaderboard passes, ``efficiency-metrics.json`` and, with
``run_dense_retrieval_eval``, the port's dense-retrieval CLI on the best
weights. Extra config key: ``device`` (default ``"cuda"``).

With ``train_qa_spans`` and ``qa_uncertainty_weighting`` (default on) the
uncertainty weighting's log-variances ``mtl_log_vars`` (3,), zeros at the
start, are a top-level parameter of the model itself, which
``models.get_model`` adds (the JAX trainer adds them to the param tree): so
the optimizer trains them ("head" group), ``best-model.npz`` and the
train-state snapshots keep them, and ``flax_to_state_dict`` maps a JAX
param tree holding them onto the model. The QA answers of a validation or
test set with ``qa_answers`` are evaluated by ``evaluation.qa_evaluate``.

``warmstart_model_path`` and ``warmstart_encoder_path`` take the port's
``.npz``, a JAX run's ``best-model.flax``, or a run folder holding either
(training/checkpoints.py). With ``gradient_accumulation_steps: k > 1``
every batch is one micro-step (``global_step``, the validation cadence and
the loss CSV count micro-steps, as in the JAX trainer) and the parameters
move on every k-th (training/optim.py); a batch skipped for running out of
device memory is left out of the mean.

Under a process group (``MATCHMAKER_COORDINATOR`` and its companions, joined
by the CLIs' ``maybe_initialize_distributed``, parallel/multihost.py) each
process trains on its own card (``cuda:(rank % cards)`` for a ``cuda``
device) with ``batch_size_train`` the global batch: the triple loader
strides whole local batches of batch_size_train / processes over the
processes before tokenizing (``process_stride``), the samplers draw
``queries_per_batch`` (rounded up to a multiple of the process count, as
JAX rounds it to its devices) or batch_size_train / processes each from
seed ``random_seed + 7919 · rank``, the parameters are broadcast from rank
0 at the start, the step averages the gradients before the norm
(training/train_step.py), the processes stop together when one runs out
of batches, the teacher scores each process's own rows, validation runs on
every process with the same metrics, and only the primary process writes
the loss CSV, scalars, best checkpoints and the run folder's files; a
train-state snapshot is collective (training/checkpoints.py). At the end
the processes meet at a barrier, the primary saves the final weights as
the best when no validation saved one, each process writes
``efficiency-metrics-p{rank}.json``, and, as in the JAX trainer, the final
evaluations and the dense retrieval are left to a single-process run.
"""

from __future__ import annotations

import csv
import itertools
import math
import os
from typing import Dict

import torch

from matchmaker_tpu_torch.data.loaders import device_prefetch, triple_training_loader
from matchmaker_tpu_torch.data.tokenization import build_tokenizer
from matchmaker_tpu_torch.evaluation import (evaluate_model, replay_cached, save_sorted_results, test_model,
                                             validate_model)
from matchmaker_tpu_torch.experiment import EarlyStopping, save_best_info
from matchmaker_tpu_torch.losses import get_loss
from matchmaker_tpu_torch.models import get_model, init_params
from matchmaker_tpu_torch.obs.perf_monitor import PerformanceMonitor
from matchmaker_tpu_torch.obs.scalars import ScalarWriter, collect_learned_scalars
from matchmaker_tpu_torch.parallel import multihost
from matchmaker_tpu_torch.training.checkpoints import (
    BEST_MODEL,
    TrainStateCheckpointer,
    load_encoder_subtree,
    load_params,
    rotate_best,
    save_params,
)
from matchmaker_tpu_torch.training.optim import build_optimizer
from matchmaker_tpu_torch.training.train_step import make_eval_step, make_train_step
from matchmaker_tpu_torch.utils.replay_cache import CrossExperimentReplayCache

_CACHE_KEYS = ("_cache_pos_passage_scores", "_cache_neg_passage_scores")


class Trainer:
    def __init__(self, config, run_folder: str, teacher_config=None):
        """``teacher_config``: the dynamic teacher's config, when the caller
        holds it (else it is read from ``dynamic_teacher_path``'s
        ``config.yaml``)."""
        self.config = config
        self.run_folder = run_folder
        self.teacher_config = teacher_config
        self.perf = PerformanceMonitor.get()
        self.n_processes = multihost.process_count()
        self.is_primary = multihost.is_primary()
        self.device = torch.device(config.get("device", "cuda"))
        if self.n_processes > 1 and self.device.type == "cuda":
            self.device = multihost.rank_device()

        self.tokenizer = build_tokenizer(config)
        self.model = get_model(config, self.tokenizer)
        init_params(self.model, config, torch.Generator().manual_seed(config.get("random_seed", 42)))
        if config.get("warmstart_model_path"):
            load_params(config["warmstart_model_path"], self.model)
        if config.get("warmstart_encoder_path"):
            # an encoder-only graft (e.g. from an MLM pre-train run): the heads stay fresh
            load_encoder_subtree(config["warmstart_encoder_path"], self.model)
        self.model.to(self.device)
        multihost.broadcast_module(self.model)  # every process starts from rank 0's parameters
        self.optimizer = build_optimizer(config, self.model)
        self.losses = get_loss(config)
        self.train_step = make_train_step(self.model, self.losses, self.optimizer, config)
        self.eval_step = make_eval_step(self.model)

        self.early_stopping = EarlyStopping(patience=config.get("early_stopping_patience", 30), mode="max")
        self.scalars = ScalarWriter(run_folder, config.get("enable_tensorboard", True))
        self.best_metric = -math.inf
        self.global_step = 0
        # data cursor for mid-epoch resume: epoch index + batches consumed
        # within it (kept in the train-state snapshot)
        self._epoch = 0
        self._epoch_batch = 0
        self._loss_csv = os.path.join(run_folder, "training-loss.csv")
        self._eval_cache: Dict[str, list] = {}
        self._ts_ckpt = None

        counts: Dict[str, int] = {}
        for name, p in self.model.named_parameters():
            top = name.split(".")[0]
            counts[top] = counts.get(top, 0) + p.numel()
        print(f"[trainer] model '{config.get('model')}' params: {sum(counts.values()):,} "
              + " ".join(f"{k}={v:,}" for k, v in sorted(counts.items())))

    # ------------------------------------------------------------------
    def _log_loss(self, epoch: int, stats: Dict[str, torch.Tensor]) -> None:
        if not self.is_primary:
            return  # one writer a run folder
        exists = os.path.exists(self._loss_csv)
        host_stats = {k: float(v) for k, v in stats.items()}
        self.scalars.write(host_stats, self.global_step)
        with open(self._loss_csv, "a", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            keys = sorted(host_stats)
            if not exists:
                w.writerow(["epoch", "step"] + keys)
            w.writerow([epoch, self.global_step] + [host_stats[k] for k in keys])

    def _validate(self, epoch: int) -> bool:
        """Continuous validation; returns True if training should stop."""
        vcfg = self.config.get("validation_cont")
        if not vcfg:
            return False
        cache = self._eval_cache if self.config.get("validation_cont_use_cache", True) else None
        _, metric_value, _ = validate_model("cont", self.eval_step, self.config, self.tokenizer, self.run_folder,
                                            vcfg, self.device, epoch, self.global_step, cache)
        if metric_value > self.best_metric:
            self.best_metric = metric_value
            if self.is_primary:  # one writer a run folder; the parameters are the same everywhere
                rotate_best(self.run_folder, self.config.get("store_n_best_checkpoints", 1))
                save_params(os.path.join(self.run_folder, BEST_MODEL), self.model)
                save_best_info(self.run_folder, self.config.get("validation_metric", "MRR@10"), metric_value, epoch,
                               self.global_step)
        if self.config.get("save_train_state", False):
            self._save_train_state()
        stats = collect_learned_scalars(self.model)
        if stats and self.is_primary:
            self.scalars.write(stats, self.global_step, prefix="params")
        min_steps = self.config.get("min_steps_training", -1)
        stop = self.early_stopping.step(metric_value)
        if stop and min_steps > 0 and self.global_step < min_steps:
            return False
        return stop

    def _train_state_checkpointer(self) -> TrainStateCheckpointer:
        if self._ts_ckpt is None:
            self._ts_ckpt = TrainStateCheckpointer(os.path.join(self.run_folder, "train_state"))
        return self._ts_ckpt

    def _save_train_state(self) -> None:
        self._train_state_checkpointer().save(self.global_step, {
            "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
            "step": self.global_step, "epoch": self._epoch, "epoch_batch": self._epoch_batch})

    def resume_from_train_state(self) -> bool:
        """Restore model, optimizer, step and data cursor from the latest
        snapshot; True if one was found. ``train()`` then starts at the saved
        epoch and skips the batches already consumed in it."""
        ckpt = self._train_state_checkpointer()
        step = ckpt.latest_step()
        if step is None:
            return False
        state = ckpt.restore(step, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["step"])
        self._epoch = int(state["epoch"])
        self._epoch_batch = int(state["epoch_batch"])
        print(f"[trainer] resumed train state at step {self.global_step} "
              f"(epoch {self._epoch}, batch {self._epoch_batch})")
        return True

    # ------------------------------------------------------------------
    def _tas_sampler(self):
        from matchmaker_tpu_torch.data.tas_balanced import TASBalancedSampler

        config = self.config
        return TASBalancedSampler(
            collection_file=config["dynamic_sampler_collection"],
            query_file=config["dynamic_sampler_queries"],
            pairs_with_teacher_scores=config["dynamic_sampler_pairs_with_teacher_scores"],
            query_cluster_file=config["dynamic_sampler_query_cluster_file"],
            batch_size=self._local_batch(),
            clusters_per_batch=config.get("tas_balanced_clusters_per_batch", 1),
            pair_balancing_strategy="bins" if config.get("tas_balanced_pair_strategy", "random") != "random"
            else "random",
            seed=self._sampler_seed(),
        )

    def _local_batch(self) -> int:
        """This process's rows of the global ``batch_size_train``."""
        return multihost.per_process_batch(self.config.get("batch_size_train", 32))

    def _sampler_seed(self) -> int:
        """The samplers' seed: decorrelated a process, as in JAX."""
        return self.config.get("random_seed", 42) + 7919 * multihost.process_index()

    def _list_sampler(self):
        from matchmaker_tpu_torch.data.list_sampler import ListwiseDynamicSampler

        config = self.config
        # the query dimension splits over the processes: rounded up to a
        # multiple of them, as JAX rounds it to its mesh's devices
        qpb = config.get("queries_per_batch", 4)
        qpb_split = -(-qpb // self.n_processes) * self.n_processes
        if qpb_split != qpb:
            print(f"[trainer] queries_per_batch {qpb} not divisible by {self.n_processes} processes; "
                  f"using {qpb_split}", flush=True)
        return ListwiseDynamicSampler(
            collection_file=config["dynamic_sampler_collection"],
            query_file=config["dynamic_sampler_queries"],
            qrels_file=config["dynamic_sampler_qrels"],
            candidate_file=config["dynamic_sampler_candidates"],
            list_size=config.get("list_size", 8),
            queries_per_batch=qpb_split // self.n_processes,
            seed=self._sampler_seed(),
        )

    def _submodel_cache(self):
        """(cache, writing) for ``submodel_train_cache_path``: a run finding
        no ``cache-meta.json`` there writes the cache, every later run
        replays it (the same data, seed and batch size give the same batch
        order); (None, False) without the key. Under a process group each
        process keeps its own cache in ``p{rank}/`` there."""
        path = self.config.get("submodel_train_cache_path")
        if not path:
            return None, False
        if self.n_processes > 1:  # each process caches its own rows
            path = os.path.join(path, f"p{multihost.process_index()}")
        write = not os.path.exists(os.path.join(path, "cache-meta.json"))
        print(f"[trainer] submodel train cache {'WRITE' if write else 'REPLAY'}: {path}")
        return CrossExperimentReplayCache(path, write=write), write

    @staticmethod
    def _split_cached(batch, scores):
        """A host batch with its cached chunk scores: positive rows, then
        negative rows."""
        b = batch[next(iter(batch))].shape[0]
        return dict(batch, bert_part_cached_pos=scores[:b], bert_part_cached_neg=scores[b:])

    def _epoch_batches(self, sampler, teacher, replay=None):
        """One epoch's batches on the device, from the current data cursor:
        the sampler's (TAS-Balanced or listwise) or the triple file's, with ``replay``'s
        cached chunk scores, scored by the dynamic teacher when there is
        one."""
        config = self.config
        if sampler is not None:
            loader = itertools.islice(sampler.batches(config, self.tokenizer,
                                                      max_batches=config.get("tas_batches_per_epoch", 1000)),
                                      self._epoch_batch, None)
        else:
            n_proc = self.n_processes
            loader = triple_training_loader(config, self.tokenizer, config["train_tsv"],
                                            batch_size=self._local_batch(),
                                            process_stride=(multihost.process_index(), n_proc) if n_proc > 1
                                            else None, skip_batches=self._epoch_batch)
        if replay is not None:
            loader = replay_cached(loader, replay, self._split_cached)
        batches = device_prefetch(loader, self.device)
        if self.n_processes > 1:  # a step every process takes, or none
            batches = multihost.lockstep(batches, self.device)
        return teacher.wrap(batches) if teacher is not None else batches

    def train(self) -> None:
        config = self.config
        validate_every = config.get("validate_every_n_batches", 4000)
        epochs = config.get("epochs", 1)
        max_batches = config.get("max_training_batches", 0)
        stopped = False
        teacher = None
        if config.get("dynamic_teacher", False):
            from matchmaker_tpu_torch.distillation.dynamic_teacher import DynamicTeacher

            teacher = DynamicTeacher(config, teacher_config=self.teacher_config)
        if config.get("dynamic_sampler", False) == "listwise":
            sampler = self._list_sampler()
        else:
            sampler = self._tas_sampler() if config.get("dynamic_sampler", False) else None
        cache, cache_write = self._submodel_cache()
        self.model.train()
        self.perf.start_block("train")
        for epoch in range(self._epoch, epochs):
            if stopped:
                break
            self._epoch = epoch
            recent_failures = []
            for batch in self._epoch_batches(sampler, teacher, None if cache_write else cache):
                self._epoch_batch += 1
                try:
                    stats = self.train_step(batch)
                except torch.cuda.OutOfMemoryError:
                    # a device OOM skips the batch, unless two fail within four steps
                    recent_failures = [s for s in recent_failures if self.global_step - s < 4]
                    recent_failures.append(self.global_step)
                    print(f"[trainer] step {self.global_step} ran out of device memory; skipping batch")
                    if len(recent_failures) >= 2:
                        raise
                    continue
                self.global_step += 1
                cached = [stats.pop(k) for k in _CACHE_KEYS if k in stats]
                if cache_write and cached:
                    cache.cache(torch.cat(cached).float().cpu().numpy())
                if self.global_step % 100 == 0:
                    self._log_loss(epoch, stats)
                if validate_every > 0 and self.global_step % validate_every == 0:
                    if self._validate(epoch):
                        stopped = True
                        break
                if max_batches and self.global_step >= max_batches:
                    if config.get("save_train_state", False):
                        self._save_train_state()
                    stopped = True
                    break
            else:
                # end-of-epoch validation keeps short epochs honest
                stopped = self._validate(epoch) or stopped
                self._epoch_batch = 0  # the next epoch starts at its first batch
        if cache_write:
            cache.finish()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.perf.stop_block("train", self.global_step)
        self.scalars.flush()

        best_path = os.path.join(self.run_folder, BEST_MODEL)
        if self.n_processes > 1:
            # the processes meet before the last writes; the primary owns the run folder
            multihost.barrier()
            if self.is_primary and self.best_metric == -math.inf:
                save_params(best_path, self.model)
            self.perf.save_summary(os.path.join(self.run_folder,
                                                f"efficiency-metrics-p{multihost.process_index()}.json"))
            self.perf.print_summary()
            multihost.barrier()
            return

        # final evaluations on the best weights this run saved, else on the
        # last ones (saved as the best, so the dense retrieval finds them)
        if self.best_metric > -math.inf and os.path.exists(best_path):
            load_params(best_path, self.model)
        else:
            save_params(best_path, self.model)
        self.final_evaluations()
        self.perf.save_summary(os.path.join(self.run_folder, "efficiency-metrics.json"))
        self.perf.print_summary()

        if config.get("run_dense_retrieval_eval", False):
            from matchmaker_tpu_torch.cli.dense_retrieval import run as run_dense_retrieval

            dr_config = dict(config)
            dr_config["trained_model"] = self.run_folder
            dr_folder = os.path.join(self.run_folder, "dense-retrieval")
            os.makedirs(dr_folder, exist_ok=True)
            run_dense_retrieval("encode+index+search", dr_config, dr_folder)

    # ------------------------------------------------------------------
    def final_evaluations(self) -> None:
        config = self.config
        self.model.eval()
        for section, kind in (("validation_end", "end"), ("test", "test")):
            for name, entry in (config.get(section) or {}).items():
                metrics = test_model(self.eval_step, config, self.tokenizer, self.run_folder, f"{kind}-{name}",
                                     entry, self.device, self.model)
                if metrics:
                    headline = config.get("validation_metric", "MRR@10")
                    print(f"[{kind}:{name}] {headline}={metrics.get(headline, float('nan')):.4f}")
        for name, entry in (config.get("leaderboard") or {}).items():
            results = evaluate_model(self.eval_step, config, self.tokenizer, entry["tsv"], self.device)
            save_sorted_results(results, os.path.join(self.run_folder, f"leaderboard-{name}-output.txt"))
