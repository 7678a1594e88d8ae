"""Optimizer construction: counterpart of ``matchmaker_tpu/training/optim.py``.

The JAX package builds one optax chain: ``clip_by_global_norm`` (when
``gradient_clip_norm`` is set), then ``multi_transform`` of three
``optax.adamw`` with their own learning-rate schedules, over the parameter
labels "embedding", "encoder" and "head". Here the same update, step for step:

- labels as ``label_params``: everything under an encoder tower
  (``encoder``, ``query_encoder``, ``doc_encoder``) is "encoder", the word
  embeddings included; only a ``token_embedding`` path is "embedding";
  ``param_group1_names`` substrings force "head";
- the learning rate of a step is the schedule at the count before the step,
  as optax evaluates it, so step 0 of a warmup runs at lr 0;
- ``torch.optim.AdamW`` per group computes optax's ``adamw`` update
  ``-lr·(adam + wd·p)`` from the pre-step parameters (every parameter of a
  group decayed, the "embedding" group with weight decay 0);
- clipping scales every gradient by ``max/norm`` when ``norm > max``
  (optax's formula, not ``clip_grad_norm_``'s ``max/(norm + 1e-6)``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch

_ENCODER_TOWERS = ("encoder", "query_encoder", "doc_encoder")
_GROUPS = ("embedding", "encoder", "head")


def label_for(name: str, config) -> str:
    """The optax label of one parameter (``name`` with ``.`` separators)."""
    joined = name.replace(".", "/")
    group1_names = tuple(config.get("param_group1_names", []) or [])
    if group1_names and any(n in joined for n in group1_names):
        return "head"
    if "token_embedding" in joined:
        return "embedding"
    if joined.split("/")[0] in _ENCODER_TOWERS:
        return "encoder"
    return "head"


def schedule(lr: float, warmup_steps: int, total_steps: int, kind: str = "cosine") -> Callable[[int], float]:
    """The optax schedule ``matchmaker_tpu/training/optim.py:_schedule`` builds."""
    if warmup_steps <= 0 and kind == "constant":
        return lambda count: lr
    warm = max(warmup_steps, 1)
    if kind == "cosine":
        decay = max(total_steps, warmup_steps + 1) - warm
        alpha = 0.01  # end_value = lr * 0.01

        def cosine(count: int) -> float:
            if count < warm:
                return lr * count / warm
            c = min(count - warm, decay)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

        return cosine
    return lambda count: lr * min(count, warm) / warm if count < warm else lr


class Optimizer:
    """The optax chain over a model's named parameters: ``step()`` reads each
    parameter's ``.grad``, clips by the global norm and applies the group's
    AdamW at its scheduled learning rate. ``count`` is the optax step count."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], config):
        total = config.get("max_training_steps", 100_000)
        warmup = config.get("optimizer_warmup_steps", 1000)
        kind = config.get("lr_schedule", "cosine")
        head_lr = config.get("param_group1_learning_rate", config.get("learning_rate", 1e-4))
        encoder_lr = config.get("param_group0_learning_rate", config.get("learning_rate", 1e-5))
        emb_lr = config.get("embedding_optimizer_learning_rate", head_lr)
        wd = config.get("weight_decay", 0.0)
        hyper = {"embedding": (emb_lr, 0.0), "encoder": (encoder_lr, wd), "head": (head_lr, wd)}
        members: Dict[str, List[torch.nn.Parameter]] = {g: [] for g in _GROUPS}
        for name, p in named_params:
            members[label_for(name, config)].append(p)
        groups = [{"params": members[g], "lr": 0.0, "weight_decay": hyper[g][1], "label": g}
                  for g in _GROUPS if members[g]]
        self.schedules = {g: schedule(hyper[g][0], warmup, total, kind) for g in _GROUPS}
        self.params = [p for g in groups for p in g["params"]]
        self.clip = config.get("gradient_clip_norm", 0.0)
        self.adamw = torch.optim.AdamW(groups, betas=(config.get("adam_beta1", 0.9), config.get("adam_beta2", 0.999)),
                                       eps=config.get("adam_eps", 1e-8))
        self.count = 0

    def global_norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient (optax.global_norm)."""
        return torch.sqrt(sum((p.grad.float() ** 2).sum() for p in self.params if p.grad is not None))

    @torch.no_grad()
    def step(self, grad_norm: torch.Tensor = None) -> None:
        if self.clip:
            norm = self.global_norm() if grad_norm is None else grad_norm
            factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            for p in self.params:
                if p.grad is not None:
                    p.grad.mul_(factor)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def build_optimizer(config, model: torch.nn.Module) -> Optimizer:
    accum = config.get("gradient_accumulation_steps", 0)
    if accum and accum > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported yet (ROADMAP.md, queue 1 item 7)")
    return Optimizer(model.named_parameters(), config)
