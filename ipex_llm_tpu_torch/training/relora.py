"""ReLoRA: periodic merge-and-reset of the LoRA adapters into the base
(port of ``ipex_llm_tpu/training/relora.py``).

The reference's ``ReLoRATrainer``/``ReLoRAScheduler`` (its relora.py:64,
286): every ``relora_steps`` the adapters are merged into the base weights
(requantized with the scale search), drawn anew, and their optimizer
state is reset; the learning rate follows a jagged cosine with restarts
(:func:`jagged_cosine_schedule`, e.g. through
``torch.optim.lr_scheduler.LambdaLR``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ipex_llm_tpu_torch.training.qlora import (LoraConfig, init_lora,
                                               make_qlora_train_step,
                                               merge_lora)
from ipex_llm_tpu_torch.training.step import init_optimizer


def jagged_cosine_schedule(base_lr: float, total_steps: int,
                           restart_every: int, warmup: int = 10,
                           min_ratio: float = 0.1) -> Callable[[int], float]:
    """The learning rate at a step: cosine decay to ``min_ratio`` over
    ``total_steps``, each restart after the first cycle re-warmed linearly
    over ``warmup`` steps (the reference's ReLoRAScheduler)."""

    def lr(step) -> float:
        step = int(step)
        cos = 0.5 * (1 + math.cos(math.pi * step / max(total_steps, 1)))
        scale = min_ratio + (1 - min_ratio) * cos
        rewarm = 1.0 if step < restart_every else min(
            1.0, (step % restart_every) / max(warmup, 1))
        return base_lr * scale * rewarm

    return lr


@dataclass
class ReLoRATrainer:
    """A step-driven trainer with a merge-and-reset every
    ``relora_steps``; ``optimizer`` builds the adapters' optimizer (as
    ``training.step.init_optimizer`` takes it)."""

    model: object
    lora_cfg: LoraConfig
    optimizer: Callable
    relora_steps: int = 100
    seed: int = 0

    def __post_init__(self):
        self.adapters = init_lora(self.seed, self.model.config,
                                  self.model.params, self.lora_cfg)
        self.opt_state = init_optimizer(self.optimizer, self.adapters)
        self._step_fn = make_qlora_train_step(self.model.config,
                                              self.optimizer, self.lora_cfg)
        self.step_count = 0

    def step(self, tokens) -> float:
        tokens = torch.as_tensor(tokens,
                                 device=self.model.params["embed"].device)
        self.adapters, self.opt_state, loss = self._step_fn(
            self.adapters, self.opt_state, tokens, self.model.params)
        self.step_count += 1
        if self.step_count % self.relora_steps == 0:
            self.merge_and_reset()
        return float(loss)

    def merge_and_reset(self):
        """Fold the adapters into the base, draw new ones, and reset their
        optimizer state (the reference's relora.py:149)."""
        self.model.params = merge_lora(self.model.params, self.adapters,
                                       self.lora_cfg)
        self.seed += 1
        self.adapters = init_lora(self.seed, self.model.config,
                                  self.model.params, self.lora_cfg)
        self.opt_state = init_optimizer(self.optimizer, self.adapters)
