"""LISA: layerwise importance sampling, training a random subset of the
decoder layers (port of ``ipex_llm_tpu/training/lisa.py``).

The reference's ``DynamicLayerActivationCallback`` (its lisa.py:23): every
``interval`` steps all decoder layers are frozen but ``n_layers`` drawn at
random (embedding, head and final norm stay trainable).  The layers are
one stacked tree ``[L, ...]``, so freezing is a gradient mask over the
leading axis, applied to each stacked leaf's ``.grad`` before the
optimizer steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.training.step import (backward_step, causal_lm_loss,
                                              init_optimizer,
                                              trainable_leaves)


def sample_active_layers(gen: torch.Generator, num_layers: int,
                         n_active: int) -> torch.Tensor:
    """Bool mask [L] with exactly ``n_active`` True entries, drawn from
    ``gen``."""
    perm = torch.randperm(num_layers, generator=gen)
    mask = torch.zeros(num_layers, dtype=torch.bool)
    mask[perm[:n_active]] = True
    return mask


def mask_layer_grads(params: dict, layer_mask: torch.Tensor) -> None:
    """Zero, in place, the gradients of the frozen layers: every stacked
    ``[L, ...]`` leaf under ``params["layers"]`` where ``layer_mask`` is
    False (embedding, head and final norm untouched, as the reference
    keeps them active)."""
    n_l = layer_mask.shape[0]
    for t in trainable_leaves(params["layers"], False):
        if t.grad is not None and t.ndim >= 1 and t.shape[0] == n_l:
            keep = layer_mask.to(device=t.device, dtype=t.grad.dtype)
            t.grad.mul_(keep.reshape((-1,) + (1,) * (t.ndim - 1)))


def make_lisa_train_step(cfg: ModelConfig, optimizer: Callable,
                         loss_fn: Callable | None = None) -> Callable:
    """``step(params, opt_state, tokens, layer_mask) -> (params, opt_state,
    loss)``: a full-parameter step whose gradients reach only the layers
    ``layer_mask`` [L] keeps (``opt_state`` as in
    ``training.step.make_train_step``)."""
    loss_fn = loss_fn or causal_lm_loss

    def step(params, opt_state, tokens, layer_mask):
        if opt_state is None:
            opt_state = init_optimizer(optimizer, params)
        loss = backward_step(loss_fn(cfg, params, tokens), opt_state,
                             lambda: mask_layer_grads(params, layer_mask))
        return params, opt_state, loss

    return step


class LisaTrainer:
    """A step-driven trainer that draws a new active layer set every
    ``interval`` steps (the reference's lisa.py:67)."""

    def __init__(self, model, optimizer: Callable, n_active_layers: int = 2,
                 interval: int = 20, seed: int = 0):
        self.model = model
        self.n_active = n_active_layers
        self.interval = interval
        self.gen = torch.Generator().manual_seed(seed)
        self.opt_state = init_optimizer(optimizer, model.params)
        self._step_fn = make_lisa_train_step(model.config, optimizer)
        self.step_count = 0
        self._resample()

    def _resample(self):
        self.layer_mask = sample_active_layers(
            self.gen, self.model.config.num_layers, self.n_active)

    def step(self, tokens) -> float:
        if self.step_count and self.step_count % self.interval == 0:
            self._resample()
        tokens = torch.as_tensor(tokens,
                                 device=self.model.params["embed"].device)
        self.model.params, self.opt_state, loss = self._step_fn(
            self.model.params, self.opt_state, tokens, self.layer_mask)
        self.step_count += 1
        return float(loss)
