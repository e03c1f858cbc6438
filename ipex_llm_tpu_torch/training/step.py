"""The shared training step (port of ``ipex_llm_tpu/training/step.py``):
the causal-LM loss and one optimizer update over a ``torch.optim``
optimizer.

The reference builds one jitted program (``jax.value_and_grad`` plus an
optax update) that returns new params; the port runs the decoder's
training form eagerly (``models/decoder.py``, ``cache=None``: B2 and B4
forward, B2^T and B4's backward kernels under ``loss.backward()``) and
updates the trainable tensors in place through the optimizer, which holds
them (PyTorch's way: no copy of the tree a step).

An ``optimizer`` argument is what builds the optimizer over a list of
tensors: a ``torch.optim`` class or any callable, e.g.
``functools.partial(torch.optim.Adam, lr=1e-3)``.  :func:`init_optimizer`
(the counterpart of optax's ``optimizer.init(tree)``) marks a tree's
trainable leaves as requiring grad and builds it over them; the built
optimizer is the ``opt_state`` the steps take and return.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.decoder import (FROZEN_BUFFER_KEYS,
                                               decoder_forward)
from ipex_llm_tpu_torch.quantize.core import QTensor


def causal_lm_loss(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   loss_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch (fp32 log-softmax);
    ``tokens`` [B, T] int, ``loss_mask`` [B, T-1] 1.0 where a target
    counts."""
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)[None].expand(b, t)
    logits, _ = decoder_forward(cfg, params, tokens, None, pos)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    if loss_mask is not None:
        loss_mask = loss_mask.to(nll.dtype)
        return (nll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
    return nll.mean()


def trainable_leaves(tree: Any, _top: bool = True) -> list[torch.Tensor]:
    """The floating-point tensors of a param (or adapter) tree, in its
    order: a ``bf16`` QTensor's matrix, never packed planes, and never the
    top-level ``FROZEN_BUFFER_KEYS``."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                if not (_top and k in FROZEN_BUFFER_KEYS)
                for t in trainable_leaves(v, False)]
    if isinstance(tree, QTensor):
        return [tree.data] if tree.qtype == "bf16" else []
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


def init_optimizer(optimizer: Callable, tree: Any) -> torch.optim.Optimizer:
    """``optimizer`` built over ``tree``'s trainable leaves, each set to
    require grad."""
    leaves = trainable_leaves(tree)
    for t in leaves:
        t.requires_grad_(True)
    return optimizer(leaves)


def freeze_buffer_updates(updates: dict) -> dict:
    """``updates`` (a tree of gradients or updates) with the
    ``FROZEN_BUFFER_KEYS`` zeroed.  The port's optimizers never hold those
    buffers (:func:`trainable_leaves` skips them), so a decoupled weight
    decay cannot step them; this is for callers that apply a tree of
    updates themselves, as the reference's step does."""
    out = dict(updates)
    for k in FROZEN_BUFFER_KEYS:
        if isinstance(out.get(k), torch.Tensor):
            out[k] = torch.zeros_like(out[k])
    return out


def backward_step(loss: torch.Tensor, opt: torch.optim.Optimizer,
                  grad_hook: Callable | None = None) -> torch.Tensor:
    """Gradients of ``loss``, then ``grad_hook()`` (e.g. LISA's mask),
    then one optimizer step; returns the detached loss."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if grad_hook is not None:
        grad_hook()
    opt.step()
    return loss.detach()


def make_train_step(cfg: ModelConfig, optimizer: Callable,
                    loss_fn: Callable | None = None) -> Callable:
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``:
    full-parameter training of ``params``' trainable leaves, updated in
    place.  ``opt_state`` is :func:`init_optimizer`'s (built on the first
    call when None).  ``loss_fn(cfg, params, tokens)`` defaults to
    :func:`causal_lm_loss`."""
    loss_fn = loss_fn or causal_lm_loss

    def step(params, opt_state, tokens):
        if opt_state is None:
            opt_state = init_optimizer(optimizer, params)
        loss = backward_step(loss_fn(cfg, params, tokens), opt_state)
        return params, opt_state, loss

    return step
