"""QLoRA: LoRA adapters over a frozen block-quantized base (port of
``ipex_llm_tpu/training/qlora.py``).

A ``LoraWeight`` wraps a frozen base weight (a QTensor in a block format,
or bf16) with the trainable adapters (A, B); ``ops.linear.linear`` adds
``(x A) B alpha/r`` to the base's output in the adapters' fp32.  The base
runs through B2 and its input gradient through B2^T; the packed planes
get no gradient, so only the adapters are optimizer targets.  Adapters
are drawn from an explicit ``torch.Generator`` (the reference's JAX keys
are not reproduced: tests carry the reference's adapters across with
``models.convert.adapters_from_reference``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.quantize import core as qcore
from ipex_llm_tpu_torch.quantize.core import QTensor
from ipex_llm_tpu_torch.training.step import (backward_step, causal_lm_loss,
                                              init_optimizer)


@dataclass(frozen=True)
class LoraConfig:
    """The reference's ``LoraConfig`` (its qlora.py:29)."""

    r: int = 8
    lora_alpha: int = 16
    target_modules: tuple[str, ...] = ("qkv", "o", "gate_up", "down")
    lora_dropout: float = 0.0  # applied by the caller's data pipeline
    train_embeddings: bool = False

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.r


@dataclass
class LoraWeight:
    """A frozen base weight and its trainable LoRA adapters."""

    base: Any               # QTensor or a dense matrix, frozen
    a: torch.Tensor         # [..., in, r]
    b: torch.Tensor         # [..., r, out]
    scale: float = 1.0


def _slot_dims(w) -> tuple[int, int]:
    if isinstance(w, QTensor):
        return w.in_features, w.out_features
    return w.shape[-2], w.shape[-1]


def _generator(gen, device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def init_lora(gen, cfg: ModelConfig, params: dict, lora_cfg: LoraConfig,
              dtype=torch.float32) -> dict:
    """The trainable adapter tree ``{slot: {"a": [L, in, r], "b": [L, r,
    out]}}`` on the params' device: A ~ N(0, 1/r) drawn from ``gen`` (a
    ``torch.Generator`` on that device, or a seed), B = 0, so the attached
    model starts exactly equal to the base."""
    dev = params["embed"].device
    gen = _generator(gen, dev)
    adapters: dict[str, dict[str, torch.Tensor]] = {}
    n_l = cfg.num_layers
    for slot in lora_cfg.target_modules:
        if slot not in params["layers"]:
            continue
        d_in, d_out = _slot_dims(params["layers"][slot])
        a = torch.randn((n_l, d_in, lora_cfg.r), generator=gen, device=dev,
                        dtype=dtype) / math.sqrt(lora_cfg.r)
        adapters[slot] = {"a": a, "b": torch.zeros((n_l, lora_cfg.r, d_out),
                                                   dtype=dtype, device=dev)}
    return adapters


def attach_lora(params: dict, adapters: dict, lora_cfg: LoraConfig) -> dict:
    """The tree with each target slot wrapped in a LoraWeight (the base
    leaves and adapters are shared, not copied)."""
    layers = dict(params["layers"])
    for slot, ab in adapters.items():
        layers[slot] = LoraWeight(base=params["layers"][slot], a=ab["a"],
                                  b=ab["b"], scale=lora_cfg.scale)
    return {**params, "layers": layers}


@torch.no_grad()
def merge_lora(params: dict, adapters: dict, lora_cfg: LoraConfig) -> dict:
    """Fold the adapters into the base weights: dequantize, add ``A B
    alpha/r`` (fp32), requantize each layer to its own format with the
    scale search (``quantize(..., optimize=True)``); a dense slot adds in
    fp32 and keeps its dtype.  The reference's merge (peft merge and
    ReLoRA's merge-and-reset)."""
    layers = dict(params["layers"])
    for slot, ab in adapters.items():
        base = layers[slot]
        delta = torch.matmul(ab["a"], ab["b"]) * lora_cfg.scale
        if isinstance(base, QTensor) and base.qtype != "bf16":
            merged = [qcore.quantize(
                qcore.dequantize(base.planes(lambda t, i=i: t[i])) + delta[i],
                base.qtype, base.block_size or None, optimize=True)
                for i in range(delta.shape[0])]

            def stack(plane):
                planes = [getattr(m, plane) for m in merged]
                return None if planes[0] is None else torch.stack(planes)
            layers[slot] = QTensor(stack("data"), stack("scales"),
                                   stack("zeros"), base.qtype, base.shape,
                                   base.block_size)
        else:
            w = base.data if isinstance(base, QTensor) else base
            new = (w.to(torch.float32) + delta).to(w.dtype)
            layers[slot] = (QTensor(new, None, None, "bf16", base.shape, 0)
                            if isinstance(base, QTensor) else new)
    return {**params, "layers": layers}


def make_qlora_train_step(cfg: ModelConfig, optimizer: Callable,
                          lora_cfg: LoraConfig,
                          loss_fn: Callable | None = None) -> Callable:
    """``step(adapters, opt_state, tokens, base_params) -> (adapters,
    opt_state, loss)``: gradients reach the adapters only (the base's
    tensors never require grad), updated in place through ``opt_state``
    (``training.step.init_optimizer(optimizer, adapters)``, built on the
    first call when None)."""
    loss_fn = loss_fn or causal_lm_loss

    def step(adapters, opt_state, tokens, base_params):
        if opt_state is None:
            opt_state = init_optimizer(optimizer, adapters)
        p = attach_lora(base_params, adapters, lora_cfg)
        loss = backward_step(loss_fn(cfg, p, tokens), opt_state)
        return adapters, opt_state, loss

    return step


class PeftModel:
    """The trainable wrapper ``get_peft_model`` returns (the reference's
    qlora.py:181)."""

    def __init__(self, model, lora_cfg: LoraConfig, seed: int = 0):
        self.model = model
        self.lora_cfg = lora_cfg
        self.adapters = init_lora(seed, model.config, model.params, lora_cfg)
        self._step = None
        self._opt_state = None

    def compile(self, optimizer: Callable) -> "PeftModel":
        self._opt_state = init_optimizer(optimizer, self.adapters)
        self._step = make_qlora_train_step(self.model.config, optimizer,
                                           self.lora_cfg)
        return self

    def train_step(self, tokens) -> float:
        tokens = torch.as_tensor(tokens, device=self.model.params[
            "embed"].device)
        self.adapters, self._opt_state, loss = self._step(
            self.adapters, self._opt_state, tokens, self.model.params)
        return float(loss)

    def merge_and_unload(self):
        self.model.params = merge_lora(self.model.params, self.adapters,
                                       self.lora_cfg)
        return self.model


def get_peft_model(model, lora_cfg: LoraConfig, seed: int = 0) -> PeftModel:
    return PeftModel(model, lora_cfg, seed)
