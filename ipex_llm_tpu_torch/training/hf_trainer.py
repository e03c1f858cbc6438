"""A ``transformers.Trainer``-shaped bridge (port of
``ipex_llm_tpu/training/hf_trainer.py``).

The finetune recipe surface -- ``Trainer(model, args, train_dataset,
data_collator)`` with HF ``TrainingArguments`` -- drives the port's steps:
QLoRA adapters (``training/qlora.py``) when given a ``PeftModel``,
full-parameter training otherwise.  Batches pad to power-of-two length
buckets (HF's ``labels == -100`` convention becomes the loss mask), as the
reference's do.  The default optimizer is AdamW with the args'
``weight_decay`` (0.0 when unset, as the reference's; PyTorch's own
default would be 0.01) under the args' learning-rate schedule (linear
warmup, then linear decay, cosine or constant).  ``transformers`` is
imported only by :func:`patch_transformers_trainer`.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _get(args: Any, name: str, default):
    v = getattr(args, name, default)
    return default if v is None else v


def lr_schedule(args: Any, total_steps: int) -> Callable[[int], float]:
    """The learning rate at a step (optax's schedules as the reference
    joins them): a linear ramp from 0 over ``warmup_steps``, then linear
    decay to 0 (HF's default), cosine decay, or constant."""
    lr = float(_get(args, "learning_rate", 5e-5))
    warmup = int(_get(args, "warmup_steps", 0))
    kind = str(_get(args, "lr_scheduler_type", "linear"))
    span = max(total_steps - warmup, 1)

    def tail(s: int) -> float:
        if "cosine" in kind:
            return lr * 0.5 * (1 + math.cos(math.pi * min(s, span) / span))
        if "constant" in kind:
            return lr
        return lr * (1 - min(s, span) / span)

    def at(step: int) -> float:
        if warmup and step < warmup:
            return lr * step / warmup
        return tail(step - warmup if warmup else step)

    return at


class TPUTrainer:
    """The ``transformers.Trainer`` finetune surface over the port.

    model: ``TPUModelForCausalLM`` (full-parameter training) or
    ``training.qlora.PeftModel`` (QLoRA adapters over the frozen quantized
    base).  ``optimizers``: HF's pair, a ``torch.optim`` optimizer built
    over the trained tensors (the adapters, or the model's trainable
    leaves) and its LR scheduler or None; ``(None, None)`` is the default
    AdamW under the args' schedule.
    """

    def __init__(self, model, args=None, train_dataset=None,
                 data_collator=None, tokenizer=None, optimizers=(None, None),
                 **kwargs: Any):
        self.model = model
        self.args = args
        self.train_dataset = train_dataset
        self.data_collator = data_collator
        self.tokenizer = tokenizer
        self._optimizer, self._scheduler = optimizers
        self.state_log: list[dict] = []

    # -- data ---------------------------------------------------------------

    def _batches(self) -> Iterable[tuple[np.ndarray, np.ndarray]]:
        """Yield (tokens [B, T], mask [B, T]) per step, padded to buckets;
        the order is the reference's (``default_rng(seed)``)."""
        bsz = int(_get(self.args, "per_device_train_batch_size", 4))
        seed = int(_get(self.args, "seed", 0))
        data = list(self.train_dataset)
        order = np.random.default_rng(seed).permutation(len(data))
        for s in range(0, len(data) - bsz + 1, bsz):
            rows = [data[int(i)] for i in order[s:s + bsz]]
            if self.data_collator is not None:
                feats = self.data_collator(rows)
                ids = np.asarray(feats["input_ids"])
                labels = np.asarray(feats.get("labels", feats["input_ids"]))
            else:
                seqs = [np.asarray(r["input_ids"]).reshape(-1) for r in rows]
                lab = [np.asarray(r.get("labels", r["input_ids"])).reshape(-1)
                       for r in rows]
                t = _bucket(max(len(x) for x in seqs))
                ids = np.zeros((bsz, t), np.int64)
                labels = np.full((bsz, t), -100, np.int64)
                for j, (q, l) in enumerate(zip(seqs, lab)):
                    ids[j, : len(q)] = q
                    labels[j, : len(l)] = l
            t = _bucket(ids.shape[1])
            if ids.shape[1] != t:
                pad = t - ids.shape[1]
                ids = np.pad(ids, ((0, 0), (0, pad)))
                labels = np.pad(labels, ((0, 0), (0, pad)),
                                constant_values=-100)
            yield ids.astype(np.int32), (labels != -100).astype(np.float32)

    def _n_steps(self) -> int:
        bsz = int(_get(self.args, "per_device_train_batch_size", 4))
        per_epoch = max(len(self.train_dataset) // bsz, 1)
        max_steps = int(_get(self.args, "max_steps", -1))
        if max_steps and max_steps > 0:
            return max_steps
        return per_epoch * int(_get(self.args, "num_train_epochs", 1))

    # -- training -----------------------------------------------------------

    def _build(self, total_steps: int):
        from ipex_llm_tpu_torch.training.qlora import (PeftModel,
                                                       make_qlora_train_step)
        from ipex_llm_tpu_torch.training.step import (causal_lm_loss,
                                                      init_optimizer,
                                                      make_train_step)

        # the steps take one `tokens` argument: pack (ids, mask) and let
        # the loss unpack, so HF's labels == -100 convention flows through
        def masked_loss(cfg, params, pack):
            ids, mask = pack
            return causal_lm_loss(cfg, params, ids, loss_mask=mask[:, 1:])

        peft = isinstance(self.model, PeftModel)
        cfg = self.model.model.config if peft else self.model.config
        tree = self.model.adapters if peft else self.model.params
        opt, sched = self._optimizer, self._scheduler
        if opt is None:
            schedule = lr_schedule(self.args, total_steps)
            opt = init_optimizer(functools.partial(
                torch.optim.AdamW, lr=1.0, weight_decay=float(
                    _get(self.args, "weight_decay", 0.0))), tree)
            # lr 1.0 times the schedule's value: AdamW multiplies its
            # decoupled decay by the scheduled lr, as optax's adamw does
            sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
        else:
            for group in opt.param_groups:
                for t in group["params"]:
                    t.requires_grad_(True)
        if peft:
            step = make_qlora_train_step(cfg, None, self.model.lora_cfg,
                                         loss_fn=masked_loss)

            def run(opt_state, ids, mask):
                return step(self.model.adapters, opt_state, (ids, mask),
                            self.model.model.params)[1:]
        else:
            step = make_train_step(cfg, None, loss_fn=masked_loss)

            def run(opt_state, ids, mask):
                return step(self.model.params, opt_state, (ids, mask))[1:]
        return opt, sched, run

    def train(self) -> dict:
        total = self._n_steps()
        opt, sched, run = self._build(total)
        dev = (self.model.model if hasattr(self.model, "lora_cfg")
               else self.model).params["embed"].device
        log_every = int(_get(self.args, "logging_steps", 10)) or 10
        out_dir = _get(self.args, "output_dir", None)
        save_steps = int(_get(self.args, "save_steps", 0) or 0)
        epochs = int(_get(self.args, "num_train_epochs", 1))

        n = 0
        t0 = time.perf_counter()
        done = False
        for _ in range(max(epochs, 1)):
            if done:
                break
            for ids, mask in self._batches():
                opt, loss = run(opt, torch.from_numpy(ids).to(dev),
                                torch.from_numpy(mask).to(dev))
                if sched is not None:
                    sched.step()
                n += 1
                if n % log_every == 0 or n == total:
                    rec = {"step": n, "loss": float(loss),
                           "elapsed_s": round(time.perf_counter() - t0, 2)}
                    self.state_log.append(rec)
                    print(f"step {n}/{total} loss {rec['loss']:.4f}")
                if save_steps and out_dir and n % save_steps == 0:
                    self.save_model(os.path.join(out_dir, f"checkpoint-{n}"))
                if n >= total:
                    done = True
                    break
        if out_dir:
            self.save_model(out_dir)
        return {"global_step": n,
                "train_loss": (self.state_log[-1]["loss"]
                               if self.state_log else float("nan"))}

    def save_model(self, output_dir: str):
        """A PeftModel's adapters (the peft convention: adapters only,
        through ``TrainCheckpointer``), else the model's ``save_low_bit``."""
        from ipex_llm_tpu_torch.training.qlora import PeftModel

        os.makedirs(output_dir, exist_ok=True)
        if isinstance(self.model, PeftModel):
            from ipex_llm_tpu_torch.training.checkpoint import \
                TrainCheckpointer

            TrainCheckpointer(output_dir).save(0, self.model.adapters)
        else:
            self.model.save_low_bit(output_dir)


def trainer_switch(orig):
    """A stand-in for ``transformers.Trainer`` (``orig``) that builds a
    :class:`TPUTrainer` when its model is one of the port's."""

    class _Switch:
        def __new__(cls, model=None, *a, **kw):
            from ipex_llm_tpu_torch.training.qlora import PeftModel
            from ipex_llm_tpu_torch.transformers.model import \
                TPUModelForCausalLM

            if isinstance(model, (PeftModel, TPUModelForCausalLM)):
                return TPUTrainer(model, *a, **kw)
            return orig(model, *a, **kw)

    return _Switch


def patch_transformers_trainer():
    """Point ``transformers.Trainer`` at :func:`trainer_switch` (the
    ``llm_patch(train=True)`` companion, the reference's
    llm_patching.py:35-71), on the module that ``llm_patching`` resolves
    and so that ``llm_unpatch`` undoes it; returns the original class."""
    from ipex_llm_tpu_torch import llm_patching

    transformers = llm_patching._resolved(["Trainer"])
    orig = transformers.Trainer
    llm_patching._replace_attr(transformers, "Trainer", trainer_switch(orig))
    return orig
