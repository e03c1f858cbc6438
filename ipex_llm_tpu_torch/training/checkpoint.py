"""Training checkpoints: save and resume (params or adapters, optimizer
state, step, extras) (port of ``ipex_llm_tpu/training/checkpoint.py``).

The reference writes through ``orbax.checkpoint``; the port keeps its API
(``save``/``latest_step``/``restore``/``close``, ``max_to_keep``) over
``torch.save``, and keeps no orbax: it neither reads nor writes orbax's
files.  Each step is a directory ``<directory>/<step>`` holding
``state.pt`` (the tree's tensors, QTensor leaves as their planes, and the
optimizer's ``state_dict()``) and ``extras.json``; it is written under a
temporary name and renamed into place, so a reader sees a whole step or
none.  Past ``max_to_keep`` steps the oldest are removed.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import torch

from ipex_llm_tpu_torch.quantize.core import QTensor


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return {"__qtensor__": (tree.qtype, tuple(tree.shape),
                                tree.block_size),
                "planes": [None if t is None else t.detach().cpu()
                           for t in (tree.data, tree.scales, tree.zeros)]}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _copy_into(template, saved):
    """Copy ``saved`` into ``template``'s tensors in place (so an
    optimizer built over them stays bound); returns the template."""
    if isinstance(template, dict):
        for k in template:
            template[k] = _copy_into(template[k], saved[k])
        return template
    if isinstance(template, QTensor):
        for t, s in zip((template.data, template.scales, template.zeros),
                        saved["planes"]):
            if t is not None:
                with torch.no_grad():
                    t.copy_(s)
        return template
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(saved)
        return template
    return saved


class TrainCheckpointer:
    """Save and restore ``(params, opt_state, extras)`` by step under
    ``directory``, keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def save(self, step: int, params: Any, opt_state: Any = None,
             extras: dict | None = None, wait: bool = False) -> None:
        """Write step ``step`` (``opt_state``: a ``torch.optim`` optimizer
        or None; ``extras``: JSON-able).  The write is synchronous;
        ``wait`` is accepted for the reference's signature."""
        state = {"params": _to_cpu(params)}
        if opt_state is not None:
            state["opt_state"] = opt_state.state_dict()
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(state, os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "extras.json"), "w",
                      encoding="utf-8") as f:
                json.dump(extras, f)
            final = os.path.join(self.directory, str(step))
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: dict, step: int | None = None) -> dict:
        """Load step ``step`` (default the latest) into ``template``
        (``{"params": tree, "opt_state": optimizer, ...}``, as was saved):
        the tree's tensors are overwritten in place, the optimizer loads
        its state; returns ``{"params", "opt_state", "extras"}``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        path = os.path.join(self.directory, str(step))
        state = torch.load(os.path.join(path, "state.pt"),
                           weights_only=False)
        out = {"params": _copy_into(template["params"], state["params"])}
        if "opt_state" in state and template.get("opt_state") is not None:
            template["opt_state"].load_state_dict(state["opt_state"])
            out["opt_state"] = template["opt_state"]
        with open(os.path.join(path, "extras.json"), encoding="utf-8") as f:
            extras = json.load(f)
        if extras is not None:
            out["extras"] = extras
        return out

    def close(self):
        """Nothing is in flight (writes are synchronous)."""
