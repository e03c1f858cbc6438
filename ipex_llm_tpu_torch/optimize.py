"""Generic ``optimize_model`` API (port of ``ipex_llm_tpu/optimize.py``).

A loaded HF torch model is a weight source: its ``state_dict`` streams
through ``models/build.py::build_params``, as a checkpoint does in
``from_pretrained``, giving a ``TPUModelForCausalLM`` on the target
device.  The torch model is left untouched (the caller may free it).
``low_memory_init`` and ``load_low_bit`` mirror the reference's reload
pair; weights are only ever materialised quantized, so
``low_memory_init`` has nothing to do.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Any


def optimize_model(model: Any, low_bit: str = "sym_int4", device=None,
                   **kwargs):
    """Convert a loaded HF torch model (anything with ``.config.to_dict()``
    and ``.state_dict()``) to a quantized ``TPUModelForCausalLM`` on
    ``device`` (``None`` = cuda); a ``TPUModelForCausalLM`` passes through.

    ``modules_to_not_convert=["lm_head"]`` keeps the lm head bf16; other
    entries warn, as in the reference (the merged-slot decoder has no
    per-module granularity).  ``optimize_llm`` is accepted; the quantized
    embedding options raise (ROADMAP item 12)."""
    from ipex_llm_tpu_torch.models.build import build_params
    from ipex_llm_tpu_torch.models.families import get_family
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    if isinstance(model, TPUModelForCausalLM):
        return model
    if not hasattr(model, "state_dict") or not hasattr(model, "config"):
        raise TypeError(
            "optimize_model expects an HF torch model or a "
            f"TPUModelForCausalLM, got {type(model)}")
    hf_config = model.config.to_dict()
    family = get_family(hf_config.get("model_type", "llama"), hf_config)
    cfg = family.to_config(hf_config)
    state = model.state_dict()

    lm_head_qtype = None
    skip = list(kwargs.pop("modules_to_not_convert", []) or [])
    if "lm_head" in skip:
        lm_head_qtype = "bf16"
        skip.remove("lm_head")
    if skip:
        warnings.warn(
            f"modules_to_not_convert={skip} has no per-module equivalent in "
            "the merged-slot decoder; these stay quantized")
    if kwargs.pop("embedding_qtype", None) or kwargs.pop("cpu_embedding",
                                                         False):
        raise NotImplementedError(
            "a quantized embedding table is not ported (ROADMAP item 12)")
    kwargs.pop("optimize_llm", None)

    params = build_params(
        cfg, family.scheme, lambda n: state[n].detach(),
        lambda n: n in state, qtype=low_bit, lm_head_qtype=lm_head_qtype,
        moe_scheme=family.moe, qkv_transform=family.qkv_transform,
        transpose_weights=family.transpose_weights, device=device)
    return TPUModelForCausalLM(cfg, params, hf_config, low_bit)


def load_low_bit(model_or_path: Any, model_path: str | None = None,
                 device=None):
    """Reload a ``save_low_bit`` directory: the path alone, or (model,
    path) as in the reference, the model being ignored (no skeleton is
    needed)."""
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    path = model_path if model_path is not None else model_or_path
    return TPUModelForCausalLM.load_low_bit(path, device=device)


@contextmanager
def low_memory_init():
    """The reference's meta-device context (see the module docstring)."""
    yield
