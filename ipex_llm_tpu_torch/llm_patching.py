"""One-line patching of existing HF scripts onto the port (port of
``ipex_llm_tpu/llm_patching.py``).

``llm_patch`` swaps ``transformers.AutoModelForCausalLM`` and friends for
the port's drop-in classes, so an unmodified script picks up the port:

    from ipex_llm_tpu_torch import llm_patch
    llm_patch()
    from transformers import AutoModelForCausalLM   # now the port's class

``train=True`` also makes ``transformers.Trainer`` build the port's
``TPUTrainer`` for the port's models (``training.hf_trainer``).
``transformers`` is imported only when patching.
"""

from __future__ import annotations

import sys

_patched_attrs: list[tuple[object, str, object]] = []
_patched: str | None = None


def _replace_attr(obj, name: str, value) -> None:
    _patched_attrs.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _restore() -> None:
    for obj, name, orig in reversed(_patched_attrs):
        setattr(obj, name, orig)
    _patched_attrs.clear()


def _resolved(names: list[str]):
    """The ``transformers`` module with ``names`` imported.  Resolving a
    lazy name can put a new module object in ``sys.modules`` (a model's
    import may re-create the package's lazy module), so the names are
    resolved until the module stays the same, and that one is patched."""
    import importlib

    mod = importlib.import_module("transformers")
    while True:
        for name in names:
            getattr(mod, name)
        now = sys.modules["transformers"]
        if now is mod:
            return mod
        mod = now


def llm_patch(train: bool = False) -> None:
    """Swap transformers' Auto classes (and ``LlamaForCausalLM``) for the
    port's; with ``train`` also its ``Trainer``.  A second call is a
    no-op until :func:`llm_unpatch`."""
    global _patched
    if _patched:
        return
    from ipex_llm_tpu_torch.training.hf_trainer import \
        patch_transformers_trainer
    from ipex_llm_tpu_torch.transformers import (AutoModel,
                                                 AutoModelForCausalLM,
                                                 AutoModelForSpeechSeq2Seq,
                                                 AutoModelForVision2Seq)

    swaps = {"AutoModelForCausalLM": AutoModelForCausalLM,
             "AutoModel": AutoModel,
             "AutoModelForSpeechSeq2Seq": AutoModelForSpeechSeq2Seq,
             "AutoModelForVision2Seq": AutoModelForVision2Seq,
             # common direct-class uses in example scripts
             "LlamaForCausalLM": AutoModelForCausalLM}
    transformers = _resolved(list(swaps) + (["Trainer"] if train else []))
    try:
        for name, value in swaps.items():
            _replace_attr(transformers, name, value)
        if train:
            patch_transformers_trainer()
    except Exception:
        # roll back a partial patch, so transformers is never left mixed
        # and a later llm_patch() can retry
        _restore()
        raise
    _patched = "Train" if train else "Inference"


def llm_unpatch() -> None:
    """Restore the original transformers attributes (also a
    ``patch_transformers_trainer`` made alone)."""
    global _patched
    _restore()
    _patched = None
