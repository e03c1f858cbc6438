"""The drop-in ``AutoModelForCausalLM`` (port of
``ipex_llm_tpu/transformers/model.py``).

``from_pretrained(path, load_in_low_bit="sym_int4")`` treats a local HF
checkpoint as a weight source: tensors stream from its safetensors shards
(or torch bins) through ``models/build.py::build_params``, each quantized
on the target device as it is read, so no full-precision model is ever
built, on the host or on the card.  ``save_low_bit``/``load_low_bit``
write and read the reference's low-bit files.  The model keeps the HF call
shape users script against: ``model.generate(input_ids,
max_new_tokens=...)`` takes a torch tensor or a numpy array and returns the
same kind, and records ``first_cost`` / ``rest_cost_mean`` like the
reference's BenchmarkWrapper; ``model(input_ids)`` returns the logits.

Families: llama and mistral (``models/families.py``).  Not ported, each
raising ``NotImplementedError`` with its ROADMAP item: GGUF and GPTQ/AWQ
import, ``imatrix``, ``embedding_qtype``/``cpu_embedding``/
``disk_embedding``, ``speculative=`` and the prompt-lookup path, ``mesh``,
and the bert, rwkv, yuan and the other ``Auto*`` model classes.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.generation import (GenerateResult, GenerationConfig,
                                           generate)
from ipex_llm_tpu_torch.kv import make_cache
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.build import build_params
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.models.families import get_family
from ipex_llm_tpu_torch.models.loader import CheckpointReader, read_config
from ipex_llm_tpu_torch.quantize import qtypes


def _resolve_qtype(kwargs: dict) -> str:
    """Map the reference's loading kwargs to one qtype name."""
    low_bit = kwargs.pop("load_in_low_bit", None)
    load_4bit = kwargs.pop("load_in_4bit", False)
    if low_bit is None:
        low_bit = "sym_int4" if load_4bit else "bf16"
    try:
        qtypes.resolve(low_bit)
    except ValueError:
        raise ValueError(
            f"load_in_low_bit={low_bit!r} is not supported; choose from "
            f"{qtypes.all_qtypes()}") from None
    return low_bit


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported (ROADMAP item {item})")


class TPUModelForCausalLM:
    """A (quantized) causal LM bound to (config, param tree); the name is the
    reference's.  The tree's device is the model's."""

    def __init__(self, cfg: ModelConfig, params: dict, hf_config: dict,
                 qtype: str):
        self.config = cfg
        self.hf_config = hf_config
        self.params = params
        self.qtype = qtype
        # BenchmarkWrapper-compatible timing attributes
        self.first_cost: float | None = None
        self.rest_cost_mean: float | None = None
        self.last_result: GenerateResult | None = None
        self.generation_config = GenerationConfig(
            eos_token_id=self._eos_ids(hf_config),
            pad_token_id=hf_config.get("pad_token_id") or 0)

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, *args,
                        device=None, **kwargs) -> "TPUModelForCausalLM":
        """Load and quantize a local HF checkpoint directory onto ``device``
        (``None`` = cuda).  Keyword arguments take the reference's names:
        ``load_in_low_bit``, ``load_in_4bit``, ``mixed_precision`` (the
        lm head at sym_int8); ``optimize_model``, ``torch_dtype``,
        ``trust_remote_code`` and ``model_hub`` are accepted and dropped,
        as there."""
        path = str(pretrained_model_name_or_path)
        if not os.path.isdir(path):
            raise ValueError(
                f"{path!r} is not a local directory; download the checkpoint "
                "first (hub download is not available in this environment)")
        qtype = _resolve_qtype(kwargs)
        mixed_precision = kwargs.pop("mixed_precision", False)
        for key, item in (("imatrix", "13"), ("embedding_qtype", "12"),
                          ("cpu_embedding", "12"), ("disk_embedding", "12"),
                          ("speculative", "12"), ("mesh", "15")):
            if kwargs.pop(key, None):
                _refuse(f"from_pretrained({key}=...)", item)
        for key in ("optimize_model", "torch_dtype", "trust_remote_code",
                    "model_hub"):
            kwargs.pop(key, None)
        hf_config = read_config(path)
        model_type = hf_config.get("model_type", "llama")
        if model_type in ("bert", "rwkv", "rwkv5", "yuan", "baichuan_m1"):
            _refuse(f"the {model_type} model class", "14")
        qc = hf_config.get("quantization_config")
        if qc and qc.get("quant_method") in ("gptq", "awq"):
            _refuse(f"{qc['quant_method']} checkpoint import", "13")
        family = get_family(model_type, hf_config)
        cfg = family.to_config(hf_config)
        reader = CheckpointReader(path)
        params = build_params(
            cfg, family.scheme, reader.get, reader.has, qtype=qtype,
            mixed_precision=mixed_precision, moe_scheme=family.moe,
            qkv_transform=family.qkv_transform,
            transpose_weights=family.transpose_weights, device=device)
        return cls(cfg, params, hf_config, qtype)

    @classmethod
    def load_low_bit(cls, path, *args, device=None,
                     **kwargs) -> "TPUModelForCausalLM":
        """Reload a ``save_low_bit`` directory (the reference's or the
        port's) onto ``device`` (``None`` = cuda)."""
        if kwargs.pop("mesh", None) is not None:
            _refuse("load_low_bit(mesh=...)", "15")
        params, hf_config, qtype = serialize.load_low_bit(str(path), device)
        family = get_family(hf_config.get("model_type", "llama"), hf_config)
        return cls(family.to_config(hf_config), params, hf_config, qtype)

    def save_low_bit(self, path) -> None:
        serialize.save_low_bit(str(path), self.params, self.hf_config,
                               self.qtype)

    # -- inference ----------------------------------------------------------

    @staticmethod
    def _eos_ids(hf_config: dict) -> tuple[int, ...]:
        eos = hf_config.get("eos_token_id")
        if eos is None:
            return ()
        if isinstance(eos, int):
            return (eos,)
        return tuple(eos)

    def generate(self, input_ids: Any = None, attention_mask: Any = None,
                 streamer: Any = None,
                 generation_config: GenerationConfig | None = None,
                 **kwargs):
        """HF-shaped generate; returns prompt+new tokens, of the input's
        type (a torch ``LongTensor`` for a tensor, else a numpy array).
        Rows are filtered by ``attention_mask``; HF kwargs
        (``max_new_tokens``, ``do_sample``, ``temperature``, ``top_p``,
        ``eos_token_id``, ...) override the model's generation config; a
        ``streamer`` receives ``put(row)`` per token row and ``end()``."""
        if input_ids is None:
            raise ValueError("input_ids is required")
        was_torch = isinstance(input_ids, torch.Tensor)
        tokens = np.asarray(_to_numpy(input_ids), np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        if attention_mask is not None:
            am = np.asarray(_to_numpy(attention_mask)).astype(bool)
            rows = [tokens[i][am[i]] for i in range(len(tokens))]
        else:
            rows = list(tokens)
        gcfg = (generation_config or self.generation_config).with_kwargs(
            kwargs)
        # the reference switches long greedy single prompts to prompt-lookup
        # decoding under IPEX_LLM_PERFORMANCE_MODE=1
        if (os.environ.get("IPEX_LLM_PERFORMANCE_MODE") == "1"
                and len(rows) == 1 and len(rows[0]) >= 512
                and streamer is None and not gcfg.do_sample):
            raise NotImplementedError(
                "prompt-lookup decoding (IPEX_LLM_PERFORMANCE_MODE=1) is not "
                "ported")
        stream_cb = None
        if streamer is not None:
            def stream_cb(row):    # HF streamer protocol: put(token_ids)
                streamer.put(torch.from_numpy(np.asarray(row, np.int64)))

        res = generate(self.config, self.params, rows, gcfg,
                       streamer=stream_cb)
        if streamer is not None and hasattr(streamer, "end"):
            streamer.end()
        self.first_cost = res.first_token_s
        self.rest_cost_mean = res.rest_token_s
        self.last_result = res
        out = np.ascontiguousarray(res.sequences)
        if was_torch:
            return torch.from_numpy(out).long()
        return out


    @torch.no_grad()
    def __call__(self, input_ids: Any, **kwargs) -> torch.Tensor:
        """Full-sequence forward over a dense cache: fp32 logits
        ``[B, T, V]`` on the model's device."""
        tokens = np.asarray(_to_numpy(input_ids), np.int32)
        if tokens.ndim == 1:
            tokens = tokens[None]
        b, t = tokens.shape
        dev = self.params["embed"].device
        cfg = self.config
        cache = make_cache("normal", cfg.num_layers, b, max(t, 1),
                           cfg.num_kv_heads, cfg.head_dim,
                           v_head_dim=cfg.v_dim, device=dev)
        pos = torch.arange(t, device=dev)[None].expand(b, t)
        logits, _ = decoder_forward(cfg, self.params,
                                    torch.from_numpy(tokens).to(dev), cache,
                                    pos)
        return logits

    # -- HF parity helpers --------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def to(self, device, *args, **kwargs) -> "TPUModelForCausalLM":
        """Move the tree to ``device`` (a dtype argument is ignored: the
        tree keeps its widths)."""
        if isinstance(device, torch.dtype):
            return self
        dev = resolve_device(device)
        self.params = _tree_to(self.params, dev)
        return self

    def eval(self) -> "TPUModelForCausalLM":
        return self

    def half(self) -> "TPUModelForCausalLM":
        return self


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if hasattr(tree, "to") else tree


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


AutoModelForCausalLM = TPUModelForCausalLM
AutoModel = TPUModelForCausalLM     # the reference aliases it too


class _NotYetSupported:
    """Loader stub for the reference's other ``Auto*`` classes, whose models
    the port does not have yet: they raise instead of mis-loading a
    checkpoint as a causal LM."""

    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        raise NotImplementedError(
            f"{cls.__name__} is not ported (ROADMAP item 14); only the "
            "llama and mistral causal LMs load")

    load_low_bit = from_pretrained


class AutoModelForSpeechSeq2Seq(_NotYetSupported):
    """Whisper (reference ``models/whisper.py``)."""


class AutoModelForSequenceClassification(_NotYetSupported):
    """Bert-style classifiers (reference ``models/bert.py``)."""


class AutoModelForMaskedLM(_NotYetSupported):
    """Bert-style MLMs (reference ``models/bert.py``)."""


class AutoModelForSeq2SeqLM(_NotYetSupported):
    """Whisper through the seq2seq name (reference ``models/whisper.py``)."""


class AutoModelForVision2Seq(_NotYetSupported):
    """Vision-language models (reference ``transformers/multimodal.py``)."""
