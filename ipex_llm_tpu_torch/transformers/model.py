"""The HF-shaped causal LM (port of
``ipex_llm_tpu/transformers/model.py::TPUModelForCausalLM``).

The reference's class binds a config to a parameter tree and keeps the HF
call shape users script against: ``model.generate(input_ids,
max_new_tokens=...)`` takes a torch tensor or a numpy array and returns the
same kind, and records ``first_cost`` / ``rest_cost_mean`` like the
reference's BenchmarkWrapper.  This is its counterpart on the port's
``generation.generate``, on the device the params lie on.  Loading a
checkpoint (``from_pretrained``, ``load_low_bit``) and the speculative and
prompt-lookup entry points are not ported.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ipex_llm_tpu_torch.generation import (GenerateResult, GenerationConfig,
                                           generate)
from ipex_llm_tpu_torch.models.config import ModelConfig


class TPUModelForCausalLM:
    """A (quantized) causal LM bound to (config, param tree); the name is the
    reference's."""

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


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x
