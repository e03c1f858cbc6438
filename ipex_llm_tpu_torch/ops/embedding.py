"""Embedding lookup (port of ``ipex_llm_tpu/ops/embedding.py``): dense
tables only; a quantized table raises."""

from __future__ import annotations

import torch


def embed_lookup(table, ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """rows = table[ids] for a dense ``[vocab, hidden]`` table."""
    if not isinstance(table, torch.Tensor):
        raise NotImplementedError("quantized embedding tables are not ported")
    return table[ids.long()].to(dtype)
