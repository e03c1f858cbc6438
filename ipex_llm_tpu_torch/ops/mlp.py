"""Gated MLP activation (port of ``ipex_llm_tpu/ops/mlp.py``): SwiGLU only."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gated_act_mul(gate: torch.Tensor, up: torch.Tensor,
                  act: str = "silu") -> torch.Tensor:
    """silu(gate) * up: silu in fp32, cast to ``up.dtype``, then the product
    in that dtype (the reference's rounding points)."""
    if act != "silu":
        raise NotImplementedError(f"activation {act!r} is not ported")
    return F.silu(gate.to(torch.float32)).to(up.dtype) * up


def split_gate_up(gate_up: torch.Tensor):
    """Split a merged gate_up projection output into (gate, up)."""
    d = gate_up.shape[-1] // 2
    return gate_up[..., :d], gate_up[..., d:]
