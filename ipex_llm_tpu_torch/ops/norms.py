"""RMSNorm (port of ``ipex_llm_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in fp32, cast back to ``x.dtype`` (the reference's rounding
    points); ``offset=1.0`` is gemma's (1 + w), added to the weight in
    fp32."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (weight.to(torch.float32) + offset)).to(dt)
