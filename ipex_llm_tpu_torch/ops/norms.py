"""RMSNorm and LayerNorm (port of ``ipex_llm_tpu/ops/norms.py``)."""

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32: the mean and the (biased) variance of ``x``
    widened to fp32, then the weight and the bias in fp32, cast back to
    ``x.dtype`` (the reference's rounding points)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dt)
