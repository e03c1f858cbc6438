"""Rotary position embeddings (port of ``ipex_llm_tpu/ops/rope.py``).

The slice needs the default (unscaled) frequency table and the "half"
(rotate_half, llama) layout; scaled tables and the interleaved layout raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RopeScaling:
    """The rotary frequency table; only ``kind="default"`` is ported."""

    head_dim: int
    base: float = 10000.0
    kind: str = "default"
    factor: float = 1.0
    partial_rotary_factor: float = 1.0

    def __post_init__(self):
        if self.kind != "default" or self.factor != 1.0:
            raise NotImplementedError(
                f"rope scaling kind={self.kind!r} factor={self.factor} is "
                "not ported")
        if self.partial_rotary_factor != 1.0:
            raise NotImplementedError("partial rotary is not ported")

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.partial_rotary_factor)
        return rd - (rd % 2)

    def inv_freq(self) -> np.ndarray:
        rd = self.rotary_dim
        inv = 1.0 / (self.base ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
        return inv.astype(np.float32)


def cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
            mscale: float = 1.0):
    """positions [..., T] int -> (cos, sin) each [..., T, rotary_dim/2] fp32."""
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles) * mscale, torch.sin(angles) * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               layout: str = "half") -> torch.Tensor:
    """Rotate q or k: x [B, T, H, D]; cos/sin [B, T, D/2]; computed in fp32
    and returned in ``x.dtype``."""
    if layout != "half":
        raise NotImplementedError(f"rope layout {layout!r} is not ported")
    dt = x.dtype
    xf = x.to(torch.float32)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)
