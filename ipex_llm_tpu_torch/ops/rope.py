"""Rotary position embeddings (port of ``ipex_llm_tpu/ops/rope.py``).

The frequency table of every scaling kind the reference builds (default,
linear, dynamic NTK, llama3, yarn and longrope) and its ``mscale``, in
numpy float64 as the reference computes them, so the tables are the
reference's bit for bit; the "half" (rotate_half) layout and the
interleaved "two" layout (DeepSeek's, pairs ``(x[2i], x[2i+1])``), over
the whole head or its first ``rotary_dim`` columns (partial rotary).

The reference's departures from HF, mirrored here (ROADMAP queue 3): the
table is built once, at the model's ``max_position_embeddings``, so
``dynamic`` and ``longrope`` use the table of that length whatever a
sequence's own length; ``mscale`` is 1.0 for ``longrope`` without an
``attention_factor``; a kind the reference does not know (the old
``"su"``) gives the unscaled table.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RopeScaling:
    """The rotary frequency table of an HF ``rope_scaling`` config (the
    reference's fields)."""

    head_dim: int
    base: float = 10000.0
    # default | linear | dynamic | llama3 | yarn | longrope
    kind: str = "default"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192
    partial_rotary_factor: float = 1.0
    attention_factor: float | None = None
    short_factor: tuple[float, ...] | None = None
    long_factor: tuple[float, ...] | None = None

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.partial_rotary_factor)
        return rd - (rd % 2)

    def inv_freq(self, seq_len: int | None = None) -> np.ndarray:
        """[rotary_dim / 2] float32 inverse frequencies for sequences of
        ``seq_len`` positions (the reference's ``RopeScaling.inv_freq``,
        step for step in float64)."""
        rd = self.rotary_dim
        steps = np.arange(0, rd, 2, dtype=np.float64) / rd
        inv = 1.0 / (self.base ** steps)
        omp = self.original_max_position
        if self.kind == "linear":
            inv = inv / self.factor
        elif self.kind == "dynamic":
            # NTK-aware: the base stretches past the original window
            sl = max(seq_len or 0, omp)
            if sl > omp:
                base = self.base * ((self.factor * sl / omp)
                                    - (self.factor - 1)) ** (rd / (rd - 2))
                inv = 1.0 / (base ** steps)
        elif self.kind == "llama3":
            low_wl = omp / self.low_freq_factor
            high_wl = omp / self.high_freq_factor
            wl = 2 * np.pi / inv
            smooth = (omp / wl - self.low_freq_factor) / (
                self.high_freq_factor - self.low_freq_factor)
            inv = np.where(
                wl < high_wl, inv,
                np.where(wl > low_wl, inv / self.factor,
                         (1 - smooth) * inv / self.factor + smooth * inv))
        elif self.kind in ("yarn", "longrope"):
            if self.kind == "longrope" and self.short_factor \
                    and self.long_factor:
                sl = seq_len or omp
                ext = np.array(self.long_factor if sl > omp
                               else self.short_factor)
                inv = inv / ext
            else:   # the yarn ramp (also longrope without factor lists)
                lo = max(np.floor(rd * np.log(omp / (32 * 2 * np.pi))
                                  / (2 * np.log(self.base))), 0)
                hi = min(np.ceil(rd * np.log(omp / (1 * 2 * np.pi))
                                 / (2 * np.log(self.base))), rd - 1)
                ramp = np.clip((np.arange(rd // 2, dtype=np.float64) - lo)
                               / max(hi - lo, 1e-3), 0, 1)
                inv = inv / self.factor * ramp + inv * (1 - ramp)
        return inv.astype(np.float32)

    def mscale(self, seq_len: int | None = None) -> float:
        """The factor on cos and sin: ``attention_factor`` where given,
        yarn's ``0.1 ln(factor) + 1``, else 1."""
        if self.attention_factor is not None:
            return float(self.attention_factor)
        if self.kind == "yarn" and self.factor > 1:
            return float(0.1 * np.log(self.factor) + 1.0)
        return 1.0


def cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
            mscale: float = 1.0):
    """positions [..., T] int -> (cos, sin) each [..., T, rotary_dim/2] fp32."""
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles) * mscale, torch.sin(angles) * mscale


ROPE_LAYOUTS = ("half", "two")


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               layout: str = "half") -> torch.Tensor:
    """Rotate q or k: x [B, T, H, D]; cos/sin [B, T, D/2]; computed in fp32
    and returned in ``x.dtype``.  "half" rotates the pairs ``(x[i],
    x[i + D/2])``, "two" the interleaved pairs ``(x[2i], x[2i+1])`` (the
    reference's ``ops/rope.py:141-145``)."""
    if layout not in ROPE_LAYOUTS:
        raise NotImplementedError(f"rope layout {layout!r} is not ported")
    dt = x.dtype
    xf = x.to(torch.float32)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    if layout == "half":
        d2 = x.shape[-1] // 2
        x1, x2 = xf[..., :d2], xf[..., d2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    return out.to(dt)


def apply_rope_partial(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       rotary_dim: int, layout: str = "half") -> torch.Tensor:
    """Rotate the first ``rotary_dim`` columns of x and pass the rest
    through (phi3's partial rotary; the reference's decoder, lines
    165-176); the whole head when ``rotary_dim`` is its width."""
    if rotary_dim == x.shape[-1]:
        return apply_rope(x, cos, sin, layout)
    return torch.cat([apply_rope(x[..., :rotary_dim], cos, sin, layout),
                      x[..., rotary_dim:]], dim=-1)
