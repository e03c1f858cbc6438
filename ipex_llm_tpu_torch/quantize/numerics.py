"""Codebooks and minifloat codecs of the low-bit formats (port of
``ipex_llm_tpu/quantize/numerics.py``).

The tables are the reference's float32 constants, built the same way (the
port keeps its own copy).  Encode and decode are torch functions that run
on either device and give the same codes on both.
"""

from __future__ import annotations

import numpy as np
import torch

# NormalFloat-4 (QLoRA, Dettmers et al. 2023), normalized to [-1, 1]
NF4_TABLE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# FP4 (e2m1): sign x {0, .5, 1, 1.5, 2, 3, 4, 6} / 6, index = sign<<3 | code
_FP4_MAGS = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0],
                     dtype=np.float32)
FP4_TABLE = np.concatenate([_FP4_MAGS, -_FP4_MAGS]) / 6.0


def _minifloat_table(exp_bits: int, man_bits: int, bias: int) -> np.ndarray:
    """Every value of a 1+e+m minifloat (with subnormals, no inf/nan)."""
    n = 1 << (1 + exp_bits + man_bits)
    codes = np.arange(n, dtype=np.uint32)
    sign = np.where(codes >> (exp_bits + man_bits) & 1, -1.0, 1.0)
    exp = (codes >> man_bits) & ((1 << exp_bits) - 1)
    man = codes & ((1 << man_bits) - 1)
    vals = np.where(
        exp > 0,
        sign * (1.0 + man / (1 << man_bits))
        * np.exp2(exp.astype(np.float64) - bias),
        sign * (man / (1 << man_bits)) * np.exp2(1.0 - bias),
    )
    return vals.astype(np.float32)


# FP6 (e3m2, bias 3), the FP6-LLM format; max magnitude 28
FP6_TABLE = _minifloat_table(3, 2, 3)
FP6_MAX = float(np.max(FP6_TABLE))

FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0

_FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}

# elements of one [rows, ..., levels] distance slab of the codebook encode
_ENCODE_SLAB = 1 << 26


def codebook_encode(x: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Index (uint8) of the nearest table entry of each element of the
    normalized ``x``, the first one on a tie (``torch.argmin`` and
    ``jnp.argmin`` both keep the first minimum).  The ``[n, levels]``
    distances are formed a slab of elements at a time, so that a 64-level
    encode of a large weight stays within a few hundred MB."""
    t = torch.from_numpy(table).to(x.device)
    flat = x.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.uint8, device=x.device)
    step = max(1, _ENCODE_SLAB // len(table))
    for i in range(0, flat.numel(), step):
        xs = flat[i:i + step]
        out[i:i + step] = (xs[:, None] - t).abs().argmin(dim=-1)
    return out.reshape(x.shape)


def codebook_decode(codes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(table).to(codes.device)[codes.long()]


def fp8_to_codes(x: torch.Tensor, variant: str) -> torch.Tensor:
    """Cast to fp8 (round to nearest even) and view the bytes as codes."""
    return x.to(_FP8[variant]).view(torch.uint8)


def fp8_from_codes(codes: torch.Tensor, variant: str) -> torch.Tensor:
    return codes.view(_FP8[variant]).to(torch.float32)
