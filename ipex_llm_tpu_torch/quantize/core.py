"""Block-quantized tensors (port of ``ipex_llm_tpu/quantize/core.py``).

Same storage as the reference, byte for byte, so packed planes cross
between the two packages unchanged:

- a weight is logically ``[in_features, out_features]`` (``x @ W``, not
  ``nn.Linear``'s ``x @ W.T``) and is quantized along the contraction axis;
- ``sym_int4`` packs two 4-bit codes per byte in the **block-local halves
  layout**: inside each 32-row block, byte ``j`` holds row ``j`` in its low
  nibble and row ``j + 16`` in its high nibble (not llama.cpp's order and
  not adjacent pairs);
- scales are fp16 ``[in/32, out]``; a code decodes as ``(code - 8) * scale``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ipex_llm_tpu_torch.quantize import qtypes

SCALE_DTYPE = torch.float16


@dataclass
class QTensor:
    """A block-quantized 2-D weight ``[in_features, out_features]``.

    data:   packed codes (uint8 ``[in/2, out]`` for sym_int4; the bf16 weight
            itself for the native ``bf16`` width)
    scales: fp16 ``[in/32, out]``, or None for ``bf16``
    qtype:  resolved qtype name
    shape:  logical ``(in_features, out_features)``
    block_size: contraction-axis block size (0 for ``bf16``)
    """

    data: torch.Tensor
    scales: torch.Tensor | None
    qtype: str
    shape: tuple[int, int]
    block_size: int

    @property
    def in_features(self) -> int:
        return self.shape[0]

    @property
    def out_features(self) -> int:
        return self.shape[1]

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device),
                       None if self.scales is None else self.scales.to(device),
                       self.qtype, self.shape, self.block_size)

    def __repr__(self) -> str:
        return f"QTensor({self.qtype}, {self.shape}, bs={self.block_size})"


# ---------------------------------------------------------------------------
# packing helpers (contraction axis = axis 0 of each [bs, out] block)
# ---------------------------------------------------------------------------


def _pack_nibbles(codes: torch.Tensor, bs: int) -> torch.Tensor:
    """[in, out] uint8 codes in [0,16) -> [in/2, out] bytes, halves layout."""
    nb = codes.shape[0] // bs
    c = codes.reshape(nb, bs, codes.shape[1])
    lo, hi = c[:, : bs // 2], c[:, bs // 2:]
    return (lo | (hi << 4)).to(torch.uint8).reshape(-1, codes.shape[1])


def _unpack_nibbles(packed: torch.Tensor, bs: int) -> torch.Tensor:
    """[in/2, out] bytes -> [in, out] uint8 codes (block-local halves)."""
    nb = packed.shape[0] // (bs // 2)
    p = packed.reshape(nb, bs // 2, packed.shape[1])
    codes = torch.cat([p & 0x0F, p >> 4], dim=1)
    return codes.reshape(-1, packed.shape[1])


def _to_blocks(w: torch.Tensor, bs: int) -> torch.Tensor:
    """[in, out] -> [n_blocks, bs, out], zero-padding a trailing partial
    block (trimmed again by :func:`dequantize`)."""
    n_in, n_out = w.shape
    pad = (-n_in) % bs
    if pad:
        w = torch.cat([w, w.new_zeros((pad, n_out))], dim=0)
    return w.reshape(-1, bs, n_out)


def _from_blocks(b: torch.Tensor) -> torch.Tensor:
    return b.reshape(b.shape[0] * b.shape[1], b.shape[2])


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def _quant_int_sym(w: torch.Tensor, bs: int, bits: int):
    """llama.cpp-style symmetric round-to-nearest: ``d = signed_absmax /
    -2^(b-1)``, codes biased into ``[0, 2^b)``.  The arithmetic follows the
    reference op for op (f32, round-half-even), so codes and scales are
    bitwise the reference's."""
    if bits != 4:
        raise NotImplementedError(f"int_sym with {bits} bits is not ported")
    blocks = _to_blocks(w.to(torch.float32), bs)
    qmax = 1 << (bits - 1)
    # the signed value of largest magnitude, first occurrence on ties
    # (torch.argmax and jnp.argmax agree on that)
    amax_idx = blocks.abs().argmax(dim=1, keepdim=True)
    signed_max = blocks.gather(1, amax_idx)                 # [nb, 1, out]
    d = signed_max / -qmax
    inv_d = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
    q = torch.clamp(torch.round(blocks * inv_d) + qmax, 0, 2 * qmax - 1)
    codes = _from_blocks(q.to(torch.uint8))
    scales = d[:, 0, :].to(SCALE_DTYPE)
    return _pack_nibbles(codes, bs), scales


def _dequant_int_sym(data: torch.Tensor, scales: torch.Tensor, bs: int,
                     bits: int = 4) -> torch.Tensor:
    """Packed planes -> f32 ``[in_padded, out]``: ``(code - 8) * scale``."""
    qmax = 1 << (bits - 1)
    codes = _unpack_nibbles(data, bs)
    blocks = _to_blocks(codes.to(torch.float32) - qmax, bs)
    return _from_blocks(blocks * scales[:, None, :].to(torch.float32))


def quantize(w: torch.Tensor, qtype: str,
             block_size: int | None = None) -> QTensor:
    """Quantize a 2-D ``[in_features, out_features]`` weight (on any
    device) into ``qtype``."""
    info = qtypes.resolve(qtype)
    w = w.to(torch.float32)
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got shape {tuple(w.shape)}")
    if info.kind == "native":
        return QTensor(w.to(torch.bfloat16), None, info.name,
                       tuple(w.shape), 0)
    bs = block_size or info.block_size
    data, scales = _quant_int_sym(w, bs, int(info.bits))
    return QTensor(data, scales, info.name, tuple(w.shape), bs)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the float weight ``[in_features, out_features]``."""
    info = qtypes.resolve(qt.qtype)
    if info.kind == "native":
        return qt.data.to(dtype)
    out = _dequant_int_sym(qt.data, qt.scales, qt.block_size, int(info.bits))
    return out[: qt.in_features].to(dtype)
