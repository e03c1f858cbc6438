"""Block-quantized tensors (port of ``ipex_llm_tpu/quantize/core.py``).

Same storage as the reference, byte for byte, so packed planes cross
between the two packages unchanged:

- a weight is logically ``[in_features, out_features]`` (``x @ W``, not
  ``nn.Linear``'s ``x @ W.T``) and is quantized along the contraction axis
  in blocks of ``block_size`` rows (a trailing partial block is zero
  padded);
- 4-bit codes pack two to a byte in the **block-local halves layout**:
  inside each block, byte ``j`` holds row ``j`` in its low nibble and row
  ``j + bs/2`` in its high nibble (not llama.cpp's order and not adjacent
  pairs);
- 5-bit codes keep their low nibbles in that layout (``K/2`` rows), then a
  plane of fifth bits (``K/8`` rows): row ``r``'s bit is bit ``r % 8`` of
  byte row ``r / 8``;
- 8-bit, fp6 and fp8 codes take one byte each;
- scales (and the minima of the asymmetric formats) are fp16
  ``[in/bs, out]``.

Every codec follows the reference op for op in float32, so its planes are
bitwise the reference's jitted codec.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ipex_llm_tpu_torch.quantize import numerics, qtypes

SCALE_DTYPE = torch.float16


@dataclass
class QTensor:
    """A block-quantized 2-D weight ``[in_features, out_features]`` (or a
    stack of them with leading axes).

    data:   packed codes (layout per qtype, see the module doc; the bf16
            weight itself for the native ``bf16`` width)
    scales: fp16 ``[in/bs, out]``, or None for ``bf16``
    zeros:  fp16 block minima ``[in/bs, out]`` of the asymmetric formats,
            else None
    qtype:  resolved qtype name
    shape:  logical ``(in_features, out_features)``
    block_size: contraction-axis block size (0 for ``bf16``)
    """

    data: torch.Tensor
    scales: torch.Tensor | None
    zeros: torch.Tensor | None
    qtype: str
    shape: tuple[int, int]
    block_size: int

    @property
    def in_features(self) -> int:
        return self.shape[0]

    @property
    def out_features(self) -> int:
        return self.shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.scales, self.zeros)
                   if t is not None)

    def planes(self, fn) -> "QTensor":
        """The same QTensor with ``fn`` applied to each plane."""
        return QTensor(fn(self.data),
                       None if self.scales is None else fn(self.scales),
                       None if self.zeros is None else fn(self.zeros),
                       self.qtype, self.shape, self.block_size)

    def to(self, device) -> "QTensor":
        return self.planes(lambda t: t.to(device))

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


def _pack_5bit(codes: torch.Tensor, bs: int) -> torch.Tensor:
    """[in, out] codes in [0,32) -> [in/2 + in/8, out] bytes: the low
    nibbles in the halves layout, then the fifth bits eight to a byte."""
    n_in, n_out = codes.shape
    low = _pack_nibbles(codes & 0x0F, bs)
    hb = (codes >> 4).reshape(n_in // 8, 8, n_out)
    high = torch.zeros((n_in // 8, n_out), dtype=torch.uint8,
                       device=codes.device)
    for j in range(8):
        high = high | (hb[:, j] << j)
    return torch.cat([low, high], dim=0)


def _unpack_5bit(packed: torch.Tensor, bs: int) -> torch.Tensor:
    """[in/2 + in/8, out] -> [in, out] uint8 codes in [0,32)."""
    n_in = packed.shape[0] * 8 // 5
    low = _unpack_nibbles(packed[: n_in // 2], bs)
    hb = packed[n_in // 2:]
    hi = torch.stack([(hb >> j) & 1 for j in range(8)], dim=1)
    return low | (hi.reshape(n_in, -1) << 4)


def _pack_codes(codes: torch.Tensor, bs: int, bits: int) -> torch.Tensor:
    if bits == 4:
        return _pack_nibbles(codes, bs)
    if bits == 5:
        return _pack_5bit(codes, bs)
    return codes


def _unpack_codes(data: torch.Tensor, bs: int, bits: int) -> torch.Tensor:
    if bits == 4:
        return _unpack_nibbles(data, bs)
    if bits == 5:
        return _unpack_5bit(data, bs)
    return data


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


def _scaled(vals: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Decoded f32 codes [in_pad, out] times their block's scale."""
    blocks = _to_blocks(vals, qt.block_size)
    return _from_blocks(blocks * qt.scales[:, None, :].to(torch.float32))


# ---------------------------------------------------------------------------
# codecs: each quantizer returns (data, scales, zeros); each dequantizer
# the f32 weight [in_padded, out]
# ---------------------------------------------------------------------------


def _recip(c: float) -> float:
    """The float32 reciprocal of a constant divisor.  The reference's
    jitted codec divides by constants (``/ levels``, ``/ FP6_MAX``,
    ``/ FP8_*_MAX``), which XLA compiles as a product with the float32
    reciprocal; the port multiplies the same way so that its scales and
    codes are the same bits (a true division differs in the last bit of
    about half the scales)."""
    return float(np.float32(1.0 / c))


def _quant_int_sym(w: torch.Tensor, bs: int, bits: int):
    """llama.cpp-style symmetric round-to-nearest: ``d = signed_absmax /
    -2^(b-1)``, codes biased into ``[0, 2^b)``."""
    blocks = _to_blocks(w, bs)
    qmax = 1 << (bits - 1)
    # the signed value of largest magnitude, first occurrence on ties
    # (torch.argmax and jnp.argmax agree on that)
    amax_idx = blocks.abs().argmax(dim=1, keepdim=True)
    signed_max = blocks.gather(1, amax_idx)                 # [nb, 1, out]
    d = signed_max / -qmax
    inv_d = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
    q = torch.clamp(torch.round(blocks * inv_d) + qmax, 0, 2 * qmax - 1)
    codes = _from_blocks(q.to(torch.uint8))
    return _pack_codes(codes, bs, bits), d[:, 0, :].to(SCALE_DTYPE), None


def _search_mults(n_cand: int = 21, span: float = 0.25) -> torch.Tensor:
    """The reference's ``jnp.linspace(1 - span, 1 + span, n_cand)`` in
    float32, bit for bit: ``start (1 - s) + stop s`` with ``s = i *
    float32(1 / (n - 1))`` (XLA multiplies by the divisor's reciprocal),
    the last value ``stop`` itself."""
    lo, hi = np.float32(1.0 - span), np.float32(1.0 + span)
    st = np.arange(n_cand - 1, dtype=np.float32) * np.float32(
        1.0 / (n_cand - 1))
    out = lo * (np.float32(1.0) - st) + hi * st
    return torch.from_numpy(np.append(out, hi).astype(np.float32))


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """[nb, bs, out] -> [nb, out], summed over the block's rows one after
    another from the first (the order of XLA's reduce on the CPU), so the
    search picks the same scale on every device."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _scale_search(blocks: torch.Tensor, d0: torch.Tensor, err_for):
    """The reference's scan over ``d0 x mult`` (``_search_mults``): keep a
    candidate only where its error is strictly below the best so far.
    Returns the best ``d`` [nb, out]."""
    best_err, best_d = err_for(d0), d0[:, 0, :]
    for mult in _search_mults().tolist():
        d = d0 * mult
        err = err_for(d)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_d = torch.where(better, d[:, 0, :], best_d)
    return best_d


def _quant_int_sym_opt(w: torch.Tensor, bs: int, bits: int):
    """Scale-search symmetric quantization (the reference's
    ``_quant_int_sym_opt``, llama.cpp ``make_qx_quants``): per block, 21
    multipliers of the absmax scale in [0.75, 1.25]; the one with the
    least x^2-weighted squared reconstruction error wins."""
    blocks = _to_blocks(w, bs)
    qmax = 1 << (bits - 1)
    amax_idx = blocks.abs().argmax(dim=1, keepdim=True)
    d0 = blocks.gather(1, amax_idx) / -qmax               # [nb, 1, out]
    wgt = blocks * blocks

    def codes(d):
        inv_d = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
        return torch.clamp(torch.round(blocks * inv_d) + qmax, 0,
                           2 * qmax - 1)

    def err_for(d):
        recon = (codes(d) - qmax) * d
        return _block_sum(((blocks - recon) ** 2) * wgt)

    d = _scale_search(blocks, d0, err_for)[:, None, :]
    q = _from_blocks(codes(d).to(torch.uint8))
    return _pack_codes(q, bs, bits), d[:, 0, :].to(SCALE_DTYPE), None


def _dequant_int_sym(qt: QTensor, bits: int) -> torch.Tensor:
    codes = _unpack_codes(qt.data, qt.block_size, bits)
    return _scaled(codes.to(torch.float32) - (1 << (bits - 1)), qt)


def _quant_int_asym(w: torch.Tensor, bs: int, bits: int):
    """q4_1/q5_1 style: ``d = (max - min) / (2^b - 1)``, ``m = min``;
    ``x ~ q * d + m``."""
    blocks = _to_blocks(w, bs)
    mn = blocks.amin(dim=1, keepdim=True)
    mx = blocks.amax(dim=1, keepdim=True)
    levels = (1 << bits) - 1
    d = (mx - mn) * _recip(levels)
    inv_d = torch.where(d == 0, torch.zeros_like(d), 1.0 / d)
    q = torch.clamp(torch.round((blocks - mn) * inv_d), 0, levels)
    codes = _from_blocks(q.to(torch.uint8))
    return (_pack_codes(codes, bs, bits), d[:, 0, :].to(SCALE_DTYPE),
            mn[:, 0, :].to(SCALE_DTYPE))


def _dequant_int_asym(qt: QTensor, bits: int) -> torch.Tensor:
    codes = _unpack_codes(qt.data, qt.block_size, bits)
    blocks = _to_blocks(codes.to(torch.float32), qt.block_size)
    return _from_blocks(blocks * qt.scales[:, None, :].to(torch.float32)
                        + qt.zeros[:, None, :].to(torch.float32))


_CODEBOOKS = {"nf4": numerics.NF4_TABLE, "fp4": numerics.FP4_TABLE}


def _quant_codebook(w: torch.Tensor, bs: int, qtype: str):
    """Absmax scale, then the nearest 4-bit codebook entry."""
    blocks = _to_blocks(w, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    d = torch.where(amax == 0, torch.ones_like(amax), amax)
    codes = numerics.codebook_encode(blocks / d, _CODEBOOKS[qtype])
    return (_pack_nibbles(_from_blocks(codes), bs),
            d[:, 0, :].to(SCALE_DTYPE), None)


def _quant_codebook_opt(w: torch.Tensor, bs: int, qtype: str):
    """Scale-search codebook quantization (the reference's
    ``_quant_codebook_opt``): per block, the multiplier of the absmax
    scale with the least x^2-weighted squared reconstruction error."""
    table = _CODEBOOKS[qtype]
    blocks = _to_blocks(w, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    d0 = torch.where(amax == 0, torch.ones_like(amax), amax)
    wgt = blocks * blocks

    def codes(d):
        return numerics.codebook_encode(torch.clamp(blocks / d, -1.0, 1.0),
                                        table)

    def err_for(d):
        recon = numerics.codebook_decode(codes(d), table) * d
        return _block_sum(((blocks - recon) ** 2) * wgt)

    d = _scale_search(blocks, d0, err_for)[:, None, :]
    return (_pack_nibbles(_from_blocks(codes(d)), bs),
            d[:, 0, :].to(SCALE_DTYPE), None)


def _dequant_codebook(qt: QTensor) -> torch.Tensor:
    codes = _unpack_nibbles(qt.data, qt.block_size)
    return _scaled(numerics.codebook_decode(codes, _CODEBOOKS[qt.qtype]), qt)


def _quant_fp6(w: torch.Tensor, bs: int):
    """Absmax scale onto the e3m2 range, then the nearest fp6 value; one
    byte per code."""
    fmax = numerics.FP6_MAX
    blocks = _to_blocks(w, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    d = torch.where(amax == 0, torch.ones_like(amax), amax * _recip(fmax))
    codes = numerics.codebook_encode(
        torch.clamp(blocks / d, -fmax, fmax) * _recip(fmax),
        numerics.FP6_TABLE / fmax)
    return _from_blocks(codes), d[:, 0, :].to(SCALE_DTYPE), None


def _dequant_fp6(qt: QTensor) -> torch.Tensor:
    return _scaled(numerics.codebook_decode(qt.data, numerics.FP6_TABLE), qt)


def _fp8_variant(qtype: str) -> str:
    return qtype.split("_")[-1]


def _quant_fp8(w: torch.Tensor, bs: int, variant: str):
    """Absmax scale onto the fp8 range, then a round-to-nearest-even cast.
    The block maximum lands on the format's maximum (the division may
    leave it a hair above, which the cast rounds back down)."""
    fmax = (numerics.FP8_E4M3_MAX if variant == "e4m3"
            else numerics.FP8_E5M2_MAX)
    blocks = _to_blocks(w, bs)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    d = torch.where(amax == 0, torch.ones_like(amax), amax * _recip(fmax))
    codes = numerics.fp8_to_codes(blocks / d, variant)
    return _from_blocks(codes), d[:, 0, :].to(SCALE_DTYPE), None


def _dequant_fp8(qt: QTensor) -> torch.Tensor:
    return _scaled(numerics.fp8_from_codes(qt.data, _fp8_variant(qt.qtype)),
                   qt)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def quantize(w: torch.Tensor, qtype: str, block_size: int | None = None, *,
             optimize: bool = False, imatrix=None) -> QTensor:
    """Quantize a 2-D ``[in_features, out_features]`` weight (on any
    device) into ``qtype``.  ``optimize=True`` runs the reference's
    per-block scale search for the symmetric integer and codebook formats
    (the requant of a LoRA merge; the other formats ignore it, as there).
    ``imatrix`` (importance-weighted quantization) is not ported."""
    if imatrix is not None:
        raise NotImplementedError(
            "imatrix-weighted quantization is not ported (ROADMAP item 13)")
    info = qtypes.resolve(qtype)
    w = w.to(torch.float32)
    if w.ndim != 2:
        raise ValueError(f"expected 2-D weight, got shape {tuple(w.shape)}")
    if info.kind == "native":
        return QTensor(w.to(torch.bfloat16), None, None, info.name,
                       tuple(w.shape), 0)
    bs = block_size or info.block_size
    bits = int(info.bits)
    if info.kind == "int_sym":
        planes = (_quant_int_sym_opt if optimize else _quant_int_sym)(
            w, bs, bits)
    elif info.kind == "int_asym":
        planes = _quant_int_asym(w, bs, bits)
    elif info.kind == "codebook":
        planes = (_quant_codebook_opt if optimize else _quant_codebook)(
            w, bs, info.name)
    elif info.name == "fp6":
        planes = _quant_fp6(w, bs)
    else:
        planes = _quant_fp8(w, bs, _fp8_variant(info.name))
    return QTensor(*planes, info.name, tuple(w.shape), bs)


def dequantize_padded(qt: QTensor) -> torch.Tensor:
    """The f32 weight over the padded contraction rows ``[in_pad, out]``
    (the operand of the fused dequant-matmul)."""
    info = qtypes.resolve(qt.qtype)
    if info.kind == "native":
        return qt.data.to(torch.float32)
    bits = int(info.bits)
    if info.kind == "int_sym":
        return _dequant_int_sym(qt, bits)
    if info.kind == "int_asym":
        return _dequant_int_asym(qt, bits)
    if info.kind == "codebook":
        return _dequant_codebook(qt)
    if info.name == "fp6":
        return _dequant_fp6(qt)
    return _dequant_fp8(qt)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the float weight ``[in_features, out_features]``."""
    info = qtypes.resolve(qt.qtype)
    if info.kind == "native":
        return qt.data.to(dtype)
    return dequantize_padded(qt)[: qt.in_features].to(dtype)
