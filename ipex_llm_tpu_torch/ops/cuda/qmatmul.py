"""Fused sym_int4 dequant-matmul (kernel B2; port of
``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas`` for sym_int4).

``csrc/qmatmul_int4.cu`` holds the kernel and the note on its design and
bound.  :func:`qmatmul_int4` launches it for CUDA tensors and runs
:func:`qmatmul_int4_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.quantize.core import _dequant_int_sym

NAME = "qmatmul_int4"
COUNTS = _build.Counts()
BLOCK = 32
_COLS_PER_BLOCK = 512       # columns one CUDA block covers (csrc constant)
_TARGET_BLOCKS = 4 * 132    # about four resident blocks per SM


def qmatmul_int4_plain(x: torch.Tensor, data: torch.Tensor,
                       scales: torch.Tensor, *, keep_f32: bool = False
                       ) -> torch.Tensor:
    """The plain version: dequantize to bf16 (the reference's rounding
    point), then one product.  The product runs in float64, so each output
    is the exactly rounded sum whatever the batch shape, and the CPU engine
    stays bitwise identical across batch compositions (mixed vs sequential
    ticks); the result is rounded to ``x.dtype`` (or fp32 with
    ``keep_f32``), as the reference's fp32 accumulator is."""
    COUNTS.plain_calls += 1
    w = _dequant_int_sym(data, scales, BLOCK).to(torch.bfloat16)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float64),
                     w.to(torch.float64))
    return y.to(torch.float32) if keep_f32 else y.to(x.dtype)


def row_tile(m: int) -> int:
    """Rows of x one CUDA block holds (a template instance of the kernel)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8 if m <= 8 \
        else 16


def split_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(splits, quant blocks per split) over the K axis: enough blocks in
    flight to cover the card, each split at least four quant blocks."""
    mt = row_tile(m)
    tiles = -(-m // mt) * -(-n // _COLS_PER_BLOCK)
    nqb = k // BLOCK
    splits = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), nqb // 4))
    per = -(-nqb // splits)
    return -(-nqb // per), per


def _launch(x, data, scales, keep_f32):
    m, k = x.shape
    n = data.shape[1]
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul_int4 kernel takes bf16 x, got {x.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError("qmatmul_int4 kernel takes uint8 data and fp16 scales")
    if data.device != dev or scales.device != dev:
        raise ValueError("x, data and scales must be on one device")
    if k % BLOCK or data.shape[0] * 2 != k or scales.shape != (k // BLOCK, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, data "
                         f"{tuple(data.shape)}, scales {tuple(scales.shape)}")
    if n % 4:
        raise ValueError("qmatmul_int4 kernel needs out_features % 4 == 0")
    for t in (x, data, scales):
        if not t.is_contiguous():
            raise ValueError("qmatmul_int4 kernel needs contiguous tensors")
    if data.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError("qmatmul_int4 kernel needs 4-byte aligned data and "
                         "8-byte aligned scales")
    lib = _build.load(NAME, _declare)
    out = torch.empty((m, n), dtype=torch.float32 if keep_f32 else x.dtype,
                      device=dev)
    if m == 0:
        return out
    splits, per = split_plan(m, n, k)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = lib.qmatmul_int4(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(data.data_ptr()),
        ctypes.c_void_p(scales.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(int(keep_f32)),
        ctypes.c_void_p(0 if partial is None else partial.data_ptr()),
        ctypes.c_int(m), ctypes.c_int(n), ctypes.c_int(k),
        ctypes.c_int(splits), ctypes.c_int(per), ctypes.c_int(row_tile(m)),
        _build.stream_handle(x))
    # a K split launches the product and then the reduce of its partials
    COUNTS.launches += 2 if splits > 1 else 1
    _build.check(err, NAME)
    return out


def qmatmul_int4(x: torch.Tensor, data: torch.Tensor, scales: torch.Tensor,
                 *, keep_f32: bool = False) -> torch.Tensor:
    """x [M, K] @ dequant(data, scales) -> [M, N]; K is the padded
    contraction width (``data.shape[0] * 2``)."""
    if x.is_cuda:
        return _launch(x, data, scales, keep_f32)
    return qmatmul_int4_plain(x, data, scales, keep_f32=keep_f32)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul_int4.argtypes = [p, p, p, p, i, p, i, i, i, i, i, i, p]
    lib.qmatmul_int4.restype = ctypes.c_int

