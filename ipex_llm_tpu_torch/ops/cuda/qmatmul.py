"""Fused block dequant-matmul in the ten block formats (kernel B2; port of
``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas``).

``csrc/qmatmul.cu`` holds the kernel, one body templated on the format,
and the note on its design and bound.  :func:`qmatmul` launches it for
CUDA tensors and runs :func:`qmatmul_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.quantize import numerics
from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize_padded
from ipex_llm_tpu_torch.quantize.qtypes import resolve

NAME = "qmatmul"
# the kernel's format ids, in this order (csrc/qmatmul.cu ``Format``)
FORMATS = ("sym_int4", "asym_int4", "nf4", "fp4", "sym_int5", "asym_int5",
           "sym_int8", "fp6", "fp8_e4m3", "fp8_e5m2")
_NIB4 = FORMATS[:4]
_BIT5 = ("sym_int5", "asym_int5")
_TABLES = {"nf4": numerics.NF4_TABLE, "fp4": numerics.FP4_TABLE}
_COLS_PER_BLOCK = 512       # columns one CUDA block covers (csrc constant)
_TARGET_BLOCKS = 4 * 132    # about four resident blocks per SM
_MIN_SPLIT_ROWS = 128       # contraction rows of the shortest K split


class _Counts(_build.Counts):
    """The kernel's launch accounting, with the launches of each format
    (``by_format``) beside the totals."""

    def reset(self):
        super().reset()
        self.by_format = dict.fromkeys(FORMATS, 0)


COUNTS = _Counts()

_table_cache: dict[tuple[str, torch.device], torch.Tensor] = {}


def data_row_factor(qtype: str) -> tuple[int, int]:
    """(num, den): padded contraction rows K = data rows * num / den."""
    if qtype in _NIB4:
        return 2, 1
    if qtype in _BIT5:
        return 8, 5
    return 1, 1


def qmatmul_plain(x: torch.Tensor, qt: QTensor, *,
                  keep_f32: bool = False) -> torch.Tensor:
    """The plain version: dequantize to bf16 (the reference's rounding
    point), then one product.  The product runs in float64, so each output
    is the exactly rounded sum whatever the batch shape, and the CPU engine
    stays bitwise identical across batch compositions (mixed vs sequential
    ticks); the result is rounded to ``x.dtype`` (or fp32 with
    ``keep_f32``), as the reference's fp32 accumulator is."""
    COUNTS.plain_calls += 1
    w = dequantize_padded(qt).to(torch.bfloat16)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float64),
                     w.to(torch.float64))
    return y.to(torch.float32) if keep_f32 else y.to(x.dtype)


def row_tile(m: int) -> int:
    """Rows of x one CUDA block holds (a template instance of the kernel)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8 if m <= 8 \
        else 16


@functools.lru_cache(maxsize=1024)
def split_plan(m: int, n: int, k: int, bs: int) -> tuple[int, int]:
    """(splits, quant blocks per split) over the K axis: enough CUDA blocks
    in flight to cover the card, each split whole quantization blocks of
    ``bs`` rows and at least 128 rows."""
    mt = row_tile(m)
    tiles = -(-m // mt) * -(-n // _COLS_PER_BLOCK)
    nqb = k // bs
    min_qb = max(1, _MIN_SPLIT_ROWS // bs)
    splits = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), nqb // min_qb))
    per = -(-nqb // splits)
    return -(-nqb // per), per


# per format: (kernel format id, block size, num, den, zeros plane); the
# wrapper runs once per linear layer on the decode path, so its checks
# read these instead of resolving the format each call
_SPECS = {q: (i, resolve(q).block_size, *data_row_factor(q),
              resolve(q).kind == "int_asym") for i, q in enumerate(FORMATS)}


def _table(qtype: str, device: torch.device) -> torch.Tensor:
    key = (qtype, device)
    if key not in _table_cache:
        _table_cache[key] = torch.from_numpy(_TABLES[qtype]).to(device)
    return _table_cache[key]


def _launch(x: torch.Tensor, qt: QTensor, keep_f32: bool) -> torch.Tensor:
    spec = _SPECS.get(qt.qtype)
    if spec is None:
        raise NotImplementedError(f"B2 has no kernel for {qt.qtype!r}")
    fid, bs, num, den, asym = spec
    m, k = x.shape
    data, scales, zeros = qt.data, qt.scales, qt.zeros
    n = data.shape[1]
    dev = x.device
    if qt.block_size != bs:
        raise ValueError(f"the {qt.qtype} kernel takes {bs}-row blocks, "
                         f"got {qt.block_size}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{NAME} kernel takes bf16 x, got {x.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"{NAME} kernel takes uint8 data and fp16 scales")
    if data.device != dev or scales.device != dev:
        raise ValueError("x and the weight planes must be on one device")
    if k % bs or data.shape[0] * num != k * den or scales.shape != (
            k // bs, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, {qt.qtype} "
                         f"data {tuple(data.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if n % 4:
        raise ValueError(f"{NAME} kernel needs out_features % 4 == 0")
    if not (x.is_contiguous() and data.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError(f"{NAME} kernel needs contiguous tensors")
    if data.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError(f"{NAME} kernel needs 4-byte aligned data and "
                         "8-byte aligned scales")
    if (zeros is not None) != asym:
        raise ValueError(f"{qt.qtype}: a zeros plane goes with the "
                         "asymmetric formats only")
    if zeros is not None and (
            zeros.dtype != torch.float16 or zeros.device != dev
            or zeros.shape != scales.shape or not zeros.is_contiguous()
            or zeros.data_ptr() % 8):
        raise ValueError(f"{NAME} kernel needs fp16 zeros shaped, placed "
                         "and aligned as the scales")
    lib = _build.load(NAME, _declare)
    out = torch.empty((m, n), dtype=torch.float32 if keep_f32 else x.dtype,
                      device=dev)
    if m == 0:
        return out
    splits, per = split_plan(m, n, k, bs)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    table = _table(qt.qtype, dev) if qt.qtype in _TABLES else None
    # the argtypes declared in _declare convert the Python ints
    err = lib.qmatmul(
        fid, x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        0 if zeros is None else zeros.data_ptr(),
        0 if table is None else table.data_ptr(), out.data_ptr(),
        int(keep_f32), 0 if partial is None else partial.data_ptr(), m, n, k,
        splits, per, row_tile(m), _build.stream_handle(x))
    # a K split launches the product and then the reduce of its partials
    launches = 2 if splits > 1 else 1
    COUNTS.launches += launches
    COUNTS.by_format[qt.qtype] += launches
    _build.check(err, NAME)
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, *,
            keep_f32: bool = False) -> torch.Tensor:
    """x [M, K] @ dequant(qt) -> [M, N]; K is the padded contraction width
    (``qt.data.shape[0] * num / den`` of :func:`data_row_factor`)."""
    if x.is_cuda:
        return _launch(x, qt, keep_f32)
    return qmatmul_plain(x, qt, keep_f32=keep_f32)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, p]
    lib.qmatmul.restype = ctypes.c_int
