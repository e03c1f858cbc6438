"""Fused block dequant-matmul in the ten block formats (kernel B2; port of
``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas``).

``csrc/qmatmul.cu`` holds the kernel, templated on the format, in two
instances, and the note on their design and bound: a GEMV on the CUDA
cores for M <= 8 (decode) and a tiled tensor-core product for M > 8 (the
verify forward, the mixed tick's prefill rows, generate's prefill).
:func:`plan` picks the instance, its row tile and its K split from the
shapes alone.  :func:`qmatmul` launches it for CUDA tensors and runs
:func:`qmatmul_plain` for CPU tensors.
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
ROUTES = ("gemv", "tiled")  # the kernel's two instances
_GEMV_MAX_M = 8             # the GEMV instance takes M <= 8
_COLS_PER_BLOCK = 512       # columns one GEMV block covers (csrc constant)
_TARGET_BLOCKS = 4 * 132    # GEMV: about four resident blocks per SM
_MIN_SPLIT_ROWS = 128       # GEMV: contraction rows of the shortest K split
_TILE_N = 128               # tiled: output columns per block (csrc kTN)
_TILE_K = 64                # tiled: contraction rows per step (csrc kTK)
_TC_TARGET_BLOCKS = 2 * 132  # tiled: split K below two waves of 132 SMs
_TC_MIN_SPLIT_ROWS = 512    # tiled: contraction rows of the shortest split


class _Counts(_build.Counts):
    """The kernel's launch accounting, with the launches of each format
    (``by_format``) and of each instance (``by_route``: ``gemv``,
    ``tiled``) beside the totals."""

    def reset(self):
        super().reset()
        self.by_format = dict.fromkeys(FORMATS, 0)
        self.by_route = dict.fromkeys(ROUTES, 0)


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


def route(m: int) -> str:
    """The instance that takes ``m`` rows of x: ``gemv`` or ``tiled``."""
    return "gemv" if m <= _GEMV_MAX_M else "tiled"


def tile_rows(m: int) -> int:
    """Rows of x one CUDA block holds (a template instance of the kernel):
    1, 2, 4 or 8 on the GEMV instance, 16, 64 or 128 on the tiled one."""
    for t in (1, 2, 4, 8, 16, 64):
        if m <= t:
            return t
    return 128


@functools.lru_cache(maxsize=1024)
def split_plan(m: int, n: int, k: int, bs: int) -> tuple[int, int]:
    """(splits, quant blocks per split) over the K axis, from shapes alone.
    Each split holds whole quantization blocks of ``bs`` rows.  GEMV: enough
    CUDA blocks in flight to cover the card, each split at least 128 rows.
    Tiled: splits only while the output tiles are under two waves of 132
    SMs, each split whole 64-row K steps and at least 512 rows."""
    nqb = k // bs
    mt = tile_rows(m)
    if route(m) == "gemv":
        tiles = -(-m // mt) * -(-n // _COLS_PER_BLOCK)
        min_qb = max(1, _MIN_SPLIT_ROWS // bs)
        splits = max(1, min(math.ceil(_TARGET_BLOCKS / tiles), nqb // min_qb))
        per = -(-nqb // splits)
        return -(-nqb // per), per
    tiles = -(-m // mt) * -(-n // _TILE_N)
    if tiles >= _TC_TARGET_BLOCKS:
        return 1, nqb
    unit = max(1, _TILE_K // bs)            # quant blocks per K step
    units = -(-nqb // unit)
    min_units = max(1, _TC_MIN_SPLIT_ROWS // (unit * bs))
    splits = max(1, min(math.ceil(_TC_TARGET_BLOCKS / tiles),
                        units // min_units))
    per = -(-units // splits) * unit
    return (-(-nqb // per), per) if per < nqb else (1, nqb)


def plan(m: int, n: int, k: int, bs: int) -> tuple[str, int, int, int]:
    """(route, rows per block, splits, quant blocks per split)."""
    return (route(m), tile_rows(m), *split_plan(m, n, k, bs))


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
    rt, tile, splits, per = plan(m, n, k, bs)
    if rt == "tiled" and x.data_ptr() % 16:
        x = x.clone()                # the tiled instance's 16-byte copies
    vec16 = n % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (data, scales, zeros))
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    table = _table(qt.qtype, dev) if qt.qtype in _TABLES else None
    # the argtypes declared in _declare convert the Python ints
    err = lib.qmatmul(
        fid, x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        0 if zeros is None else zeros.data_ptr(),
        0 if table is None else table.data_ptr(), out.data_ptr(),
        int(keep_f32), 0 if partial is None else partial.data_ptr(), m, n, k,
        splits, per, tile, int(vec16), _build.stream_handle(x))
    # a K split launches the product and then the reduce of its partials
    launches = 2 if splits > 1 else 1
    COUNTS.launches += launches
    COUNTS.by_format[qt.qtype] += launches
    COUNTS.by_route[rt] += launches
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
    lib.qmatmul.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i,
                           p]
    lib.qmatmul.restype = ctypes.c_int
