"""Fused block dequant-matmul in the ten block formats (kernel B2; port of
``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas``).

``csrc/qmatmul.cu`` holds the kernel, templated on the format, in two
instances, and the note on their design and bound: a GEMV for M <= 8
(decode) that decodes into tensor-core fragments and splits K over the
warps of a block and the blocks of a thread-block cluster, summing in
shared memory (one launch), and a tiled tensor-core product for M > 8
(the verify forward, the mixed tick's prefill rows, generate's prefill).
:func:`plan` picks the instance, its row tile and its K split from the
shapes alone (:func:`gemv_plan` the GEMV's warps and cluster, and
:func:`gemv_fragment_map` says which codes each lane decodes).
:func:`qmatmul` launches it for CUDA tensors and runs
:func:`qmatmul_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
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
_GEMV_WARPS = 4             # warps per GEMV block (csrc kGemvWarps)
_GEMV_COLS = 128            # output columns per GEMV warp (csrc kGemvCols)
_GEMV_MAX_CLUSTER = 8       # the portable thread-block cluster size
_GEMV_MAX_SPLITS = _GEMV_WARPS * _GEMV_MAX_CLUSTER
_GEMV_TARGET_WARPS = 720      # GEMV warps to aim for (about 5.5 an SM)
_GEMV_MIN_SPLIT_ROWS = 128  # contraction rows of the shortest GEMV split
_GEMV_X_BYTES = 64 * 1024   # a GEMV block's bf16 x stage at most
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


class GemvPlan(NamedTuple):
    """The GEMV instance's launch: ``warps_k`` of a block's 4 warps split K
    (the other ``4 // warps_k`` take 128 columns each), ``cluster`` blocks
    of a thread-block cluster split it further, and split ``s = rank *
    warps_k + wk`` holds quantization blocks ``[s * qb_per_warp, (s + 1) *
    qb_per_warp)``; the grid is ``(cluster, col_blocks)`` and the partial
    sums meet in the cluster's shared memory, so a call is one launch."""
    warps_k: int
    cluster: int
    qb_per_warp: int
    col_blocks: int

    @property
    def splits(self) -> int:
        return self.warps_k * self.cluster

    def x_rows(self, bs: int) -> int:
        """Contraction rows of x one block stages."""
        return self.warps_k * self.qb_per_warp * bs


@functools.lru_cache(maxsize=1024)
def gemv_plan(m: int, n: int, k: int, bs: int) -> GemvPlan | None:
    """The GEMV plan, from shapes alone: the fewest K splits (a power of
    two, at most 4 warps x 8 ranks) that put at least 720 warps on the
    card (about 5.5 an SM: fewer, longer streams timed faster on the H100
    than a full wave of shorter ones), each split at least 128 rows of
    whole quantization blocks; the block's warps split K before the
    cluster does, unless the block's x stage would pass 64 KiB.  None when
    no plan fits (K past about 32,768 rows at 8 rows of x): the tiled
    instance takes the call."""
    nqb = k // bs
    tiles = -(-n // _GEMV_COLS)
    max_splits = max(1, min(_GEMV_MAX_SPLITS,
                            nqb // max(1, _GEMV_MIN_SPLIT_ROWS // bs)))
    splits = 1
    while splits * 2 <= max_splits and tiles * splits < _GEMV_TARGET_WARPS:
        splits *= 2
    x_cap = _GEMV_X_BYTES // (2 * tile_rows(m))   # rows of x a block holds
    while splits <= _GEMV_MAX_SPLITS:
        per = -(-nqb // splits)
        for wk in (4, 2, 1):
            if (splits % wk == 0 and splits // wk <= _GEMV_MAX_CLUSTER
                    and wk * per * bs <= x_cap):
                cols = (_GEMV_WARPS // wk) * _GEMV_COLS
                return GemvPlan(wk, splits // wk, per, -(-n // cols))
        splits *= 2
    return None


def gemv_fragment_map(layout: str, bs: int) -> dict[str, np.ndarray]:
    """Which weight each lane of a GEMV warp decodes into each bf16 half of
    its mma.sync A registers, and which x row into its B registers, as
    ``csrc/qmatmul.cu`` reads them (``layout``: ``nib4``, ``bit5`` or
    ``byte``; ``bs`` the block size).  A arrays are [k-steps of a block, 32
    lanes, 8 tiles, 4 registers, 2 halves]: ``a_row``/``a_k`` the position
    in the 16 x 16 A tile (mma.sync's fragment layout), ``n`` the column of
    the warp's 128, ``k`` the row of the block; ``data_row`` the row of the
    block's data plane that holds the code (of the byte at column ``n``),
    ``shift`` its bit offset in that byte (0, or 4 for a high nibble),
    ``bit_row``/``bit`` where the fifth bit lies in the block's bit-plane
    rows (5-bit; else -1).  ``x_k`` [k-steps, 32 lanes, 2 registers, 2
    halves]: the block row of x in B register b0/b1 of lane l (column m =
    l // 4)."""
    steps = bs // 16
    sh = (steps, 32, 8, 4, 2)
    st, ln, tile, reg, half = np.meshgrid(
        *(np.arange(d) for d in sh), indexing="ij")
    g, t = ln // 4, ln % 4
    hi = reg // 2                           # a[2], a[3]: A k 8..15
    out = {"a_row": g + 8 * (reg % 2), "a_k": 2 * t + half + 8 * hi,
           "n": 16 * g + 2 * tile + reg % 2}
    xs, xl, xr, xh = np.meshgrid(*(np.arange(d) for d in (steps, 32, 2, 2)),
                                 indexing="ij")
    xt = xl % 4
    if layout == "byte":
        out["k"] = 16 * st + 4 * t + 2 * hi + half
        out["data_row"] = out["k"]
        out["shift"] = np.zeros(sh, np.int64)
        out["x_k"] = 16 * xs + 4 * xt + 2 * xr + xh
    else:
        out["data_row"] = 8 * st + 2 * t + half
        out["k"] = out["data_row"] + (bs // 2) * hi
        out["shift"] = 4 * hi
        out["x_k"] = 8 * xs + 2 * xt + xh + (bs // 2) * xr
    if layout == "bit5":
        out["bit_row"] = st + 2 * hi
        out["bit"] = 2 * t + half
    else:
        out["bit_row"] = out["bit"] = np.full(sh, -1)
    return out


def route(m: int, n: int, k: int, bs: int) -> str:
    """The instance that takes ``m`` rows of x: ``gemv`` for M <= 8 (when
    its plan fits the shapes), else ``tiled``."""
    if m <= _GEMV_MAX_M and gemv_plan(m, n, k, bs) is not None:
        return "gemv"
    return "tiled"


def launches(rt: str, splits: int) -> int:
    """Kernel launches of one call: the tiled instance's K split adds the
    reduce of its fp32 partials; the GEMV's splits meet in shared memory."""
    return 2 if rt == "tiled" and splits > 1 else 1


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
    Each split holds whole quantization blocks of ``bs`` rows.  GEMV: the
    non-empty splits of :func:`gemv_plan` (its warps x cluster ranks), each
    at least 128 rows.  Tiled: splits only while the output tiles are under two waves
    of 132 SMs, each split whole 64-row K steps and at least 512 rows."""
    nqb = k // bs
    if route(m, n, k, bs) == "gemv":
        # the non-empty splits: the plan's warps x ranks past them get none
        per = gemv_plan(m, n, k, bs).qb_per_warp
        return -(-nqb // per), per
    mt = max(16, tile_rows(m))
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
    rt = route(m, n, k, bs)
    tile = tile_rows(m) if rt == "gemv" else max(16, tile_rows(m))
    return (rt, tile, *split_plan(m, n, k, bs))


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
    if x.data_ptr() % 16:
        x = x.clone()                # both instances' 16-byte copies of x
    vec16 = n % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (data, scales, zeros))
    if rt == "gemv":                 # the launch's splits: warps x ranks
        gp = gemv_plan(m, n, k, bs)
        warps_k, splits = gp.warps_k, gp.splits
    else:
        warps_k = 1
    n_launch = launches(rt, splits)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if n_launch == 2 else None)
    table = _table(qt.qtype, dev) if qt.qtype in _TABLES else None
    # the argtypes declared in _declare convert the Python ints
    err = lib.qmatmul(
        fid, x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        0 if zeros is None else zeros.data_ptr(),
        0 if table is None else table.data_ptr(), out.data_ptr(),
        int(keep_f32), 0 if partial is None else partial.data_ptr(), m, n, k,
        splits, per, tile, int(vec16), warps_k, _build.stream_handle(x))
    COUNTS.launches += n_launch
    COUNTS.by_format[qt.qtype] += n_launch
    COUNTS.by_route[rt] += n_launch
    _build.check(err, NAME)
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, *,
            keep_f32: bool = False) -> torch.Tensor:
    """x [M, K] @ dequant(qt) -> [M, N]; K is the padded contraction width
    (``qt.data.shape[0] * num / den`` of :func:`data_row_factor`)."""
    if x.is_cuda:
        return _launch(x, qt, keep_f32)
    return qmatmul_plain(x, qt, keep_f32=keep_f32)


def qmatmul_sharded(x: torch.Tensor, qt: QTensor, mode: str, group=None, *,
                    qtype: str = "bf16") -> torch.Tensor:
    """One rank of the reference's ``qmatmul_pallas_sharded`` (B2s): ``x``
    [M, K'] against the rank's planes ``qt`` (``parallel/shard.py``).

    - ``mode="col"`` (qkv, gate_up, the lm head): ``qt`` holds ``out / tp``
      columns, ``x`` is the whole input; the rank's output columns, no
      collective;
    - ``mode="row"`` (o, down): ``qt`` holds ``in / tp`` contraction rows
      in whole blocks, ``x`` the matching input columns; B2's fp32
      partial (``keep_f32``), summed over ``group`` by
      ``ops/collectives.py::all_reduce`` under the ``qtype`` wire family,
      then rounded to ``x``'s dtype.  The only cross-rank arithmetic.

    B2 on the card (counted in :data:`SHARDED_COL` or
    :data:`SHARDED_ROW` too), its plain version on the CPU."""
    if mode == "col":
        return _build.through(SHARDED_COL, COUNTS, lambda: qmatmul(x, qt))
    if mode != "row":
        raise NotImplementedError(f"tp mode {mode!r}")
    if qt.qtype in _BIT5:
        raise NotImplementedError(f"{qt.qtype} has no row split")
    from ipex_llm_tpu_torch.ops.collectives import all_reduce

    part = _build.through(SHARDED_ROW, COUNTS,
                          lambda: qmatmul(x, qt, keep_f32=True))
    return all_reduce(part, group, qtype, out_dtype=x.dtype)


SHARDED_COL = _build.Counts()   # launches made through B2s, column split
SHARDED_ROW = _build.Counts()   # and row split


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i,
                           i, p]
    lib.qmatmul.restype = ctypes.c_int
