"""Expert-grouped block dequant-matmul in the ten block formats (kernel
B2e): ``y[p] = x[p] @ dequant(W[e(p)])`` for rows sorted by expert.

It replaces ``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas`` as the
reference's sparse MoE dispatch reaches it, one product per (token,
expert) pair under ``jax.vmap`` (``ipex_llm_tpu/ops/moe.py::moe_gather``),
and the reference's ragged route (``moe_ragged``: the whole stack
dequantized to bf16, then ``lax.ragged_dot``).  Three instances, one
source each, the work found on the device from the segment offsets
``seg`` (no host read); :func:`plan` picks one from static shapes and a
static bound on the rows any expert holds (``max_rows``: the forward's
token count, since a token's k experts are distinct):

- ``gemv`` (``csrc/qmatmul_experts_gemv.cu``), bound <= 8, decode: B2's
  GEMV block over each expert's rows, decoding into ``mma.sync``
  fragments, K split over warps and a cluster (:func:`gemv_plan`);
- ``wgmma`` (``csrc/qmatmul_experts_wgmma.cu``), P / E >= 64, prefill: a
  persistent, warp-specialised ``wgmma`` tile of 128 rows x 256 columns
  (:func:`wgmma_smem_bytes`);
- ``tiled`` (``csrc/qmatmul_experts.cu``) in between: B2's ``mma.sync``
  tile of 16 or 64 rows over each expert's row tiles.

Each source's head comment holds its design and bound.
:func:`qmatmul_experts` launches the chosen instance for CUDA tensors and
runs :func:`qmatmul_experts_plain` for CPU ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda.qmatmul import (_GEMV_COLS,
                                                 _GEMV_MAX_CLUSTER,
                                                 _GEMV_MAX_SPLITS,
                                                 _GEMV_MIN_SPLIT_ROWS,
                                                 _GEMV_TARGET_WARPS,
                                                 _GEMV_WARPS, _GEMV_X_BYTES,
                                                 _BIT5, _NIB4, _SPECS,
                                                 _TABLES, FORMATS, GemvPlan,
                                                 _table)
from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize_padded
from ipex_llm_tpu_torch.quantize.qtypes import resolve

NAME = "qmatmul_experts"
# one source, and one library, for each instance
SOURCES = {"tiled": NAME, "gemv": f"{NAME}_gemv", "wgmma": f"{NAME}_wgmma"}
TILES = (16, 64)            # rows of a row tile of the tiled instance
GEMV_MAX_ROWS = 8           # gemv: the bound on an expert's rows
WGMMA_MIN_MEAN_ROWS = 64    # wgmma: the least mean rows an expert, P / E
WGMMA_ROWS = 128            # wgmma: rows of a tile (csrc kBM)
WGMMA_COLS = 256            # wgmma: columns of a tile (csrc kBN)
WGMMA_STEP = 64             # wgmma: contraction rows a step (csrc kBK)
_WGMMA_P_STAGES = 4         # wgmma: the producer's packed-plane ring
_WGMMA_X_STAGES = 4         # wgmma: each consumer's x ring


class _Counts(_build.Counts):
    """Launches of B2e with those of each format (``by_format``) and of
    each instance (``by_instance``: ``"gemv/<out dtype>"``,
    ``"wgmma/<out dtype>"`` and ``"tiled<rows of a tile>/<out dtype>"``)."""

    def reset(self):
        super().reset()
        self.by_format = dict.fromkeys(FORMATS, 0)
        self.by_instance = dict.fromkeys(
            (f"{i}/{d}" for i in ("gemv", "wgmma",
                                  *(f"tiled{t}" for t in TILES))
             for d in ("bf16", "f32")), 0)


COUNTS = _Counts()


def tile_rows(p: int, e: int) -> int:
    """The tiled instance's row tile for ``p`` rows among ``e`` experts,
    from the mean rows an expert: 16 up to 16, else 64 (it takes means
    below 64: the wgmma instance takes the rest)."""
    return TILES[0] if -(-p // max(1, e)) <= TILES[0] else TILES[1]


def slots(p: int, e: int, tile: int) -> int:
    """Row-tile slots of the grid: ``ceil(p / tile) + e`` bounds the row
    tiles of any split of ``p`` rows among ``e`` experts (each expert adds
    at most one partial tile)."""
    return -(-p // tile) + e if p else 0


@functools.lru_cache(maxsize=1024)
def gemv_plan(p: int, e: int, n: int, k: int, bs: int) -> GemvPlan | None:
    """The gemv instance's launch, from shapes alone, by the rule of B2's
    :func:`~ipex_llm_tpu_torch.ops.cuda.qmatmul.gemv_plan` with its warps
    counted over the grid's ``min(e, p)`` expert slots: the fewest K splits
    (a power of two, at most 4 warps x 8 cluster ranks) that put at least
    720 warps on the card, each split at least 128 rows of whole
    quantization blocks; the block's warps split K before the cluster
    does, unless the block's x stage (8 rows) would pass 64 KiB.  The grid
    is ``(cluster, col_blocks, min(e, p))``.  None when no plan fits."""
    nqb = k // bs
    warps = min(e, p) * -(-n // _GEMV_COLS)
    max_splits = max(1, min(_GEMV_MAX_SPLITS,
                            nqb // max(1, _GEMV_MIN_SPLIT_ROWS // bs)))
    splits = 1
    while splits * 2 <= max_splits and warps * splits < _GEMV_TARGET_WARPS:
        splits *= 2
    x_cap = _GEMV_X_BYTES // (2 * GEMV_MAX_ROWS)
    while splits <= _GEMV_MAX_SPLITS:
        per = -(-nqb // splits)
        for wk in (4, 2, 1):
            if (splits % wk == 0 and splits // wk <= _GEMV_MAX_CLUSTER
                    and wk * per * bs <= x_cap):
                cols = (_GEMV_WARPS // wk) * _GEMV_COLS
                return GemvPlan(wk, splits // wk, per, -(-n // cols))
        splits *= 2
    return None


class Plan(NamedTuple):
    """B2e's launch: the ``instance`` (``gemv``, ``wgmma`` or ``tiled``),
    the tiled instance's row tile (``tile``, 0 on the others) and its grid's
    row-tile slots (``slots``), the gemv plan (``gemv``, else None) and
    the wgmma instance's persistent blocks (``blocks``, else 0)."""
    instance: str
    tile: int = 0
    slots: int = 0
    gemv: GemvPlan | None = None
    blocks: int = 0


def plan(p: int, e: int, n: int, k: int, bs: int,
         max_rows: int | None = None, sms: int = 132) -> Plan:
    """The instance for ``p`` rows among ``e`` experts, from static shapes
    and ``max_rows``, a static bound on the rows any expert holds (None:
    ``p``): ``gemv`` when the bound is 8 or less (and its plan fits),
    ``wgmma`` when the mean rows an expert is 64 or more, else the tiled
    instance.  The bound only chooses: every instance is right for any
    split of the rows.  ``sms``: the card's SMs, one persistent wgmma
    block each at most."""
    bound = p if max_rows is None else min(p, max_rows)
    if bound <= GEMV_MAX_ROWS:
        gp = gemv_plan(p, e, n, k, bs)
        if gp is not None:
            return Plan("gemv", gemv=gp)
    if p >= WGMMA_MIN_MEAN_ROWS * e:
        items = slots(p, e, WGMMA_ROWS) * -(-n // WGMMA_COLS)
        return Plan("wgmma", blocks=max(1, min(sms, items)))
    tile = tile_rows(p, e)
    return Plan("tiled", tile=tile, slots=slots(p, e, tile))


def wgmma_smem_bytes(qtype: str) -> int:
    """Dynamic shared memory of one wgmma block in ``qtype``, as the
    kernel's ``wgmma_smem_bytes`` counts it: two bf16 weight tiles, the two
    consumers' x rings, the producer's ring of packed planes and 1 KiB to
    align the swizzled tiles."""
    q = resolve(qtype)
    nibbles = qtype in _NIB4 + _BIT5            # two codes a byte
    data = (WGMMA_STEP // 2 if nibbles else WGMMA_STEP) * WGMMA_COLS
    hbits = WGMMA_STEP // 8 * WGMMA_COLS if qtype in _BIT5 else 0
    scales = max(1, WGMMA_STEP // q.block_size) * WGMMA_COLS * 2
    zeros = scales if q.kind == "int_asym" else 0
    stage = data + hbits + scales + zeros
    return (2 * WGMMA_STEP * WGMMA_COLS * 2
            + 2 * _WGMMA_X_STAGES * 64 * WGMMA_STEP * 2
            + _WGMMA_P_STAGES * stage + 1024)


def segments(sorted_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """int32 ``[E + 1]`` offsets of each expert's rows in ``sorted_ids``
    (expert ids in ascending order): ``seg[e]`` counts the ids below
    ``e``, found by a binary search on the ids' device.  No host read,
    so it never waits for the card (``torch.bincount`` would: it reads
    the ids' range to size its output)."""
    bounds = torch.arange(n_experts + 1, device=sorted_ids.device,
                          dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids.reshape(-1), bounds,
                              out_int32=True)


def qmatmul_experts_plain(x: torch.Tensor, seg: torch.Tensor, qt: QTensor,
                          *, keep_f32: bool = False) -> torch.Tensor:
    """The plain version: each touched expert's weight dequantized to bf16
    (the reference's rounding point), then one product over its rows in
    float64, each output the exactly rounded sum, rounded to bf16 (or fp32
    with ``keep_f32``)."""
    COUNTS.plain_calls += 1
    bounds = seg.tolist()
    out = torch.empty((x.shape[0], qt.out_features),
                      dtype=torch.float32 if keep_f32 else torch.bfloat16,
                      device=x.device)
    xd = x.to(torch.bfloat16).to(torch.float64)
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi > lo:
            w = dequantize_padded(qt.planes(lambda t: t[e])).to(
                torch.bfloat16).to(torch.float64)
            out[lo:hi] = (xd[lo:hi] @ w).to(out.dtype)
    return out


def _launch(x: torch.Tensor, seg: torch.Tensor, qt: QTensor,
            keep_f32: bool, max_rows: int | None) -> torch.Tensor:
    spec = _SPECS.get(qt.qtype)
    if spec is None:
        raise NotImplementedError(f"B2e has no kernel for {qt.qtype!r}")
    fid, bs, num, den, asym = spec
    p, k = x.shape
    data, scales, zeros = qt.data, qt.scales, qt.zeros
    if data.dim() != 3:
        raise ValueError(f"{NAME} takes an [E, rows, N] stack, got data "
                         f"{tuple(data.shape)}")
    e, rows, n = data.shape
    dev = x.device
    if qt.block_size != bs:
        raise ValueError(f"the {qt.qtype} kernel takes {bs}-row blocks, "
                         f"got {qt.block_size}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{NAME} kernel takes bf16 x, got {x.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"{NAME} kernel takes uint8 data and fp16 scales")
    if seg.dtype != torch.int32 or seg.shape != (e + 1,):
        raise ValueError(f"{NAME} needs int32 seg [E + 1 = {e + 1}], got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    if any(t.device != dev for t in (data, scales, seg)):
        raise ValueError("x, seg and the weight planes must be on one "
                         "device")
    if k % bs or rows * num != k * den or scales.shape != (e, k // bs, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, {qt.qtype} "
                         f"data {tuple(data.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if n % 4:
        raise ValueError(f"{NAME} kernel needs out_features % 4 == 0")
    if not all(t.is_contiguous() for t in (x, data, scales, seg)):
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
    out = torch.empty((p, n), dtype=torch.float32 if keep_f32
                      else torch.bfloat16, device=dev)
    if p == 0:
        return out
    pl = plan(p, e, n, k, bs, max_rows, _sm_count(dev))
    lib = _build.load(SOURCES[pl.instance], _DECLARE[pl.instance])
    if x.data_ptr() % 16:
        x = x.clone()                # the instances' 16-byte copies of x
    vec16 = n % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (data, scales, zeros))
    table = _table(qt.qtype, dev) if qt.qtype in _TABLES else None
    # the argtypes _DECLARE sets convert the Python ints
    common = (fid, x.data_ptr(), data.data_ptr(), scales.data_ptr(),
              0 if zeros is None else zeros.data_ptr(),
              0 if table is None else table.data_ptr(), seg.data_ptr(),
              out.data_ptr(), int(keep_f32), e, n, k, rows * n,
              (k // bs) * n)
    if pl.instance == "gemv":
        gp = pl.gemv
        err = lib.qmatmul_experts_gemv(
            *common, min(e, p), gp.warps_k, gp.cluster, gp.qb_per_warp,
            int(vec16), _build.stream_handle(x))
        key = "gemv"
    elif pl.instance == "wgmma":
        err = lib.qmatmul_experts_wgmma(*common, pl.blocks, int(vec16),
                                        _build.stream_handle(x))
        key = "wgmma"
    else:
        err = lib.qmatmul_experts(*common, pl.tile, pl.slots, int(vec16),
                                  _build.stream_handle(x))
        key = f"tiled{pl.tile}"
    COUNTS.launches += 1
    COUNTS.by_format[qt.qtype] += 1
    COUNTS.by_instance[f"{key}/{'f32' if keep_f32 else 'bf16'}"] += 1
    _build.check(err, SOURCES[pl.instance])
    return out


_sms: dict[torch.device, int] = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def qmatmul_experts(x: torch.Tensor, seg: torch.Tensor, qt: QTensor, *,
                    keep_f32: bool = False,
                    max_rows: int | None = None) -> torch.Tensor:
    """x [P, K] (rows sorted by expert, expert e's at ``seg[e]:seg[e+1]``)
    against the ``[E, ...]`` stack ``qt`` -> [P, N] bf16 (fp32 with
    ``keep_f32``); K is the padded contraction width of
    :func:`~ipex_llm_tpu_torch.ops.cuda.qmatmul.data_row_factor`.
    ``max_rows``: a static bound on the rows any expert holds (None: P),
    which with the shapes picks the instance (:func:`plan`)."""
    if x.is_cuda:
        return _launch(x, seg, qt, keep_f32, max_rows)
    return qmatmul_experts_plain(x, seg, qt, keep_f32=keep_f32)


# the arguments each source's entry point takes after the common ones:
# (format, x, data, scales, zeros, table, seg, out, out_f32, E, N, K,
# data_stride, scale_stride)
def _declarer(fn: str, tail):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def declare(lib: ctypes.CDLL):
        f = getattr(lib, fn)
        f.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, ll, ll,
                      *(i for _ in range(tail)), p]
        f.restype = ctypes.c_int
    return declare


_DECLARE = {"tiled": _declarer("qmatmul_experts", 3),     # tile, slots, vec16
            # slots, warps_k, cluster, qb_per_warp, vec16
            "gemv": _declarer("qmatmul_experts_gemv", 5),
            "wgmma": _declarer("qmatmul_experts_wgmma", 2)}  # grid, vec16
