"""Expert-grouped block dequant-matmul in the ten block formats (kernel
B2e): ``y[p] = x[p] @ dequant(W[e(p)])`` for rows sorted by expert.

It replaces ``ipex_llm_tpu/ops/pallas/qmatmul.py::qmatmul_pallas`` as the
reference's sparse MoE dispatch reaches it, one product per (token,
expert) pair under ``jax.vmap`` (``ipex_llm_tpu/ops/moe.py::moe_gather``),
and the reference's ragged route (``moe_ragged``: the whole stack
dequantized to bf16, then ``lax.ragged_dot``).  ``csrc/qmatmul_experts.cu``
holds the kernel and the note on its design and bound: B2's tiled tile
(``csrc/qmatmul_tile.cuh``) over each expert's row tiles, the tiles found
on the device from the segment offsets ``seg``.  :func:`qmatmul_experts`
launches it for CUDA tensors and runs :func:`qmatmul_experts_plain` for
CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda.qmatmul import (_SPECS, _TABLES, FORMATS,
                                                 _table)
from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize_padded

NAME = "qmatmul_experts"
TILES = (16, 64, 128)       # rows of a row tile (the kernel's instances)


class _Counts(_build.Counts):
    """Launches of B2e with those of each format (``by_format``) and of
    each instance (``by_instance``: ``"<rows of a tile>/<out dtype>"``)."""

    def reset(self):
        super().reset()
        self.by_format = dict.fromkeys(FORMATS, 0)
        self.by_instance = dict.fromkeys(
            (f"{t}/{d}" for t in TILES for d in ("bf16", "f32")), 0)


COUNTS = _Counts()


def tile_rows(p: int, e: int) -> int:
    """The row tile for ``p`` rows among ``e`` experts, from the mean rows
    an expert: 16 up to 16 (decode), 64 up to 64, else 128."""
    mean = -(-p // max(1, e))
    for t in TILES[:-1]:
        if mean <= t:
            return t
    return TILES[-1]


def slots(p: int, e: int, tile: int) -> int:
    """Row-tile slots of the grid: ``ceil(p / tile) + e`` bounds the row
    tiles of any split of ``p`` rows among ``e`` experts (each expert adds
    at most one partial tile)."""
    return -(-p // tile) + e if p else 0


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
            keep_f32: bool) -> torch.Tensor:
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
    lib = _build.load(NAME, _declare)
    out = torch.empty((p, n), dtype=torch.float32 if keep_f32
                      else torch.bfloat16, device=dev)
    if p == 0:
        return out
    if x.data_ptr() % 16:
        x = x.clone()                # the tile's 16-byte copies of x
    vec16 = n % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (data, scales, zeros))
    tile = tile_rows(p, e)
    table = _table(qt.qtype, dev) if qt.qtype in _TABLES else None
    err = lib.qmatmul_experts(
        fid, x.data_ptr(), data.data_ptr(), scales.data_ptr(),
        0 if zeros is None else zeros.data_ptr(),
        0 if table is None else table.data_ptr(), seg.data_ptr(),
        out.data_ptr(), int(keep_f32), e, n, k, rows * n, (k // bs) * n,
        tile, slots(p, e, tile), int(vec16), _build.stream_handle(x))
    COUNTS.launches += 1
    COUNTS.by_format[qt.qtype] += 1
    COUNTS.by_instance[f"{tile}/{'f32' if keep_f32 else 'bf16'}"] += 1
    _build.check(err, NAME)
    return out


def qmatmul_experts(x: torch.Tensor, seg: torch.Tensor, qt: QTensor, *,
                    keep_f32: bool = False) -> torch.Tensor:
    """x [P, K] (rows sorted by expert, expert e's at ``seg[e]:seg[e+1]``)
    against the ``[E, ...]`` stack ``qt`` -> [P, N] bf16 (fp32 with
    ``keep_f32``); K is the padded contraction width of
    :func:`~ipex_llm_tpu_torch.ops.cuda.qmatmul.data_row_factor`."""
    if x.is_cuda:
        return _launch(x, seg, qt, keep_f32)
    return qmatmul_experts_plain(x, seg, qt, keep_f32=keep_f32)


def _declare(lib: ctypes.CDLL):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qmatmul_experts.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, ll,
                                    ll, i, i, i, p]
    lib.qmatmul_experts.restype = ctypes.c_int

