"""Split paged attention (kernel B5; port of
``ipex_llm_tpu/ops/pallas/paged_attention.py``: ``paged_decode_sdpa`` and
``paged_prefill_sdpa``).

Decode (each query sees slots ``[0, kv_len)``) and uniform chunks of C
causal queries at slots ``[kv_len - C, kv_len)`` over the paged pool.  As in
the JAX package, the engine does not dispatch it: the ragged kernel (B1)
carries every attention of the tick, and B5 is its oracle in these two
regimes, which are exactly the shapes of the speculative verify step.
``csrc/paged_attention.cu`` holds the kernel (a page-split pass on the
tensor cores and a merge pass) and the note on its design and bound;
:func:`split_plan` and :func:`query_rows` plan its grid from shapes, and
:func:`key_tiles` / :func:`tile_kind` mirror which key tiles a warp runs
and which it masks.  The wrappers launch it for CUDA tensors and run
:func:`paged_sdpa_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ipex_llm_tpu_torch.kv import gather_rows
from ipex_llm_tpu_torch.ops.cuda import _build

NAME = "paged_attention"
COUNTS = _build.Counts()
_HEAD_DIMS = (128,)         # the kernel's instance
_PAGE_ALIGN = 32            # page sizes the kernel takes: multiples of 32
WARP_ROWS = 16              # query rows per warp (one mma.sync fragment)
# pass-1 blocks to aim for: 64-row tiles (4 warps, about 3 resident an SM)
# and single-warp 16-row blocks, whose splits carry the parallelism
_TARGET_BLOCKS = {64: 1024, 16: 2048}
SKIP, FREE, MASKED = "skip", "free", "masked"   # what a warp does to a tile
_POOL_DTYPES = (torch.bfloat16, torch.float8_e5m2)


def paged_sdpa_plain(q, k_pool, v_pool, tables, kv_len, *,
                     scale: float) -> torch.Tensor:
    """The plain version: gather each row's pages (``kv.gather_rows``) and
    run ``sdpa_reference`` in float64 with the uniform-chunk causal mask
    (query j of row r at slot ``kv_len[r] - C + j``).  A query that sees no
    key (its slot is negative, or ``kv_len`` is 0) returns exact zeros, as
    the kernel does."""
    from ipex_llm_tpu_torch.ops.attention import sdpa_reference

    COUNTS.plain_calls += 1
    c = q.shape[1]

    def gather(pool):                                 # [R, S, Hkv, D]
        return gather_rows(pool, tables).transpose(1, 2).to(torch.bfloat16)

    kv_len = kv_len.long()
    qpos = (kv_len - c)[:, None] + torch.arange(c, device=q.device)
    out = sdpa_reference(q, gather(k_pool), gather(v_pool), scale=scale,
                         q_positions=qpos, kv_len=kv_len,
                         acc_dtype=torch.float64)
    keep = qpos >= 0
    return torch.where(keep[:, :, None, None], out, torch.zeros_like(out))


def query_rows(gc: int) -> int:
    """Query rows of a pass-1 block: 64 (four warps sharing each key tile)
    when the GQA group x chunk has more than 16 rows (C = 128), else one
    16-row fragment (one warp: decode and the verify chunks)."""
    return 64 if gc > 16 else 16


def key_tile(gc: int) -> int:
    """Keys per staged tile: 64 for the 64-row blocks, 16 for the
    single-warp ones (csrc ``key_tile``)."""
    return 64 if gc > 16 else 16


def split_plan(r: int, hkv: int, gc: int, maxp: int) -> tuple[int, int]:
    """(splits, pages per split) of each row's pages, for every chunk
    width: enough pass-1 blocks to cover the card, from shapes alone (no
    read of ``kv_len``)."""
    rows = query_rows(gc)
    base = r * hkv * -(-gc // rows)
    splits = max(1, min(maxp, math.ceil(_TARGET_BLOCKS[rows] / base)))
    pps = -(-maxp // splits)
    return -(-maxp // pps), pps


def key_tiles(k_lo: int, k_hi: int, kt: int) -> list[int]:
    """First slots of the ``kt``-key tiles a block walks over its keys
    [k_lo, k_hi): k_hi is already cut at the split's end, ``kv_len``, the
    table and the block's last visible slot."""
    return list(range(k_lo, k_hi, kt)) if k_hi > k_lo else []


def tile_kind(k0: int, q_lo: int, q_hi: int, k_hi: int, kt: int) -> str:
    """What a warp whose valid rows sit at slots ``q_lo`` .. ``q_hi`` (the
    earliest and the latest) does with the ``kt``-key tile at ``k0``: SKIP
    it when its first key is past every row's slot; FREE (no slot
    compared) when every row sees all its keys and the tile ends by
    ``k_hi``; else MASKED."""
    if k0 > q_hi:
        return SKIP
    if k0 + kt - 1 <= q_lo and k0 + kt <= k_hi:
        return FREE
    return MASKED


def _launch(q, k_pool, v_pool, tables, kv_len, scale):
    r, c, hq, d = q.shape
    n_pages, hkv, ps, dk = k_pool.shape
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bf16 q, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError("paged attention kernel takes bf16 or float8_e5m2 "
                        f"pools, got {k_pool.dtype}/{v_pool.dtype}")
    if tuple(v_pool.shape) != tuple(k_pool.shape) or dk != d:
        raise ValueError("k/v pools must be [P, Hkv, ps, D] with q's D")
    if d not in _HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d} (kernel has {_HEAD_DIMS})")
    if ps % _PAGE_ALIGN:
        raise NotImplementedError(f"page size {ps} is not a multiple of "
                                  f"{_PAGE_ALIGN}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != r:
        raise ValueError("tables must be int32 [R, maxP]")
    if r > 65535 or hkv > 65535:
        raise ValueError("more than 65535 rows or kv heads in one launch")
    kv_len = kv_len.to(torch.int32).contiguous()
    for t in (k_pool, v_pool, tables, kv_len):
        if t.device != dev:
            raise ValueError("all paged attention inputs must be on q's "
                             "device")
    for t in (q, k_pool, v_pool, tables):
        if not t.is_contiguous():
            raise ValueError("paged attention kernel needs contiguous "
                             "tensors")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("pools must be 16-byte aligned, q 4-byte aligned")
    gc = hq // hkv * c
    maxp = tables.shape[1]
    splits, pps = split_plan(r, hkv, gc, maxp)
    lib = _build.load(NAME, _declare)
    ws_acc = torch.empty((r, hkv, splits, gc, d), dtype=torch.float32,
                         device=dev)
    ws_ml = torch.empty((r, hkv, splits, gc, 2), dtype=torch.float32,
                        device=dev)
    out = torch.empty_like(q)
    err = lib.paged_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pool.data_ptr()),
        ctypes.c_void_p(v_pool.data_ptr()), ctypes.c_void_p(tables.data_ptr()),
        ctypes.c_void_p(kv_len.data_ptr()), ctypes.c_void_p(ws_acc.data_ptr()),
        ctypes.c_void_p(ws_ml.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        r, c, hq, hkv, d, ps, n_pages, maxp, splits, pps, query_rows(gc),
        int(k_pool.dtype == torch.float8_e5m2), ctypes.c_float(scale),
        _build.stream_handle(q))
    COUNTS.launches += 2          # the page-split pass and the merge pass
    _build.check(err, NAME)
    return out


def _paged(q, k_pool, v_pool, tables, kv_len, scale):
    d = q.shape[3]
    if q.shape[2] % k_pool.shape[1]:
        raise NotImplementedError("Hq must be a multiple of Hkv")
    scale = float(d ** -0.5 if scale is None else scale)
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, tables, kv_len, scale)
    return paged_sdpa_plain(q, k_pool, v_pool, tables, kv_len, scale=scale)


def paged_decode_sdpa(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables: torch.Tensor,
                      kv_len: torch.Tensor, *,
                      scale: float | None = None) -> torch.Tensor:
    """T=1 attention straight off the paged pool.  q [R, 1, Hq, D];
    k/v_pool [P, Hkv, ps, D] in storage dtype (bf16 or float8_e5m2); tables
    [R, maxP] int32 (-1 = unallocated); kv_len [R] valid slots.  Returns
    [R, 1, Hq, D] in q's dtype."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_sdpa takes one query per row, got "
                         f"{q.shape[1]} (paged_prefill_sdpa takes chunks)")
    return _paged(q, k_pool, v_pool, tables, kv_len, scale)


def paged_prefill_sdpa(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, tables: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       scale: float | None = None) -> torch.Tensor:
    """Chunked attention straight off the paged pool: q [R, C, Hq, D] holds
    each row's queries at slots ``[kv_len - C, kv_len)``, causally masked;
    the chunk's own K/V must already be in the pool.  Other arguments as
    :func:`paged_decode_sdpa`.  Returns [R, C, Hq, D]."""
    return _paged(q, k_pool, v_pool, tables, kv_len, scale)


def paged_decode_sdpa_sharded(q, k_pool, v_pool, tables, kv_len, *,
                              tp: int, rank: int, n_kv_heads: int,
                              scale: float | None = None) -> torch.Tensor:
    """One rank of the reference's ``paged_decode_sdpa_sharded`` (B5s):
    ``q`` [R, 1, Hq/tp, D] the rank's query heads; the pool holds its
    ``n_kv_heads / tp`` heads (``Hkv % tp == 0``) or all ``n_kv_heads``
    (``tp % Hkv == 0``: the rank reads kv head ``rank // (tp / Hkv)``).
    B1s's oracle, not dispatched.  B5 on the card (counted in
    :data:`SHARDED_DECODE` too), its plain version on the CPU."""
    from ipex_llm_tpu_torch.parallel.shard import rank_kv

    k_pool, v_pool = rank_kv(k_pool, v_pool, q.shape[2], tp, rank,
                             n_kv_heads)
    return _build.through(SHARDED_DECODE, COUNTS, lambda: paged_decode_sdpa(
        q, k_pool, v_pool, tables, kv_len, scale=scale))


def paged_prefill_sdpa_sharded(q, k_pool, v_pool, tables, kv_len, *,
                               tp: int, rank: int, n_kv_heads: int,
                               scale: float | None = None) -> torch.Tensor:
    """:func:`paged_prefill_sdpa` for one rank, the head split of
    :func:`paged_decode_sdpa_sharded` (counted in :data:`SHARDED_PREFILL`
    too)."""
    from ipex_llm_tpu_torch.parallel.shard import rank_kv

    k_pool, v_pool = rank_kv(k_pool, v_pool, q.shape[2], tp, rank,
                             n_kv_heads)
    return _build.through(SHARDED_PREFILL, COUNTS, lambda: paged_prefill_sdpa(
        q, k_pool, v_pool, tables, kv_len, scale=scale))


SHARDED_DECODE = _build.Counts()    # launches and plain calls through B5s
SHARDED_PREFILL = _build.Counts()   # decode and B5s prefill


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                    i, i, i, i, i, i, ctypes.c_float, p]
    lib.paged_attention.restype = ctypes.c_int
