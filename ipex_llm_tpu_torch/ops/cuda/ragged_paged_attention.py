"""Ragged paged attention (kernel B1; port of
``ipex_llm_tpu/ops/pallas/ragged_paged_attention.py::ragged_paged_sdpa``).

``csrc/ragged_paged_attention.cu`` holds the kernel, in two instances, and
the note on their design and bound: query tiles for many-query rows, and
a key split (a split pass, then a merge) for few-query rows (G*C <= 16:
decode, the verify chunks of speculation); each at (K, V) head widths
(64, 64), (80, 80), (96, 96), (128, 128), (256, 256), DeepSeek's MLA
(192, 128) and MiniCPM3's (96, 64) (:func:`smem_plan`).  :func:`split_plan` plans the split from shapes
alone.  :func:`ragged_paged_sdpa` keeps the reference's
public signature, launches the kernel for CUDA tensors and runs
:func:`ragged_paged_sdpa_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ipex_llm_tpu_torch.kv import gather_rows
from ipex_llm_tpu_torch.ops.cuda import _build

NAME = "ragged_paged_attention"
ROUTES = ("tiles", "split")     # the kernel's two instances
# (K, V) head widths of the template instances in the source
INSTANCES = ((64, 64), (80, 80), (96, 64), (96, 96), (128, 128),
             (192, 128), (256, 256))
_FEW_ROWS = 16              # G*C at or below: the key split (its blocks hold 16 rows)
_TILE_KEYS = 64             # keys per shared-memory tile (csrc kKT)
_TARGET_BLOCKS = 1024       # split-pass blocks to aim for (about 8 per SM)
_POOL_DTYPES = (torch.bfloat16, torch.float8_e5m2)


class _Counts(_build.Counts):
    """The kernel's launch accounting, with the launches of each instance
    (``by_route``: ``tiles``, ``split``; a split counts its merge launch;
    ``by_head_dim``, by K width) beside the totals."""

    def reset(self):
        super().reset()
        self.by_route = dict.fromkeys(ROUTES, 0)


COUNTS = _Counts()


def ragged_paged_sdpa_plain(q, k_pool, v_pool, tables, kv_len, chunk_len, *,
                            scale: float) -> torch.Tensor:
    """The plain version: gather each row's pages (``kv.gather_rows``, the
    reference fallback's ``gather_layer`` view) and run
    ``sdpa_reference`` with the causal ``(kv_len, chunk_len)`` mask, in
    float64 so that the result does not depend on the batch or table width.
    Idle rows (``chunk_len == 0``) and queries that see no key return exact
    zeros, as the kernel does."""
    from ipex_llm_tpu_torch.ops.attention import sdpa_reference

    COUNTS.plain_calls += 1
    c = q.shape[1]

    def gather(pool):                                 # [R, S, Hkv, D]
        return gather_rows(pool, tables).transpose(1, 2).to(torch.bfloat16)

    kv_len = kv_len.long()
    chunk = chunk_len.long()
    qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=q.device)
    out = sdpa_reference(q, gather(k_pool), gather(v_pool), scale=scale,
                         q_positions=qpos, kv_len=kv_len,
                         acc_dtype=torch.float64)
    # key slot 0 is the first a query can see: visible keys exist iff it is
    keep = (qpos >= 0) & (kv_len[:, None] > 0) & (chunk[:, None] > 0)
    return torch.where(keep[:, :, None, None], out, torch.zeros_like(out))


def row_width(d: int) -> int:
    """The columns of a key's row in a shared-memory tile (csrc
    ``kRowD``): ``d``, but 128 at 80 and 96, whose ten or twelve 16-byte
    chunks the XOR swizzle would carry out of the row; 64 columns are
    eight chunks, one period of it."""
    return d if d == 64 or d >= 128 else 128


def smem_plan(d: int, split: bool, dv: int | None = None
              ) -> tuple[int, bool]:
    """(shared-memory bytes, whether the query rows sit in shared memory)
    of a block at K width ``d`` and V width ``dv`` (None: ``d``) (csrc
    ``Plan``): two staged pairs of a 64-key K tile and V tile, and the
    block's last visible slot; at 256 the block's query rows (64 for the
    query tiles, 16 for the key split) beside them, which leaves room for
    one block an SM.  At (192, 128) Q stays in registers as at 128: 80
    KiB; at 80 and 96 a tile's rows are 128 columns wide, so 128's 64
    KiB; at 64 (one period of the swizzle) they are 64 wide."""
    dv = d if dv is None else dv
    pair = _TILE_KEYS * (row_width(d) + row_width(dv)) * 2
    if d <= 192:
        return 2 * pair + 16, False
    return 2 * pair + 128 + (_FEW_ROWS if split else 64) * d * 2, True


def split_plan(r: int, hkv: int, gc: int, maxp: int,
               ps: int) -> tuple[int, int]:
    """(splits, pages per split) of the key axis, from shapes alone (no
    read of ``kv_len``): rows of ``gc`` = G*C <= 16 queries split into
    whole pages, enough split-pass blocks to cover the card, each split at
    least one 64-key tile; many-query rows do not split."""
    if gc > _FEW_ROWS:
        return 1, maxp
    min_pages = -(-_TILE_KEYS // ps)
    splits = max(1, min(-(-maxp // min_pages),
                        math.ceil(_TARGET_BLOCKS / (r * hkv))))
    pps = -(-maxp // splits)
    return -(-maxp // pps), pps


def _launch(q, k_pool, v_pool, tables, kv_len, chunk_len, scale):
    r, c, hq, d = q.shape
    n_pages, hkv, ps, dk = k_pool.shape
    dv = v_pool.shape[3]
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"ragged attention kernel takes bf16 q, got {q.dtype}")
    if k_pool.dtype not in _POOL_DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError("ragged attention kernel takes bf16 or float8_e5m2 "
                        f"pools, got {k_pool.dtype}/{v_pool.dtype}")
    if tuple(v_pool.shape[:3]) != tuple(k_pool.shape[:3]) or dk != d:
        raise ValueError("k/v pools must be [P, Hkv, ps, D] and [P, Hkv, "
                         "ps, Dv] with q's D")
    if (d, dv) not in INSTANCES:
        raise NotImplementedError(f"(K, V) head widths {(d, dv)} (kernel "
                                  f"has {INSTANCES})")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != r:
        raise ValueError("tables must be int32 [R, maxP]")
    if r > 65535 or hkv > 65535:
        raise ValueError("more than 65535 rows or kv heads in one launch")
    kv_len = kv_len.to(torch.int32).contiguous()
    chunk_len = chunk_len.to(torch.int32).contiguous()
    for t in (k_pool, v_pool, tables, kv_len, chunk_len):
        if t.device != dev:
            raise ValueError("all ragged attention inputs must be on q's "
                             "device")
    for t in (q, k_pool, v_pool, tables):
        if not t.is_contiguous():
            raise ValueError("ragged attention kernel needs contiguous "
                             "tensors")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("pools must be 16-byte and q 4-byte aligned")
    gc = hq // hkv * c
    maxp = tables.shape[1]
    splits, pps = split_plan(r, hkv, gc, maxp, ps)
    lib = _build.load(NAME, _declare)
    out = q.new_empty((r, c, hq, dv))
    ws_acc = ws_ml = None
    if gc <= _FEW_ROWS:
        ws_acc = torch.empty((r, hkv, splits, gc, dv), dtype=torch.float32,
                             device=dev)
        ws_ml = torch.empty((r, hkv, splits, gc, 2), dtype=torch.float32,
                            device=dev)
    err = lib.ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        kv_len.data_ptr(), chunk_len.data_ptr(), out.data_ptr(),
        0 if ws_acc is None else ws_acc.data_ptr(),
        0 if ws_ml is None else ws_ml.data_ptr(),
        r, c, hq, hkv, d, dv, ps, n_pages, maxp, splits, pps,
        int(k_pool.dtype == torch.float8_e5m2), scale,
        _build.stream_handle(q))
    # the key split launches the split pass and then the merge
    route, launches = ("split", 2) if ws_acc is not None else ("tiles", 1)
    COUNTS.launches += launches
    COUNTS.by_route[route] += launches
    COUNTS.by_head_dim[d] += launches
    _build.check(err, NAME)
    return out


def ragged_paged_sdpa(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, tables: torch.Tensor,
                      kv_len: torch.Tensor,
                      chunk_len: torch.Tensor | None = None, *,
                      scale: float | None = None) -> torch.Tensor:
    """Ragged-batch attention straight off the paged pool.

    q [R, C, Hq, D] right-padded per-row chunks; k_pool [P, Hkv, ps, D]
    and v_pool [P, Hkv, ps, Dv] in storage dtype (bf16 or float8_e5m2);
    tables [R, maxP] int32 (-1 =
    unallocated); kv_len [R] valid slots including this chunk; chunk_len [R]
    valid queries (0 = idle row, None = all C).  Row i's queries sit at
    slots ``[kv_len - chunk_len, kv_len)``; the chunk's own K/V must already
    be in the pool.  Returns [R, C, Hq, Dv] in q's dtype."""
    r, c, hq, d = q.shape
    if hq % k_pool.shape[1]:
        raise NotImplementedError("Hq must be a multiple of Hkv")
    if scale is None:
        scale = d ** -0.5
    if chunk_len is None:
        chunk_len = torch.full((r,), c, dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, tables, kv_len, chunk_len,
                       float(scale))
    return ragged_paged_sdpa_plain(q, k_pool, v_pool, tables, kv_len,
                                   chunk_len, scale=float(scale))


def ragged_paged_sdpa_sharded(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, tables: torch.Tensor,
                              kv_len: torch.Tensor,
                              chunk_len: torch.Tensor | None = None, *,
                              tp: int, rank: int, n_kv_heads: int,
                              scale: float | None = None) -> torch.Tensor:
    """One rank of the reference's ``ragged_paged_sdpa_sharded`` (B1s):
    ``q`` [R, C, Hq/tp, D] the rank's query heads; ``k_pool``/``v_pool`` its
    pool, holding its ``n_kv_heads / tp`` kv heads where they divide, or
    all ``n_kv_heads`` where ``tp % n_kv_heads == 0`` (then the rank reads
    kv head ``rank // (tp / n_kv_heads)``, the reference's GQA repeat);
    tables and lengths shared.  Attention is head-local: no collective.
    Launches B1 on the card (counted in :data:`SHARDED` too) and runs its
    plain version on the CPU."""
    from ipex_llm_tpu_torch.parallel.shard import rank_kv

    k_pool, v_pool = rank_kv(k_pool, v_pool, q.shape[2], tp, rank,
                             n_kv_heads)
    return _build.through(SHARDED, COUNTS, lambda: ragged_paged_sdpa(
        q, k_pool, v_pool, tables, kv_len, chunk_len, scale=scale))


SHARDED = _Counts()     # launches and plain calls made through B1s


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ragged_paged_attention.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                           i, i, i, i, i, i, i, i, i, i,
                                           ctypes.c_float, p]
    lib.ragged_paged_attention.restype = ctypes.c_int
