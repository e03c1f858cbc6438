"""Decode-step attention over the dense KV cache (kernel B3; port of
``ipex_llm_tpu/ops/pallas/decode_attention.py::decode_sdpa``).

``csrc/decode_attention.cu`` holds the kernel and the note on its design
and bound.  :func:`split_plan` sets the number of splits of each row's
visible range from shapes alone, :func:`split_bounds` is the sub-range
each split's block computes for itself on the device, and
:func:`row_tiles` the query rows of a GQA group each block takes (a group
above 16 runs as several 16-row tiles).
:func:`decode_sdpa` keeps the reference's public signature, launches the
kernel for CUDA tensors and runs :func:`decode_sdpa_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda.ragged_paged_attention import row_width

NAME = "decode_attention"
# (K, V) head widths of the kernel's instances
INSTANCES = ((64, 64), (80, 80), (96, 64), (96, 96), (128, 128),
             (192, 128), (256, 256))
_TILE_ROWS = 16              # query rows of one mma tile (csrc kRows)
_KV_DTYPES = (torch.bfloat16, torch.float8_e5m2)
_TILE_KEYS = 64              # keys per staged tile (csrc kKT)
_SMS = 132                   # the H100's SMs
_MAX_SPLITS = 64             # keeps every split non-empty (split_plan)


COUNTS = _build.Counts()


def ring_plan(d: int, fp8: bool, dv: int | None = None
              ) -> tuple[int, int, int]:
    """(stages, shared-memory bytes, blocks an SM holds) of the split
    pass at K width ``d`` and V width ``dv`` (None: ``d``) over a bf16 or
    e5m2 layer (csrc ``Ring`` and ``kResident``): three bf16 stages of a
    K/V tile pair, or four raw e5m2 stages and the widened bf16 pair, one
    stage fewer where V is narrower than K (two blocks an SM at (192,
    128) and (96, 64)); a tile's rows 128 columns wide at d = 80 and 96
    (``ragged_paged_attention.row_width``), 64 at 64; at d = 256 the 16
    query rows in shared memory too, and one block an SM."""
    dv = d if dv is None else dv
    pair = _TILE_KEYS * (row_width(d) + row_width(dv)) * 2   # bf16 K + V
    stages = (4 if fp8 else 3) - (dv < d)
    smem = stages * (pair // 2 if fp8 else pair) + (pair if fp8 else 0)
    if d > 192:
        smem += 16 * d * 2
    return stages, smem, 2 if d <= 192 else 1


def row_vectors(b: int, s: int, device, kv_len, kv_start, window_on):
    """kv_len, kv_start and the window enable as int32 [B] on ``device``
    (the reference's defaults: the whole buffer, slot 0, enabled).  A
    Python scalar becomes a fill on the device, not a host-to-device copy
    (the decoder passes its per-layer window flag as a bool)."""
    def vec(x, default):
        x = default if x is None else x
        if not isinstance(x, torch.Tensor):
            return torch.full((b,), int(x), dtype=torch.int32, device=device)
        return x.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return vec(kv_len, s), vec(kv_start, 0), vec(window_on, 1)


def call_args(q, s: int, hkv: int, *, scale, kv_len, kv_start,
              window, window_on, softcap):
    """The checks and defaults of B3's and B4's wrappers, in one place:
    returns (scale, kv_len, kv_start, won, window, softcap) with the row
    vectors as :func:`row_vectors` makes them."""
    b, _, hq, d = q.shape
    if hq % hkv:
        raise NotImplementedError("Hq must be a multiple of Hkv")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    kv_len, kv_start, won = row_vectors(b, s, q.device, kv_len, kv_start,
                                        window_on)
    return (float(d ** -0.5 if scale is None else scale), kv_len, kv_start,
            won, None if window is None else int(window),
            None if softcap is None else float(softcap))


def first_visible(kv_len, kv_start, won, window: int | None):
    """[B] first slot a decode query at ``kv_len - 1`` can see."""
    lo = kv_start.clamp(min=0)
    if window is not None:
        lo = torch.where(won != 0, torch.maximum(lo, kv_len - window), lo)
    return lo


def decode_sdpa_plain(q, k_raw, v_raw, *, scale: float, kv_len, kv_start,
                      won, window: int | None, softcap: float | None
                      ) -> torch.Tensor:
    """The plain version: ``sdpa_reference`` in float64 on the widened
    layer with the query at slot ``kv_len - 1``; a row that sees no key
    returns 0, as the kernel does."""
    from ipex_llm_tpu_torch.ops.attention import sdpa_reference

    COUNTS.plain_calls += 1
    s = k_raw.shape[2]

    def widen(x):                                  # [B, S, Hkv, D]
        return x.to(torch.bfloat16).transpose(1, 2)

    out = sdpa_reference(q, widen(k_raw), widen(v_raw), scale=scale,
                         q_positions=(kv_len - 1).long()[:, None],
                         kv_len=kv_len.long(), kv_start=kv_start.long(),
                         window=window, window_on=won.bool()[:, None, None, None],
                         softcap=softcap, acc_dtype=torch.float64)
    keep = first_visible(kv_len, kv_start, won, window) < kv_len.clamp(max=s)
    return torch.where(keep[:, None, None, None], out, torch.zeros_like(out))


def row_tiles(g: int) -> list[tuple[int, int]]:
    """(first row, rows) of each query-row tile of a GQA group of ``g``
    query heads, as each block computes its own on the device (csrc
    ``g0``, ``rows``): 16-row tiles, the last one short."""
    return [(g0, min(_TILE_ROWS, g - g0)) for g0 in range(0, g, _TILE_ROWS)]


def split_plan(b: int, hkv: int, s: int, d: int = 128,
               dv: int | None = None, g: int = 1) -> int:
    """The number of splits of each row's visible range, from shapes alone
    (reading ``kv_len`` on the host would sync the device every step): as
    many as one wave of the split blocks the card holds at once (2 an SM
    at head dim 96 and 128, 1 at 256: :func:`ring_plan`) takes, with the
    ``len(row_tiles(g))`` row tiles of a GQA group of ``g`` each a block,
    at most one split per 64-key tile of the capacity, and at most 64.
    With the range cut evenly (:func:`split_bounds`), 64 splits or fewer
    leave no split empty while another holds more than one tile."""
    blocks = b * hkv * len(row_tiles(g))
    wave = ring_plan(d, False, dv)[2] * _SMS // blocks
    return max(1, min(wave, -(-s // _TILE_KEYS), _MAX_SPLITS))


def split_bounds(lo, hi, splits: int):
    """([B, splits], [B, splits]): the slots ``[start, end)`` of each split
    of the visible range ``[lo, hi)`` (``lo`` from :func:`first_visible`,
    ``hi`` the clipped ``kv_len``), as each block computes its own on the
    device: ``ceil(n / splits)`` slots a split, the last ones short or
    empty (``end <= start``)."""
    n = (hi - lo).clamp(min=0)
    per = (n + splits - 1) // splits
    start = lo[:, None] + torch.arange(splits, device=lo.device) * per[:, None]
    end = torch.minimum(hi[:, None], start + per[:, None])
    return start, end


def _launch(q, k_raw, v_raw, kv_len, kv_start, won, scale, window, softcap):
    b, _, hq, d = q.shape
    _, hkv, s, dk = k_raw.shape
    dv = v_raw.shape[3]
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode attention kernel takes bf16 q, got {q.dtype}")
    if k_raw.dtype not in _KV_DTYPES or v_raw.dtype != k_raw.dtype:
        raise TypeError("decode attention kernel takes a bf16 or "
                        f"float8_e5m2 cache, got {k_raw.dtype}/{v_raw.dtype}")
    if tuple(v_raw.shape[:3]) != tuple(k_raw.shape[:3]) or dk != d \
            or k_raw.shape[0] != b:
        raise ValueError("k/v must be [B, Hkv, S, D] and [B, Hkv, S, Dv] "
                         "with q's B and D")
    if (d, dv) not in INSTANCES:
        raise NotImplementedError(f"(K, V) head widths {(d, dv)} (kernel "
                                  f"has {INSTANCES})")
    for t in (k_raw, v_raw, kv_len, kv_start, won):
        if t.device != dev:
            raise ValueError("all decode attention inputs must be on q's "
                             "device")
    for t in (q, k_raw, v_raw):
        if not t.is_contiguous():
            raise ValueError("decode attention kernel needs contiguous "
                             "tensors")
        if t.data_ptr() % 16:
            raise ValueError("decode attention kernel needs 16-byte aligned "
                             "tensors")
    lib = _build.load(NAME, _declare)
    g = hq // hkv
    splits = split_plan(b, hkv, s, d, dv, g)
    out = q.new_empty((b, 1, hq, dv))
    ws_acc = torch.empty((b, hkv, splits, g, dv), dtype=torch.float32,
                         device=dev)
    ws_ml = torch.empty((b, hkv, splits, g, 2), dtype=torch.float32,
                        device=dev)
    err = lib.decode_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_raw.data_ptr()),
        ctypes.c_void_p(v_raw.data_ptr()), ctypes.c_void_p(kv_len.data_ptr()),
        ctypes.c_void_p(kv_start.data_ptr()), ctypes.c_void_p(won.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(ws_acc.data_ptr()),
        ctypes.c_void_p(ws_ml.data_ptr()), b, hq, hkv, s, d, dv, splits,
        int(k_raw.dtype == torch.float8_e5m2), ctypes.c_float(scale),
        -1 if window is None else window,
        ctypes.c_float(0.0 if softcap is None else softcap),
        _build.stream_handle(q))
    # the split kernel and the merge of its partials
    COUNTS.launches += 2
    COUNTS.by_head_dim[d] += 2
    _build.check(err, NAME)
    return out


def decode_sdpa(q: torch.Tensor, k_raw: torch.Tensor, v_raw: torch.Tensor,
                *, scale: float | None = None, kv_len=None, kv_start=None,
                window: int | None = None, window_on=True,
                softcap: float | None = None) -> torch.Tensor:
    """T=1 attention over the raw (bf16 or e5m2) head-major cache layer.

    q [B, 1, Hq, D]; k_raw [B, Hkv, S, D] and v_raw [B, Hkv, S, Dv];
    kv_len/kv_start [B] (None: S and 0); ``window_on`` a bool or a [B]
    tensor.  The query sits at slot ``kv_len - 1`` (the decode loop's
    invariant), which subsumes the causal mask.  Returns [B, 1, Hq, Dv] in
    q's dtype."""
    if q.shape[1] != 1:
        raise ValueError("decode attention takes single-token steps")
    scale, kv_len, kv_start, won, window, softcap = call_args(
        q, k_raw.shape[2], k_raw.shape[1], scale=scale, kv_len=kv_len,
        kv_start=kv_start, window=window, window_on=window_on,
        softcap=softcap)
    if q.is_cuda:
        return _launch(q, k_raw, v_raw, kv_len, kv_start, won, scale, window,
                       softcap)
    return decode_sdpa_plain(q, k_raw, v_raw, scale=scale, kv_len=kv_len,
                             kv_start=kv_start, won=won, window=window,
                             softcap=softcap)


def decode_sdpa_sharded(q: torch.Tensor, k_raw: torch.Tensor,
                        v_raw: torch.Tensor, *, tp: int, rank: int,
                        n_kv_heads: int, **kwargs) -> torch.Tensor:
    """One rank of the reference's ``decode_sdpa_sharded`` (B3s): ``q``
    [B, 1, Hq/tp, D] the rank's query heads; ``k_raw``/``v_raw`` [B, Hkv',
    S, D] its layer, holding its ``n_kv_heads / tp`` heads where they
    divide, or all ``n_kv_heads`` where ``tp % n_kv_heads == 0`` (then the
    rank reads kv head ``rank // (tp / n_kv_heads)``, the GQA repeat).
    ``kwargs`` as :func:`decode_sdpa`.  Head-local: no collective.  B3 on
    the card (counted in :data:`SHARDED` too), its plain version on the
    CPU."""
    from ipex_llm_tpu_torch.parallel.shard import rank_kv

    k_raw, v_raw = rank_kv(k_raw, v_raw, q.shape[2], tp, rank, n_kv_heads)
    return _build.through(SHARDED, COUNTS,
                          lambda: decode_sdpa(q, k_raw, v_raw, **kwargs))


SHARDED = _build.Counts()   # launches and plain calls made through B3s


def _declare(lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                     i, i, i, f, i, f, p]
    lib.decode_attention.restype = ctypes.c_int
