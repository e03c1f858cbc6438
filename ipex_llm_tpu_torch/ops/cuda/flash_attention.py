"""Flash attention for prefill (kernel B4; port of
``ipex_llm_tpu/ops/pallas/flash_attention.py::flash_sdpa``).

``csrc/flash_attention.cu`` holds the kernel and the note on its design
and bound; :func:`key_tiles` and :func:`tile_kind` are its walk over the
key tiles, the rule the kernel applies on the device.  :func:`flash_sdpa`
keeps the reference's public signature, launches the kernel for CUDA
tensors and runs :func:`flash_sdpa_plain` for CPU tensors.  K/V are bf16
(the caller widens an e5m2 cache layer once, as the reference's
``cached_sdpa`` does) and are read through their strides, so the dense
cache's head-major layer seen as ``[B, S, Hkv, D]`` is not copied.
:func:`flash_sdpa_lse` is the training forward: the kernel's LSE instance
(head dim 128, no window, no softcap), which also returns each query's
log-sum-exp for the backward (``ops/cuda/flash_attention_bwd.py``), and
:func:`lse_plain` its plain version's.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda.decode_attention import call_args
from ipex_llm_tpu_torch.ops.cuda.ragged_paged_attention import row_width

NAME = "flash_attention"
COUNTS = _build.Counts()
# (K, V) head widths of the kernel's instances
INSTANCES = ((64, 64), (80, 80), (96, 64), (96, 96), (128, 128),
             (192, 128), (256, 256))
Q_TILE = 64                  # queries per block (csrc kBQ)
WARP_ROWS = 16               # queries per warp
K_TILE = 64                  # keys per tile (csrc kBK)
SKIP, FREE, MASKED = 0, 1, 2  # tile kinds (csrc kSkip, kFree, kMasked)


def smem_plan(d: int, dv: int | None = None) -> tuple[int, int, int]:
    """(stages, shared-memory bytes, blocks an SM holds) at K width ``d``
    and V width ``dv`` (None: ``d``) (csrc ``Plan``): a ring of K/V tile
    pairs of 64 keys (three at 64, 80, 96 and 128, two at (192, 128) and
    256; a tile's rows 128 columns wide at 80 and 96, 64 at 64:
    ``ragged_paged_attention.row_width``), at 256 the block's
    64 query rows beside them (Q is read through a descriptor), and 1 KiB
    of slack to align the swizzle."""
    dv = d if dv is None else dv
    pair = K_TILE * (row_width(d) + row_width(dv)) * 2
    stages = 3 if d <= 128 else 2
    smem = stages * pair + (Q_TILE * d * 2 if d > 192 else 0) + 1024
    return stages, smem, 2 if d <= 192 else 1


def key_tiles(qmin: int, qmax: int, kvs: int, kvl: int, *, causal: bool,
              window: int | None) -> range:
    """The first slots of the key tiles a block walks, whose live queries
    sit at slots ``[qmin, qmax]``: from the first slot any of them can see
    to the last.  ``kvs``/``kvl`` are the row's clipped kv_start and
    kv_len; ``window`` is None unless the window is on for the row (it
    applies only under causal masking)."""
    lo, hi = kvs, kvl
    if causal:
        hi = min(hi, qmax + 1)
        if window is not None:
            lo = max(lo, qmin - window + 1)
    if hi <= lo:
        return range(0)
    return range(lo // K_TILE * K_TILE, hi, K_TILE)


def tile_kind(kt: int, qmin: int, qmax: int, kvs: int, kvl: int, *,
              causal: bool, window: int | None) -> int:
    """What one warp does with the key tile at ``kt`` for its rows, whose
    live queries sit at slots ``[qmin, qmax]``: SKIP (no visible pair),
    FREE (every pair visible: no mask) or MASKED (compare each slot)."""
    last = kt + K_TILE - 1
    if causal and kt > qmax:
        return SKIP
    if causal and window is not None and last <= qmin - window:
        return SKIP
    if last < kvs or kt >= kvl:
        return SKIP
    free = kt >= kvs and last < kvl and (
        not causal or (last <= qmin and (window is None
                                         or kt > qmax - window)))
    return FREE if free else MASKED


def visible_queries(q_positions, kv_len, kv_start, won, *, causal: bool,
                    window: int | None, s: int) -> torch.Tensor:
    """[B, T] bool: the query sees at least one key slot."""
    lo = kv_start.clamp(min=0)[:, None].expand_as(q_positions)
    hi = kv_len.clamp(max=s)[:, None].expand_as(q_positions)
    if causal:
        hi = torch.minimum(hi, q_positions + 1)
        if window is not None:
            lo = torch.where(won[:, None] != 0,
                             torch.maximum(lo, q_positions - window + 1), lo)
    return lo < hi


def flash_sdpa_plain(q, k, v, *, scale: float, causal: bool, q_positions,
                     kv_len, kv_start, won, window: int | None,
                     softcap: float | None) -> torch.Tensor:
    """The plain version: ``sdpa_reference`` in float64, and 0 for a query
    that sees no key (the kernel's and the TPU kernel's result; the
    reference's softmax over an all-masked row gives the mean of V)."""
    from ipex_llm_tpu_torch.ops.attention import sdpa_reference

    COUNTS.plain_calls += 1
    out = sdpa_reference(q, k, v, scale=scale, causal=causal,
                         q_positions=q_positions, kv_len=kv_len,
                         kv_start=kv_start, window=window,
                         window_on=won.bool(), softcap=softcap,
                         acc_dtype=torch.float64)
    keep = visible_queries(q_positions, kv_len, kv_start, won, causal=causal,
                           window=window, s=k.shape[1])
    return torch.where(keep[:, :, None, None], out, torch.zeros_like(out))


def lse_plain(q, k, *, scale: float, causal: bool, q_positions, kv_len,
              kv_start) -> torch.Tensor:
    """[B, Hq, T] fp32: each query's log-sum-exp of its visible scaled
    scores, in float64 (+inf for a query that sees no key), the LSE
    instance's output (no window, no softcap)."""
    b, t, hq, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.double(), kk) * scale
    kv_pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = (kv_pos >= kv_start[:, None, None, None]) & (
        kv_pos < kv_len[:, None, None, None])
    if causal:
        mask = mask & (kv_pos <= q_positions[:, None, :, None])
    lse = torch.logsumexp(scores.masked_fill(~mask, -math.inf), dim=-1)
    return torch.where(torch.isfinite(lse), lse,
                       torch.full_like(lse, math.inf)).float()


def _launch(q, k, v, q_positions, kv_len, kv_start, won, scale, causal,
            window, softcap, lse=None):
    b, t, hq, d = q.shape
    _, s, hkv, dk = k.shape
    dv = v.shape[3]
    dev = q.device
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise TypeError("flash attention kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if tuple(v.shape[:3]) != tuple(k.shape[:3]) or dk != d \
            or k.shape[0] != b:
        raise ValueError("k/v must be [B, S, Hkv, D] and [B, S, Hkv, Dv] "
                         "with q's B and D")
    if (d, dv) not in INSTANCES:
        raise NotImplementedError(f"(K, V) head widths {(d, dv)} (kernel "
                                  f"has {INSTANCES})")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("k and v need a contiguous head dim")
    if d == dv and k.stride() != v.stride():
        raise ValueError("k and v of one width need the same strides")
    if any(st % 8 for st in k.stride()[:3] + v.stride()[:3]):
        raise ValueError("k/v strides must be multiples of 8 elements")
    if not q.is_contiguous():
        raise ValueError("flash attention kernel needs a contiguous q")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("flash attention kernel needs 16-byte aligned "
                             "tensors")
    for x in (k, v, q_positions, kv_len, kv_start, won):
        if x.device != dev:
            raise ValueError("all flash attention inputs must be on q's "
                             "device")
    if -(-t // Q_TILE) > 65535 or b > 65535:
        raise ValueError("grid too large for one launch")
    qpos = q_positions.to(torch.int32).contiguous()
    lib = _build.load(NAME, _declare)
    out = q.new_empty((b, t, hq, dv))
    err = lib.flash_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(qpos.data_ptr()),
        ctypes.c_void_p(kv_len.data_ptr()),
        ctypes.c_void_p(kv_start.data_ptr()), ctypes.c_void_p(won.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), b, t, hq, hkv, s, d, dv,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
        v.stride(2), ctypes.c_float(scale),
        int(causal), -1 if window is None else window,
        ctypes.c_float(0.0 if softcap is None else softcap),
        ctypes.c_void_p(0 if lse is None else lse.data_ptr()),
        _build.stream_handle(q))
    COUNTS.launches += 1
    COUNTS.by_head_dim[d] += 1
    _build.check(err, NAME)
    return out


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               scale: float | None = None, causal: bool = True,
               q_positions: torch.Tensor | None = None, kv_len=None,
               kv_start=None, window: int | None = None, window_on=True,
               softcap: float | None = None,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The contract of ``ops.attention.sdpa_reference`` (q [B, T, Hq, D],
    k [B, S, Hkv, D], v [B, S, Hkv, Dv]), except that a query with no
    visible key gives 0.  Returns [B, T, Hq, Dv] in q's dtype."""
    if bias is not None:
        raise NotImplementedError("bias is not supported by the flash kernel")
    scale, kv_len, kv_start, won, window, softcap = call_args(
        q, k.shape[1], k.shape[2], scale=scale, kv_len=kv_len,
        kv_start=kv_start, window=window, window_on=window_on,
        softcap=softcap)
    if q_positions is None:
        b, t = q.shape[:2]
        q_positions = torch.arange(t, device=q.device)[None].expand(b, t)
    if q.is_cuda:
        return _launch(q, k, v, q_positions, kv_len, kv_start, won, scale,
                       bool(causal), window, softcap)
    return flash_sdpa_plain(q, k, v, scale=scale, causal=bool(causal),
                            q_positions=q_positions.long(), kv_len=kv_len,
                            kv_start=kv_start, won=won, window=window,
                            softcap=softcap)


def flash_sdpa_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       tp: int, n_kv_heads: int, **kwargs) -> torch.Tensor:
    """One rank of the reference's ``flash_sdpa_sharded`` (B4s): ``q`` [B,
    T, Hq/tp, D] and ``k``/``v`` [B, S, Hkv/tp, D] the rank's heads (both
    counts must divide tp, as the reference requires); ``kwargs`` as
    :func:`flash_sdpa`.  Head-local: no collective.  B4 on the card
    (counted in :data:`SHARDED` too), its plain version on the CPU."""
    if n_kv_heads % tp or q.shape[2] % (n_kv_heads // tp):
        raise NotImplementedError("head counts must divide tp")
    if k.shape[2] * tp != n_kv_heads:
        raise ValueError(f"a rank's k/v hold {n_kv_heads // tp} kv heads, "
                         f"got {k.shape[2]}")
    return _build.through(SHARDED, COUNTS,
                          lambda: flash_sdpa(q, k, v, **kwargs))


SHARDED = _build.Counts()   # launches and plain calls made through B4s


def flash_sdpa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool, q_positions: torch.Tensor,
                   kv_len: torch.Tensor, kv_start: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): :func:`flash_sdpa` (head dim 128, no window, no
    softcap; ``kv_len``/``kv_start`` int32 [B], ``q_positions`` [B, T])
    and each query's log-sum-exp [B, Hq, T] fp32 (+inf where it sees no
    key), through the LSE instance on a CUDA tensor and the plain versions
    on a CPU one."""
    kv_len, kv_start = (x.to(device=q.device, dtype=torch.int32).contiguous()
                        for x in (kv_len, kv_start))
    won = torch.zeros_like(kv_len)
    if q.is_cuda:
        if q.shape[-1] != 128:
            raise NotImplementedError(
                f"the LSE instance has head_dim 128, got {q.shape[-1]}")
        b, t, hq, _ = q.shape
        lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
        out = _launch(q, k, v, q_positions, kv_len, kv_start, won, scale,
                      bool(causal), None, None, lse=lse)
        return out, lse
    out = flash_sdpa_plain(q, k, v, scale=scale, causal=bool(causal),
                           q_positions=q_positions.long(), kv_len=kv_len,
                           kv_start=kv_start, won=won, window=None,
                           softcap=None)
    return out, lse_plain(q, k, scale=scale, causal=bool(causal),
                          q_positions=q_positions.long(), kv_len=kv_len,
                          kv_start=kv_start)


def _declare(lib: ctypes.CDLL):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.flash_attention.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                    i, ll, ll, ll, ll, ll, ll, f, i, i, f, p,
                                    p]
    lib.flash_attention.restype = ctypes.c_int
