"""Flash attention's backward (B4's gradient): dQ, dK and dV of the causal
SDPA that :func:`ops.cuda.flash_attention.flash_sdpa_lse` computes.

The JAX package has no backward kernel: its gradient is XLA's autodiff of
``sdpa_reference``.  ``csrc/flash_attention_bwd.cu`` holds the port's
kernels (two launches a call: Delta and dQ over query tiles, Delta
recomputed in fp32 as the sum of P dP over the visible keys, then dK and
dV over key tiles, with no atomics) and the note on their design and
bound; :func:`plan` is their launch; the dq kernel walks B4's forward
key tiles (``flash_attention.key_tiles``, without a window) and
:func:`query_tiles` is the dkdv kernel's walk, the rule it applies on
the device.  :func:`flash_sdpa_bwd` launches them for CUDA
tensors and runs :func:`flash_sdpa_bwd_plain` (autograd of the forward's
plain version, in float64) for CPU tensors.  Head dim 128; no window, no
softcap.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4

NAME = "flash_attention_bwd"
COUNTS = _build.Counts()
HEAD_DIM = 128               # the kernels' one instance (csrc kD)
Q_TILE = 64                  # queries per tile (csrc kBQ)
K_TILE = 64                  # keys per tile (csrc kBK)
THREADS = 128                # 4 warps of 16 rows
ROW_PAD = 8                  # bf16 elements after each staged row (csrc kLd)
LAUNCHES = 2                 # dq, then dkdv


class Plan(NamedTuple):
    """The two launches: grids (x, y, z), threads and shared memory of a
    block (four staged 64 x 128 bf16 tiles, rows padded)."""
    dq_grid: tuple[int, int, int]
    dkdv_grid: tuple[int, int, int]
    threads: int
    smem: int


def plan(b: int, t: int, hq: int, hkv: int, s: int) -> Plan:
    smem = 4 * 64 * (HEAD_DIM + ROW_PAD) * 2
    return Plan((hq, b, -(-t // Q_TILE)), (hkv, b, -(-s // K_TILE)),
                THREADS, smem)


def query_tiles(k0: int, qpos_row: list[int], kvs: int, kvl: int, *,
                causal: bool) -> list[int]:
    """The first queries of the 64-query tiles the dkdv block of the keys
    ``[k0, k0 + 64)`` visits, ``qpos_row`` the row's query slots: none
    when the keys lie outside ``[kvs, kvl)``; under causal masking only
    tiles with a query at or past ``k0``."""
    if k0 + K_TILE <= kvs or k0 >= kvl:
        return []
    out = []
    for q0 in range(0, len(qpos_row), Q_TILE):
        tile = qpos_row[q0:q0 + Q_TILE]
        if not causal or max(tile) >= k0:
            out.append(q0)
    return out


def flash_sdpa_bwd_plain(q, k, v, dout, *, scale: float, causal: bool,
                         q_positions, kv_len, kv_start):
    """The plain version: (dq, dk, dv) by autograd of the forward's plain
    version (``flash_sdpa_plain``, ``sdpa_reference`` in float64) on
    float64 copies, each rounded to its input's dtype."""
    COUNTS.plain_calls += 1
    with torch.enable_grad():
        xs = [x.detach().double().requires_grad_() for x in (q, k, v)]
        out = b4.flash_sdpa_plain(
            *xs, scale=scale, causal=causal, q_positions=q_positions.long(),
            kv_len=kv_len, kv_start=kv_start, won=torch.zeros_like(kv_len),
            window=None, softcap=None)
        grads = torch.autograd.grad(out, xs, dout.double())
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def _launch(q, k, v, dout, lse, q_positions, kv_len, kv_start, scale,
            causal):
    b, t, hq, d = q.shape
    _, s, hkv, _ = k.shape
    dev = q.device
    for x in (q, k, v, dout):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{NAME} takes bf16 tensors, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{NAME}: all inputs on q's device")
    if d != HEAD_DIM:
        raise NotImplementedError(f"{NAME} has head_dim {HEAD_DIM}, got {d}")
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or hq % hkv:
        raise ValueError("k/v must be [B, S, Hkv, D] with q's B and D")
    if k.stride() != v.stride() or k.stride(3) != 1 or any(
            st % 8 for st in k.stride()[:3]):
        raise ValueError("k and v need the same strides, multiples of 8, "
                         "and a contiguous head dim")
    for x in (q, dout):
        if not x.is_contiguous():
            raise ValueError(f"{NAME} needs contiguous q and dout")
    for x in (q, k, v, dout):
        if x.data_ptr() % 16:
            raise ValueError(f"{NAME} needs 16-byte aligned tensors")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"{NAME} needs the forward's fp32 [B, Hq, T] lse")
    p = plan(b, t, hq, hkv, s)
    if max(p.dq_grid[2], p.dkdv_grid[2], b) > 65535:
        raise ValueError("grid too large for one launch")
    qpos, kv_len, kv_start = (x.to(device=dev, dtype=torch.int32)
                              .contiguous()
                              for x in (q_positions, kv_len, kv_start))
    lib = _build.load(NAME, _declare)
    dq = torch.empty_like(q)
    dk = torch.empty((b, s, hkv, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=dev)
    ptr = [ctypes.c_void_p(x.data_ptr()) for x in (
        q, k, v, dout, qpos, kv_len, kv_start, lse, delta, dq, dk, dv)]
    err = lib.flash_attention_bwd(
        *ptr, b, t, hq, hkv, s, d, k.stride(0), k.stride(1), k.stride(2),
        ctypes.c_float(scale), int(causal), _build.stream_handle(q))
    COUNTS.launches += LAUNCHES
    _build.check(err, NAME)
    return dq, dk, dv


def flash_sdpa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dout: torch.Tensor, lse: torch.Tensor,
                   *, scale: float, causal: bool,
                   q_positions: torch.Tensor, kv_len: torch.Tensor,
                   kv_start: torch.Tensor):
    """(dq [B, T, Hq, D], dk, dv [B, S, Hkv, D]) of ``flash_sdpa_lse``'s
    output for its gradient ``dout``, from the forward's ``lse``;
    ``kv_len``/``kv_start`` int32 [B], ``q_positions`` [B, T]."""
    if q.is_cuda:
        return _launch(q, k, v, dout.contiguous(), lse, q_positions,
                       kv_len, kv_start, scale, causal)
    return flash_sdpa_bwd_plain(q, k, v, dout, scale=scale, causal=causal,
                                q_positions=q_positions, kv_len=kv_len,
                                kv_start=kv_start)


def _declare(lib: ctypes.CDLL):
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.flash_attention_bwd.argtypes = [p] * 12 + [i] * 6 + [ll] * 3 + [
        f, i, p]
    lib.flash_attention_bwd.restype = ctypes.c_int
