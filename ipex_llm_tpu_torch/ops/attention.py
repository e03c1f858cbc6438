"""Scaled dot-product attention (port of ``ipex_llm_tpu/ops/attention.py``).

The slice needs ``sdpa_reference`` (the oracle the plain ragged attention
is built on) and the paged branch of ``cached_sdpa``: every attention of
the serving tick goes to the ragged paged kernel (B1).  The reference's
other branches (bias, sliding window, softcap, left padding, the dense
cache) are outside the slice; ``ModelConfig`` refuses the models that
would need them.
"""

from __future__ import annotations

import torch

from ipex_llm_tpu_torch.ops.cuda.ragged_paged_attention import \
    ragged_paged_sdpa

NEG_INF = -1e30


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, kv_len: torch.Tensor,
                   scale: float | None = None,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """Causal attention: q [B, T, Hq, D] at absolute slots ``q_positions``
    [B, T], k/v [B, S, Hkv, D] valid below ``kv_len`` [B]; returns
    [B, T, Hq, D] in q's dtype.  Scores and softmax in ``acc_dtype``."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hq != hkv:   # GQA: head h reads kv head h // (Hq/Hkv)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.to(acc_dtype),
                          k.to(acc_dtype)) * scale
    kv_pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = (kv_pos < kv_len[:, None, None, None]) & (
        kv_pos <= q_positions[:, None, :, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(acc_dtype))
    return out.to(q.dtype)


def cached_sdpa(q: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor, cache,
                *, kv_len: torch.Tensor,
                chunk_lens: torch.Tensor | None = None,
                scale: float | None = None) -> torch.Tensor:
    """SDPA over one paged pool layer in its storage dtype: the ragged
    paged kernel reads each row's pages through ``cache.tables``.  Queries
    sit right-aligned at slots ``[kv_len - chunk_lens, kv_len)`` (the
    engine's invariant)."""
    return ragged_paged_sdpa(q, kl, vl, cache.tables, kv_len, chunk_lens,
                             scale=scale)
