"""Scaled dot-product attention (port of ``ipex_llm_tpu/ops/attention.py``).

``sdpa_reference`` keeps the reference's whole contract (causal and
non-causal, GQA, ``kv_len``/``kv_start`` validity, a sliding window with an
enable flag, softcap); it is the oracle the kernels' plain versions are
built on.  The port has no dispatch ladder: a bias-free ``sdpa`` goes to
the flash kernel (B4) whatever T is, and a T=1 ``cached_sdpa`` over the
dense cache to the decode kernel (B3), each wrapper running its kernel on
a CUDA tensor and its plain version on a CPU one.  (The reference's
``T >= 128`` rule picks the flash kernel on a TPU by measurement; on the
card it would leave short prefills on the plain version.)  Attention over
the serving engine's paged pool goes to the ragged paged kernel (B1),
unless the layer has a window, a softcap or left padding: then, as in the
reference, each row's pages are gathered into a head-major layer that B3
(T=1) or B4 reads.  Biases raise.  V may be narrower than K (DeepSeek's
MLA: K 192, V 128): every function takes V's width from ``v`` and
returns it, on either route.

Under a gradient (``torch.is_grad_enabled()`` and a q, k or v that
requires grad) ``sdpa`` runs B4's LSE instance inside
:class:`_FlashAttention`, whose backward is B4's backward kernels
(``ops/cuda/flash_attention_bwd.py``); windows, softcaps, biases and, on
the card, a head_dim other than 128 raise there (ROADMAP item 16's
remainder).  Otherwise B4 is called as it is, with no autograd node.

Tensor-parallel serving passes the rank's group (``tp``) to
:func:`cached_sdpa` and :func:`sdpa`: q holds the rank's query heads and
the cache its kv heads, and the call goes to the kernels' sharded
wrappers (B1s, B3s, B4s), head-local with no collective.
"""

from __future__ import annotations

import torch

from ipex_llm_tpu_torch.ops.cuda.decode_attention import (
    call_args, decode_sdpa, decode_sdpa_sharded)
from ipex_llm_tpu_torch.ops.cuda.flash_attention import (flash_sdpa,
                                                         flash_sdpa_lse,
                                                         flash_sdpa_sharded)
from ipex_llm_tpu_torch.ops.cuda.flash_attention_bwd import flash_sdpa_bwd
from ipex_llm_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_sdpa, ragged_paged_sdpa_sharded)

NEG_INF = -1e30


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float | None = None, causal: bool = True,
                   q_positions: torch.Tensor | None = None,
                   kv_len: torch.Tensor | None = None,
                   kv_start: torch.Tensor | None = None,
                   window: int | None = None, window_on=True,
                   softcap: float | None = None,
                   bias: torch.Tensor | None = None,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """q [B, T, Hq, D] against k/v [B, S, Hkv, D]; returns [B, T, Hq, D] in
    q's dtype.  Scores and softmax in ``acc_dtype``.  Key slot s is valid
    below ``kv_len`` [B] and from ``kv_start`` [B]; causal masking is on the
    absolute slots ``q_positions`` [B, T] (default 0..T-1), and with a
    ``window`` a key must also lie within ``window`` slots of the query
    where ``window_on`` (a bool or a [B] tensor) is set.  A query with no
    valid key gets the mean of V (the softmax of an all-masked row)."""
    if bias is not None:
        raise NotImplementedError("attention biases are not ported")
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hq != hkv:   # GQA: head h reads kv head h // (Hq/Hkv)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.to(acc_dtype),
                          k.to(acc_dtype)) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    kv_pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = torch.ones((b, 1, t, s), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= kv_pos < kv_len[:, None, None, None]
    if kv_start is not None:
        mask &= kv_pos >= kv_start[:, None, None, None]
    if causal:
        if q_positions is None:
            q_positions = torch.arange(t, device=q.device)[None].expand(b, t)
        qp = q_positions[:, None, :, None]
        mask &= kv_pos <= qp
        if window is not None:
            won = torch.as_tensor(window_on, device=q.device).bool()
            if won.dim() == 1:
                won = won[:, None, None, None]
            mask &= (kv_pos > qp - window) | ~won
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.to(acc_dtype))
    return out.to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """B4's LSE instance forward, B4's backward kernels backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_len, kv_start, scale, causal):
        out, lse = flash_sdpa_lse(q, k, v, scale=scale, causal=causal,
                                  q_positions=q_positions, kv_len=kv_len,
                                  kv_start=kv_start)
        ctx.save_for_backward(q, k, v, lse, q_positions, kv_len, kv_start)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, q_positions, kv_len, kv_start = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_bwd(q, k, v, dout, lse, scale=ctx.scale,
                                    causal=ctx.causal,
                                    q_positions=q_positions, kv_len=kv_len,
                                    kv_start=kv_start)
        return dq, dk, dv, None, None, None, None, None


def _sdpa_grad(q, k, v, *, scale=None, causal=True, q_positions=None,
               kv_len=None, kv_start=None, window=None, window_on=True,
               softcap=None, bias=None) -> torch.Tensor:
    if window is not None or softcap is not None or bias is not None:
        raise NotImplementedError(
            "attention with a window, a softcap or a bias under a gradient "
            "is not ported (ROADMAP item 16's remainder)")
    if q.is_cuda and q.shape[-1] != 128:
        raise NotImplementedError(
            f"attention at head_dim {q.shape[-1]} under a gradient on the "
            "card is not ported (ROADMAP item 16's remainder)")
    scale, kv_len, kv_start, _, _, _ = call_args(
        q, k.shape[1], k.shape[2], scale=scale, kv_len=kv_len,
        kv_start=kv_start, window=None, window_on=window_on, softcap=None)
    if q_positions is None:
        b, t = q.shape[:2]
        q_positions = torch.arange(t, device=q.device)[None].expand(b, t)
    return _FlashAttention.apply(q, k, v, q_positions, kv_len, kv_start,
                                 scale, bool(causal))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, tp=None,
         **kwargs) -> torch.Tensor:
    """Attention with ``sdpa_reference``'s arguments through the flash
    kernel (B4; a bias raises); a query with no valid key gets 0.  Under a
    gradient, through :class:`_FlashAttention`; with a ``tp`` group, one
    rank's heads through B4s."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if tp is not None:
            raise NotImplementedError(
                "tensor-parallel attention under a gradient is not ported "
                "(ROADMAP item 15)")
        return _sdpa_grad(q, k, v, **kwargs)
    if tp is not None:
        return flash_sdpa_sharded(q, k, v, tp=tp.size,
                                  n_kv_heads=k.shape[2] * tp.size, **kwargs)
    return flash_sdpa(q, k, v, **kwargs)


def cached_sdpa(q: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor, cache,
                *, compute_dtype=torch.bfloat16,
                chunk_lens: torch.Tensor | None = None, tp=None,
                **kwargs) -> torch.Tensor:
    """SDPA over one cache layer in its storage layout and dtype.

    Paged pool (``cache.tables``): queries sit right-aligned at slots
    ``[kv_len - chunk_lens, kv_len)`` (the engine's invariant).  Without a
    window, a softcap or left padding the ragged paged kernel reads each
    row's pages.  With any of them (the reference's fallback,
    ``ipex_llm_tpu/ops/attention.py:196-236``) each row's pages are
    gathered (``cache.gather_layer``) into a head-major ``[R, Hkv, S, D]``
    layer in storage dtype, ``kv_len`` is clipped to its S (an idle row's
    write slot is a sentinel at or past S), and the layer goes the dense
    cache's way, with ``q_positions`` the queries' slots.  Dense cache
    (layer [B, Hkv, S, D]): a T=1 step reads the layer as stored through
    the decode kernel (e5m2 widened inside it); every other shape widens
    the layer once and runs ``sdpa`` on its ``[B, S, Hkv, D]`` view (no
    copy: the flash kernel reads through the strides).  With a ``tp``
    group, each kernel through its sharded wrapper (module docstring)."""
    if kwargs.get("bias") is not None:
        raise NotImplementedError("attention biases are not ported")
    shard = {} if tp is None else dict(tp=tp.size, rank=tp.rank,
                                       n_kv_heads=kl.shape[1] * tp.size)
    if hasattr(cache, "tables"):
        if kwargs.get("kv_start") is None and kwargs.get("softcap") is None \
                and kwargs.get("window") is None:
            if tp is not None:
                return ragged_paged_sdpa_sharded(
                    q, kl, vl, cache.tables, kwargs["kv_len"], chunk_lens,
                    scale=kwargs.get("scale"), **shard)
            return ragged_paged_sdpa(q, kl, vl, cache.tables,
                                     kwargs["kv_len"], chunk_lens,
                                     scale=kwargs.get("scale"))
        kl = cache.gather_layer(kl)
        vl = cache.gather_layer(vl)
        kwargs["kv_len"] = kwargs["kv_len"].clamp(max=kl.shape[2])
    if q.shape[1] == 1:
        dkw = dict(scale=kwargs.get("scale"), kv_len=kwargs.get("kv_len"),
                   kv_start=kwargs.get("kv_start"),
                   window=kwargs.get("window"),
                   window_on=kwargs.get("window_on", True),
                   softcap=kwargs.get("softcap"))
        if tp is not None:
            return decode_sdpa_sharded(q, kl, vl, **shard, **dkw)
        return decode_sdpa(q, kl, vl, **dkw)
    kd = kl.to(compute_dtype).transpose(1, 2)
    vd = vl.to(compute_dtype).transpose(1, 2)
    return sdpa(q, kd, vd, tp=tp, **kwargs)
