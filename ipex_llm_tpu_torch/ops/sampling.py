"""Per-row token sampling for the serving engine (port of
``ipex_llm_tpu/ops/sampling.py``: ``sample_rows_with_logprobs`` and the
per-row top-k / top-p masks).

Greedy rows take the argmax and every row reports the raw log-softmax
logprob of its token, exactly as the reference.  Sampled rows cannot
reproduce the reference's bits: it draws with JAX's threefry keys
(``fold_in(PRNGKey(seed), step)``), and a port of threefry would tie the
engine to one framework's generator for no gain in quality.  The port
instead draws each row with Gumbel-max over counter-based uniforms: a hash
of ``(seed, step, vocab index)`` computed on the device.  A row's stream
then depends only on its seed and output index — never on its batch
mates, the tick shape or the decode horizon — which is the property the
engine's equivalences rest on.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32) without overflowing
    int64: the product is split at 16 bits."""
    lo = h & 0xFFFF
    hi = h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection that mixes every bit)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_rows(seeds: torch.Tensor, steps: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[R] seeds x [R] steps -> [R, vocab] fp32 uniforms in (0, 1), a pure
    function of (seed, step, index)."""
    s = seeds.to(torch.int64) & _M32
    t = steps.to(torch.int64) & _M32
    key = _fmix32((_fmix32(s) + _mul32(t, 0x9E3779B9)) & _M32)
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _fmix32(key[:, None] ^ _mul32(idx, 0x27D4EB2F)[None, :])
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _top_p_mask(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus mask; ``p`` is a scalar or a per-row [R] vector."""
    if isinstance(p, torch.Tensor):
        p = p[..., None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens until the cumulative prob exceeds p (top-1 always kept);
    # the smallest KEPT logit is the cutoff (dropped slots flood to +inf)
    cutoff_mask = cum - probs > p
    cutoff = torch.where(cutoff_mask, torch.full_like(sorted_logits,
                                                      float("inf")),
                         sorted_logits).min(dim=-1, keepdim=True).values
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                       logits)


def _top_k_mask_rows(logits: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Per-row top-k mask; ks [R] int, <= 0 disables for that row."""
    v = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(ks.to(torch.int64) - 1, 0, v - 1)[:, None]
    cutoff = torch.gather(sorted_desc, -1, idx)
    masked = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF),
                         logits)
    return torch.where((ks > 0)[:, None], masked, logits)


def sample_rows_with_logprobs(logits: torch.Tensor, temps: torch.Tensor,
                              top_ps: torch.Tensor, seeds: torch.Tensor,
                              steps: torch.Tensor,
                              top_ks: torch.Tensor | None = None,
                              active: torch.Tensor | None = None):
    """Rows with temperature 0 take the argmax; the others draw from the
    temperature-scaled, top-k/top-p-masked distribution with the
    counter-based stream of ``(seeds[r], steps[r])`` (``steps`` is the
    row's output index).  Returns (tokens [R] int32, logprobs [R] fp32),
    the logprob under the raw model distribution.  ``active`` [R] masks
    dead rows to (token 0, logprob 0)."""
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-4)[:, None]
    if top_ks is not None:
        scaled = _top_k_mask_rows(scaled, top_ks)
    scaled = _top_p_mask(scaled, top_ps)
    u = uniform_rows(seeds, steps, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    chosen = torch.where(temps > 0, sampled, greedy)
    lp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                      chosen.to(torch.int64)[:, None])[:, 0]
    if active is not None:
        chosen = torch.where(active, chosen, torch.zeros_like(chosen))
        lp = torch.where(active, lp, torch.zeros_like(lp))
    return chosen, lp
