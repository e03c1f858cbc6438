"""Token sampling (port of ``ipex_llm_tpu/ops/sampling.py``).

Two consumers, as in the reference:

- ``generate()`` samples the whole batch with one :class:`SamplingParams`
  (:func:`sample`: repetition penalty, then greedy argmax, or temperature,
  top-k and top-p and a draw);
- the serving engine samples each row with its own knobs and reports the
  raw log-softmax logprob of its token (:func:`sample_rows_with_logprobs`).

Greedy choices are the reference's exactly.  Sampled draws cannot
reproduce the reference's bits: it draws with JAX's threefry keys, and a
port of threefry would tie the port to one framework's generator for no
gain in quality.  ``sample`` draws with Gumbel-max over uniforms from an
explicit ``torch.Generator`` on the logits' device (no host sync), so a
seeded ``generate()`` repeats itself.  The engine draws each row with
Gumbel-max over counter-based uniforms: a hash of ``(seed, step, vocab
index)`` computed on the device.  A row's stream then depends only on its
seed and output index, never on its batch mates, the tick shape or the
decode horizon, which is the property the engine's equivalences rest on.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    repetition_penalty: float = 1.0
    do_sample: bool = False


def apply_repetition_penalty(logits: torch.Tensor, prev_tokens: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """CTRL-style repetition penalty over previously seen tokens.

    logits [B, V]; prev_tokens [B, L] with -1 padding for unused slots."""
    if penalty == 1.0:
        return logits
    valid = prev_tokens >= 0
    idx = torch.where(valid, prev_tokens, torch.zeros_like(prev_tokens))
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, idx.long(), valid.to(torch.int32))
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(hits > 0, penalized, logits)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _transform_logits(logits: torch.Tensor,
                      params: SamplingParams) -> torch.Tensor:
    """The temperature/top-k/top-p transform chain of :func:`sample`."""
    logits = logits.to(torch.float32)
    if params.temperature not in (0.0, 1.0):
        logits = logits / params.temperature
    if params.top_k > 0:
        logits = _top_k_mask(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _top_p_mask(logits, params.top_p)
    return logits


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams,
           prev_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """Next token ids [B] (int32) from logits [B, V].  A sampled draw takes
    its uniforms from ``generator`` (on the logits' device); greedy needs
    none."""
    logits = logits.to(torch.float32)
    if prev_tokens is not None and params.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, prev_tokens,
                                          params.repetition_penalty)
    if not params.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _transform_logits(logits, params)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
