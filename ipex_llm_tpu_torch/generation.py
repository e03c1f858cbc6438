"""Generation over the dense KV cache (port of ``ipex_llm_tpu/generation.py``).

The reference pads the prompt batch into a length bucket, runs one jitted
prefill, and decodes in one jitted ``lax.while_loop`` that exits early when
every row hit EOS.  The port keeps the bucketing, the left padding
(``kv_start`` masks each row's pad slots), the cache capacity and the
repetition-penalty ring, and runs the decode loop in Python, one decoder
step per token, as PyTorch runs eagerly:

- the loop knows the cache's fill, so K/V are written at a Python-int slot
  and no step reads a device scalar;
- without an EOS id no step waits on the device; with one, each step reads
  the ``done`` flags back (one device-to-host sync) to stop early, as the
  reference's ``while_loop`` condition does on the device;
- a streamer callback gets each step's row, which costs one read a step.

``GenerateResult.host_syncs`` counts the device-to-host waits of a call.
Sampled draws come from a ``torch.Generator`` on the device seeded with
``GenerationConfig.seed`` (JAX's threefry keys cannot be reproduced; see
``ops/sampling.py``).  SnapKV compression, the streamed host embedding,
meshes and input embeddings are not ported and raise.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, fields, replace
from typing import Any, Callable

import numpy as np
import torch

from ipex_llm_tpu_torch import kv as kv_mod
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.ops.sampling import SamplingParams, sample

BUCKET = 128          # prompt-length bucket granularity
DECODE_BLOCK = 256    # KV capacity granularity
REP_WINDOW = 512      # repetition-penalty lookback ring size


@dataclass(frozen=True)
class GenerationConfig:
    """HF-compatible knobs (the subset the reference's benchmarks exercise)."""

    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: tuple[int, ...] = ()
    pad_token_id: int = 0
    seed: int = 0

    def sampling(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
            repetition_penalty=self.repetition_penalty,
            do_sample=self.do_sample)

    def with_kwargs(self, kwargs: dict) -> "GenerationConfig":
        """Pop HF-style generate kwargs into a new config (an int or list
        eos becomes a tuple)."""
        names = {f.name for f in fields(GenerationConfig)}
        picked = {k: kwargs.pop(k) for k in list(kwargs) if k in names}
        eos = picked.get("eos_token_id")
        if isinstance(eos, int):
            picked["eos_token_id"] = (eos,)
        elif eos is not None:
            picked["eos_token_id"] = tuple(int(e) for e in eos)
        return replace(self, **picked) if picked else self


@dataclass
class GenerateResult:
    sequences: np.ndarray          # [B, prompt+new] right-trimmed at pad
    num_prompt_tokens: int
    num_new_tokens: np.ndarray     # [B]
    first_token_s: float = 0.0     # TTFT (prefill + first sample)
    rest_token_s: float = 0.0      # mean per-token latency after the first
    host_syncs: int = 0            # device-to-host waits of the call
    cache_kind: str = ""           # 'normal' (bf16) or 'fp8' (e5m2)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_batch(input_ids: Any, pad_id: int, bucket: int = BUCKET
              ) -> tuple[np.ndarray, np.ndarray, int]:
    """Left-pad a ragged (or rectangular) batch into a bucketed array.

    Returns (tokens [B, Tpad], lengths [B], Tpad)."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    if isinstance(input_ids, np.ndarray) and input_ids.ndim == 2:
        rows = list(input_ids)
    else:
        rows = [np.asarray(r).reshape(-1) for r in input_ids]
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    tpad = _round_up(max(int(lens.max()), 1), bucket)
    out = np.full((len(rows), tpad), pad_id, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, tpad - len(r):] = r
    return out, lens, tpad


def _init_prev_ring(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Seed the repetition-penalty ring with the prompt tail: the token at
    absolute position ``p`` lives at ring index ``p % REP_WINDOW``, the
    convention the decode loop writes with."""
    b, tpad = tokens.shape
    ring = np.full((b, REP_WINDOW), -1, dtype=np.int32)
    for i in range(b):
        length = int(lengths[i])
        row = tokens[i, tpad - length:]
        for p in range(max(0, length - REP_WINDOW), length):
            ring[i, p % REP_WINDOW] = row[p]
    return ring


def prefill_step(cfg: ModelConfig, params: dict, cache, tokens: torch.Tensor,
                 lengths: torch.Tensor, input_embeds=None):
    """Run the left-padded prompt [B, Tpad] through the decoder; returns
    (last-token logits [B, V], cache) with the cache filled in place."""
    if input_embeds is not None:
        raise NotImplementedError("input_embeds are not ported")
    b, tpad = tokens.shape
    kv_start = (tpad - lengths).to(torch.int32)
    # logical positions: 0..len-1 right-aligned, clipped at 0 in the pad zone
    pos = torch.clamp(torch.arange(tpad, device=tokens.device)[None, :]
                      - kv_start[:, None], min=0)
    return decoder_forward(cfg, params, tokens, cache, pos, kv_start,
                           last_token_only=True)


def _decode_one(cfg: ModelConfig, params: dict, cache, tok: torch.Tensor,
                pos: torch.Tensor, kv_start: torch.Tensor, prev: torch.Tensor,
                ring_idx: torch.Tensor, generator, gen: GenerationConfig):
    """One decode step: tok [B] at logical positions pos [B]; returns the
    next tokens [B] with the ring ``prev`` updated in place at
    ``ring_idx``."""
    logits, _ = decoder_forward(cfg, params, tok[:, None], cache,
                                pos[:, None], kv_start, last_token_only=True)
    sp = gen.sampling()
    nxt = sample(logits, generator, sp,
                 prev if sp.repetition_penalty != 1.0 else None)
    prev[torch.arange(nxt.shape[0], device=nxt.device), ring_idx] = nxt
    return nxt


def decode_loop(cfg: ModelConfig, params: dict, cache,
                first_tokens: torch.Tensor, lengths: torch.Tensor,
                kv_start: torch.Tensor, prev_ring: torch.Tensor, generator,
                gen: GenerationConfig, max_steps: int):
    """The decode loop with the reference's EOS early exit.

    Returns (tokens [B, max_steps] on the device, steps run, host syncs)."""
    b = first_tokens.shape[0]
    dev = first_tokens.device
    out = torch.full((b, max_steps), gen.pad_token_id, dtype=torch.int32,
                     device=dev)
    out[:, 0] = first_tokens
    eos = (torch.tensor(gen.eos_token_id, dtype=torch.int32, device=dev)
           if gen.eos_token_id else None)
    done = (torch.isin(first_tokens, eos) if eos is not None
            else torch.zeros((b,), dtype=torch.bool, device=dev))
    syncs = 0
    step = 1
    while step < max_steps:
        if eos is not None:
            syncs += 1
            if bool(done.all()):
                break
        nxt = _decode_one(cfg, params, cache, out[:, step - 1],
                          lengths + step - 1, kv_start, prev_ring,
                          (lengths + step) % REP_WINDOW, generator, gen)
        nxt = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt)
        if eos is not None:
            done = done | torch.isin(nxt, eos)
        out[:, step] = nxt
        step += 1
    return out, step, syncs


def _stream_decode(cfg: ModelConfig, params: dict, cache,
                   first: torch.Tensor, lengths: torch.Tensor,
                   kv_start: torch.Tensor, prev_ring: torch.Tensor, generator,
                   gen: GenerationConfig, streamer):
    """Python-driven decode loop with a callback per token row: one host
    sync per token.  Returns (tokens [B, max_new] numpy, steps, syncs)."""
    b = first.shape[0]
    eos_set = set(gen.eos_token_id)
    out = np.full((b, gen.max_new_tokens), gen.pad_token_id, np.int32)
    out[:, 0] = first.cpu().numpy()
    syncs = 1
    streamer(out[:, 0])
    done = np.array([int(t) in eos_set for t in out[:, 0]])
    tok = first
    step = 1
    while step < gen.max_new_tokens and not done.all():
        nxt = _decode_one(cfg, params, cache, tok, lengths + step - 1,
                          kv_start, prev_ring, (lengths + step) % REP_WINDOW,
                          generator, gen)
        row = np.where(done, gen.pad_token_id, nxt.cpu().numpy())
        syncs += 1
        out[:, step] = row
        streamer(row)
        if eos_set:
            done |= np.isin(row, list(eos_set))
        tok = torch.from_numpy(row.astype(np.int32)).to(first.device)
        step += 1
    return out, step, syncs


@torch.no_grad()
def generate(cfg: ModelConfig, params: dict, input_ids: Any,
             generation_config: GenerationConfig, kv_kind: str = "auto",
             streamer: Callable[[np.ndarray], None] | None = None,
             mesh=None, host_embed=None) -> GenerateResult:
    """End-to-end generate on the params' device.  ``input_ids``: a list of
    token lists or a [B, T] array.  ``kv_kind``: 'auto' (e5m2 when
    ``kv.use_quantize_kv_cache()``, else bf16), 'normal' or 'fp8'.

    With a ``streamer`` the callback receives each new token row [B]."""
    if mesh is not None:
        raise NotImplementedError("generate over a mesh is not ported")
    if host_embed is not None:
        raise NotImplementedError("the streamed host embedding is not ported")
    gen = generation_config
    tokens, lengths, tpad = pad_batch(input_ids, gen.pad_token_id)
    b = tokens.shape[0]
    if kv_kind == "auto":
        compress = os.environ.get("IPEX_LLM_TPU_COMPRESS_KV_CACHE",
                                  os.environ.get("IPEX_LLM_COMPRESS_KV_CACHE",
                                                 "")) == "1"
        if compress and cfg.sliding_window is None:
            raise NotImplementedError("SnapKV compression (compresskv.py) is "
                                      "not ported")
        kv_kind = "fp8" if kv_mod.use_quantize_kv_cache() else "normal"
    if kv_kind not in ("normal", "fp8"):
        raise NotImplementedError(f"kv_kind {kv_kind!r} is not ported for "
                                  "generate (normal, fp8)")
    capacity = tpad + _round_up(gen.max_new_tokens + 1, DECODE_BLOCK)
    cache = kv_mod.make_cache(kv_kind, cfg.num_layers, b, capacity,
                              cfg.num_kv_heads, cfg.head_dim,
                              v_head_dim=cfg.v_dim,
                              device=params["embed"].device)
    res = _generate_inner(cfg, params, gen, tokens, lengths, tpad, b, cache,
                          streamer)
    res.cache_kind = kv_kind
    return res


def _generate_inner(cfg, params, gen: GenerationConfig, tokens, lengths,
                    tpad, b, cache, streamer) -> GenerateResult:
    dev = cache.k.device
    tokens_t = torch.from_numpy(tokens).to(dev)
    lengths_t = torch.from_numpy(lengths).to(dev)
    sp = gen.sampling()

    t0 = time.perf_counter()
    logits, cache = prefill_step(cfg, params, cache, tokens_t, lengths_t)
    generator = torch.Generator(device=dev).manual_seed(gen.seed)
    prev_ring = torch.from_numpy(_init_prev_ring(tokens, lengths)).to(dev)
    first = sample(logits, generator, sp,
                   prev_ring if sp.repetition_penalty != 1.0 else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ttft = time.perf_counter() - t0
    syncs = 1
    # the first sampled token joins the penalty window immediately
    prev_ring[torch.arange(b, device=dev), lengths_t % REP_WINDOW] = first
    kv_start = torch.from_numpy((tpad - lengths).astype(np.int32)).to(dev)

    t1 = time.perf_counter()
    if streamer is None:
        out, steps, n = decode_loop(cfg, params, cache, first, lengths_t,
                                    kv_start, prev_ring, generator, gen,
                                    gen.max_new_tokens)
        out = out.cpu().numpy()
        n += 1
    else:
        out, steps, n = _stream_decode(cfg, params, cache, first, lengths_t,
                                       kv_start, prev_ring, generator, gen,
                                       streamer)
    dt = time.perf_counter() - t1

    eos_set = set(gen.eos_token_id)
    new_counts = np.zeros((b,), np.int32)
    for i in range(b):
        n_new = 0
        for t in out[i, :steps]:
            n_new += 1
            if int(t) in eos_set:
                break
        new_counts[i] = n_new
    seqs = np.concatenate([tokens[:, tpad - lengths.max():], out[:, :steps]],
                          axis=1)
    return GenerateResult(sequences=seqs, num_prompt_tokens=int(lengths.max()),
                          num_new_tokens=new_counts, first_token_s=ttft,
                          rest_token_s=dt / max(steps - 1, 1),
                          host_syncs=syncs + n)
