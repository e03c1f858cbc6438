"""Continuous-batching engine over the paged KV pool (port of
``ipex_llm_tpu/serving/engine.py``).

One engine thread owns the device.  Each tick is one of two shapes, the
reference's static planner decisions:

- **mixed tick** (any row is still consuming its prompt and
  ``step_token_budget > 0``): every prefilling row advances by a ragged
  chunk of a power-of-two width that fair-shares the token budget, rows
  whose prompt completes sample their first token on the device and join
  the decode state there, and every decoding row takes one decode step —
  :func:`tick_body` with a prefill block;
- **horizon tick** (nothing prefilling): up to ``decode_horizon`` decode
  and sample steps (:func:`decode_horizon_loop`), drained token by token
  through the same emission path as a one-step tick.

With ``spec_k > 0`` both tick shapes decode speculatively by prompt lookup
(:func:`spec_horizon_loop`): each iteration drafts up to ``spec_k`` tokens
from the row's device-resident token history, verifies them in one
``[R, spec_k + 1]`` forward, samples every position with the row's own
parameters and emits the accepted run, 1 to ``spec_k + 1`` tokens.  Every
emitted token is a draw from the plain engine's conditional, so greedy
streams equal the spec-off engine's and seeded rows repeat their streams.

``step_token_budget=0`` selects the sequential engine instead (one row, one
chunk per tick, then the decode step, or with ``spec_k > 0`` one verify
round whose drafts and acceptance walk run on the host): the equivalence
baseline the mixed engine is held against.  The host keeps page tables,
prefix-cache refcounts and request bookkeeping; the per-row decode state
(current token, length, liveness, sampling parameters, budgets, the token
history of speculation) lives on the device and is uploaded only at epochs
(admission, prefill progress, finish).

Admission is bounded: ``submit`` raises ``EngineOverloaded`` when
``max_queue`` requests already wait or the engine is draining; ``drain``
lets the work in flight finish and sheds what is left at its deadline;
per-request deadlines expire at each tick boundary.  The engine keeps the
host-side surfaces the HTTP front end (``serving/api_server.py``) reads:
``metrics``, ``kv_stats``, ``weight_stats``, ``spec_stats``, the latency
``histograms``, the request ``tracer`` and the tick ``flight`` recorder
(``serving/observe.py``).  None of them touches a device tensor, and their
timings read the host clock around block reads the tick already makes.

Every tick the engine thread runs is a transaction (:meth:`_tick`): the
host state is checkpointed, client-visible emissions and trace spans are
staged and flushed only when the tick commits, and a tick that raises is
rolled back.  A transient fault (``faults.is_transient``) retries the
tick, which recomputes it bitwise; a deterministic one is bisected to one
request, which alone finishes "error" (the reference's fault domain,
``serving/faults.py``).

Tensor parallelism (``ServingEngine(..., tp=TPGroup)``, the reference's
manual tick, ``parallel/manual.py``): one engine a rank, each holding its
slices of the params (``shard_params_manual``) and its kv heads of the
pool, all running the same ticks in lockstep over ``local_cfg``.  Rank 0
owns the queue: at each tick's start it broadcasts that tick's
admissions, cancellations, deadline expiries, shed and stop over the
group's gloo control group, and the followers apply exactly those; only
rank 0 takes requests and streams to clients.  The logits are gathered
before sampling and every rank's generator starts from the same seed, so
every rank draws the same tokens and holds the same host state.  The
fault injector is replicated, so a scripted fault fires on every rank at
the same site; at each tick's end the ranks agree on whether it faulted
(one all-reduce over the control group), so retries and bisection run in
lockstep, and a fault on some ranks only ends every rank.  A collective
that fails or times out (``ops/collectives.py::CollectiveError``) is
sticky: every request fails and the engine ends, within the group's
timeout on every rank.  What ``manual.ineligible_reason`` refuses raises
``NotImplementedError``: the reference routes it to GSPMD, which the port
has no counterpart for (ROADMAP item 15).

What the reference has and this slice leaves out: the model-predictive
planner (so no plan masks speculation off for a tick, and the device
history never goes stale between epochs), perfwatch, the host-RAM spill
tier, KV export and import (and their fault sites), and pipeline, data,
expert and context parallelism (and the pipelined verify step).

The reference runs its whole tick as one compiled program with an
on-device early exit from the horizon loop; PyTorch runs eagerly, so the
horizon is a Python loop whose early exit reads the rows' liveness back
from the device once per step.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
import uuid
import warnings
from collections import OrderedDict, deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.kv import PagedKVCache, paged_page_bytes
from ipex_llm_tpu_torch.models.build import (packed_qtypes, param_bytes,
                                             requantize_params)
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.ops.collectives import CollectiveError, resolve_qtype
from ipex_llm_tpu_torch.ops.sampling import sample_rows_with_logprobs
from ipex_llm_tpu_torch.ops.speculate import propose_ngram_rows
from ipex_llm_tpu_torch.quantize.qtypes import resolve as qtype_info
from ipex_llm_tpu_torch.serving.faults import (EngineOverloaded, is_sticky,
                                               is_transient)
from ipex_llm_tpu_torch.serving.observe import (FAST_LATENCY_BUCKETS_S,
                                                LATENCY_BUCKETS_S,
                                                FlightRecorder, Histogram,
                                                Tracer, span)


@dataclass(frozen=True)
class EngineConfig:
    max_rows: int = 16          # concurrent sequences
    max_seq_len: int = 4096     # per-row KV capacity (block-table width)
    page_size: int = 128        # KV page length (slots)
    pool_pages: int = 0         # 0 = auto: max_rows * max_seq_len / page / 2
    kv_storage: str = "bf16"    # "bf16" or "fp8" (e5m2 codes)
    # KV pool byte budget: when > 0 the page count is kv_pool_bytes //
    # page_bytes, so an fp8 pool holds twice the pages of a bf16 one
    kv_pool_bytes: int = 0
    # re-pack full-width (bf16) linear weights into this block format at
    # engine build; None serves the tree at the width it was handed over
    weight_qtype: str | None = None
    prefill_bucket: int = 128   # chunked-prefill chunk length
    decode_horizon: int = 1     # decode steps per horizon tick
    # prefill token budget of a mixed tick; None = prefill_bucket, 0 = the
    # sequential engine (one row, one chunk per tick)
    step_token_budget: int | None = None
    # prompt-lookup speculative decoding: drafts per verify round (0 = off)
    # and the longest n-gram the proposer matches
    spec_k: int = 0
    spec_ngram: int = 3
    # admission control: submit() raises EngineOverloaded once this many
    # requests wait for a row (inbox and pending, not the rows in flight);
    # the HTTP surfaces map it to 429.  0 = unbounded
    max_queue: int = 256
    # fault domain: a transient tick fault retries up to max_step_retries
    # times, the nth retry after a backoff of retry_backoff_s * 2^(n-1); a
    # deterministic one (or exhausted retries) bisects the tick to one
    # culprit request.  Both fields carry the reference engine's names and
    # defaults, so one config dict builds either engine
    max_step_retries: int = 3
    retry_backoff_s: float = 0.02
    # default per-request deadline covering queue wait and generation
    # (Request.deadline_s overrides it); 0 = none.  An expired request
    # finishes "timeout": in the queue without ever taking a row, or in
    # flight at the next tick boundary
    request_deadline_s: float = 0.0
    # request-lifecycle tracing (serving/observe.py): per-request spans
    # (queue wait, prefill chunks, first token, decode horizons, spec
    # rounds, finish) served at /trace/{id}.  False = no tracer, and a
    # trace site costs one `is None` check.  The flight recorder and the
    # latency histograms are always on
    trace_requests: bool = False
    trace_buffer: int = 256     # traces retained (LRU)
    flight_ring: int = 256      # tick records the flight recorder keeps
    # tensor parallelism: the all-reduce's wire family (bf16 = exact, e5m2
    # or int8 = bounded error); None = IPEX_LLM_TPU_COLLECTIVE_QTYPE, else
    # bf16 (ops/collectives.py::resolve_qtype)
    collective_qtype: str | None = None

    @property
    def n_pages(self) -> int:
        if self.pool_pages:
            return self.pool_pages
        # half the worst case (the point of paging); +2: page 0 is scratch
        return max(self.max_rows * self.max_seq_len // self.page_size // 2,
                   self.max_rows + 2)

    @property
    def max_pages(self) -> int:
        return self.max_seq_len // self.page_size


def resolve_load_low_bit(engine_config: EngineConfig | None,
                         low_bit: str | None) -> str | None:
    """The load-width half of the serving width rule (one definition for
    every server entry point): a pinned ``EngineConfig.weight_qtype``
    outranks the ``low_bit`` load argument, so the pinned width drives the
    checkpoint load itself (loading packed at one width and asking the
    engine for another would leave the request a no-op: packed codes are
    not requantized)."""
    if engine_config is not None and engine_config.weight_qtype:
        return engine_config.weight_qtype
    return low_bit


def default_weight_qtype(engine_config: EngineConfig | None,
                         low_bit: str | None) -> EngineConfig:
    """The config half of the serving width rule, beside
    :func:`resolve_load_low_bit`: the width the checkpoint was loaded at
    becomes ``EngineConfig.weight_qtype`` unless the caller pinned one.
    Only for a server that also loaded the checkpoint at that width (the
    repack is then a pass-through and the config records the width
    truthfully); a caller handing in a full-width tree opts into repacking
    through ``weight_qtype`` itself."""
    ec = engine_config or EngineConfig()
    if ec.weight_qtype is None and low_bit:
        ec = replace(ec, weight_qtype=low_bit)
    return ec


@dataclass
class Request:
    prompt_ids: list[int]
    max_new_tokens: int = 128
    temperature: float = 0.0    # 0 = greedy
    top_p: float = 1.0
    top_k: int = 0              # 0 = off
    # sampling stream of the request; None = one drawn from the engine's
    # generator at admission
    seed: int | None = None
    eos_token_id: tuple[int, ...] = ()
    stream_queue: "queue.Queue[int | None]" = field(
        default_factory=queue.Queue)
    request_id: str = ""
    # filled by the engine
    output_ids: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)  # per output token
    finish_reason: str | None = None
    first_token_s: float = 0.0
    submitted_s: float = field(default_factory=time.perf_counter)
    cancelled: bool = False
    # None = the engine default (speculate when EngineConfig.spec_k > 0);
    # False opts the request out, as spec_k=0 does (the reference's flag;
    # _row_spec_k reads both); the row still rides the wide verify step
    speculative: bool | None = None
    # the request's draft width, capped at EngineConfig.spec_k; None = that
    spec_k: int | None = None
    # the HTTP surfaces' stop sequences, cut on the decoded text there
    stop_strings: list[str] = field(default_factory=list)
    # wall-clock budget from submission covering queue wait and
    # generation; None = EngineConfig.request_deadline_s (0 there = none)
    deadline_s: float | None = None
    # the caller's W3C trace id (None = the engine keys the trace on
    # request_id)
    trace_id: str | None = None
    # last emission time (perf_counter), for the inter-token histogram
    _last_tok_s: float = 0.0

    def abort(self):
        self.cancelled = True


class PageAllocator:
    """Host-side page bookkeeping: free list, refcounts, and the
    chained-hash prefix cache (LRU-evicted when the pool runs dry)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        # page 0 is the device scratch page (update_layer routes pad and
        # out-of-range writes there): never handed out
        self.free: list[int] = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros((n_pages,), np.int32)
        self.prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self._page_key: dict[int, bytes] = {}
        # cached prefix pages dropped to satisfy new allocations
        self.prefix_evictions = 0
        # the pages rows held at a tick's checkpoint: released during the
        # tick, they are not handed out (or evicted) again before it
        # commits, so a rollback gives them back to their rows unwritten
        self.pinned: frozenset = frozenset()
        self._deferred: list[int] = []

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self.free) - len(self._deferred)

    def pin(self, pids):
        self.pinned = frozenset(pids)
        self._deferred = []

    def unpin(self):
        """The tick committed: the pages its rows released are free."""
        self.free.extend(self._deferred)
        self.pin(())

    def alloc(self) -> int | None:
        if not self.free and not self._evict(1):
            return None
        pid = self.free.pop()
        self.ref[pid] = 1
        return pid

    def addref(self, pid: int):
        self.ref[pid] += 1

    def decref(self, pid: int):
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            (self._deferred if pid in self.pinned else self.free).append(pid)

    def _evict(self, n: int) -> int:
        """Drop up to ``n`` least-recently-used prefix pages held only by
        the cache; returns how many were dropped."""
        picks = [(key, pid) for key, pid in self.prefix.items()
                 if self.ref[pid] == 1 and pid not in self.pinned][:n]
        for key, pid in picks:
            del self.prefix[key]
            del self._page_key[pid]
            self.decref(pid)
        self.prefix_evictions += len(picks)
        return len(picks)

    def register_prefix(self, key: bytes, pid: int):
        if key in self.prefix or pid in self._page_key:
            return
        self.prefix[key] = pid
        self._page_key[pid] = key
        self.addref(pid)  # the cache's own reference

    def lookup_prefix(self, key: bytes) -> int | None:
        pid = self.prefix.get(key)
        if pid is not None:
            self.prefix.move_to_end(key)  # LRU touch
        return pid


def _chain_hashes(prompt: np.ndarray, page_size: int) -> list[bytes]:
    """Chained content hash per full page: page i's key commits to every
    token before it, so equal keys imply equal K/V contents."""
    keys, h = [], b""
    for i in range(len(prompt) // page_size):
        h = hashlib.sha256(
            h + prompt[i * page_size:(i + 1) * page_size].tobytes()).digest()
        keys.append(h)
    return keys


# -- the tick --------------------------------------------------------------


def decode_horizon_loop(cfg: ModelConfig, params, cache: PagedKVCache,
                        st: dict, horizon: int, tp=None):
    """Up to ``horizon`` decode+sample steps over the whole row pool,
    updating the device state ``st`` in place (port of
    ``_decode_horizon_loop`` without speculation).

    A row that hits EOS or exhausts its budget goes dead for the rest of
    the horizon: its later positions emit padding (token 0, logprob 0) and
    it rides the batch as an idle row (``chunk_lens`` 0, write slot past
    the table width, so its masked K/V write lands on the scratch page and
    attention walks none of its pages).  The loop stops early once every
    row is dead.  Returns ([R, H] tokens, [R, H] logprobs, steps run)."""
    r = st["toks"].shape[0]
    dev = st["toks"].device
    sentinel = cache.tables.shape[1] * cache.page_size
    tok_block = torch.zeros((r, horizon), dtype=torch.int32, device=dev)
    lp_block = torch.zeros((r, horizon), dtype=torch.float32, device=dev)
    alive = st["active"]
    n = 0
    while n < horizon and bool(alive.any()):
        row_lens = st["row_lens"]
        write_at = torch.where(alive, row_lens, torch.full_like(row_lens,
                                                                sentinel))
        logits, cache = decoder_forward(
            cfg, params, st["toks"][:, None], cache, row_lens[:, None],
            slot_offsets=write_at, last_token_only=True,
            chunk_lens=alive.to(torch.int32), tp=tp)
        nxt, lp = sample_rows_with_logprobs(
            logits, st["temps"], st["top_ps"], st["seeds"], st["steps"],
            top_ks=st["top_ks"], active=alive)
        hit_eos = (nxt[:, None] == st["eos"]).any(dim=1) & alive
        adv = alive.to(torch.int32)
        st["row_lens"] = row_lens + adv
        st["steps"] = st["steps"] + adv
        st["remain"] = st["remain"] - adv
        alive = alive & ~hit_eos & (st["remain"] > 0)
        st["toks"] = torch.where(alive, nxt, st["toks"])
        tok_block[:, n] = nxt
        lp_block[:, n] = lp
        n += 1
    st["active"] = alive
    return tok_block, lp_block, n


def _propose_ngram(history: np.ndarray, k: int, ngram: int) -> np.ndarray:
    """Prompt-lookup candidates on the host (the reference's
    ``_propose_ngram``): the k tokens that followed the most recent earlier
    occurrence of the trailing n-gram, longest n first.  Returns [k] int32,
    -1-padded.  The sequential engine drafts with it; the fused tick's
    ``propose_ngram_rows`` computes the same on the device."""
    out = np.full((k,), -1, np.int32)
    ln = len(history)
    for n in range(min(ngram, ln - 1), 0, -1):
        tail = history[ln - n:]
        wins = np.lib.stride_tricks.sliding_window_view(history, n)
        hits = np.nonzero((wins[: ln - n] == tail).all(axis=1))[0]
        if len(hits):
            s = int(hits[-1])  # most recent earlier occurrence
            nxt = history[s + n: s + n + k]
            out[: len(nxt)] = nxt
            return out
    return out


def sample_verify_positions(logits: torch.Tensor, active: torch.Tensor,
                            temps: torch.Tensor, top_ps: torch.Tensor,
                            seeds: torch.Tensor, steps: torch.Tensor,
                            top_ks: torch.Tensor):
    """Sample every position of a verify forward (port of
    ``_sample_verify_positions``): position j of row r draws from
    p(. | context, drafts 1..j) with the row's parameters at output index
    ``steps[r] + j``, so a seeded row keys on (seed, output index) exactly
    as the plain step does.  logits [R, K1, V]; returns tokens and logprobs
    [R, K1], dead rows (``active`` False) padding."""
    r, k1, v = logits.shape
    pos = steps.to(torch.int64)[:, None] + torch.arange(k1,
                                                       device=steps.device)
    t, lp = sample_rows_with_logprobs(
        logits.reshape(r * k1, v), temps.repeat_interleave(k1),
        top_ps.repeat_interleave(k1), seeds.repeat_interleave(k1),
        pos.reshape(-1), top_ks=top_ks.repeat_interleave(k1),
        active=active.repeat_interleave(k1))
    return t.reshape(r, k1), lp.reshape(r, k1)


def spec_horizon_loop(cfg: ModelConfig, params, cache: PagedKVCache,
                      st: dict, horizon: int, spec_ks: torch.Tensor,
                      spec_k: int, spec_ngram: int, tp=None):
    """The speculative form of :func:`decode_horizon_loop` (port of
    ``_spec_horizon_loop``), updating ``st`` (with its token history
    ``st["hist"]``) in place.  Up to ``horizon`` iterations, each on the
    device with no host read but the loop's liveness check:

    - draft: the prompt-lookup continuation of each row's history,
      capped per row by ``spec_ks`` [R] (0 = a plain step through the same
      wide forward: opted-out rows and rows the pool could not back);
    - verify: one ``[R, spec_k + 1]`` forward over [current token; drafts],
      writing K/V at slots ``row_lens .. row_lens + spec_k`` (a rejected
      draft's slot is dead until overwritten; dead rows ride idle);
    - sample every position (:func:`sample_verify_positions`) and walk the
      acceptance chain: position j+1's sample is emitted while the draft fed
      there equals the token emitted before it;
    - truncate the run at the first EOS or the budget, and append it to
      the history.

    Returns ([R, H, K1] tokens, [R, H, K1] logprobs, iterations run,
    [R, H] tokens taken per iteration, drafts proposed, drafts accepted),
    the last two as device scalars."""
    toks = st["toks"]
    r = toks.shape[0]
    dev = toks.device
    k1 = spec_k + 1
    sentinel = cache.tables.shape[1] * cache.page_size
    hist = st["hist"]
    w_hist = hist.shape[1]
    ar_k = torch.arange(spec_k, device=dev)[None, :]
    ar_k1 = torch.arange(k1, device=dev)[None, :]
    tok_block = torch.zeros((r, horizon, k1), dtype=torch.int32, device=dev)
    lp_block = torch.zeros((r, horizon, k1), dtype=torch.float32, device=dev)
    take_block = torch.zeros((r, horizon), dtype=torch.int32, device=dev)
    prop = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    alive = st["active"]
    n = 0
    while n < horizon and bool(alive.any()):
        row_lens = st["row_lens"]
        drafts, n_prop = propose_ngram_rows(hist, row_lens + 1, spec_k,
                                            spec_ngram)
        n_prop = torch.where(alive, torch.minimum(n_prop, spec_ks), 0)
        drafts = torch.where(ar_k < n_prop[:, None], drafts, 0)
        write_at = torch.where(alive, row_lens, sentinel)
        tokens = torch.cat([st["toks"][:, None], drafts], dim=1)
        logits, cache = decoder_forward(
            cfg, params, tokens, cache, write_at[:, None] + ar_k1,
            slot_offsets=write_at, chunk_lens=alive.to(torch.int32) * k1,
            tp=tp)
        t_all, lp_all = sample_verify_positions(
            logits, alive, st["temps"], st["top_ps"], st["seeds"],
            st["steps"], st["top_ks"])
        ok = (drafts == t_all[:, :spec_k]) & (ar_k < n_prop[:, None])
        n_acc = ok.to(torch.int32).cumprod(dim=1).sum(dim=1,
                                                     dtype=torch.int32)
        # EOS or budget truncation inside the accepted window: the boundary
        # the host's _emit walk stops at
        eos_hit = (t_all[:, :, None] == st["eos"][:, None, :]).any(dim=-1)
        ehit = eos_hit & (ar_k1 <= n_acc[:, None])
        any_eos = ehit.any(dim=1)
        first_eos = ehit.to(torch.int32).argmax(dim=1).to(torch.int32)
        n_stop = torch.where(any_eos, first_eos + 1, n_acc + 1)
        n_take = torch.where(alive, torch.minimum(n_stop, st["remain"]), 0)
        keep = ar_k1 < n_take[:, None]
        tok_block[:, n] = torch.where(keep, t_all, 0)
        lp_block[:, n] = torch.where(keep, lp_all, 0.0)
        take_block[:, n] = n_take
        # append the emitted run to the history (the next draft's input);
        # a row's positions are distinct and kept ones lie below the
        # width, so writing back the old value elsewhere changes nothing
        hpos = (row_lens.to(torch.int64)[:, None] + 1 + ar_k1).clamp(
            max=w_hist - 1)
        hist.scatter_(1, hpos, torch.where(keep, t_all, hist.gather(1, hpos)))
        died_eos = any_eos & (first_eos < n_take)
        st["row_lens"] = row_lens + n_take
        st["steps"] = st["steps"] + n_take
        st["remain"] = st["remain"] - n_take
        alive = alive & ~died_eos & (st["remain"] > 0)
        last = t_all.gather(1, (n_take - 1).clamp(min=0).to(
            torch.int64)[:, None])[:, 0]
        st["toks"] = torch.where(alive, last, st["toks"])
        prop += n_prop.sum()
        acc += (n_take - 1).clamp(min=0).sum()
        n += 1
    st["active"] = alive
    return tok_block, lp_block, n, take_block, prop, acc


def tick_body(cfg: ModelConfig, params, cache: PagedKVCache, st: dict,
              prefill=None, horizon: int = 1, with_decode: bool = True,
              spec_ks: torch.Tensor | None = None, spec_k: int = 0,
              spec_ngram: int = 3, tp=None):
    """One engine tick on the device (port of ``_tick_body``); ``tp`` the
    rank's group under tensor parallelism.

    ``prefill`` = (tokens [P, W], tables [P, maxP], base [P], n_valid [P],
    emit [P], canjoin [P], rowmap [P]): a ragged right-padded chunk per
    prefilling row, run as one batch straight over the pool.  Rows whose
    prompt completes (``emit``) sample their first token (output index 0)
    and join the decode state on the device unless that token is EOS, the
    budget is spent, or ``canjoin`` says the host could not back their
    next KV slot.  Then, with ``with_decode``, the decode horizon runs
    over the merged state.  Returns (first tokens [P] | None, first
    logprobs [P] | None, [R, H] tokens, [R, H] logprobs, steps run, None,
    None, None).

    With ``spec_k > 0`` the decode horizon is :func:`spec_horizon_loop`
    (``spec_ks`` [R] the per-row draft widths), a completing row's first
    token joins its history on the device so that it drafts in this very
    tick, and the blocks are [R, H, K1] with the last three entries filled:
    [R, H] tokens taken per iteration, drafts proposed, drafts accepted."""
    r = st["toks"].shape[0]
    dev = st["toks"].device
    first_t = first_lp = None
    if prefill is not None:
        p_tokens, p_tables, p_base, p_nvalid, p_emit, p_canjoin, p_rowmap = \
            prefill
        w = p_tokens.shape[1]
        pos = p_base[:, None] + torch.arange(w, device=dev)[None, :]
        logits, _ = decoder_forward(
            cfg, params, p_tokens, cache.with_tables(p_tables), pos,
            slot_offsets=p_base,
            gather_positions=torch.clamp(p_nvalid - 1, min=0),
            chunk_lens=p_nvalid, tp=tp)
        rows = p_rowmap.long()
        first_t, first_lp = sample_rows_with_logprobs(
            logits, st["temps"][rows], st["top_ps"][rows], st["seeds"][rows],
            torch.zeros_like(p_nvalid), top_ks=st["top_ks"][rows],
            active=p_emit)
        st["row_lens"][rows] = p_base + p_nvalid
        hit_eos = (first_t[:, None] == st["eos"][rows]).any(dim=1)
        rem_after = st["remain"][rows] - 1
        join = p_emit & p_canjoin & ~hit_eos & (rem_after > 0)
        st["toks"][rows] = torch.where(p_emit, first_t, st["toks"][rows])
        st["steps"][rows] = torch.where(p_emit, torch.ones_like(p_nvalid),
                                        st["steps"][rows])
        st["remain"][rows] = torch.where(p_emit, rem_after,
                                         st["remain"][rows])
        st["active"][rows] = torch.where(p_emit, join, st["active"][rows])
        if spec_k > 0:
            # the prompt landed in the history with the admission epoch;
            # the first token joins it here (rows are distinct, and a
            # non-completing row writes back what its slot held)
            hist = st["hist"]
            hpos = (p_base + p_nvalid).to(torch.int64).clamp(
                max=hist.shape[1] - 1)
            hist[rows, hpos] = torch.where(p_emit, first_t, hist[rows, hpos])
    if with_decode and spec_k > 0:
        return (first_t, first_lp) + spec_horizon_loop(
            cfg, params, cache, st, horizon, spec_ks, spec_k, spec_ngram, tp)
    if with_decode:
        tok_block, lp_block, n_exec = decode_horizon_loop(
            cfg, params, cache, st, horizon, tp)
    else:
        tok_block = torch.zeros((r, horizon), dtype=torch.int32, device=dev)
        lp_block = torch.zeros((r, horizon), dtype=torch.float32, device=dev)
        n_exec = 0
    return first_t, first_lp, tok_block, lp_block, n_exec, None, None, None


# _bisect_culprit's answer when the fault does not reproduce
_FAULT_VANISHED = object()


class ServingEngine:
    """Threaded continuous-batching engine around one model of a ported
    family (``models/families.py``)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 engine_config: EngineConfig | None = None,
                 default_eos: tuple[int, ...] = (), device=None,
                 fault_injector=None, tp=None):
        """``params`` must already lie on ``device`` (``None`` = cuda);
        ``fault_injector`` (``faults.FaultInjector``) scripts faults at the
        tick's guarded sites.  ``tp`` (``parallel.mesh.TPGroup``, size >
        1): this engine is that rank of a tensor-parallel engine; ``params``
        is the whole tree (every rank builds it alike) and the engine keeps
        the rank's slices (module docstring)."""
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.ec = ec = engine_config or EngineConfig()
        if ec.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if ec.step_token_budget is not None and ec.step_token_budget < 0:
            raise ValueError("step_token_budget must be >= 0")
        if ec.kv_pool_bytes < 0:
            raise ValueError("kv_pool_bytes must be >= 0")
        if ec.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        if ec.spec_k > 0 and ec.spec_ngram < 1:
            raise ValueError("spec_ngram must be >= 1 when spec_k > 0")
        self.page_bytes = paged_page_bytes(
            cfg.num_layers, cfg.num_kv_heads, ec.page_size, cfg.head_dim,
            cfg.v_dim, storage=ec.kv_storage)
        if ec.kv_pool_bytes:
            pages = ec.kv_pool_bytes // self.page_bytes
            floor = ec.max_rows + 2   # one page per row + scratch
            if pages < floor:
                raise ValueError(
                    f"kv_pool_bytes={ec.kv_pool_bytes} holds only {pages} "
                    f"{ec.kv_storage} pages of {self.page_bytes} bytes; "
                    f"max_rows={ec.max_rows} needs at least {floor}")
            self.ec = ec = replace(ec, pool_pages=pages)
        if ec.weight_qtype is not None:
            params = requantize_params(params, ec.weight_qtype)
        self._weight_qtypes = packed_qtypes(params)
        self.tp = None
        self._fwd_cfg = cfg          # the config the decoder runs over
        self._tp_msg: dict = {}      # this tick's cancellations, expiries
        self._tp_dead = False        # the group broke: send nothing more
        self._tp_procs: list = []    # follower processes this rank started
        if tp is not None and tp.size > 1:
            params = self._tp_setup(cfg, params, tp)
        self.params = params
        self._weight_bytes, self._weight_dense_bytes = param_bytes(params)
        self._served_qtype = self._served_width()
        self.default_eos = default_eos
        r = ec.max_rows
        # a rank's pool holds its kv heads of every page (the page count,
        # and so every allocator decision, is the tp = 1 engine's)
        self.cache = PagedKVCache.init(
            cfg.num_layers, ec.n_pages, r, ec.max_pages,
            self._fwd_cfg.num_kv_heads, ec.page_size, cfg.head_dim,
            storage=ec.kv_storage, device=self.device, v_head_dim=cfg.v_dim)
        self._step_budget = (ec.prefill_bucket if ec.step_token_budget is None
                             else int(ec.step_token_budget))
        self._mixed_mode = self._step_budget > 0
        # the mixed engine drafts, verifies and accepts on the device inside
        # its tick; the sequential engine keeps the host-walk _spec_step,
        # the oracle the fused tick is held against, which runs one verify
        # round a tick and so cannot honour a longer horizon
        self._fused_spec = ec.spec_k > 0 and self._mixed_mode
        if ec.spec_k > 0 and ec.decode_horizon > 1 and not self._fused_spec:
            raise ValueError(
                "decode_horizon > 1 with spec_k > 0 needs the mixed engine "
                "(step_token_budget > 0); the host-walk verify step runs one "
                "round a tick")
        self.alloc = PageAllocator(ec.n_pages)
        self.tables = np.full((r, ec.max_pages), -1, np.int32)
        self._dirty_tables: set[int] = set()
        self.rows: list[Request | None] = [None] * r
        self.row_lens = np.zeros((r,), np.int32)
        self.row_budget = np.zeros((r,), np.int32)
        self.toks = np.zeros((r,), np.int32)
        self.temps = np.zeros((r,), np.float32)
        self.top_ps = np.ones((r,), np.float32)
        self.seeds = np.zeros((r,), np.int64)
        self.top_ks = np.zeros((r,), np.int32)
        self._prefilling: dict[int, np.ndarray] = {}  # row -> remaining ids
        self._row_keys: dict[int, list[bytes]] = {}   # row -> prefix hashes
        # gives each unseeded request its sampling seed at admission
        self._gen = torch.Generator().manual_seed(0)
        self._inbox: "queue.Queue[Request]" = queue.Queue()
        self._pending: "deque[Request]" = deque()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the tick's plan: planned once a logical tick (before its
        # checkpoint), replayed by a retry and by every bisection probe
        self._horizon = ec.decode_horizon
        # the transaction: client-visible puts and trace spans staged until
        # the tick commits (None = outside a tick: they land directly),
        # requests a bisection probe masks out, arrivals drained mid-tick
        # (a rollback returns them to the queue), and the retry count
        self.injector = fault_injector
        self._staging: list[tuple["queue.Queue", int | None]] | None = None
        self._span_staging: list[tuple[str, dict]] = []
        self._masked: set[str] = set()
        self._tick_arrivals: list[Request] = []
        self._retries = 0
        # recovery evidence since the last flight record: a failed tick
        # rolls back and never records, so its retries and injector hits
        # ride the next record (_flight_pending)
        self._flight_retries0 = 0
        self._flight_hits0: dict = {}
        # device-resident row state, re-uploaded only when _dirty
        self._dev: dict[str, torch.Tensor] | None = None
        self._dirty = True
        # drain: submit() refuses while set; _drain_abort asks the engine
        # thread to shed what is left at the drain's deadline
        self._draining = False
        self._drain_deadline: float | None = None
        self._drain_abort = threading.Event()
        # submit()'s check of the bound and its put, one caller at a time
        self._admission = threading.Lock()
        # device programs (tick shapes) issued by the current tick
        self._tick_dispatches = 0
        # request-lifecycle spans, None unless EngineConfig.trace_requests
        self.tracer = (Tracer(ec.trace_buffer) if ec.trace_requests
                       else None)
        # one record a working tick; _fail_all freezes the ring
        self.flight = FlightRecorder(ec.flight_ring)
        # latency histograms: TTFT, client-visible inter-token latency
        # (bursty under a decode horizon: H tokens reach the stream at
        # once), and the tick's blocking read of its results
        self.hists: dict[str, Histogram] = {
            "ttft_s": Histogram(LATENCY_BUCKETS_S),
            "token_latency_s": Histogram(LATENCY_BUCKETS_S),
            "tick_sync_s": Histogram(FAST_LATENCY_BUCKETS_S),
        }
        # the copies histograms() serves, republished after every committed
        # tick, so that a reader never sees one the engine thread is
        # updating nor an observation a rollback takes back
        self._hists_published = {k: h.copy() for k, h in self.hists.items()}
        # rolling TTFT window of /health's ttft_p95_s
        self._ttfts: "deque[float]" = deque(maxlen=128)
        self.metrics = {"requests": 0, "tokens": 0, "steps": 0,
                        # ticks run: frozen while the server's uptime
                        # advances is the wedged-engine signal
                        "ticks": 0,
                        "mixed_steps": 0, "decode_horizon_effective": 0,
                        # one block read of a tick's results a tick, the
                        # seconds blocked in it, tokens emitted per read,
                        # uploads of row state, scatters of dirty table rows
                        "host_syncs": 0, "host_sync_s": 0.0,
                        "tokens_per_sync": 0.0, "epoch_syncs": 0,
                        "table_row_syncs": 0,
                        # admission waves: prompt tokens run in mixed ticks,
                        # per mixed tick, and the rolling TTFT p95
                        "mixed_prefill_tokens": 0,
                        "prefill_tokens_per_step": 0.0, "ttft_p95_s": 0.0,
                        "prefix_hits": 0, "prefix_pages_shared": 0,
                        "alloc_fail_clamps": 0, "pages_in_use": 0,
                        # fault domain: requests isolated and ticks retried,
                        # submissions refused, deadlines expired, requests
                        # waiting for a row
                        "errors_isolated": 0, "retries": 0, "rejected": 0,
                        "timeouts": 0, "queue_depth": 0,
                        "last_error": "",
                        # the horizon loop's per-iteration liveness reads,
                        # beside host_syncs (one block read a tick)
                        "liveness_syncs": 0}
        if ec.spec_k > 0:
            # speculation: verify rounds, ticks that ran them, tokens
            # emitted, row-rounds, drafts proposed and accepted
            self.metrics.update(
                spec_steps=0, spec_ticks=0, spec_emitted=0, spec_row_steps=0,
                spec_accept_rate=0.0, draft_proposed=0, draft_accepted=0,
                spec_tokens_per_dispatch=0.0)
        # rolling (drafts proposed, drafts accepted) of the last 128 spec
        # ticks: the accept rate an operator tunes spec_k and spec_ngram on
        self._spec_window: "deque[tuple[int, int]]" = deque(maxlen=128)

    def _tp_setup(self, cfg: ModelConfig, params: dict, tp) -> dict:
        """Check that the per-rank layout serves this model, resolve the
        wire family, and return the rank's params."""
        from dataclasses import replace as _replace

        from ipex_llm_tpu_torch.parallel.manual import (ineligible_reason,
                                                        local_cfg,
                                                        shard_params_manual)

        budget = (self.ec.prefill_bucket if self.ec.step_token_budget is None
                  else int(self.ec.step_token_budget))
        why = ineligible_reason(cfg, params, {"tp": tp.size}, budget)
        if why is not None:
            raise NotImplementedError(
                f"tensor-parallel serving at tp={tp.size} cannot serve this "
                f"model: {why} (the reference falls back to GSPMD; ROADMAP "
                "item 15)")
        if tp.device != self.device:
            raise ValueError(f"rank {tp.rank} runs on {tp.device}, the "
                             f"engine on {self.device}")
        self.tp = _replace(tp, collective_qtype=resolve_qtype(
            self.ec.collective_qtype or tp.collective_qtype))
        self._fwd_cfg = local_cfg(cfg, tp.size)
        return shard_params_manual(params, cfg, tp.size, tp.rank)

    def parallel_stats(self) -> dict | None:
        """``/health``'s ``parallel`` block: tp, backend, the wire family,
        and this rank's bytes of the KV pool (None without tp)."""
        if self.tp is None:
            return None
        from ipex_llm_tpu_torch.ops.collectives import COUNTS

        return {"tp": self.tp.size, "rank": self.tp.rank,
                "backend": self.tp.backend,
                "collective_qtype": self.tp.collective_qtype,
                "kv_pool_bytes_per_rank": int(
                    self.cache.k.numel() * self.cache.k.element_size()
                    + self.cache.v.numel() * self.cache.v.element_size()),
                "collective_calls": dict(COUNTS.calls),
                "collective_s": {k: round(v, 6)
                                 for k, v in COUNTS.seconds.items()}}

    def _served_width(self) -> str | None:
        """The width the planes really serve (reference
        ``serving/engine.py:1175-1220``): the requested format by its
        canonical name; the planes' own format when the tree arrived packed
        at another width (a warning says the request was not applied, as
        requantizing packed codes would stack error); "mixed" when the tree
        holds more than one packed format; None when nothing is packed."""
        ask = self.ec.weight_qtype
        resolved = qtype_info(ask).name if ask is not None else None
        packed = self._weight_qtypes
        if not packed:
            if resolved is not None and qtype_info(resolved).kind \
                    != "native":
                warnings.warn(
                    f"weight_qtype={ask!r} requested but the tree holds no "
                    "quantizable QTensor leaves: nothing is served at that "
                    "width", stacklevel=3)
                return None
            return resolved
        if resolved is not None and resolved not in packed:
            warnings.warn(
                f"weight_qtype={ask!r} requested but the param tree is "
                f"already packed as {list(packed)}: requantizing packed "
                "codes would stack quantization error, so the tree serves "
                "as-is", stacklevel=3)
        if len(packed) > 1:
            return "mixed"
        return resolved if resolved in packed else packed[0]

    def spec_stats(self) -> dict:
        """Speculative decoding's draft economics (port of
        ``spec_stats``): lifetime drafts proposed and accepted, the accept
        rate over the rolling window of the last 128 spec ticks and over
        the engine's life, and tokens emitted per spec tick."""
        m = self.metrics
        win = list(self._spec_window)   # one copy: the engine appends
        w_prop = sum(p for p, _ in win)
        w_acc = sum(a for _, a in win)
        return {
            "spec_k": self.ec.spec_k,
            "spec_ngram": self.ec.spec_ngram,
            "fused": self._fused_spec,
            "draft_proposed": m.get("draft_proposed", 0),
            "draft_accepted": m.get("draft_accepted", 0),
            "accept_rate": round(w_acc / w_prop, 4) if w_prop else 0.0,
            "accept_rate_lifetime": m.get("spec_accept_rate", 0.0),
            "tokens_per_dispatch": m.get("spec_tokens_per_dispatch", 0.0),
        }

    def weight_stats(self) -> dict:
        """The weight axis (port of the reference's ``weight_stats``): the
        width served, the width asked for, the packed formats present, the
        bytes the tree holds as stored and at bf16 full width, and the
        difference."""
        return {
            "qtype": self._served_qtype,
            "requested_qtype": self.ec.weight_qtype,
            "packed_qtypes": list(self._weight_qtypes),
            "weight_bytes": self._weight_bytes,
            "dense_bytes": self._weight_dense_bytes,
            "bytes_saved": self._weight_dense_bytes - self._weight_bytes,
        }

    def kv_stats(self) -> dict:
        """The KV pool (port of the reference's ``kv_stats``): storage
        format, page and pool bytes, occupancy, and the pressure trace
        (prefix-cache evictions, allocation failures that forced a clamp).
        The host-RAM spill tier is not ported, so ``spill_enabled`` is
        False."""
        a = self.alloc
        return {
            "storage": self.ec.kv_storage,
            "page_size": self.ec.page_size,
            "pages_total": a.n_pages,       # page 0 = reserved scratch
            "pages_free": len(a.free),
            "pages_in_use": a.pages_in_use,
            "page_bytes": self.page_bytes,
            "pool_bytes": a.n_pages * self.page_bytes,
            "prefix_pages_cached": len(a.prefix),
            "prefix_evictions": a.prefix_evictions,
            "alloc_fail_clamps": self.metrics.get("alloc_fail_clamps", 0),
            "horizon_clamped": self.metrics.get("horizon_clamped", 0),
            "spill_enabled": False,
        }

    def histograms(self) -> dict[str, Histogram]:
        """The latency histograms as of the last committed tick (frozen
        copies: the engine thread never mutates what a reader holds, and a
        rolled-back tick's observations never show)."""
        return self._hists_published

    def trace_view(self, trace_id: str) -> dict | None:
        """One trace's spans (/trace/{id}); None when tracing is off or
        the trace aged out of the LRU."""
        if self.tracer is None:
            return None
        return self.tracer.get(trace_id)

    def _trace(self, req: Request | None, name: str, t0: float | None = None,
               t1: float | None = None, **attrs):
        """Record one lifecycle span (or, with no ``t1``, an instant event)
        on ``req``'s trace; one ``is None`` check when tracing is off.
        Inside a tick the span is staged and lands only when the tick
        commits, so a rolled-back tick leaves none."""
        if self.tracer is None or req is None:
            return
        s = span(name, time.time() if t0 is None else t0, t1,
                 origin="engine", **attrs)
        tid = req.trace_id or req.request_id
        if self._staging is not None:
            self._span_staging.append((tid, s))
        else:
            self.tracer.add(tid, s)

    def _decode_parts(self, active: np.ndarray):
        """The (row, request, tokens so far) of a decode drain's rows, so
        that each request's span reports the tokens this tick emitted;
        None when tracing is off."""
        if self.tracer is None:
            return None
        return [(i, self.rows[i], len(self.rows[i].output_ids))
                for i in np.flatnonzero(active) if self.rows[i] is not None]

    def _trace_decode(self, parts, t0_w: float, executed: int, take_np):
        """One span a request for a decode tick: ``decode_horizon`` (steps
        and tokens) or, speculating, ``spec_round`` (rounds and accepted
        drafts, from the take block the tick already read)."""
        if not parts:
            return
        t1 = time.time()
        for i, req, n0 in parts:
            toks = len(req.output_ids) - n0
            if toks == 0 and req.finish_reason is None:
                continue            # a row that idled through the tick
            if take_np is not None:
                row = take_np[i]
                rounds = int((row > 0).sum())
                self._trace(req, "spec_round", t0=t0_w, t1=t1,
                            rounds=rounds, tokens=toks,
                            accepted=max(int(row.sum()) - rounds, 0))
            else:
                self._trace(req, "decode_horizon", t0=t0_w, t1=t1,
                            steps=executed, tokens=toks)

    def _flight_pending(self) -> dict:
        """Recovery evidence since the last record: a failed tick rolls
        back and never records, and ``_recover`` counts its retry after
        the rollback, so the retries and injector site hits ride the next
        committed record (and the dumps taken at a recovery decision)."""
        out = {"retries": self.metrics.get("retries", 0)
               - self._flight_retries0}
        if self.injector is not None:
            hits = {k: v - self._flight_hits0.get(k, 0)
                    for k, v in self.injector.site_hits.items()
                    if v != self._flight_hits0.get(k, 0)}
            if hits:
                out["fault_sites"] = hits
        return out

    def _flight_record(self, snap: dict, t_wall: float):
        """One committed working tick's record: deltas against its
        checkpoint (``snap``), and the recovery evidence against the last
        record, so the ring reads as what each tick did.  Idle ticks are
        counted, not recorded (the idle loop runs ~50 ticks a second and
        would flush real work out of the ring)."""
        m, m0 = self.metrics, snap["metrics"]

        def d(key):
            return m.get(key, 0) - m0.get(key, 0)

        pend = self._flight_pending()
        tokens, admitted = d("tokens"), d("requests")
        if not (tokens or admitted or d("timeouts") or pend["retries"]
                or pend.get("fault_sites") or d("errors_isolated")
                or self._tick_dispatches):
            self.flight.skip_idle()
            return
        free0, _, _, _, evictions0 = snap["alloc"]
        rec = {
            "t": round(t_wall, 3),
            "tick": m["ticks"],
            "dispatches": self._tick_dispatches,
            "sync_s": round(d("host_sync_s"), 6),
            "rows_active": int(self._active_mask().sum()),
            "rows_prefilling": len(self._prefilling),
            "queue_depth": m["queue_depth"],
            "tokens": tokens,
            "admitted": admitted,
            "pages_in_use": self.alloc.pages_in_use,
            "pages_delta": len(free0) - len(self.alloc.free),
            "prefix_evictions": self.alloc.prefix_evictions - evictions0,
            "alloc_fail_clamps": d("alloc_fail_clamps"),
            "retries": pend["retries"],
        }
        if pend.get("fault_sites"):
            rec["fault_sites"] = pend["fault_sites"]
        self._flight_retries0 = m.get("retries", 0)
        if self.injector is not None:
            self._flight_hits0 = dict(self.injector.site_hits)
        self.flight.record(rec)

    # -- public API ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """End the engine thread; on rank 0 of a tensor-parallel engine
        that also ends the followers (the stop rides the next tick message,
        or is sent here when no thread ticks), and the follower processes
        this rank started are joined."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=30)
        elif self.tp is not None and self.tp.leader and not self._tp_dead:
            self._tp_exchange()
        for proc in self._tp_procs:
            proc.join(timeout=self.tp.timeout_s if self.tp else 30)
            if proc.is_alive():
                proc.terminate()
        self._tp_procs = []

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the engine thread to end (a follower rank's engine ends
        when rank 0 stops it, or on a collective error); True when it
        has."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def submit(self, req: Request) -> Request:
        """Queue a request.  Raises ``EngineOverloaded`` when the engine is
        draining (the HTTP surfaces answer 503) or ``max_queue`` requests
        already wait (429): load shedding instead of an unbounded backlog.
        Safe to call from many threads: the bound is checked and the
        request queued under one lock."""
        if self.tp is not None and not self.tp.leader:
            raise RuntimeError("only rank 0 of a tensor-parallel engine "
                               "takes requests")
        if not req.request_id:
            req.request_id = uuid.uuid4().hex
        if not req.eos_token_id:
            req.eos_token_id = self.default_eos
        with self._admission:
            if self._draining:
                self.metrics["rejected"] += 1
                raise EngineOverloaded("engine is draining",
                                       queue_depth=self.queue_depth,
                                       draining=True)
            depth = self.queue_depth
            if self.ec.max_queue and depth >= self.ec.max_queue:
                self.metrics["rejected"] += 1
                raise EngineOverloaded(
                    f"queue full ({depth} requests waiting)",
                    queue_depth=depth)
            self._inbox.put(req)
        self._work.set()
        return req

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a row (inbox and pending, not in flight)."""
        return self._inbox.qsize() + len(self._pending)

    def abort(self, req: Request):
        """Cancel a request (a client that went away, a stop string); its
        row frees at the next tick boundary."""
        req.cancelled = True

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drain_seconds_left(self) -> float:
        """Seconds until the drain's window closes (0.0 when not draining):
        what a 503's Retry-After is derived from."""
        if not self._draining or self._drain_deadline is None:
            return 0.0
        return max(0.0, self._drain_deadline - time.monotonic())

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: refuse new submissions (503), let queued and
        in-flight requests finish, then have the engine thread abort what
        is left at the deadline.  Returns True when everything finished in
        ``timeout``.  The engine thread keeps running (``stop()`` ends it);
        /health reports "draining" meanwhile."""
        with self._admission:
            self._draining = True
            self._drain_deadline = time.monotonic() + timeout

        def busy():
            return (any(r is not None for r in self.rows)
                    or bool(self._pending) or not self._inbox.empty())

        while busy() and time.monotonic() < self._drain_deadline:
            time.sleep(0.01)
        clean = not busy()
        if not clean:
            # the engine thread owns the rows: it sheds them at the top of
            # its next tick
            self._drain_abort.set()
            self._work.set()
            hard = time.monotonic() + 10.0
            while busy() and time.monotonic() < hard:
                time.sleep(0.01)
        return clean

    def _shed_remaining(self):
        """The drain's deadline passed (engine thread): abort every row in
        flight and every queued request, so that ``drain`` returns."""
        for i, r in enumerate(self.rows):
            if r is not None:
                self._finish(i, "abort")
        self._drain_inbox()
        while self._pending:
            req = self._pending.popleft()
            if req.finish_reason is None:
                req.finish_reason = "abort"
            self._queue_put(req, None)
        self.metrics["queue_depth"] = self.queue_depth

    def _deadline_of(self, req: Request) -> float | None:
        d = (req.deadline_s if req.deadline_s is not None
             else self.ec.request_deadline_s)
        return d if d and d > 0 else None

    def _expire_deadlines(self):
        """Finish the requests past their budget: rows in flight, and
        queued requests before they ever take a row (under tp the ones rank
        0 found expired at the tick's start)."""
        now = time.perf_counter()
        for i, r in enumerate(self.rows):
            if r is None:
                continue
            if self._expired(r, now):
                self.metrics["timeouts"] += 1
                self._finish(i, "timeout")
        if self._pending:
            keep: "deque[Request]" = deque()
            for r in self._pending:
                if self._expired(r, now):
                    self.metrics["timeouts"] += 1
                    if r.finish_reason is None:
                        r.finish_reason = "timeout"
                    self._queue_put(r, None)
                else:
                    keep.append(r)
            self._pending = keep

    def _expired(self, req: Request, now: float) -> bool:
        if self.tp is not None:
            return req.request_id in self._tp_msg.get("expire", ())
        d = self._deadline_of(req)
        return d is not None and now - req.submitted_s > d

    def _cancelled(self, req: Request) -> bool:
        """The request's cancel flag; under tp the flag as rank 0 read it
        at the tick's start (another thread may set it mid-tick, on rank 0
        alone)."""
        if self.tp is not None:
            return req.request_id in self._tp_msg.get("cancel", ())
        return req.cancelled

    # -- tensor-parallel lockstep --------------------------------------------

    def _tp_exchange(self) -> dict | None:
        """The tick message (module docstring), sent by rank 0 and applied
        on every rank; on a retry (``_retries > 0``) it carries no new
        work and the failed tick's cancellations and expiries stand.
        Returns the message, or None when the engine is to stop."""
        import torch.distributed as dist

        leader = self.tp.leader
        fresh = self._retries == 0
        msg = None
        if leader:
            msg = {"stop": self._stop.is_set(),
                   "shed": self._drain_abort.is_set(), "new": []}
            if fresh and not msg["stop"]:
                new = []
                while not self._inbox.empty():
                    new.append(self._inbox.get_nowait())
                self._pending.extend(new)
                now = time.perf_counter()
                live = [r for r in self.rows if r is not None] + \
                    list(self._pending)
                msg["new"] = [_request_fields(r) for r in new]
                msg["cancel"] = [r.request_id for r in live if r.cancelled]
                d_of = self._deadline_of
                msg["expire"] = [r.request_id for r in live
                                 if d_of(r) is not None
                                 and now - r.submitted_s > d_of(r)]
        box = [msg]
        try:
            dist.broadcast_object_list(box, src=0, group=self.tp.ctrl)
        except Exception as exc:  # noqa: BLE001 -- the group is gone
            raise CollectiveError(
                f"tick message over gloo (rank {self.tp.rank} of "
                f"{self.tp.size}) failed: {type(exc).__name__}: "
                f"{exc}") from exc
        msg = box[0]
        if msg["stop"]:
            self._stop.set()
            return None
        if not leader:
            self._pending.extend(Request(**f) for f in msg["new"])
        if fresh:
            self._tp_msg = {"cancel": set(msg.get("cancel", ())),
                            "expire": set(msg.get("expire", ()))}
        return msg

    def _tp_agree(self, err: BaseException | None) -> BaseException | None:
        """After a tick's scheduler ran: every rank reports whether it
        raised (and whether transiently) in one all-reduce over the
        control group.  The same fault on every rank recovers in lockstep;
        a fault on some ranks only, or a failed agreement, becomes a
        ``CollectiveError`` (sticky: every rank ends)."""
        import torch.distributed as dist

        if isinstance(err, CollectiveError):
            return err      # the group is broken: the peers time out
        flags = torch.tensor([int(err is not None),
                              int(err is not None and is_transient(err))],
                             dtype=torch.int64)
        try:
            dist.all_reduce(flags, group=self.tp.ctrl)
        except Exception as exc:  # noqa: BLE001 -- the group is gone
            return CollectiveError(
                f"tick agreement over gloo (rank {self.tp.rank}) failed: "
                f"{type(exc).__name__}: {exc}")
        n = self.tp.size
        if any(int(f) not in (0, n) for f in flags):
            return CollectiveError(
                f"the ranks diverged: {int(flags[0])} of {n} raised in this "
                f"tick ({int(flags[1])} transiently); this rank's error: "
                f"{type(err).__name__ if err else None}: {err}")
        return err

    # -- fault domain -------------------------------------------------------

    def _fault_point(self, site: str, rows=(), reqs=()):
        """A guarded site: the injector may raise here, before the device
        or allocator operation the site names.  ``rows`` and ``reqs`` name
        the requests taking part, which scope a poisoned-request fault and
        which bisection masks."""
        if self.injector is None:
            return
        ids = [r.request_id for r in reqs if r is not None]
        for i in rows:
            r = self.rows[i]
            if r is not None:
                ids.append(r.request_id)
        self.injector.hit(site, ids)

    def _queue_put(self, req: Request, item: int | None):
        """A client-visible emission: staged inside a tick and flushed only
        when it commits, so a rolled-back (retried or bisected) tick never
        leaks a token or a terminal None."""
        if self._staging is not None:
            self._staging.append((req.stream_queue, item))
        else:
            req.stream_queue.put(item)

    def _checkpoint(self) -> dict:
        """Snapshot every piece of host state a tick can mutate: row
        bookkeeping, the page allocator and prefix cache, the pending
        queue, the generator that seeds unseeded requests, the plan,
        metrics, histograms and the mutable fields of every request in
        flight or queued.  It holds no device tensor: K/V written past the
        committed ``row_lens`` is scratch (a retried tick writes the same
        slots with the same values), and the decode loops mutate the
        device row state in place, so a rollback marks it all stale and
        the next dispatch uploads it again from the restored host state.

        Two kinds of page hold committed K/V and may be written by the tick
        all the same: a page a row holds, once the row finishes mid-tick
        and another row takes the page, and a page only the prefix cache
        holds, once evicted and handed out.  The first kind is pinned (not
        handed out again before the commit); the second is dropped from
        the cache by the rollback."""
        reqs = [r for r in self.rows if r is not None] + list(self._pending)
        self.alloc.pin(int(p) for p in np.unique(self.tables)
                       if p > 0)
        return {
            "rows": list(self.rows),
            "row_lens": self.row_lens.copy(),
            "row_budget": self.row_budget.copy(),
            "toks": self.toks.copy(),
            "temps": self.temps.copy(),
            "top_ps": self.top_ps.copy(),
            "seeds": self.seeds.copy(),
            "top_ks": self.top_ks.copy(),
            "tables": self.tables.copy(),
            "prefilling": dict(self._prefilling),
            "row_keys": dict(self._row_keys),
            "pending": list(self._pending),
            "alloc": (list(self.alloc.free), self.alloc.ref.copy(),
                      OrderedDict(self.alloc.prefix),
                      dict(self.alloc._page_key),
                      self.alloc.prefix_evictions),
            # the seeds of unseeded requests admitted by a retried tick
            # are drawn again from the same state
            "gen": self._gen.get_state(),
            "plan": self._horizon,
            "metrics": dict(self.metrics),
            "ttfts": list(self._ttfts),
            "spec_window": list(self._spec_window),
            "hists": {k: h.snapshot() for k, h in self.hists.items()},
            "reqs": [(r, len(r.output_ids), len(r.logprobs),
                      r.finish_reason, r.first_token_s, r._last_tok_s)
                     for r in reqs],
        }

    def _rollback(self, snap: dict):
        """Restore the checkpoint: the tick never happened.  Staged
        emissions and spans are dropped (clients saw nothing), arrivals
        drained mid-tick go back to the pending queue, and the device row
        state and every table row are marked stale."""
        self._staging = None
        self._span_staging = []
        self.rows = list(snap["rows"])
        self.row_lens = snap["row_lens"].copy()
        self.row_budget = snap["row_budget"].copy()
        self.toks = snap["toks"].copy()
        self.temps = snap["temps"].copy()
        self.top_ps = snap["top_ps"].copy()
        self.seeds = snap["seeds"].copy()
        self.top_ks = snap["top_ks"].copy()
        self.tables = snap["tables"].copy()
        self._prefilling = dict(snap["prefilling"])
        self._row_keys = dict(snap["row_keys"])
        free, ref, prefix, pkey, evictions = snap["alloc"]
        # cached pages the tick evicted may have been handed out and
        # written: their keys are not restored, the pages go back free in
        # eviction order (after the free list), and the evictions stand
        gone = [(k, p) for k, p in prefix.items()
                if self.alloc.prefix.get(k) != p]
        self.alloc.free = [p for _, p in reversed(gone)] + list(free)
        self.alloc.ref = ref.copy()
        self.alloc.prefix = OrderedDict(prefix)
        self.alloc._page_key = dict(pkey)
        for k, p in gone:
            del self.alloc.prefix[k]
            del self.alloc._page_key[p]
            self.alloc.ref[p] = 0
        self.alloc.prefix_evictions = evictions + len(gone)
        self.alloc.pin(())
        self._gen.set_state(snap["gen"])
        self._horizon = snap["plan"]
        self._ttfts = deque(snap["ttfts"], maxlen=self._ttfts.maxlen)
        self._spec_window = deque(snap["spec_window"],
                                  maxlen=self._spec_window.maxlen)
        # metrics revert but for the counter submit() moves from other
        # threads (a refusal during the doomed tick really happened)
        m = dict(snap["metrics"])
        m["rejected"] = max(self.metrics.get("rejected", 0),
                            m.get("rejected", 0))
        self.metrics = m
        for k, h in self.hists.items():
            h.restore(snap["hists"][k])
        for r, n_out, n_lp, fin, fts, lts in snap["reqs"]:
            del r.output_ids[n_out:]
            del r.logprobs[n_lp:]
            r.finish_reason = fin
            r.first_token_s = fts
            r._last_tok_s = lts
        self._pending = deque(snap["pending"])
        for r in self._tick_arrivals:   # drained mid-tick: fresh again
            r.output_ids.clear()
            r.logprobs.clear()
            r.finish_reason = None
            r.first_token_s = 0.0
            r._last_tok_s = 0.0
            self._pending.append(r)
        self._tick_arrivals = []
        self._dev = None
        self._dirty = True
        self._dirty_tables = set(range(self.ec.max_rows))

    def _commit(self):
        """Flush the tick's staged emissions to the client queues in
        emission order, and its spans to the tracer: the only point a
        tick's output becomes visible."""
        staged, self._staging = self._staging, None
        staged_spans, self._span_staging = self._span_staging, []
        self._tick_arrivals = []
        self.alloc.unpin()
        for q, item in staged:
            q.put(item)
        if self.tracer is not None:
            for tid, s in staged_spans:
                self.tracer.add(tid, s)
        self.metrics["queue_depth"] = self.queue_depth

    @torch.no_grad()
    def _tick(self) -> bool:
        """One transactional tick, the one the engine thread runs: plan,
        checkpoint, run the scheduler (:meth:`_step`), commit; on an
        exception, roll back (clients saw nothing) and recover
        (:meth:`_recover`).  Then count the tick, record it in the flight
        recorder and publish the histograms.  Returns True when the tick
        committed.

        Every tick that decodes ends in a blocking read of its results
        before it can commit, so a fault its kernels raise on the device
        is charged to it.  A tick that only prefills (no row decoding, no
        prompt completing) reads nothing back; a fault of its kernels
        surfaces at the next tick's read.  The faults that surface late
        are CUDA context errors, sticky (``faults.is_transient``), which
        fail every request whichever tick they are charged to."""
        shed = self._drain_abort.is_set()
        if self.tp is not None:     # rank 0's word, on every rank
            try:
                msg = self._tp_exchange()
            except CollectiveError as exc:
                self._tp_end(exc)
                return False
            if msg is None:
                return False
            shed = msg["shed"]
        if shed:
            self._shed_remaining()
            self._drain_abort.clear()
        # planned before the checkpoint, so that a retry and every probe
        # replay the failed tick's plan instead of re-planning against the
        # queue as the fault left it
        if self._retries == 0:
            self._horizon = self._plan_horizon()
        snap = self._checkpoint()
        self._staging = []
        self._span_staging = []
        self._tick_arrivals = []
        self._tick_dispatches = 0
        t_wall = time.time()
        err = None
        try:
            self._step()
        except Exception as exc:  # noqa: BLE001 -- the tick's fault domain
            err = exc
        if self.tp is not None:
            err = self._tp_agree(err)
        if err is not None:
            self._rollback(snap)
            self._recover(err)
            return False
        self._commit()
        self._retries = 0
        # after the commit: a rolled-back tick never moves the liveness
        # counter, so `ticks` moves only while the engine makes progress
        self.metrics["ticks"] += 1
        self._flight_record(snap, t_wall)
        m0 = snap["metrics"]
        if self.metrics["tokens"] != m0["tokens"] or \
                self.metrics["host_syncs"] != m0["host_syncs"]:
            self._hists_published = {k: h.copy()
                                     for k, h in self.hists.items()}
        return True

    def _recover(self, exc: BaseException):
        """After the rollback: a transient fault backs off exponentially
        and lets the loop run the tick again from the committed state
        (bitwise the same tick).  Exhausted retries or a deterministic
        fault bisect the tick's requests and quarantine the culprit; a
        fault bisection cannot place on a request, and a sticky CUDA
        context error (``faults.is_sticky``: no request is its culprit,
        and a probe with every request masked runs no kernel, so
        bisection would quarantine each in turn), reach ``_fail_all``.
        After a sticky error the context is dead, so the engine loop ends
        there: the thread stops, ``/health`` answers 503 "dead", and a
        later request fails at once (``next_stream_item``)."""
        if is_transient(exc) and self._retries < self.ec.max_step_retries:
            self._retries += 1
            self.metrics["retries"] += 1
            if self.tracer is not None:
                # after the rollback, so these land directly
                for req in [r for r in self.rows if r is not None] + \
                        list(self._pending):
                    self._trace(req, "retry", attempt=self._retries,
                                error=f"{type(exc).__name__}: {exc}")
            self._stop.wait(
                self.ec.retry_backoff_s * (2 ** (self._retries - 1)))
            return
        self._retries = 0
        if isinstance(exc, CollectiveError):
            self._tp_end(exc)
            return
        if is_sticky(exc):
            self._fail_all(exc)
            self._stop.set()
            return
        culprit = self._bisect_culprit()
        if culprit is _FAULT_VANISHED:
            # it did not reproduce: carry on from the committed state
            self.metrics["last_error"] = f"{type(exc).__name__}: {exc}"
            return
        if culprit is None:
            self._fail_all(exc)
            return
        self._quarantine(culprit, exc)

    def _probe(self, masked_ids: set) -> BaseException | None:
        """Run the tick again with ``masked_ids`` sat out (skipped by
        admission and prefill, inactive on the device), emissions muted and
        everything rolled back afterwards: a probe only observes whether
        the fault fires."""
        snap = self._checkpoint()
        self._staging = []
        self._span_staging = []
        self._tick_arrivals = []
        self._masked = set(masked_ids)
        self._dirty = True   # the active mask differs from the device's
        try:
            self._step()
            return None
        except CollectiveError:
            raise           # a broken group is no probe's answer
        except Exception as e:  # noqa: BLE001 -- what the probe observes
            return e
        finally:
            self._masked = set()
            self._rollback(snap)

    def _bisect_culprit(self):
        """Place a deterministic fault on one request by running the tick
        with halves of the suspects masked.  Returns the culprit, None when
        the fault fires with every suspect masked (engine-level), or
        ``_FAULT_VANISHED`` when it does not reproduce."""
        suspects = [r for r in self.rows if r is not None]
        suspects += [r for r in self._pending if r not in suspects]
        if not suspects:
            return None
        if self._probe(set()) is None:
            return _FAULT_VANISHED
        all_ids = {r.request_id for r in suspects}
        if self._probe(all_ids) is not None:
            return None
        cands = suspects
        while len(cands) > 1:
            half = cands[:len(cands) // 2]
            if self._probe({r.request_id for r in half}) is None:
                cands = half            # silenced: the culprit is masked
            else:
                cands = cands[len(cands) // 2:]
        culprit = cands[0]
        # confirm with the culprit alone taking part, so that a fault that
        # stopped firing mid-bisection quarantines no innocent request
        if self._probe(all_ids - {culprit.request_id}) is None:
            return _FAULT_VANISHED
        return culprit

    def _quarantine(self, req: Request, exc: BaseException):
        """Finish the culprit alone with ``finish_reason="error"``, whether
        it holds a row (its pages go back) or waits in the queue, after
        freezing the flight ring with the evidence.  The next tick runs
        without it, so the survivors' streams are the unfaulted run's."""
        err = f"{type(exc).__name__}: {exc}"
        self.metrics["errors_isolated"] += 1
        self.metrics["last_error"] = (
            f"isolated to request {req.request_id[:12]}: {err}")
        self.flight.dump("quarantine", request_id=req.request_id,
                         error=err,
                         **{f"{k}_pending": v for k, v
                            in self._flight_pending().items() if v})
        self._trace(req, "quarantine", error=err)
        for i, r in enumerate(self.rows):
            if r is req:
                self._finish(i, "error")
                return
        try:
            self._pending.remove(req)
        except ValueError:
            pass
        if req.finish_reason is None:
            req.finish_reason = "error"
        self._queue_put(req, None)

    def _h2d(self, a, dtype=None) -> torch.Tensor:
        """Upload a host array: ``torch.tensor`` copies, so the device
        tensor never aliases a numpy buffer the engine mutates later."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- page bookkeeping ---------------------------------------------------

    def _ensure_pages(self, row: int, upto_slot: int,
                      req: Request | None = None) -> bool:
        """Allocate pages so slots [0, upto_slot) are backed; False = dry.
        Slots past the table width are right-padded prefill slack, which
        update_layer routes to the scratch page.  ``req`` names an
        admission's request, which holds no row yet."""
        self._fault_point("page-alloc", rows=(row,), reqs=(req,))
        need = min(-(-upto_slot // self.ec.page_size), self.ec.max_pages)
        for j in range(need):
            if self.tables[row, j] < 0:
                pid = self.alloc.alloc()
                if pid is None:
                    self.metrics["alloc_fail_clamps"] += 1
                    return False
                self.tables[row, j] = pid
                self._dirty_tables.add(row)
        return True

    def _release_row_pages(self, row: int):
        for j in range(self.ec.max_pages):
            pid = int(self.tables[row, j])
            if pid >= 0:
                self.alloc.decref(pid)
                self.tables[row, j] = -1
                self._dirty_tables.add(row)

    # -- device state -------------------------------------------------------

    def _active_mask(self) -> np.ndarray:
        """Rows decoding: occupied, past prefill and not masked by a
        bisection probe (a masked row goes inactive on the device, so it
        takes no part in the tick)."""
        return np.array([r is not None and i not in self._prefilling
                         and r.request_id not in self._masked
                         for i, r in enumerate(self.rows)], bool)

    def _upload_row_state(self):
        rows = self.rows
        steps = np.asarray([len(r.output_ids) if r is not None else 0
                            for r in rows], np.int32)
        remain = np.asarray([int(self.row_budget[i]) - len(r.output_ids)
                             if r is not None else 0
                             for i, r in enumerate(rows)], np.int32)
        # per-row EOS ids, -1-padded to a power-of-two width
        e_w = max([1] + [len(r.eos_token_id) for r in rows if r is not None])
        e_w = 1 << (e_w - 1).bit_length()
        eos = np.full((len(rows), e_w), -1, np.int32)
        for i, r in enumerate(rows):
            if r is not None and r.eos_token_id:
                eos[i, :len(r.eos_token_id)] = list(r.eos_token_id)
        self._dev = {
            "toks": self._h2d(self.toks), "row_lens": self._h2d(self.row_lens),
            "active": self._h2d(self._active_mask()),
            "temps": self._h2d(self.temps), "top_ps": self._h2d(self.top_ps),
            "seeds": self._h2d(self.seeds), "top_ks": self._h2d(self.top_ks),
            "steps": self._h2d(steps), "remain": self._h2d(remain),
            "eos": self._h2d(eos),
        }
        if self._fused_spec:
            # the token history the device proposer scans: the whole prompt
            # lands at admission (so a mid-prefill row needs no per-chunk
            # write), emitted tokens are appended on the device, and each
            # epoch rebuilds it from the host's ids.  spec_k + 1 columns
            # past max_seq_len take a verify window's writes at any length
            hist = np.zeros((len(rows), self.ec.max_seq_len + self.ec.spec_k
                             + 1), np.int32)
            for i, r in enumerate(rows):
                if r is not None:
                    ids = list(r.prompt_ids) + list(r.output_ids)
                    hist[i, :len(ids)] = ids
            self._dev["hist"] = self._h2d(hist)
        self._flush_dirty_tables()
        self._dirty = False

    def _flush_dirty_tables(self) -> PagedKVCache:
        """Scatter only the block-table rows changed since the last device
        call into the resident tables."""
        if self._dirty_tables:
            rows = np.array(sorted(self._dirty_tables), np.int64)
            self.cache.with_table_rows(self._h2d(rows),
                                       self._h2d(self.tables[rows]))
            self.metrics["table_row_syncs"] += 1
            self._dirty_tables.clear()
        return self.cache

    def _sync_device_state(self) -> dict:
        if self._dirty or self._dev is None:
            self.metrics["epoch_syncs"] += 1
            self._upload_row_state()
        else:
            self._flush_dirty_tables()
        return self._dev

    # -- engine loop --------------------------------------------------------

    def _loop(self):
        while not self._stop.is_set():
            try:
                committed = self._tick()
                # a committed tick: the engine recovered, so /health goes
                # back to "ok" (an isolation stays in errors_isolated)
                if committed and self.metrics.get("last_error"):
                    self.metrics["last_error"] = ""
            except Exception as exc:  # noqa: BLE001 -- recovery failed
                self._fail_all(exc)
                if is_sticky(exc):
                    self._stop.set()
        if self.tp is not None and self.tp.leader and not self._tp_dead:
            try:    # the followers' last tick message: stop
                self._tp_exchange()
            except CollectiveError:
                pass

    def _tp_end(self, exc: BaseException):
        """A broken group (a collective failed or timed out): fail every
        request and end this rank's engine; no further message is sent."""
        self._tp_dead = True
        self._fail_all(exc)
        self._stop.set()

    def _fail_all(self, exc: BaseException):
        """The engine-level backstop, reached only when bisection cannot
        place a fault on a request or the recovery itself failed: finish
        every in-flight and queued request with 'error' so no client
        blocks forever, record the error, and keep serving.  The flight
        recorder's ring is frozen first, as the failure's evidence."""
        self._staging = None    # emissions land directly from here on
        self._span_staging = []
        self._tick_arrivals = []
        self._masked = set()
        self.flight.dump("fail_all", error=f"{type(exc).__name__}: {exc}",
                         **{f"{k}_pending": v for k, v
                            in self._flight_pending().items() if v})
        for i, req in enumerate(self.rows):
            if req is not None:
                self._finish(i, "error")
        self._drain_inbox()
        while self._pending:
            req = self._pending.popleft()
            req.finish_reason = req.finish_reason or "error"
            self._queue_put(req, None)
        self._dev = None
        self.metrics["errors"] = self.metrics.get("errors", 0) + 1
        self.metrics["last_error"] = f"{type(exc).__name__}: {exc}"
        self.metrics["queue_depth"] = self.queue_depth

    def _free_row(self) -> int | None:
        for i, r in enumerate(self.rows):
            if r is None:
                return i
        return None

    def _drain_inbox(self):
        """Move submissions into the pending queue; inside a tick, note
        them, so that a rollback puts them back instead of losing them
        (the inbox itself is never rolled back)."""
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                return
            self._pending.append(req)
            if self._staging is not None:
                self._tick_arrivals.append(req)

    def _pop_pending(self) -> Request | None:
        """The head of the pending queue, skipping requests a bisection
        probe masks (they stay queued, in order)."""
        for i, req in enumerate(self._pending):
            if req.request_id not in self._masked:
                del self._pending[i]
                return req
        return None

    def _plan_horizon(self) -> int:
        """The static planner's horizon, from pre-tick state: 1 while
        streams are joining (rows mid-prefill, or queued work a free row
        could take), so a joining row never waits out a horizon."""
        queued = bool(self._pending) or (self.tp is None
                                         and not self._inbox.empty())
        joining = bool(self._prefilling) or (
            queued and self._free_row() is not None)
        return 1 if joining else self.ec.decode_horizon

    def _step(self):
        """The scheduler: expire deadlines at the tick boundary, admit,
        then run one tick shape at the planned horizon.  Under tp the
        arrivals came with the tick message."""
        if self.tp is None:
            self._drain_inbox()
        self._expire_deadlines()
        self.metrics["queue_depth"] = self.queue_depth
        self._admit()
        for i, req in enumerate(self.rows):  # drop disconnected clients
            if req is not None and self._cancelled(req):
                self._finish(i, "abort")
        if self._prefilling and self._mixed_mode:
            self._mixed_step()
            return
        self._prefill_one_chunk()
        active = self._active_mask()
        if not active.any():
            if not self._prefilling:
                self._wait_for_work()
            return
        if self.ec.spec_k > 0 and not self._fused_spec:
            self._spec_step(active)
            return
        self._horizon_step(active)

    def _wait_for_work(self, timeout: float = 0.02):
        if self._inbox.empty():
            self._work.wait(timeout)
        self._work.clear()

    def _admit(self):
        """Join pending requests into free rows: prefix matching and page
        allocation on the host; the prompt runs chunk-wise later."""
        ps = self.ec.page_size
        while True:
            row = self._free_row()
            if row is None:
                return
            req = self._pop_pending()
            if req is None:
                return
            if self._cancelled(req):
                req.finish_reason = "abort"
                self._queue_put(req, None)
                continue
            prompt = np.asarray(req.prompt_ids, np.int32)
            n_p = len(prompt)
            capacity = min(self.ec.max_seq_len, self.ec.max_pages * ps,
                           (self.ec.n_pages - 1) * ps)
            if n_p + req.max_new_tokens > capacity or n_p == 0:
                req.finish_reason = "length"
                self._queue_put(req, None)
                continue
            # reuse the longest chain of cached full pages covering at most
            # the first n_p - 1 tokens (one token must run for logits)
            keys = _chain_hashes(prompt, ps)
            shared = 0
            for key in keys[:(n_p - 1) // ps]:
                pid = self.alloc.lookup_prefix(key)
                if pid is None:
                    break
                self.alloc.addref(pid)
                self.tables[row, shared] = pid
                self._dirty_tables.add(row)
                shared += 1
            if not self._ensure_pages(row, n_p, req=req):
                self._release_row_pages(row)
                if any(r is not None for r in self.rows):
                    self._pending.appendleft(req)   # retry at the head
                else:
                    req.finish_reason = "length"    # it will never fit
                    self._queue_put(req, None)
                return
            if shared:
                self.metrics["prefix_hits"] += 1
                self.metrics["prefix_pages_shared"] += shared
            if self.tracer is not None:
                # the queue wait, its start rebuilt from submit()'s stamp
                now_w = time.time()
                waited = time.perf_counter() - req.submitted_s
                self._trace(req, "queue", t0=now_w - waited, t1=now_w,
                            queue_depth=self.queue_depth,
                            prompt_tokens=n_p, shared_pages=shared)
            base = shared * ps
            self.rows[row] = req
            self.row_lens[row] = base
            self.row_budget[row] = req.max_new_tokens
            self.temps[row] = req.temperature
            self.top_ps[row] = req.top_p
            self.top_ks[row] = max(0, int(req.top_k or 0))
            self.seeds[row] = (int(req.seed) if req.seed is not None else
                               int(torch.randint(0, 2 ** 31 - 1, (1,),
                                                 generator=self._gen)))
            self._prefilling[row] = prompt[base:]
            self._row_keys[row] = keys
            self.metrics["requests"] += 1
            self._dirty = True

    def _prefill_one_chunk(self):
        """Sequential engine: advance ONE prefilling row by one chunk and,
        when its prompt completes, sample its first token."""
        # the first prefilling row a bisection probe does not mask
        row = next((r for r in self._prefilling
                    if self.rows[r].request_id not in self._masked), None)
        if row is None:
            return
        req = self.rows[row]
        remaining = self._prefilling[row]
        cp = self.ec.prefill_bucket
        chunk = remaining[:cp]
        n_valid = len(chunk)
        base = int(self.row_lens[row])
        if not self._ensure_pages(row, base + n_valid):
            self._finish(row, "error")  # pool exhausted mid-prefill
            return
        toks = np.zeros((1, cp), np.int32)
        toks[0, :n_valid] = chunk
        self._fault_point("prefill-chunk", rows=(row,))
        cache = self._flush_dirty_tables()
        pos = np.arange(base, base + cp, dtype=np.int32)[None, :]
        t0_w = time.time()
        self._tick_dispatches += 1
        logits, _ = decoder_forward(
            self._fwd_cfg, self.params, self._h2d(toks),
            cache.with_tables(cache.tables[row:row + 1]), self._h2d(pos),
            slot_offsets=self._h2d([base], torch.int32),
            gather_positions=self._h2d([n_valid - 1], torch.int32),
            chunk_lens=self._h2d([n_valid], torch.int32), tp=self.tp)
        self.row_lens[row] = base + n_valid
        self._trace(req, "prefill_chunk", t0=t0_w, t1=time.time(),
                    tokens=n_valid, base=base)
        self._dirty = True
        if n_valid < len(remaining):
            self._prefilling[row] = remaining[n_valid:]
            return
        self._prefilling.pop(row)
        first_t, first_lp = sample_rows_with_logprobs(
            logits, self._h2d(self.temps[row:row + 1]),
            self._h2d(self.top_ps[row:row + 1]),
            self._h2d(self.seeds[row:row + 1]),
            self._h2d([0], torch.int32),
            top_ks=self._h2d(self.top_ks[row:row + 1]))
        self._fault_point("sample", rows=(row,))
        t0 = time.perf_counter()
        first, lp = int(first_t.cpu()[0]), float(first_lp.cpu()[0])
        self._count_sync(time.perf_counter() - t0)
        self._finish_prompt(row, first, lp)

    def _finish_prompt(self, row: int, first: int, logprob: float):
        """Prompt completion, shared by both admission paths: register the
        prompt's full pages in the prefix cache, record TTFT, emit."""
        n_p = int(self.row_lens[row])
        keys = self._row_keys.pop(row, [])
        for j in range(min(len(keys), (n_p - 1) // self.ec.page_size)):
            self.alloc.register_prefix(keys[j], int(self.tables[row, j]))
        req = self.rows[row]
        req.first_token_s = time.perf_counter() - req.submitted_s
        self._record_ttft(req.first_token_s)
        self._trace(req, "first_token", ttft_s=round(req.first_token_s, 6))
        self.toks[row] = first
        self._emit(row, first, logprob)

    def _record_ttft(self, seconds: float):
        """TTFT into its histogram and the rolling p95 of /health (the
        last 128 requests)."""
        self._ttfts.append(seconds)
        self.hists["ttft_s"].observe(seconds)
        self.metrics["ttft_p95_s"] = round(
            float(np.percentile(np.fromiter(self._ttfts, np.float64), 95)),
            4)

    def _emit(self, row: int, token: int, logprob: float = 0.0):
        req = self.rows[row]
        if self._cancelled(req):
            self._finish(row, "abort")
            return
        req.output_ids.append(token)
        req.logprobs.append(logprob)
        # client-visible inter-token latency (the first token is TTFT's)
        now = time.perf_counter()
        if req._last_tok_s:
            self.hists["token_latency_s"].observe(now - req._last_tok_s)
        req._last_tok_s = now
        self._queue_put(req, token)
        self.metrics["tokens"] += 1
        if token in req.eos_token_id:
            self._finish(row, "stop")
        elif len(req.output_ids) >= self.row_budget[row]:
            self._finish(row, "length")

    def _finish(self, row: int, reason: str):
        req = self.rows[row]
        if req.finish_reason is None:
            req.finish_reason = reason
        self._trace(req, "finish", reason=req.finish_reason,
                    output_tokens=len(req.output_ids))
        self._queue_put(req, None)
        self.rows[row] = None
        self.row_lens[row] = 0
        self.toks[row] = 0
        self._prefilling.pop(row, None)
        self._row_keys.pop(row, None)
        self._release_row_pages(row)
        self._dirty = True

    def _mixed_step(self):
        """One admission-wave tick: a ragged chunk for every prefilling
        row, on-device first-token sampling and merge for the prompts that
        complete, and one decode step for every decoding row.  Rows a
        bisection probe masks sit the tick out."""
        rows = sorted(r for r in self._prefilling
                      if self.rows[r].request_id not in self._masked)
        if not rows:
            active = self._active_mask()
            if active.any():
                self._horizon_step(active)
            return
        # per-row chunk width: the budget fair-shares across joining rows,
        # power-of-two floor, at least 4, at most the prefill bucket
        share = max(1, self._step_budget // len(rows))
        width = min(max(1 << (share.bit_length() - 1), 4),
                    self.ec.prefill_bucket)
        chunks: list[tuple[int, int, int]] = []   # (row, n_i, base)
        for row in rows:
            rem = self._prefilling[row]
            n_i = min(len(rem), width)
            b = int(self.row_lens[row])
            if not self._ensure_pages(row, b + n_i):
                self._finish(row, "error")  # pool exhausted mid-prefill
                continue
            chunks.append((row, n_i, b))
        if not chunks:
            active = self._active_mask()
            if active.any():
                self._horizon_step(active)
            return
        emit = [n_i == len(self._prefilling[row]) for row, n_i, _ in chunks]
        # a completing row's first decode step runs inside this tick and
        # writes KV at slot b + n_i: back it now (after every row's chunk
        # pages, so the extra page never starves a later row's chunk).  A
        # speculating row reserves its verify window, min(k + 1, budget
        # after the first token) slots, and drops to a plain step when the
        # pool backs only one
        spec_ks = (np.zeros((len(self.rows),), np.int32)
                   if self._fused_spec else None)
        canjoin = []
        for (row, n_i, b), e in zip(chunks, emit):
            if not e:
                canjoin.append(True)
                continue
            req = self.rows[row]
            k_i = self._row_spec_k(req) if spec_ks is not None else 0
            want = max(min(k_i + 1, req.max_new_tokens - 1), 1)
            ok = self._ensure_pages(row, b + n_i + want)
            if not ok and k_i:
                k_i = 0
                ok = self._ensure_pages(row, b + n_i + 1)
            if spec_ks is not None:
                spec_ks[row] = k_i
            canjoin.append(ok)
        # decoding rows need their next KV slot (a speculating row its
        # verify window) backed before the tick
        active = self._active_mask()
        for i in np.flatnonzero(active):
            i = int(i)
            k_i = self._row_spec_k(self.rows[i]) if spec_ks is not None else 0
            rem_i = int(self.row_budget[i]) - len(self.rows[i].output_ids)
            lens = int(self.row_lens[i])
            if not self._ensure_pages(i, lens + max(min(k_i + 1, rem_i), 1)):
                if k_i and self._ensure_pages(i, lens + 1):
                    k_i = 0
                else:
                    self._finish(i, "length")
                    active[i] = False
                    continue
            if spec_ks is not None:
                spec_ks[i] = k_i
        with_decode = bool(active.any() or any(emit))
        self._fault_point("mixed-step", rows=[row for row, _, _ in chunks])
        # the decode participants: rows decoding and completions that join
        # the decode this tick, so that a request's fault at this site
        # fires on the tick its first token would commit
        decode_rows = list(np.flatnonzero(active)) + [
            row for (row, _, _), e, ok in zip(chunks, emit, canjoin)
            if e and ok]
        if with_decode and decode_rows:
            self._fault_point("decode-dispatch", rows=decode_rows)
        p = len(chunks)
        toks = np.zeros((p, width), np.int32)
        for s, (row, n_i, _) in enumerate(chunks):
            toks[s, :n_i] = self._prefilling[row][:n_i]
        cache = self._flush_dirty_tables()
        rowmap = self._h2d([row for row, _, _ in chunks], torch.int64)
        dev = self._sync_device_state()
        prefill = (self._h2d(toks), cache.tables[rowmap],
                   self._h2d([b for _, _, b in chunks], torch.int32),
                   self._h2d([n for _, n, _ in chunks], torch.int32),
                   self._h2d(emit, torch.bool), self._h2d(canjoin, torch.bool),
                   rowmap)
        # a pure-chunk tick (with_decode False) emits nothing, so it runs
        # without speculation
        spec = spec_ks is not None and with_decode
        t0_w = time.time()
        self._tick_dispatches += 1
        (first_t, first_lp, tok_block, lp_block, executed, take_block, prop,
         acc) = tick_body(
            self._fwd_cfg, self.params, self.cache, dev, prefill=prefill,
            horizon=1, with_decode=with_decode,
            spec_ks=self._h2d(spec_ks) if spec else None,
            spec_k=self.ec.spec_k if spec else 0,
            spec_ngram=self.ec.spec_ngram, tp=self.tp)
        completing: list[tuple[int, int]] = []   # (slot, row)
        t1_w = time.time()
        for s, (row, n_i, b) in enumerate(chunks):
            self.row_lens[row] += n_i
            self._trace(self.rows[row], "prefill_chunk", t0=t0_w, t1=t1_w,
                        tokens=n_i, base=b, fused=True)
            if emit[s]:
                self._prefilling.pop(row)
                completing.append((s, row))
            else:
                self._prefilling[row] = self._prefilling[row][n_i:]
        m = self.metrics
        m["mixed_steps"] += 1
        m["mixed_prefill_tokens"] += sum(n for _, n, _ in chunks)
        m["prefill_tokens_per_step"] = round(
            m["mixed_prefill_tokens"] / m["mixed_steps"], 2)
        m["pages_in_use"] = self.alloc.pages_in_use
        if not with_decode:
            return      # pure-chunk tick: nothing to read back
        if completing:
            self._dirty = True
            self._fault_point("sample", rows=[row for _, row in completing])
        t0 = time.perf_counter()
        if completing:
            nxt, lp = first_t.cpu().numpy(), first_lp.cpu().numpy()
        tok_np, lp_np = tok_block.cpu().numpy(), lp_block.cpu().numpy()
        self._count_syncs(executed, 1, time.perf_counter() - t0)
        for s, row in completing:
            self._finish_prompt(row, int(nxt[s]), float(lp[s]))
            if not canjoin[s] and self.rows[row] is not None:
                self._finish(row, "length")  # no KV slot for its decode
        m["steps"] += executed
        m["decode_horizon_effective"] = 1
        mask = self._active_mask()
        parts = self._decode_parts(mask)
        if take_block is not None:
            take_np = take_block.cpu().numpy()
            self._spec_metrics(take_np, int(prop), int(acc), executed)
            self._drain_spec_block(tok_np, lp_np, take_np, mask, executed)
        else:
            take_np = None
            self._drain_block(tok_np, lp_np, mask, executed)
        self._trace_decode(parts, t0_w, executed, take_np)
        m["tokens_per_sync"] = round(m["tokens"] / m["host_syncs"], 2)

    def _horizon_step(self, active: np.ndarray):
        """Up to ``decode_horizon`` decode steps (with speculation, verify
        rounds), drained token by token through ``_emit`` exactly as
        one-step ticks are."""
        horizon = h = self._horizon
        spec_ks = self._spec_widths(active) if self._fused_spec else None
        for i in np.flatnonzero(active):
            i = int(i)
            lens = int(self.row_lens[i])
            # a near-finished row reserves only what its budget can write; a
            # speculating row min(H * (k + 1), budget) slots, and under pool
            # pressure it takes plain steps before the horizon is clamped
            rem_i = int(self.row_budget[i]) - len(self.rows[i].output_ids)
            k_i = int(spec_ks[i]) if spec_ks is not None else 0
            if self._ensure_pages(i, lens + max(min(horizon * (k_i + 1),
                                                    rem_i), 1)):
                continue
            if k_i:
                spec_ks[i] = 0
                if self._ensure_pages(i, lens + max(min(horizon, rem_i), 1)):
                    continue
            backed = int((self.tables[i] >= 0).sum()) * self.ec.page_size \
                - lens
            if backed < 1:
                self._finish(i, "length")
                active[i] = False
            else:
                h = min(h, backed)
        if not active.any():
            return
        if h < horizon:
            h = 1 << (h.bit_length() - 1)      # largest power of two <= h
            self.metrics["horizon_clamped"] = (
                self.metrics.get("horizon_clamped", 0) + 1)
        self._fault_point("decode-dispatch",
                          rows=[int(i) for i in np.flatnonzero(active)])
        dev = self._sync_device_state()
        t0_w = time.time()
        self._tick_dispatches += 1
        _, _, tok_block, lp_block, executed, take_block, prop, acc = \
            tick_body(self._fwd_cfg, self.params, self.cache, dev,
                      horizon=h,
                      spec_ks=(self._h2d(spec_ks) if spec_ks is not None
                               else None),
                      spec_k=self.ec.spec_k if spec_ks is not None else 0,
                      spec_ngram=self.ec.spec_ngram, tp=self.tp)
        t0 = time.perf_counter()
        tok_np, lp_np = tok_block.cpu().numpy(), lp_block.cpu().numpy()
        self._count_syncs(executed, h, time.perf_counter() - t0)
        m = self.metrics
        m["steps"] += executed
        m["decode_horizon_effective"] = h
        m["pages_in_use"] = self.alloc.pages_in_use
        parts = self._decode_parts(active)
        if take_block is not None:
            take_np = take_block.cpu().numpy()
            self._spec_metrics(take_np, int(prop), int(acc), executed)
            self._drain_spec_block(tok_np, lp_np, take_np, active, executed)
        else:
            take_np = None
            self._drain_block(tok_np, lp_np, active, executed)
        self._trace_decode(parts, t0_w, executed, take_np)
        m["tokens_per_sync"] = round(m["tokens"] / m["host_syncs"], 2)

    def _count_sync(self, seconds: float):
        """One block read of a tick's results and the seconds it blocked
        (timed around the read the tick makes anyway)."""
        self.metrics["host_syncs"] += 1
        self.hists["tick_sync_s"].observe(seconds)
        self.metrics["host_sync_s"] = round(
            self.metrics["host_sync_s"] + seconds, 6)

    def _count_syncs(self, executed: int, horizon: int, seconds: float):
        """The tick's block read, and the loop's liveness reads: one per
        iteration, plus the one that found every row dead before
        ``horizon``."""
        self._count_sync(seconds)
        self.metrics["liveness_syncs"] += executed + (executed < horizon)

    def _drain_block(self, tok_block, lp_block, active: np.ndarray, h: int):
        """Walk an [R, h] token/logprob block through the per-token
        emission path; the host stops a row at its EOS/budget/abort
        boundary, the same boundary the device masked at."""
        for i in np.flatnonzero(active):
            i = int(i)
            if self.rows[i] is None:
                continue
            for j in range(h):
                self.row_lens[i] += 1
                tok = int(tok_block[i, j])
                self.toks[i] = tok
                self._emit(i, tok, float(lp_block[i, j]))
                if self.rows[i] is None:   # finished mid-block
                    break

    # -- speculative decoding ----------------------------------------------

    def _row_spec_k(self, req: Request) -> int:
        """A request's draft width: the engine's spec_k, capped by
        ``Request.spec_k``, 0 when it opted out (``speculative=False``).
        (The reference also caps it by the planner's plan; the port has no
        planner, so that cap is spec_k itself.)"""
        if req.speculative is False:
            return 0
        return (self.ec.spec_k if req.spec_k is None
                else max(0, min(int(req.spec_k), self.ec.spec_k)))

    def _spec_widths(self, active: np.ndarray) -> np.ndarray:
        """Per-row draft widths of a fused spec tick, uploaded as a tensor
        so that one code path serves every opt-out mix."""
        ks = np.zeros((len(self.rows),), np.int32)
        for i in np.flatnonzero(active):
            ks[i] = self._row_spec_k(self.rows[i])
        return ks

    def _spec_metrics(self, take_block: np.ndarray, prop: int, acc: int,
                      executed: int):
        """Accounting of a tick's verify rounds (one loop iteration is one
        round): tokens emitted, row-rounds that emitted, the accept rate
        over them, drafts proposed and accepted, and the rolling window."""
        m = self.metrics
        k1 = self.ec.spec_k + 1
        m["spec_steps"] += executed
        m["spec_ticks"] += 1
        m["spec_emitted"] += int(take_block.sum())
        m["spec_row_steps"] += int((take_block > 0).sum())
        m["spec_accept_rate"] = round(
            m["spec_emitted"] / (k1 * max(m["spec_row_steps"], 1)), 4)
        m["draft_proposed"] += prop
        m["draft_accepted"] += acc
        m["spec_tokens_per_dispatch"] = round(
            m["spec_emitted"] / max(m["spec_ticks"], 1), 2)
        self._spec_window.append((prop, acc))

    def _drain_spec_block(self, tok_block, lp_block, take_block,
                          active: np.ndarray, h: int):
        """Walk an [R, h, K1] spec block through the per-token emission
        path: round j of row i emitted ``take_block[i, j]`` tokens, cut on
        the device at the EOS or budget boundary that ``_emit`` stops at."""
        for i in np.flatnonzero(active):
            i = int(i)
            for j in range(h):
                if self.rows[i] is None:   # finished mid-run
                    break
                for t in range(int(take_block[i, j])):
                    self.row_lens[i] += 1
                    tok = int(tok_block[i, j, t])
                    self.toks[i] = tok
                    self._emit(i, tok, float(lp_block[i, j, t]))
                    if self.rows[i] is None:
                        break

    def _spec_step(self, active: np.ndarray):
        """One verify round over the active rows with drafts from the host
        proposer and the acceptance chain walked on the host (the
        sequential engine's speculative step, port of ``_spec_step`` and
        ``_verify_step``): the oracle the fused tick is held against.  A
        row the pool cannot back ``spec_k + 1`` slots for takes a plain
        step through the same wide forward."""
        k = self.ec.spec_k
        k1 = k + 1
        r = len(self.rows)
        no_spec = np.zeros((r,), bool)
        for i in np.flatnonzero(active):
            i = int(i)
            lens = int(self.row_lens[i])
            if not self._ensure_pages(i, lens + k1):
                if self._ensure_pages(i, lens + 1):
                    no_spec[i] = True
                else:
                    self._finish(i, "length")
                    active[i] = False
        if not active.any():
            return
        drafts = np.zeros((r, k), np.int32)
        n_prop = np.zeros((r,), np.int32)
        for i in np.flatnonzero(active):
            req = self.rows[i]
            k_req = 0 if no_spec[i] else self._row_spec_k(req)
            if k_req == 0:
                continue
            d = _propose_ngram(np.asarray(list(req.prompt_ids)
                                          + list(req.output_ids), np.int32),
                               k_req, self.ec.spec_ngram)
            valid = d >= 0
            n_prop[i] = k_req if valid.all() else int(valid.argmin())
            drafts[i, :k_req] = np.where(valid, d, 0)
        self._fault_point("decode-dispatch",
                          rows=[int(i) for i in np.flatnonzero(active)])
        cache = self._flush_dirty_tables()
        sentinel = self.ec.max_pages * self.ec.page_size
        write_at = np.where(active, self.row_lens, sentinel).astype(np.int32)
        steps = np.asarray([len(q.output_ids) if q is not None else 0
                            for q in self.rows], np.int32)
        tokens = np.concatenate([self.toks[:, None], drafts], axis=1)
        pos = write_at[:, None] + np.arange(k1, dtype=np.int32)[None, :]
        t0_w = time.time()
        self._tick_dispatches += 1
        logits, _ = decoder_forward(
            self._fwd_cfg, self.params, self._h2d(tokens), cache,
            self._h2d(pos), slot_offsets=self._h2d(write_at),
            chunk_lens=self._h2d(active.astype(np.int32) * k1), tp=self.tp)
        t_all, lp_all = sample_verify_positions(
            logits, self._h2d(active), self._h2d(self.temps),
            self._h2d(self.top_ps), self._h2d(self.seeds), self._h2d(steps),
            self._h2d(self.top_ks))
        t0 = time.perf_counter()
        t_all, lp_all = t_all.cpu().numpy(), lp_all.cpu().numpy()
        self._count_sync(time.perf_counter() - t0)
        self.metrics["steps"] += 1
        self._dirty = True      # the host walked the chains: state diverges
        take = np.zeros((r, 1), np.int32)
        for i in np.flatnonzero(active):
            i = int(i)
            emitted = [(int(t_all[i, 0]), float(lp_all[i, 0]))]
            for j in range(int(n_prop[i])):
                # position j+1 samples the true conditional only if the
                # draft fed there is the token just emitted
                if int(drafts[i, j]) != emitted[-1][0]:
                    break
                emitted.append((int(t_all[i, j + 1]), float(lp_all[i, j + 1])))
            # every emitted token but the last has its K/V in the pool; the
            # last is the next round's input
            self.row_lens[i] += len(emitted)
            self.toks[i] = emitted[-1][0]
            req = self.rows[i]
            for tok, lp in emitted:
                n_out = len(req.output_ids)
                self._emit(i, tok, lp)
                take[i, 0] += len(req.output_ids) - n_out
                if self.rows[i] is None:   # EOS, budget or abort mid-chain
                    break
            self._trace(req, "spec_round", t0=t0_w, t1=time.time(),
                        rounds=1, tokens=int(take[i, 0]),
                        accepted=max(int(take[i, 0]) - 1, 0))
        self._spec_metrics(take, int(n_prop.sum()),
                           int(np.maximum(take - 1, 0).sum()), 1)
        m = self.metrics
        m["tokens_per_sync"] = round(m["tokens"] / m["host_syncs"], 2)


def _request_fields(req: Request) -> dict:
    """What a follower rank needs to rebuild ``req`` (the tick message)."""
    return dict(prompt_ids=[int(t) for t in req.prompt_ids],
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, top_p=req.top_p,
                top_k=req.top_k, seed=req.seed,
                eos_token_id=tuple(req.eos_token_id),
                request_id=req.request_id, speculative=req.speculative,
                spec_k=req.spec_k, deadline_s=req.deadline_s)


def next_stream_item(engine: ServingEngine, req: Request,
                     poll_s: float = 0.5) -> int | None:
    """One item of a request's stream, waited for in slices of ``poll_s``
    so that a dead engine thread fails the request (``finish_reason``
    "error") instead of hanging its reader: the next token, or None at the
    end of the stream or when the engine is dead."""
    while True:
        try:
            return req.stream_queue.get(timeout=poll_s)
        except queue.Empty:
            t = engine._thread
            if t is None or not t.is_alive():
                if req.finish_reason is None:
                    req.finish_reason = "error"
                return None


def stream_tokens(req: Request, timeout: float | None = None):
    """Yield tokens from a submitted request until completion.  ``timeout``
    is the longest wait between two tokens; None = the request's deadline
    plus 30 s of grace for the engine's expiry tick when it has one, else
    120 s."""
    if timeout is None:
        timeout = (req.deadline_s + 30.0) if req.deadline_s else 120.0
    while True:
        tok = req.stream_queue.get(timeout=timeout)
        if tok is None:
            return
        yield tok
