"""The port's transactional tick: the unit of failure is a request, not the
engine (ports of the transaction tests of ``tests/test_serving_faults.py``,
``test_serving_spec.py:217``, ``test_serving_kv_storage.py:293,332``,
``test_serving_lowbit.py:326`` and ``test_serving_observe.py:238,267,394``).

- A transient fault at any guarded site rolls the tick back and retries
  it; the committed streams are bitwise the unfaulted run's, in tokens and
  logprobs.
- A deterministic fault is bisected to the culprit request, which alone
  finishes "error" with no token; the survivors are bitwise the unfaulted
  run's and no page leaks.  ``_fail_all`` runs only when bisection cannot
  place the fault on a request.
- Three hazards of the port: the generator that seeds unseeded requests
  is part of the checkpoint (a retried admission wave draws the same
  seeds); the checkpoint holds no device tensor (the decode loops mutate
  the device row state in place, so a rollback re-uploads it); the tick's
  plan (``_horizon``) rides the checkpoint and a retry replays it.

The engines are driven synchronously through ``_tick`` (what the engine
thread runs), so the faults land deterministically.  The cross-check
against the JAX engine under the same scripted faults is in
``tests/test_torch_faults_reference.py``.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine, stream_tokens)
from ipex_llm_tpu_torch.serving.faults import (FAULT_SITES,
                                               REPLICA_FAULT_SITES,
                                               DeterministicFault,
                                               FaultInjector,
                                               TransientFault, is_sticky,
                                               is_transient, rate_injector)
from tests.test_torch_decoder import tiny_pair

# the reference's fault tests' engine and model widths
EC = dict(max_rows=4, max_seq_len=256, page_size=32, prefill_bucket=32,
          retry_backoff_s=0.001)
WIDTHS = dict(vocab_size=131, hidden_size=48, intermediate_size=96,
              num_heads=4, num_kv_heads=2, head_dim=12)
# sites the mixed engine hits; prefill-chunk only on the sequential path
MIXED_SITES = ("page-alloc", "mixed-step", "decode-dispatch", "sample")


@pytest.fixture(scope="module")
def port():
    """(port cfg, port bf16 params) at the reference tests' widths."""
    _, _, cfg, params = tiny_pair("bf16", **WIDTHS)
    return cfg, params


def _engine(port, inj=None, **ec):
    cfg, params = port
    return ServingEngine(cfg, params, EngineConfig(**{**EC, **ec}),
                         device="cpu", fault_injector=inj)


def _drive(eng, reqs, max_ticks=3000):
    """Submit all, run ``_tick`` until every request finished; returns the
    drained streams in submission order."""
    for r in reqs:
        eng.submit(r)
    for _ in range(max_ticks):
        eng._tick()
        if all(r.finish_reason is not None for r in reqs):
            break
    assert all(r.finish_reason is not None for r in reqs), (
        [r.finish_reason for r in reqs])
    return [list(stream_tokens(r, timeout=10)) for r in reqs]


def _wave(vocab: int, seed: int = 7, unseeded: bool = False):
    """Four rows of mixed prompt lengths: greedy rows and one seeded
    sampled row (``unseeded``: one more sampled row whose seed the engine
    draws), prompts long enough that several mixed ticks run while rows
    decode, so that every site is hit."""
    rng = np.random.default_rng(seed)
    spec = [(40, {}), (70, {"temperature": 0.8, "seed": 99}),
            (24, {"temperature": 0.9} if unseeded else {}), (50, {})]
    return [Request(prompt_ids=[int(v) for v in rng.integers(0, vocab, n)],
                    max_new_tokens=8, **kw) for n, kw in spec]


def _outputs(reqs):
    return ([r.output_ids for r in reqs], [r.logprobs for r in reqs],
            [r.finish_reason for r in reqs])


@pytest.fixture(scope="module")
def baseline(port):
    """The unfaulted run: streams, logprobs, reasons, pages left in use."""
    eng = _engine(port)
    reqs = _wave(port[0].vocab_size)
    streams = _drive(eng, reqs)
    return {"streams": streams, "logprobs": [r.logprobs for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "pages_idle": eng.alloc.pages_in_use}


def _assert_bitwise(reqs, streams, base, skip=()):
    for i, r in enumerate(reqs):
        if i in skip:
            continue
        assert streams[i] == base["streams"][i], f"stream {i} diverged"
        assert r.finish_reason == base["reasons"][i]
        np.testing.assert_array_equal(np.asarray(r.logprobs, np.float32),
                                      np.asarray(base["logprobs"][i],
                                                 np.float32))


# -- transient faults: rollback and retry, bitwise ---------------------------

@pytest.mark.parametrize("site", MIXED_SITES)
def test_transient_fault_retried_bit_identical(port, baseline, site):
    inj = FaultInjector().inject(site, TransientFault, nth=2)
    eng = _engine(port, inj)
    reqs = _wave(port[0].vocab_size)
    streams = _drive(eng, reqs)
    assert inj.fired == 1, f"site {site} never hit"
    assert eng.metrics["retries"] == 1
    assert eng.metrics["errors_isolated"] == 0
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, baseline)


def test_transient_fault_sequential_prefill_site(port):
    """The sequential (budget 0) admission path retries its own site."""
    reqs0 = _wave(port[0].vocab_size)
    base = _drive(_engine(port, step_token_budget=0), reqs0)
    inj = FaultInjector().inject("prefill-chunk", TransientFault, nth=2)
    eng = _engine(port, inj, step_token_budget=0)
    reqs = _wave(port[0].vocab_size)
    assert _drive(eng, reqs) == base
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert _outputs(reqs) == _outputs(reqs0)


def test_retries_exhausted_escalates_to_isolation(port, baseline):
    """A transient fault that keeps firing for one request exhausts the
    retries; bisection then isolates that request."""
    reqs = _wave(port[0].vocab_size)
    reqs[1].request_id = "sticky-transient"
    inj = FaultInjector().inject("mixed-step", TransientFault,
                                 request_id="sticky-transient", times=None)
    eng = _engine(port, inj)
    streams = _drive(eng, reqs)
    assert reqs[1].finish_reason == "error"
    assert eng.metrics["retries"] == eng.ec.max_step_retries
    assert eng.metrics["errors_isolated"] == 1
    _assert_bitwise(reqs, streams, baseline, skip=(1,))


# -- deterministic faults: bisection quarantines one request ----------------

@pytest.mark.parametrize("site,nth", [("mixed-step", 1),
                                      ("decode-dispatch", 1),
                                      ("decode-dispatch", 3)])
def test_poisoned_request_quarantined_survivors_identical(port, baseline,
                                                          site, nth):
    """A deterministic fault tied to one request of the wave fails that
    request alone, with no token past the fault (none at all when it
    fires on the request's first tick; with ``nth`` 3 it fires while the
    request decodes, so bisection masks a decoding row); the other three
    are bitwise the unfaulted run's; no page leaks; ``_fail_all`` never
    runs."""
    reqs = _wave(port[0].vocab_size)
    culprit = 0 if site == "decode-dispatch" else 2
    reqs[culprit].request_id = "poisoned"
    inj = FaultInjector().inject(site, DeterministicFault, nth=nth,
                                 request_id="poisoned", times=None)
    eng = _engine(port, inj)
    streams = _drive(eng, reqs)
    assert reqs[culprit].finish_reason == "error"
    n_ok = len(streams[culprit])
    assert (n_ok == 0) == (nth == 1)
    assert streams[culprit] == baseline["streams"][culprit][:n_ok]
    assert eng.metrics["errors_isolated"] == 1
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, baseline, skip=(culprit,))
    # every page still in use is held by the prefix cache alone
    assert eng.alloc.pages_in_use == len(eng.alloc.prefix)
    assert all(eng.alloc.ref[p] == 1 for p in eng.alloc.prefix.values())
    if culprit == 2:
        # the 24-token culprit registers no prefix page even unfaulted
        assert eng.alloc.pages_in_use == baseline["pages_idle"]


def test_quarantine_pool_returns_fully_idle(port):
    """With prompts too short to register prefix pages, the pool is wholly
    free after a quarantine and the others' completions."""
    rng = np.random.default_rng(5)
    reqs = [Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 20)],
                    max_new_tokens=4) for _ in range(3)]
    reqs[1].request_id = "poisoned"
    inj = FaultInjector().inject("decode-dispatch", DeterministicFault,
                                 request_id="poisoned", times=None)
    eng = _engine(port, inj)
    _drive(eng, reqs)
    assert reqs[1].finish_reason == "error"
    assert eng.alloc.pages_in_use == 0
    assert not eng.alloc.prefix


def test_vanished_fault_resolves_without_quarantine(port, baseline):
    """A one-shot deterministic fault that does not reproduce under
    bisection counts as resolved: nobody is quarantined and every stream
    commits bitwise."""
    inj = FaultInjector().inject("decode-dispatch", DeterministicFault,
                                 nth=1, times=1)
    eng = _engine(port, inj)
    reqs = _wave(port[0].vocab_size)
    streams = _drive(eng, reqs)
    assert inj.fired == 1
    assert eng.metrics["errors_isolated"] == 0
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, baseline)


def test_fail_all_only_when_bisection_fails(port):
    """A fault that fires with every request masked reaches ``_fail_all``
    (the other path there is a sticky CUDA context error, below)."""
    rng = np.random.default_rng(6)
    eng = _engine(port)
    reqs = [Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 20)],
                    max_new_tokens=4) for _ in range(2)]
    for r in reqs:
        eng.submit(r)

    def bad_admit():
        raise DeterministicFault("engine-level, not request-level")

    eng._admit = bad_admit
    assert eng._tick() is False
    assert all(r.finish_reason == "error" for r in reqs)
    assert eng.metrics["errors"] == 1
    assert eng.metrics["errors_isolated"] == 0
    for r in reqs:     # the terminal None arrived: no client hangs
        assert list(stream_tokens(r, timeout=1)) == []
    assert eng.flight.view()["dumps"][-1]["reason"] == "fail_all"


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: device-side assert triggered"),
    torch.AcceleratorError("CUDA error: an illegal memory access was "
                           "encountered")], ids=["message", "class"])
def test_sticky_context_error_reaches_fail_all_without_bisection(port, exc):
    """A lost CUDA context (here raised at every decode dispatch, as every
    later call fails on the card) is no request's fault: the engine does
    not bisect it (a probe with every request masked runs no kernel, so it
    would quarantine each request in turn) but fails every request once
    through ``_fail_all``."""
    eng = _engine(port, FaultInjector().inject("decode-dispatch", exc,
                                               times=None))
    reqs = _wave(port[0].vocab_size)
    for r in reqs:
        eng.submit(r)
    for _ in range(200):
        if eng._tick() is False:
            break
    assert all(r.finish_reason == "error" for r in reqs)
    assert eng.metrics["errors"] == 1
    assert eng.metrics["errors_isolated"] == 0
    assert eng.metrics["retries"] == 0
    assert eng.flight.view()["dumps"][-1]["reason"] == "fail_all"
    assert is_sticky(exc) and not is_transient(exc)
    # the context is dead: the engine loop ends after the backstop
    assert eng._stop.is_set()


def test_sticky_error_ends_the_engine_thread(port):
    """After a sticky error the engine thread fails every request once and
    ends: ``/health`` answers 503 "dead" and a later request fails at once
    (its reader sees the dead thread) instead of each going through the
    backstop."""
    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer
    from ipex_llm_tpu_torch.serving.engine import next_stream_item

    class Tok:
        eos_token_id = None

        def __call__(self, text):
            return {"input_ids": [int(w) for w in text.split()]}

        def decode(self, ids):
            return " ".join(map(str, ids))

    eng = _engine(port, FaultInjector().inject(
        "decode-dispatch", RuntimeError("CUDA error: device-side assert "
                                        "triggered"), times=None))
    reqs = _wave(port[0].vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.start()
    try:
        eng._thread.join(timeout=60)
        assert not eng._thread.is_alive()
        assert all(r.finish_reason == "error" for r in reqs)
        assert eng.metrics["errors"] == 1
        reply = asyncio.run(OpenAIServer(eng, Tok(), "tiny").call(
            "GET", "/health"))
        assert reply.status == 503 and reply.body["status"] == "dead"
        late = eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4))
        t0 = time.monotonic()
        assert next_stream_item(eng, late, poll_s=0.05) is None
        assert late.finish_reason == "error"
        assert time.monotonic() - t0 < 5
        assert eng.metrics["errors"] == 1      # no second backstop
    finally:
        eng.stop()


def test_recovery_that_raises_reaches_fail_all_in_the_loop(port):
    """When the recovery itself fails, the engine thread's loop fails
    every request and serves on."""
    eng = _engine(port, FaultInjector().inject("mixed-step", TransientFault))

    def broken_recover(exc):
        raise RuntimeError("recovery failed")

    eng._recover = broken_recover
    eng.start()
    try:
        first = eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4))
        assert list(stream_tokens(first, timeout=60)) == []
        assert first.finish_reason == "error"
        assert eng.metrics["errors"] == 1
        second = eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4))
        assert len(list(stream_tokens(second, timeout=60))) == 4
    finally:
        eng.stop()


def test_injector_validates_sites():
    with pytest.raises(ValueError):
        FaultInjector().inject("not-a-site", TransientFault)
    # five tick sites and the spill and transport sites
    assert len(FAULT_SITES) == 9
    for site in ("spill-store", "swap-in", "kv-export", "kv-import"):
        assert site in FAULT_SITES
    FaultInjector().inject(REPLICA_FAULT_SITES[0])


def test_is_transient_classification():
    assert is_transient(TransientFault("x"))
    assert not is_transient(DeterministicFault("x"))
    assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: oom on chip"))
    assert is_transient(ConnectionError("tunnel dropped"))
    assert not is_transient(RuntimeError("INVALID_ARGUMENT: bad shape"))
    # the card: the caching allocator's failure retries; a lost context
    # (sticky: every later call fails too) does not
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    assert is_transient(oom)
    assert torch.cuda.OutOfMemoryError is torch.OutOfMemoryError
    assert is_transient(RuntimeError("CUDA error: out of memory"))
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered",
                "CUDA error: misaligned address",
                "CUDA error: unspecified launch failure"):
        assert not is_transient(RuntimeError(msg)), msg
    assert not is_transient(torch.AcceleratorError("CUDA error: x"))
    assert is_sticky(torch.AcceleratorError("CUDA error: x"))
    assert is_sticky(RuntimeError("CUDA error: misaligned address"))
    assert not is_sticky(DeterministicFault("illegal memory access"))
    assert not is_sticky(oom) and not is_sticky(TransientFault("x"))


def test_pool_dry_requeue_preserves_fifo(port):
    """r2 (pool-dry at admission) is admitted again before r3 (which would
    fit at once): a pool-dry requeue goes back to the head."""
    rng = np.random.default_rng(11)
    eng = _engine(port, max_rows=2, max_seq_len=64, pool_pages=4)
    r1 = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 40)],
                 max_new_tokens=8)
    r2 = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 40)],
                 max_new_tokens=8)
    r3 = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 20)],
                 max_new_tokens=4)
    admitted_at: dict[int, int] = {}
    for r in (r1, r2, r3):
        eng.submit(r)
    for t in range(3000):
        eng._tick()
        for r, name in ((r1, 1), (r2, 2), (r3, 3)):
            if name not in admitted_at and r in eng.rows:
                admitted_at[name] = t
        if all(r.finish_reason is not None for r in (r1, r2, r3)):
            break
    assert [r.finish_reason for r in (r1, r2, r3)] == ["length"] * 3
    assert admitted_at[2] <= admitted_at[3], admitted_at


def test_rollback_drops_prefix_pages_the_doomed_tick_evicted(port):
    """A bisection probe that gets past the dispatch (the culprit masked)
    may evict a cached prefix page, hand it out and write another
    request's K/V into it.  The rollback must not map the prefix key to
    that page again: a later request sharing the prefix would attend to
    the other request's K/V.  Here the quarantine frees the culprit's
    pages, so the committed admission does not evict the page again; the
    later prefix request's tokens equal a fresh engine's."""
    rng = np.random.default_rng(21)
    prompt_a = [int(v) for v in rng.integers(0, 131, 49)]
    # one 64-token chunk writes the wave's whole prompt, the evicted page
    # included, in the probe that masks the culprit
    kw = dict(max_rows=2, page_size=16, prefill_bucket=64,
              step_token_budget=64, pool_pages=8)
    inj = FaultInjector()
    eng = _engine(port, inj, **kw)
    _drive(eng, [Request(prompt_ids=prompt_a, max_new_tokens=2)])
    cached = dict(eng.alloc.prefix)
    assert len(cached) == 3          # 48 of 49 prompt tokens, 16 a page
    culprit = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 10)],
                      max_new_tokens=40, request_id="poisoned")
    eng.submit(culprit)
    while len(culprit.output_ids) < 2:
        eng._tick()
    # the culprit decodes; the wave's admission must evict a cached page
    inj.inject("decode-dispatch", DeterministicFault, request_id="poisoned",
               times=None)
    wave = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 60)],
                   max_new_tokens=4)
    _drive(eng, [wave])
    assert culprit.finish_reason == "error"
    assert eng.metrics["errors_isolated"] == 1
    assert wave.finish_reason == "length"
    # the probe's eviction stands: the first page's key is gone
    assert next(iter(cached)) not in eng.alloc.prefix
    assert eng.alloc.pages_in_use == len(eng.alloc.prefix)
    assert all(eng.alloc.ref[p] == 1 for p in eng.alloc.prefix.values())

    prompt_b = prompt_a + [int(v) for v in rng.integers(0, 131, 8)]
    later = Request(prompt_ids=prompt_b, max_new_tokens=8)
    fresh = Request(prompt_ids=prompt_b, max_new_tokens=8)
    got = _drive(eng, [later])
    want = _drive(_engine(port, **kw), [fresh])
    assert got == want
    np.testing.assert_allclose(later.logprobs, fresh.logprobs, atol=2e-2)


def test_rollback_returns_row_pages_unwritten(port):
    """A decoding row that finds the pool dry finishes "length" mid-tick
    and releases its pages; a later row of the same tick needs a page.
    Inside a transaction the released pages stay pinned until the commit,
    so a probe (the culprit masked) cannot write another row's K/V into
    them.  After the culprit's quarantine the row goes on decoding over
    its own K/V: its tokens equal a fresh engine's."""
    rng = np.random.default_rng(31)
    kw = dict(max_rows=3, page_size=16, prefill_bucket=32, pool_pages=6)
    inj = FaultInjector()
    eng = _engine(port, inj, **kw)
    culprit = Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 10)],
                      max_new_tokens=60, request_id="poisoned")
    reqs = [Request(prompt_ids=[int(v) for v in rng.integers(0, 131, 30)],
                    max_new_tokens=12) for _ in range(2)]
    for r in [culprit] + reqs:
        eng.submit(r)
    # both 30-token rows reach a page boundary on the same tick, the pool
    # dry: the first finishes "length" and the second wants its page
    while eng.row_lens[1] < 32:
        eng._tick()
    assert not eng.alloc.free and eng.row_lens[2] == 32
    inj.inject("decode-dispatch", DeterministicFault, request_id="poisoned",
               times=None)
    for _ in range(100):
        eng._tick()
        if all(r.finish_reason is not None for r in reqs):
            break
    assert culprit.finish_reason == "error"
    assert eng.metrics["errors_isolated"] == 1
    assert len(reqs[0].output_ids) > 3      # it decoded past the boundary
    for r in reqs:
        fresh = Request(prompt_ids=r.prompt_ids, max_new_tokens=12)
        _drive(_engine(port, max_rows=3, page_size=16, prefill_bucket=32),
               [fresh])
        assert r.output_ids == fresh.output_ids[:len(r.output_ids)]
    assert eng.alloc.pages_in_use == len(eng.alloc.prefix)


# -- the port's hazards: the generator, the device state, the plan -----------

def test_rollback_after_decode_restores_generator_and_device_state(port):
    """The decode loops mutate the device row state in place (where the
    reference relied on donation never touching its key): the checkpoint
    holds no device tensor and the generator's state, and a rollback after
    a dispatched decode tick drops the device state, marks every table row
    stale and restores the generator, so the ticks after it commit the
    unfaulted run's stream."""
    want = Request(prompt_ids=list(range(1, 30)), max_new_tokens=6,
                   temperature=0.9)
    _drive(_engine(port), [want])
    eng = _engine(port)
    req = Request(prompt_ids=list(range(1, 30)), max_new_tokens=6,
                  temperature=0.9)                 # seeded by the engine
    eng.submit(req)
    for _ in range(200):                           # into steady decode
        eng._tick()
        if len(req.output_ids) >= 2:
            break
    assert len(req.output_ids) >= 2 and req.finish_reason is None
    snap = eng._checkpoint()
    gen0 = snap["gen"].clone()
    dev_before = {k: v.clone() for k, v in eng._dev.items()}
    torch.randint(0, 9, (4,), generator=eng._gen)  # the generator moves
    eng._staging, eng._tick_arrivals = [], []
    eng._step()                                    # a dispatched decode
    assert not torch.equal(eng._dev["row_lens"], dev_before["row_lens"])
    eng._rollback(snap)
    assert eng._dev is None and eng._dirty
    assert eng._dirty_tables == set(range(eng.ec.max_rows))
    assert torch.equal(eng._gen.get_state(), gen0)
    n_before = len(req.output_ids)
    for _ in range(200):
        eng._tick()
        if req.finish_reason is not None:
            break
    assert req.finish_reason == "length" and len(req.output_ids) > n_before
    assert (req.output_ids, req.logprobs) == (want.output_ids, want.logprobs)


def test_checkpoint_holds_no_device_tensor(port):
    """Walk a checkpoint taken mid-decode: the only tensor in it is the
    generator's state, a CPU byte tensor; nothing aliases the device row
    state or the pool."""
    eng = _engine(port)
    reqs = _wave(port[0].vocab_size)
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng._tick()
    assert eng._dev is not None
    snap = eng._checkpoint()
    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(snap)
    assert len(found) == 1 and found[0] is snap["gen"]
    assert snap["gen"].device.type == "cpu"
    assert snap["gen"].dtype == torch.uint8


# the hit of each site that falls in the tick admitting the whole wave
@pytest.mark.parametrize("site,nth", [("page-alloc", 2), ("mixed-step", 1)])
def test_unseeded_row_of_a_retried_wave_equals_the_unfaulted_run(port, site,
                                                                 nth):
    """An unseeded sampled request draws its seed from the engine's
    generator at admission.  A transient fault in the admission wave rolls
    the generator back with the tick, so the retried wave draws the same
    seeds and every stream, the unseeded one included, is bitwise the
    unfaulted run's."""
    base = _wave(port[0].vocab_size, unseeded=True)
    _drive(_engine(port), base)
    inj = FaultInjector().inject(site, TransientFault, nth=nth)
    eng = _engine(port, inj)
    reqs = _wave(port[0].vocab_size, unseeded=True)
    _drive(eng, reqs)
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert reqs[2].seed is None and reqs[2].temperature > 0
    assert _outputs(reqs) == _outputs(base)


def test_plan_rides_checkpoint_and_rollback(port):
    """The tick's plan (``_horizon``) is part of the checkpoint, and a
    retry replays it: a request that arrives after the plan was made (a
    free row, so a re-plan would pick horizon 1) does not shrink the
    retried tick, which runs the planned horizon of 4 as the unfaulted
    run does."""
    eng = _engine(port, decode_horizon=4)
    held = eng._horizon
    snap = eng._checkpoint()
    assert snap["plan"] == held
    eng._horizon = None
    eng._staging, eng._tick_arrivals = [], []
    eng._rollback(snap)
    assert eng._horizon == held

    def run(inj):
        eng = _engine(port, inj, decode_horizon=4)
        first = Request(prompt_ids=list(range(1, 30)), max_new_tokens=12)
        # refused at admission (past the row's capacity): it never takes
        # the free row, so the tick it is drained in stays a horizon tick
        late = Request(prompt_ids=list(range(5, 20)), max_new_tokens=10_000)
        eng.submit(first)
        while len(first.output_ids) < 2:
            eng._tick()
        real = eng._expire_deadlines
        calls = []

        def arrive_after_planning():
            calls.append(1)
            if len(calls) == 1:
                eng.submit(late)   # lands after the tick drained its inbox
            real()

        eng._expire_deadlines = arrive_after_planning
        horizons = []
        while first.finish_reason is None or late.finish_reason is None:
            n = len(first.output_ids)
            if eng._tick():
                horizons.append((eng._horizon, len(first.output_ids) - n))
        return eng, horizons, _outputs([first, late])

    _, clean_h, clean = run(None)
    eng, faulted_h, faulted = run(
        FaultInjector().inject("decode-dispatch", TransientFault, nth=2))
    assert eng.metrics["retries"] == 1
    # the clean run drains the arrival one tick later and plans that tick
    # at horizon 1; the streams are equal (H4 is bitwise H1)
    assert faulted_h[0] == clean_h[0] == (4, 4)
    assert faulted == clean and clean[2] == ["length", "length"]


# -- composition: speculation, an e5m2 pool, int4 weights --------------------

def _periodic_prompt(base_len=4, reps=10, seed=11):
    rng = np.random.default_rng(seed)
    return list(np.tile(rng.integers(0, 127, base_len), reps).astype(int))


def test_spec_transient_fault_rollback_replay(port):
    """A transient fault at decode-dispatch across fused spec ticks rolls
    the tick back (the device token history included: the re-upload
    rebuilds it from the host's ids) and the retried tick replays bitwise;
    the draft counters and the rolling accept window carry no residue."""
    kws = [dict(prompt_ids=_periodic_prompt(4, 7, seed=31),
                max_new_tokens=14),
           dict(prompt_ids=_periodic_prompt(5, 6, seed=37),
                max_new_tokens=12, temperature=0.7, seed=11)]
    spec = dict(spec_k=3, decode_horizon=4)

    def run(inj):
        eng = _engine(port, inj, **spec)
        reqs = [Request(**kw) for kw in kws]
        _drive(eng, reqs)
        return eng, _outputs(reqs)

    clean_eng, clean = run(None)
    inj = rate_injector("decode-dispatch", 3, TransientFault, limit=4)
    eng, faulted = run(inj)
    assert inj.fired > 0 and eng.metrics["retries"] > 0
    assert faulted == clean
    for k in ("draft_proposed", "draft_accepted", "spec_emitted"):
        assert eng.metrics[k] == clean_eng.metrics[k], k
    assert list(eng._spec_window) == list(clean_eng._spec_window)


def test_transient_fault_rollback_preserves_fp8_pool(port):
    """A transient fault over an e5m2 pool: the retry reproduces the
    unfaulted e5m2 run bitwise, the pool keeps its storage through the
    rollback's re-upload and drains back to the prefix cache's pages."""
    rng = np.random.default_rng(3)
    prompts = [[int(v) for v in rng.integers(0, 131, n)] for n in (40, 70)]

    def wave():
        return [Request(prompt_ids=p, max_new_tokens=8) for p in prompts]

    base = _drive(_engine(port, kv_storage="fp8"), wave())
    inj = FaultInjector().inject("decode-dispatch", TransientFault, nth=2)
    eng = _engine(port, inj, kv_storage="fp8")
    reqs = wave()
    assert _drive(eng, reqs) == base
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert all(r.finish_reason == "length" for r in reqs)
    assert eng.cache.k.dtype == torch.float8_e5m2
    assert eng.cache.v.dtype == torch.float8_e5m2
    cached = set(eng.alloc.prefix.values())
    for pid in range(1, eng.alloc.n_pages):
        refs = int(eng.alloc.ref[pid])
        assert refs == 0 or (pid in cached and refs == 1), (pid, refs)


def test_prefix_eviction_and_alloc_clamp_counters(port):
    """Evicting a cached prefix page moves ``prefix_evictions`` and a
    failed allocation ``alloc_fail_clamps`` (both in ``kv_stats``); a
    rollback takes back a count the doomed tick moved, but not a real
    eviction (the page may have been handed out and written)."""
    rng = np.random.default_rng(12)
    eng = _engine(port, max_rows=2, page_size=16, pool_pages=8,
                  decode_horizon=8)
    for i in range(3):
        p = [int(v) for v in rng.integers(0, 131, 40 + 16 * i)]
        _drive(eng, [Request(prompt_ids=p, max_new_tokens=20)])
    kv = eng.kv_stats()
    assert kv["prefix_evictions"] > 0, kv
    assert kv["prefix_evictions"] == eng.alloc.prefix_evictions

    eng2 = _engine(port, max_rows=2, page_size=16, pool_pages=6,
                   decode_horizon=8)
    _drive(eng2, [Request(prompt_ids=[int(v) for v in
                                      rng.integers(0, 131, n)],
                          max_new_tokens=m) for n, m in ((25, 26), (16, 20))])
    kv2 = eng2.kv_stats()
    assert kv2["alloc_fail_clamps"] > 0, kv2
    assert kv2["alloc_fail_clamps"] == eng2.metrics["alloc_fail_clamps"]
    assert kv2["horizon_clamped"] >= 1, kv2
    snap = eng._checkpoint()
    eng.alloc.prefix_evictions += 5
    eng._staging, eng._tick_arrivals = [], []
    eng._rollback(snap)
    assert eng.alloc.prefix_evictions == kv["prefix_evictions"]
    # a real eviction of the rolled-back tick stands: its page may have
    # been handed out and written, so its key is not restored
    key, pid = next(iter(eng.alloc.prefix.items()))
    snap = eng._checkpoint()
    assert eng.alloc._evict(1) == 1
    eng._staging, eng._tick_arrivals = [], []
    eng._rollback(snap)
    assert key not in eng.alloc.prefix and pid not in eng.alloc._page_key
    assert eng.alloc.ref[pid] == 0 and pid in eng.alloc.free
    assert eng.alloc.prefix_evictions == kv["prefix_evictions"] + 1


def test_transient_fault_rollback_over_int4_tick(port):
    """A transient fault over sym_int4 weights (repacked by the engine):
    the retry reproduces the unfaulted int4 run bitwise, and the packed
    planes are untouched by the rollback."""
    rng = np.random.default_rng(4)
    prompts = [[int(v) for v in rng.integers(0, 131, n)] for n in (40, 70)]

    def wave():
        return [Request(prompt_ids=p, max_new_tokens=8) for p in prompts]

    base_eng = _engine(port, weight_qtype="sym_int4")
    base = _drive(base_eng, wave())
    inj = FaultInjector().inject("decode-dispatch", TransientFault, nth=2)
    eng = _engine(port, inj, weight_qtype="sym_int4")
    reqs = wave()
    assert _drive(eng, reqs) == base
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert all(r.finish_reason == "length" for r in reqs)
    qkv = eng.params["layers"]["qkv"]
    assert qkv.qtype == "sym_int4" and qkv.data.dtype == torch.uint8
    assert torch.equal(qkv.data, base_eng.params["layers"]["qkv"].data)


# -- observability under faults ----------------------------------------------

def _spans(eng, req, name):
    tv = eng.trace_view(req.trace_id or req.request_id)
    assert tv is not None, "no trace recorded"
    return [s for s in tv["spans"] if s["name"] == name]


def test_rollback_leaves_no_span_residue(port):
    """A rolled-back tick's staged spans are dropped (the retried tick
    records them once); the only extra evidence is the retry event, and
    the histograms count each observation once."""
    rng = np.random.default_rng(23)
    inj = FaultInjector().inject("decode-dispatch", TransientFault, nth=3)
    eng = _engine(port, inj, trace_requests=True)
    req = Request(prompt_ids=[int(v) for v in rng.integers(1, 131, 40)],
                  max_new_tokens=8)
    (out,) = _drive(eng, [req])
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert len(out) == 8
    retries = _spans(eng, req, "retry")
    assert len(retries) == 1
    assert retries[0]["attrs"]["error"].startswith("TransientFault")
    assert len(_spans(eng, req, "first_token")) == 1
    assert len(_spans(eng, req, "finish")) == 1
    horizons = _spans(eng, req, "decode_horizon")
    assert sum(s["attrs"]["tokens"] for s in horizons) == len(out) - 1
    assert eng.hists["ttft_s"].count == 1
    assert eng.hists["token_latency_s"].count == len(out) - 1
    assert eng.histograms()["token_latency_s"].count == len(out) - 1


def test_quarantine_dumps_flight_recorder(port):
    """A quarantine freezes the flight ring and stamps the culprit's
    trace; the survivor's stream and trace are whole."""
    rng = np.random.default_rng(24)
    good = Request(prompt_ids=[int(v) for v in rng.integers(1, 131, 24)],
                   max_new_tokens=6)
    bad = Request(prompt_ids=[int(v) for v in rng.integers(1, 131, 24)],
                  max_new_tokens=6, request_id="poisoned")
    inj = FaultInjector().inject("decode-dispatch", DeterministicFault,
                                 request_id="poisoned", times=None)
    eng = _engine(port, inj, trace_requests=True)
    _drive(eng, [good, bad])
    assert bad.finish_reason == "error"
    assert good.finish_reason == "length"
    dumps = eng.flight.view()["dumps"]
    assert dumps and dumps[-1]["reason"] == "quarantine"
    assert dumps[-1]["request_id"] == "poisoned"
    assert dumps[-1]["ring"], "the dump carried an empty ring"
    assert {"tick", "dispatches", "sync_s", "rows_active",
            "pages_in_use"} <= set(dumps[-1]["ring"][-1])
    assert dumps[-1]["fault_sites_pending"]["decode-dispatch"] >= 1
    assert len(_spans(eng, bad, "quarantine")) == 1
    assert len(_spans(eng, good, "finish")) == 1


def test_flight_recorder_carries_rollback_retry_evidence(port):
    """A failed tick rolls back and never records, and the retry is
    counted after the rollback: the next committed record carries the
    retry and the failed tick's site hits."""
    rng = np.random.default_rng(25)
    inj = FaultInjector().inject("decode-dispatch", TransientFault, nth=3)
    eng = _engine(port, inj)
    _drive(eng, [Request(prompt_ids=[int(v) for v in
                                     rng.integers(1, 131, 40)],
                         max_new_tokens=8)])
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    ring = eng.flight.view()["ring"]
    assert sum(r.get("retries", 0) for r in ring) == 1
    carrier = next(r for r in ring if r.get("retries"))
    assert carrier.get("fault_sites", {}).get("decode-dispatch", 0) >= 1
    assert eng.metrics["ticks"] == ring[-1]["tick"]
