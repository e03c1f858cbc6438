"""Fault taxonomy and deterministic fault injection for the serving engine
(port of ``ipex_llm_tpu/serving/faults.py``).

The engine's unit of failure is a request, not the engine.  Two failure
classes drive the recovery policy of ``ServingEngine._recover``:

- **transient**: the tick would succeed if run again (the caching
  allocator found no room for a moment, a dropped connection).  Recovery
  rolls the host bookkeeping back to the last committed tick, marks the
  device row state stale, backs off exponentially and runs the tick
  again.  The retried tick computes the same thing (the same seeds, the
  same plan, the same shapes), so its output is bitwise the unfaulted
  run's.
- **deterministic**: the same inputs fail every time (a poisoned request).
  The engine bisects the faulted tick's requests, re-running it with
  suspects masked, emissions muted and everything rolled back between
  probes, until one culprit remains; it finishes that request alone with
  ``finish_reason="error"`` and the survivors run on unchanged.
  ``_fail_all`` is left only for a fault bisection cannot place on a
  request (it fires with every request masked), and a fault that does not
  reproduce during bisection counts as resolved.

Classification, by exception type first and then by message:

- transient: ``TransientFault``; ``torch.OutOfMemoryError`` (the class
  ``torch.cuda.OutOfMemoryError`` names); ``ConnectionError``,
  ``TimeoutError`` and ``OSError``; and messages carrying a status a
  runtime gives to a retry-worthy failure (``RESOURCE_EXHAUSTED``,
  ``UNAVAILABLE``, ..., "out of memory").
- not transient: ``DeterministicFault``, and CUDA context errors
  (``torch.AcceleratorError``, or a message naming an illegal memory
  access, a device-side assert, a misaligned address or an unspecified
  launch failure).  Those are sticky (``is_sticky``): the context is
  lost and every later call fails too, so no request is the culprit.
  The engine does not bisect them (a probe with every request masked
  runs no kernel, so bisection would quarantine each request in turn):
  it ends the tick's work in ``_fail_all`` at once.  The engine does not
  try to rebuild the context.

``FaultInjector`` raises scripted exceptions at named sites of the engine
tick (page-alloc, prefill-chunk, mixed-step, decode-dispatch, sample) on
the Nth hit of the site, optionally only when a given request takes part,
which is the shape of a poisoned request and what makes bisection
observable.  A site fires before the operation it guards.  The spill,
transport and replica sites are listed because ``inject`` validates
against them; the port's engine does not guard them yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ipex_llm_tpu_torch.ops.collectives import CollectiveError

__all__ = [
    "TransientFault",
    "DeterministicFault",
    "EngineOverloaded",
    "FaultInjector",
    "FAULT_SITES",
    "REPLICA_FAULT_SITES",
    "is_sticky",
    "is_transient",
    "rate_injector",
]


class TransientFault(RuntimeError):
    """A step failure expected to succeed on retry (device preemption,
    pool pressure in the runtime, a dropped connection)."""


class DeterministicFault(RuntimeError):
    """A step failure that will recur on identical inputs (a poisoned
    request); retry is useless, isolation is the remedy."""


class EngineOverloaded(RuntimeError):
    """Raised by ``ServingEngine.submit`` when the bounded queue is full
    or the engine is draining: the load-shedding signal the HTTP surfaces
    map to 429/503."""

    def __init__(self, message: str, queue_depth: int = 0,
                 draining: bool = False):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.draining = draining


# Status names runtimes put in the message of a retry-worthy failure, and
# transport failures.  Deliberately not here: INVALID_ARGUMENT, INTERNAL,
# FAILED_PRECONDITION, which recur on identical inputs.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "connection reset",
    "connection refused",
    "broken pipe",
    "out of memory",
)

# CUDA errors that leave the context unusable: every later call fails
_STICKY_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "misaligned address",
    "unspecified launch failure",
)
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


def is_sticky(exc: BaseException) -> bool:
    """A CUDA context error, or a tensor-parallel group's collective that
    failed or timed out: every later call fails too."""
    if isinstance(exc, CollectiveError):
        return True
    if isinstance(exc, (TransientFault, DeterministicFault,
                        torch.OutOfMemoryError)):
        return False
    if _ACCELERATOR_ERROR is not None and isinstance(exc,
                                                     _ACCELERATOR_ERROR):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _STICKY_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """Classify a tick's exception: True = bounded retry, False = isolate
    (module docstring)."""
    if isinstance(exc, (TransientFault, torch.OutOfMemoryError)):
        return True
    if isinstance(exc, DeterministicFault) or is_sticky(exc):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    msg = str(exc).lower()
    return any(m.lower() in msg for m in _TRANSIENT_MARKERS)


# The sites ``ServingEngine`` guards with ``_fault_point``.  Each fires
# before the operation it names, with the ids of the requests taking part.
FAULT_SITES = (
    "page-alloc",        # page allocation for a row or an admission
    "prefill-chunk",     # the sequential engine's one-row prefill chunk
    "mixed-step",        # the batched ragged prefill of an admission wave
    "decode-dispatch",   # the decode horizon or verify step
    "sample",            # the blocking read of first tokens
    # the host-RAM spill tier and KV transport (not guarded in the port)
    "spill-store",
    "swap-in",
    "kv-export",
    "kv-import",
)

# the replica router's sites, one injector per backend
REPLICA_FAULT_SITES = (
    "replica-connect",
    "replica-stream",
    "replica-health",
    "replica-handoff",
)


@dataclass
class _FaultSpec:
    site: str
    exc_factory: "type[BaseException] | Any"
    nth: int = 1              # fire starting at the Nth matching hit
    times: int | None = 1     # how many firings (None = every time)
    request_id: str | None = None  # only when this request participates
    period: int = 0           # >0: re-fire every `period` hits after nth
    hits: int = 0             # matching hits seen so far
    fired: int = 0            # faults actually raised

    def due(self) -> bool:
        if self.hits < self.nth:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.period > 0:
            return (self.hits - self.nth) % self.period == 0
        # one-shot window: fire on hits nth..nth+times-1 (times=None: all)
        return self.times is None or self.hits < self.nth + self.times


@dataclass
class FaultInjector:
    """Deterministic scripted fault source.

    >>> inj = FaultInjector()
    >>> inj.inject("decode-dispatch", TransientFault, nth=3)
    >>> inj.inject("mixed-step", DeterministicFault, request_id=rid,
    ...            times=None)     # poisoned request: fires every time

    The engine calls ``hit(site, request_ids)`` at each guarded site; the
    first matching spec that is due raises.  A ``request_id``-scoped spec
    counts only the hits where that request takes part, so quarantining
    the request silences the fault.  ``exc`` is an exception class (raised
    with a message naming the site) or an instance (raised as it is).
    """

    specs: list[_FaultSpec] = field(default_factory=list)
    site_hits: dict = field(default_factory=dict)

    def inject(self, site: str, exc=TransientFault, *, nth: int = 1,
               times: int | None = 1, request_id: str | None = None,
               period: int = 0):
        if site not in FAULT_SITES + REPLICA_FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"one of {FAULT_SITES + REPLICA_FAULT_SITES}")
        self.specs.append(_FaultSpec(site=site, exc_factory=exc, nth=nth,
                                     times=times, request_id=request_id,
                                     period=period))
        return self

    def hit(self, site: str, request_ids=()):
        """Called by the engine at a guarded site, before the operation the
        site names; raises if a spec is due."""
        self.site_hits[site] = self.site_hits.get(site, 0) + 1
        for spec in self.specs:
            if spec.site != site:
                continue
            if (spec.request_id is not None
                    and spec.request_id not in request_ids):
                continue
            spec.hits += 1
            if not spec.due():
                continue
            spec.fired += 1
            exc = spec.exc_factory
            if isinstance(exc, type):
                exc = exc(f"injected {spec.site} fault"
                          + (f" (request {spec.request_id})"
                             if spec.request_id else ""))
            raise exc

    @property
    def fired(self) -> int:
        return sum(s.fired for s in self.specs)


def rate_injector(site: str, every: int, exc=TransientFault,
                  limit: int | None = None) -> FaultInjector:
    """Chaos helper: fire ``exc`` on every ``every``-th hit of ``site``, up
    to ``limit`` in all; deterministic, so a chaos run repeats."""
    return FaultInjector().inject(site, exc, nth=every, period=every,
                                  times=limit)
