"""Fault classes of the serving engine (port of the admission part of
``ipex_llm_tpu/serving/faults.py``).

- ``EngineOverloaded`` is what ``ServingEngine.submit`` raises when the
  bounded queue is full or the engine is draining; the HTTP front end
  maps it to 429 (queue full) or 503 (draining).
- ``TransientFault`` and ``DeterministicFault`` are the two failure
  classes of a tick.  The port's engine does not tell them apart yet: any
  exception in a tick fails every request in flight (``_fail_all``).

Left for later slices: ``is_transient`` (with its mapping of CUDA
out-of-memory and launch errors onto the transient class) and the
deterministic ``FaultInjector`` with its sites go with the transactional
tick (rollback, retry and bisection of a faulted tick); the ``Replica*``
faults go with the replica router.
"""

from __future__ import annotations

__all__ = ["TransientFault", "DeterministicFault", "EngineOverloaded"]


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
