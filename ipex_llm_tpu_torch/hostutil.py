"""Host-side cache bookkeeping (port of ``ipex_llm_tpu/hostutil.py``'s
``HostLRU``).

The reference module also holds its host-to-device upload helpers
(``h2d``, ``d2h``), which exist for JAX's zero-copy uploads; the port's
copies are explicit ``Tensor.to`` calls, so only the LRU is ported.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable


class HostLRU:
    """Byte-budgeted LRU: one implementation of the evict-to-fit
    bookkeeping every cache tier shares (``offload.ExpertStore``'s device
    expert cache; the reference's serving KV page store also rides it), so
    budget accounting and eviction order cannot drift between them.

    Semantics, the reference's exactly: ``put`` evicts least-recently-used
    entries until the new entry fits (or the cache is empty: a single
    entry larger than the whole budget is admitted over budget rather than
    refused, so a degenerate budget degrades to a one-entry cache instead
    of a dead one); ``get`` is an LRU touch and counts hits and misses.
    Values are treated as immutable: ``snapshot``/``restore`` copy only
    the bookkeeping (key order, byte sizes, counters), so a transactional
    caller's checkpoint and rollback of a tier cost O(entries), not
    O(bytes).
    """

    def __init__(self, budget_bytes: int,
                 on_evict: "Callable[[Any, Any], None] | None" = None):
        self.budget = int(budget_bytes)
        self.on_evict = on_evict     # called as on_evict(key, value)
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._sizes: dict[Any, int] = {}
        self.used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def get(self, key, touch: bool = True):
        """Value for ``key`` (None = miss); a hit is an LRU touch."""
        if key in self._entries:
            self.hits += 1
            if touch:
                self._entries.move_to_end(key)
            return self._entries[key]
        self.misses += 1
        return None

    def peek(self, key):
        """Value for ``key`` with no side effect at all: no LRU touch, no
        hit or miss counted (an observer's read)."""
        return self._entries.get(key)

    def put(self, key, value, nbytes: int):
        """Insert or replace ``key`` (it becomes the most recent), evicting
        LRU entries until it fits under the byte budget."""
        if key in self._entries:
            self.used -= self._sizes.pop(key)
            del self._entries[key]
        while self.used + nbytes > self.budget and self._entries:
            old_key, old_val = self._entries.popitem(last=False)
            self.used -= self._sizes.pop(old_key)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old_key, old_val)
        self._entries[key] = value
        self._sizes[key] = int(nbytes)
        self.used += int(nbytes)

    def pop(self, key):
        """Remove and return ``key``'s value (None when absent); counts no
        hit or miss."""
        if key not in self._entries:
            return None
        self.used -= self._sizes.pop(key)
        return self._entries.pop(key)

    def snapshot(self) -> dict:
        """Bookkeeping-only checkpoint (values held by reference)."""
        return {
            "entries": OrderedDict(self._entries),
            "sizes": dict(self._sizes),
            "used": self.used,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def restore(self, snap: dict):
        self._entries = OrderedDict(snap["entries"])
        self._sizes = dict(snap["sizes"])
        self.used = snap["used"]
        self.hits = snap["hits"]
        self.misses = snap["misses"]
        self.evictions = snap["evictions"]
