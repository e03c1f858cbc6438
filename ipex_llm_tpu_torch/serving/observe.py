"""Zero-dependency tracing and telemetry for the serving tier (port of
``ipex_llm_tpu/serving/observe.py``, which imports no JAX; the port keeps
its own copy so that it never imports the JAX package).

Three primitives, shared by the engine and the HTTP front end:

- **Per-request spans** (``Tracer``): a bounded LRU of traces, each a
  flat list of span dicts ``{"name", "t0", "t1", "attrs", "origin"}``
  with wall-clock (epoch) timestamps, so spans recorded in different
  processes merge into one timeline.  A W3C ``traceparent``
  (``00-<trace>-<span>-01``) from the client keys the engine's spans to
  the caller's trace id, and ``/trace/{id}`` serves the assembled trace.
  Traces export as Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto loadable).
- **Tick flight recorder** (``FlightRecorder``): a bounded ring of
  recent per-tick records (sync duration, rows active and prefilling,
  pages in use, tokens, admissions).  ``dump(reason)`` freezes the ring;
  the engine calls it when it fails every request (``_fail_all``), so
  the evidence exists the moment the failure is decided.
  ``/debug/flight`` exposes ring and dumps on demand.
- **Histograms** (``Histogram``): fixed-bucket latency distributions
  with true Prometheus ``_bucket``/``_sum``/``_count`` exposition,
  O(buckets) ``snapshot``/``restore``/``copy``, and ``merge`` for fleet
  sums.

Everything here is host bookkeeping: no torch, no device calls, no
syncs.  Timestamps are ``time.time()`` reads at points the host already
visits, and with tracing disabled a trace site costs one ``is None``
check.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict, deque

__all__ = [
    "Histogram",
    "Tracer",
    "FlightRecorder",
    "LATENCY_BUCKETS_S",
    "FAST_LATENCY_BUCKETS_S",
    "new_trace_id",
    "new_span_id",
    "make_traceparent",
    "parse_traceparent",
    "span",
]

# Prometheus-style latency bounds (seconds).  LATENCY covers request-
# scale times (TTFT, per-token under load, handoff legs); FAST covers
# device-sync-scale times (tick sync, swap-in).  Fixed at construction:
# bucket identity is what makes fleet sums and cross-round comparisons
# meaningful.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
FAST_LATENCY_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                          0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)


# ---------------------------------------------------------------------------
# W3C traceparent (https://www.w3.org/TR/trace-context/)


def new_trace_id() -> str:
    return uuid.uuid4().hex            # 32 lowercase hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]       # 16 lowercase hex chars


def make_traceparent(trace_id: str, span_id: str | None = None) -> str:
    return f"00-{trace_id}-{span_id or new_span_id()}-01"


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header, or
    None when absent/malformed (a bad header must never fail a request —
    tracing degrades to a fresh trace instead)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32:
        return None
    return trace_id, span_id


def span(name: str, t0: float, t1: float | None = None,
         origin: str = "", **attrs) -> dict:
    """One span record.  ``t0``/``t1`` are epoch seconds (``time.time``)
    so spans from different processes order on one timeline; ``t1`` is
    None for instant events (rendered zero-width)."""
    return {"name": name, "t0": round(t0, 6),
            "t1": round(t1, 6) if t1 is not None else None,
            "origin": origin, "attrs": attrs}


# ---------------------------------------------------------------------------
# Histogram


class Histogram:
    """Fixed-bucket histogram with Prometheus semantics.

    ``bounds`` are the inclusive upper bounds of the finite buckets (the
    ``le`` labels); one implicit +Inf bucket catches the rest.  State is
    (counts, sum, count) — O(len(bounds)) to snapshot or copy, which is
    what lets the engine publish a frozen copy EVERY tick without tick
    latency scaling with history.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds=LATENCY_BUCKETS_S):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)   # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first bound >= v
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Bucket-interpolated percentile (q in [0, 100]); the honest
        caveat of any fixed-bucket scheme: resolution is the bucket
        width, and the +Inf bucket reports its lower bound."""
        if self.count == 0:
            return 0.0
        rank = max(1, -(-self.count * q // 100))   # ceil
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else lo
            if acc + c >= rank:
                frac = (rank - acc) / c
                return lo + (hi - lo) * frac
            acc += c
        return self.bounds[-1]

    # -- exposition ---------------------------------------------------------

    def prometheus_lines(self, name: str, labels: str = "") -> list[str]:
        """Real ``_bucket``/``_sum``/``_count`` series.  ``labels`` is a
        pre-rendered ``key="value"`` list (no braces) merged with the
        ``le`` label on bucket lines; counts are CUMULATIVE per the
        exposition format."""
        out, acc = [], 0
        for i, b in enumerate(self.bounds):
            acc += self.counts[i]
            le = f'le="{b:g}"'
            lab = f"{{{labels},{le}}}" if labels else f"{{{le}}}"
            out.append(f"{name}_bucket{lab} {acc}")
        acc += self.counts[-1]
        lab = f'{{{labels},le="+Inf"}}' if labels else '{le="+Inf"}'
        out.append(f"{name}_bucket{lab} {acc}")
        lab = f"{{{labels}}}" if labels else ""
        out.append(f"{name}_sum{lab} {round(self.sum, 6)}")
        out.append(f"{name}_count{lab} {acc}")
        return out

    def to_dict(self) -> dict:
        """Machine shape for ``/metrics?format=json`` — what the router
        fetches and fleet-sums."""
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}

    def merge(self, other: dict) -> bool:
        """Fold another histogram's ``to_dict`` shape in (the fleet
        sum).  Returns False — and folds nothing — on a bucket-bound
        mismatch: summing differently-bucketed series would fabricate a
        distribution neither replica measured."""
        if tuple(other.get("bounds", ())) != self.bounds:
            return False
        for i, c in enumerate(other.get("counts", ())):
            self.counts[i] += int(c)
        self.sum += float(other.get("sum", 0.0))
        self.count += int(other.get("count", 0))
        return True

    # -- transactionality ---------------------------------------------------

    def snapshot(self) -> tuple:
        return (tuple(self.counts), self.sum, self.count)

    def copy(self) -> "Histogram":
        """Independent frozen copy (the engine publishes one per tick,
        so /metrics never reads a histogram the engine thread is
        updating)."""
        h = Histogram(self.bounds)
        h.counts = list(self.counts)
        h.sum = self.sum
        h.count = self.count
        return h

    def restore(self, snap: tuple):
        counts, s, c = snap
        self.counts = list(counts)
        self.sum = s
        self.count = c


# ---------------------------------------------------------------------------
# Tracer


class Tracer:
    """Bounded LRU of traces (trace_id → span list).

    Thread-safe around a plain lock: the engine thread appends committed
    spans while HTTP threads read ``/trace/{id}`` — span lists are
    copied out under the lock, never handed out live.  Per-trace span
    count is capped too (``max_spans``): a pathological 100k-token
    stream degrades to a truncated trace with a ``spans_dropped`` count,
    never unbounded memory.
    """

    def __init__(self, max_traces: int = 256, max_spans: int = 512):
        self.max_traces = max(1, int(max_traces))
        self.max_spans = max(16, int(max_spans))
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        self._dropped: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, trace_id: str, *spans: dict):
        if not trace_id or not spans:
            return
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                tr = self._traces[trace_id] = []
            self._traces.move_to_end(trace_id)
            for s in spans:
                if len(tr) >= self.max_spans:
                    self._dropped[trace_id] = (
                        self._dropped.get(trace_id, 0) + 1)
                else:
                    tr.append(s)
            while len(self._traces) > self.max_traces:
                old, _ = self._traces.popitem(last=False)
                self._dropped.pop(old, None)

    def get(self, trace_id: str) -> dict | None:
        """``{"trace_id", "spans", "spans_dropped"}`` or None.  Spans
        come back sorted by start time (the assembly order a reader
        wants; insertion order is commit order, which interleaves)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            spans = sorted(tr, key=lambda s: (s["t0"], s["name"]))
            return {"trace_id": trace_id, "spans": spans,
                    "spans_dropped": self._dropped.get(trace_id, 0)}

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    # -- Chrome trace-event export ------------------------------------------

    @staticmethod
    def chrome_events(traces: list[dict], pid: int = 1) -> dict:
        """Render assembled traces as Chrome trace-event JSON (load in
        ``chrome://tracing`` or Perfetto).  Spans become complete ("X")
        events in microseconds since the earliest span; instant events
        ("i") keep zero duration.  Each trace gets its own tid row, each
        origin its own pid row, so a router+replicas trace reads as a
        swimlane per process."""
        events = []
        t_base = min((s["t0"] for tr in traces for s in tr["spans"]),
                     default=0.0)
        origins = {}
        for tid_i, tr in enumerate(traces, start=1):
            for s in tr["spans"]:
                org = s.get("origin") or "serving"
                o_pid = origins.setdefault(org, len(origins) + pid)
                ts = (s["t0"] - t_base) * 1e6
                args = dict(s.get("attrs") or {})
                args["trace_id"] = tr["trace_id"]
                ev = {"name": s["name"], "cat": org, "pid": o_pid,
                      "tid": tid_i, "ts": round(ts, 1), "args": args}
                if s.get("t1") is not None:
                    ev["ph"] = "X"
                    ev["dur"] = round((s["t1"] - s["t0"]) * 1e6, 1)
                else:
                    ev["ph"] = "i"
                    ev["s"] = "t"
                events.append(ev)
        meta = [{"ph": "M", "pid": o_pid, "tid": 0,
                 "name": "process_name", "args": {"name": org}}
                for org, o_pid in origins.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, trace_ids=None, pid: int = 1) -> dict:
        """Whole-window (or selected) export in one call."""
        ids = trace_ids if trace_ids is not None else self.trace_ids()
        traces = [t for t in (self.get(i) for i in ids) if t is not None]
        return self.chrome_events(traces, pid=pid)


# ---------------------------------------------------------------------------
# Flight recorder


class FlightRecorder:
    """Bounded ring of recent tick records + frozen postmortem dumps.

    A record is one small dict per COMMITTED working tick (the engine
    skips pure idle ticks so the ring holds the last N units of real
    work, not the last N/50 seconds of idling).  ``dump(reason)``
    freezes a copy of the ring with its reason and timestamp — called
    automatically at the engine's blast-radius decisions (_fail_all,
    quarantine) so the evidence is captured at the moment of failure.
    """

    def __init__(self, size: int = 256, max_dumps: int = 8):
        self.ring: "deque[dict]" = deque(maxlen=max(8, int(size)))
        self.dumps: "deque[dict]" = deque(maxlen=max(1, int(max_dumps)))
        self.idle_skipped = 0
        self.recorded = 0
        self._lock = threading.Lock()

    def record(self, rec: dict):
        with self._lock:
            self.recorded += 1
            self.ring.append(rec)

    def skip_idle(self):
        self.idle_skipped += 1

    def dump(self, reason: str, **extra) -> dict:
        with self._lock:
            d = {"t": round(time.time(), 3), "reason": reason,
                 "ring": list(self.ring), **extra}
            self.dumps.append(d)
            return d

    def view(self) -> dict:
        """The ``/debug/flight`` payload."""
        with self._lock:
            return {"ring": list(self.ring),
                    "ring_size": self.ring.maxlen,
                    "recorded": self.recorded,
                    "idle_skipped": self.idle_skipped,
                    "dumps": list(self.dumps)}
