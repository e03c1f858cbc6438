"""The port's observability classes (``ipex_llm_tpu_torch/serving/observe.py``)
against the JAX package's (``ipex_llm_tpu/serving/observe.py``).

Both are pure Python, so the same seeded observations must give exactly
the same histograms, traces, flight-recorder views and traceparents."""

import uuid

import numpy as np
import pytest

import ipex_llm_tpu.serving.observe as ref
import ipex_llm_tpu_torch.serving.observe as port

BOUNDS = {"latency": ref.LATENCY_BUCKETS_S,
          "fast": ref.FAST_LATENCY_BUCKETS_S, "three": (0.5, 1.0, 2.0)}


@pytest.fixture
def frozen_clock(monkeypatch):
    """time.time() as both modules read it, moved only by the test."""
    clock = {"t": 1_700_000_000.0}
    monkeypatch.setattr(ref.time, "time", lambda: clock["t"])
    return clock


def test_constants_and_exports_match():
    assert port.LATENCY_BUCKETS_S == ref.LATENCY_BUCKETS_S
    assert port.FAST_LATENCY_BUCKETS_S == ref.FAST_LATENCY_BUCKETS_S
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("bounds", sorted(BOUNDS))
def test_histogram_matches_reference(bounds):
    b = BOUNDS[bounds]
    rng = np.random.default_rng(11)
    values = np.concatenate([rng.lognormal(-3.0, 2.0, 300),
                             [0.0, b[0], b[-1], b[-1] * 10]]).tolist()
    hp, hr = port.Histogram(b), ref.Histogram(b)
    for v in values:
        hp.observe(v)
        hr.observe(v)
    assert hp.to_dict() == hr.to_dict()
    for labels in ("", 'replica_id="r1"'):
        assert (hp.prometheus_lines("ipex_llm_tpu_x", labels)
                == hr.prometheus_lines("ipex_llm_tpu_x", labels))
    for q in (0, 1, 50, 90, 95, 99, 100):
        assert hp.percentile(q) == hr.percentile(q)
    snap_p, snap_r = hp.snapshot(), hr.snapshot()
    assert snap_p == snap_r
    for v in values[:17]:
        hp.observe(v)
        hr.observe(v)
    hp.restore(snap_p)
    hr.restore(snap_r)
    assert hp.to_dict() == hr.to_dict()
    assert hp.copy().to_dict() == hr.copy().to_dict()
    # fleet sums: equal bounds fold in, other bounds are refused
    assert hp.merge(hr.to_dict()) and hr.merge(hr.copy().to_dict())
    assert hp.to_dict() == hr.to_dict()
    other = ref.Histogram((0.1, 0.2))
    assert not hp.merge(other.to_dict()) and not hr.merge(other.to_dict())
    assert port.Histogram(b).percentile(50) == ref.Histogram(b).percentile(50)
    for bad in ((1.0, 1.0), (2.0, 1.0)):
        for mod in (port, ref):
            with pytest.raises(ValueError):
                mod.Histogram(bad)


@pytest.mark.parametrize("max_traces,max_spans", [(4, 16), (256, 512)])
def test_tracer_matches_reference(frozen_clock, max_traces, max_spans):
    """LRU eviction of whole traces, the per-trace span cap with its
    dropped count, sorted assembly and Chrome export."""
    rng = np.random.default_rng(5)
    tp, tr = port.Tracer(max_traces, max_spans), ref.Tracer(max_traces,
                                                              max_spans)
    ids = [f"{i:032x}" for i in range(1, 8)]
    for n in range(400):
        tid = ids[int(rng.integers(0, len(ids)))]
        t0 = 1_700_000_000.0 + float(rng.uniform(0, 10))
        t1 = None if n % 5 == 0 else t0 + float(rng.uniform(0, 0.2))
        name = ("queue", "prefill_chunk", "first_token",
                "decode_horizon", "finish")[n % 5]
        origin = "engine" if n % 3 else ""
        sp, sr = (port.span(name, t0, t1, origin=origin, step=n),
                  ref.span(name, t0, t1, origin=origin, step=n))
        assert sp == sr
        tp.add(tid, sp)
        tr.add(tid, sr)
    tp.add("", port.span("x", 1.0))      # no trace id: ignored by both
    tr.add("", ref.span("x", 1.0))
    assert tp.trace_ids() == tr.trace_ids()
    assert len(tp) == len(tr) == min(max_traces, len(ids))
    for tid in ids + ["f" * 32]:
        assert tp.get(tid) == tr.get(tid)
    got = [tp.get(t) for t in tp.trace_ids()]
    assert port.Tracer.chrome_events(got) == ref.Tracer.chrome_events(got)
    assert tp.export_chrome() == tr.export_chrome()
    assert tp.export_chrome(ids[:2], pid=3) == tr.export_chrome(ids[:2],
                                                                pid=3)


def test_flight_recorder_matches_reference(frozen_clock):
    """The ring keeps the last ``size`` records (at least 8), dumps freeze
    it with their reason (at most ``max_dumps``), idle ticks are counted."""
    fp, fr = port.FlightRecorder(8, max_dumps=2), ref.FlightRecorder(
        8, max_dumps=2)
    for i in range(21):
        rec = {"tick": i, "tokens": i * 3 % 7, "sync_s": round(i * 1e-4, 6)}
        fp.record(dict(rec))
        fr.record(dict(rec))
        if i % 4 == 0:
            fp.skip_idle()
            fr.skip_idle()
        if i % 6 == 5:
            frozen_clock["t"] += 1.25
            assert (fp.dump("fail_all", error=f"E{i}")
                    == fr.dump("fail_all", error=f"E{i}"))
    assert fp.view() == fr.view()
    assert port.FlightRecorder(3).view() == ref.FlightRecorder(3).view()


HEADERS = [
    None, "", 42, "garbage", "00-abc-def-01",
    f"00-{'a' * 32}-{'b' * 16}-01",
    f"  00-{'0123456789abcdef' * 2}-{'0f' * 8}-00  ",
    f"00-{'0' * 32}-{'b' * 16}-01",             # all-zero trace id
    f"00-{'g' * 32}-{'b' * 16}-01",             # not hex
    f"00-{'a' * 31}-{'b' * 16}-01",             # short trace id
    f"00-{'a' * 32}-{'b' * 15}-01",             # short span id
    f"00-{'a' * 32}-{'b' * 16}",                # three parts
]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_parse_traceparent_matches_reference(header):
    assert port.parse_traceparent(header) == ref.parse_traceparent(header)


def test_trace_ids_and_traceparent_match_reference(monkeypatch):
    """The same uuid4 draws give the same ids and traceparents."""
    made = []
    for mod in (port, ref):
        counter = iter(range(100, 200))
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(counter) * 104729))
        made.append([mod.new_trace_id(), mod.new_span_id(),
                     mod.make_traceparent("c" * 32)])
    a, b = made
    assert a == b
    assert len(a[0]) == 32 and len(a[1]) == 16
    assert port.parse_traceparent(a[2]) == ("c" * 32, a[2].split("-")[2])
    assert (port.make_traceparent("d" * 32, "e" * 16)
            == ref.make_traceparent("d" * 32, "e" * 16)
            == f"00-{'d' * 32}-{'e' * 16}-01")
