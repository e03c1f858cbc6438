"""Admission control, deadlines and drain in the port's engine and HTTP
front end: ports of the JAX package's ``tests/test_serving_faults.py``
tests of them, driving the port engine's transactional ``_tick`` (the
tick its engine thread runs), as the reference's tests drive theirs.

- A deadline covers queue wait and generation: an expired request
  finishes ``"timeout"``, in the queue without ever taking a row or in
  flight at the next tick, and surfaces as HTTP 408 or a terminal SSE
  error event.
- A full bounded queue raises ``EngineOverloaded`` (HTTP 429); a draining
  engine refuses with 503 while /health reports ``draining``.
- A drain finishes the work in flight, or aborts the stragglers at its
  deadline, and an abort the drain made is an error to the client.
- A dead engine fails a waiting HTTP client (500) instead of hanging it.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ipex_llm_tpu_torch.models.random_init import llama_config, random_params
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine, stream_tokens)
from ipex_llm_tpu_torch.serving.faults import EngineOverloaded
from tests.test_torch_api_server import _Tok, _post, _spin_server

EC = dict(max_rows=4, max_seq_len=256, page_size=32, prefill_bucket=32)


@pytest.fixture(scope="module")
def cfg_params():
    cfg = llama_config(hidden_size=48, intermediate_size=96, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=12,
                       vocab_size=131)
    return cfg, random_params(cfg, "bf16", seed=3, device="cpu")


def _engine(cfg_params, **ec):
    cfg, params = cfg_params
    return ServingEngine(cfg, params, EngineConfig(**{**EC, **ec}),
                         device="cpu")


def _ids(cfg, seed, n):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, cfg.vocab_size, n)]


# -- deadlines, admission control, drain --------------------------------------

def test_deadline_expires_in_queue_without_row(cfg_params):
    eng = _engine(cfg_params)
    req = Request(prompt_ids=[1, 2, 3], max_new_tokens=4, deadline_s=0.05)
    req.submitted_s -= 10.0          # aged in the queue
    eng.submit(req)
    eng._tick()
    assert req.finish_reason == "timeout"
    assert eng.metrics["timeouts"] == 1
    assert eng.metrics["requests"] == 0      # never occupied a row
    assert list(stream_tokens(req, timeout=1)) == []


def test_deadline_expires_mid_generation(cfg_params):
    eng = _engine(cfg_params)
    req = Request(prompt_ids=_ids(cfg_params[0], 8, 10), max_new_tokens=64,
                  deadline_s=60.0)
    eng.submit(req)
    for _ in range(5):
        eng._tick()
    assert req.finish_reason is None and len(req.output_ids) > 0
    req.submitted_s -= 120.0         # deadline now past
    eng._tick()
    assert req.finish_reason == "timeout"
    assert eng.metrics["timeouts"] == 1
    # the tokens emitted before the deadline reached the stream
    assert list(stream_tokens(req, timeout=1)) == req.output_ids
    assert eng.alloc.pages_in_use == 0       # the row's pages went back


def test_bounded_queue_load_shedding(cfg_params):
    eng = _engine(cfg_params, max_queue=2)
    eng.submit(Request(prompt_ids=[1]))
    eng.submit(Request(prompt_ids=[2]))
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(Request(prompt_ids=[3]))
    assert ei.value.queue_depth == 2 and not ei.value.draining
    assert eng.metrics["rejected"] == 1
    assert eng.queue_depth == 2


def test_bounded_queue_holds_under_concurrent_submits(cfg_params):
    """Many threads submitting at once (with a short switch interval) never
    queue more than max_queue requests, and every refusal is counted."""
    import sys

    eng = _engine(cfg_params, max_queue=37)
    results = []
    lock = threading.Lock()

    def hammer():
        for _ in range(25):
            try:
                eng.submit(Request(prompt_ids=[1]))
                ok = True
            except EngineOverloaded:
                ok = False
            with lock:
                results.append(ok)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 16 * 25
    assert sum(results) == eng.queue_depth == 37
    assert eng.metrics["rejected"] == len(results) - 37


def test_drain_finishes_in_flight_then_rejects(cfg_params):
    eng = _engine(cfg_params).start()
    try:
        req = Request(prompt_ids=_ids(cfg_params[0], 9, 20),
                      max_new_tokens=8)
        eng.submit(req)
        assert eng.drain(timeout=120)
        assert req.finish_reason == "length"
        assert len(list(stream_tokens(req, timeout=5))) == 8
        assert eng.draining
        with pytest.raises(EngineOverloaded) as ei:
            eng.submit(Request(prompt_ids=[1]))
        assert ei.value.draining
        assert eng.metrics["rejected"] == 1
    finally:
        eng.stop()


def test_drain_deadline_aborts_stragglers(cfg_params):
    eng = _engine(cfg_params).start()
    try:
        req = Request(prompt_ids=_ids(cfg_params[0], 10, 20),
                      max_new_tokens=200)   # outlives the zero-width window
        eng.submit(req)
        clean = eng.drain(timeout=0.0)   # expires immediately
        assert not clean
        assert req.finish_reason == "abort"
        list(stream_tokens(req, timeout=5))   # terminal None arrived
    finally:
        eng.stop()


def test_shed_abort_maps_to_error_not_success():
    """A drain-deadline shed ("abort" without req.cancelled) must surface
    as an error object, never a 200 with truncated text, while a
    client-initiated abort stays a non-failure."""
    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer, _req_failed

    shed = Request(prompt_ids=[1], finish_reason="abort")
    assert _req_failed(shed)
    payload = OpenAIServer._error_payload(shed)
    assert payload["error"]["type"] == "unavailable_error"
    assert payload["error"]["code"] == "server_draining"
    tgi = OpenAIServer._tgi_error_payload(shed)
    assert tgi["error_type"] == "unavailable"

    client_abort = Request(prompt_ids=[1], finish_reason="abort")
    client_abort.cancelled = True
    assert not _req_failed(client_abort)
    for fr, failed in (("error", True), ("timeout", True), ("stop", False),
                       ("length", False), ("stop_string", False)):
        assert _req_failed(Request(prompt_ids=[1], finish_reason=fr)) is failed


# -- HTTP surfaces: 429 / 503 / 408 / error events / draining health ---------

def test_http_deadline_maps_to_408_and_sse_error(cfg_params):
    """An expired deadline surfaces as HTTP 408 with an OpenAI-style error
    object (non-streaming) and as a terminal error event (streaming):
    never a 200 with empty text."""
    pytest.importorskip("aiohttp")
    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer

    eng = _engine(cfg_params, request_deadline_s=0.02).start()
    loop, port, _ = _spin_server(OpenAIServer(eng, _Tok(), "tiny"))
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/completions",
                  {"prompt": "1 2 3", "max_tokens": 64})
        assert ei.value.code == 408
        body = json.loads(ei.value.read())
        assert body["error"]["type"] == "timeout_error"
        assert body["error"]["code"] == "timeout"

        resp = _post(port, "/v1/completions",
                     {"prompt": "4 5 6", "max_tokens": 64, "stream": True})
        events = [json.loads(line.decode().strip()[6:]) for line in resp
                  if line.decode().strip().startswith("data: ")
                  and line.decode().strip() != "data: [DONE]"]
        assert any("error" in e for e in events)

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/generate",
                  {"inputs": "7 8 9", "parameters": {"max_new_tokens": 64}})
        assert ei.value.code == 408
        body = json.loads(ei.value.read())
        assert body["error_type"] == "timeout"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        eng.stop()


def test_http_overload_draining_and_health(cfg_params):
    """End to end: bounded queue -> 429 with queue_depth in /health; drain
    -> the work in flight finishes, /health "draining", submit 503."""
    pytest.importorskip("aiohttp")
    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer

    eng = _engine(cfg_params, max_rows=1, max_seq_len=512, pool_pages=12,
                  max_queue=1).start()
    loop, port, _ = _spin_server(OpenAIServer(eng, _Tok(), "tiny"))
    results = {}

    def slow(name, n):
        try:
            results[name] = _post(port, "/v1/completions",
                                  {"prompt": "1 2 3", "max_tokens": n})
        except urllib.error.HTTPError as e:
            results[name] = e
    try:
        t1 = threading.Thread(target=slow, args=("r1", 300))
        t1.start()
        # wait until r1 occupies the row, then fill the queue with r2
        for _ in range(3000):
            if eng.metrics["requests"] >= 1:
                break
            time.sleep(0.01)
        t2 = threading.Thread(target=slow, args=("r2", 4))
        t2.start()
        for _ in range(500):
            if eng.queue_depth >= 1:
                break
            time.sleep(0.01)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/completions", {"prompt": "9", "max_tokens": 2})
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        body = json.loads(ei.value.read())
        assert body["error"]["code"] == "queue_full"
        assert body["error"]["queue_depth"] == 1

        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30).read())
        assert health["fault_domain"]["queue_depth"] == 1
        assert health["fault_domain"]["rejected"] >= 1

        assert eng.drain(timeout=120)     # r1 and queued r2 run to the end
        t1.join(60)
        t2.join(60)
        assert not isinstance(results["r1"], urllib.error.HTTPError)
        assert not isinstance(results["r2"], urllib.error.HTTPError)

        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30).read())
        assert health["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/completions", {"prompt": "9", "max_tokens": 2})
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["error"]["code"] == (
            "engine_draining")
    finally:
        loop.call_soon_threadsafe(loop.stop)
        eng.stop()


def test_dead_engine_fails_clients_instead_of_hanging(cfg_params):
    """A dead engine thread must fail a waiting HTTP client promptly
    (bounded-wait loop) instead of blocking on the stream queue forever."""
    pytest.importorskip("aiohttp")
    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer

    eng = _engine(cfg_params).start()
    loop, port, _ = _spin_server(OpenAIServer(eng, _Tok(), "tiny"))
    try:
        # kill the engine thread; the request never gets a terminal None
        eng._stop.set()
        eng._thread.join(10)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(port, "/v1/completions",
                  {"prompt": "1 2 3", "max_tokens": 8}, timeout=30)
        assert ei.value.code == 500
        assert json.loads(ei.value.read())["error"]["type"] == "server_error"
        health = urllib.request.Request(f"http://127.0.0.1:{port}/health")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(health, timeout=30)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "dead"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        eng.stop()


def test_http_shutdown_drains_the_engine(cfg_params):
    """Shutting the aiohttp app down drains the engine (a request in flight
    finishes) and then stops its thread."""
    pytest.importorskip("aiohttp")
    import asyncio

    from ipex_llm_tpu_torch.serving.api_server import OpenAIServer

    eng = _engine(cfg_params).start()
    loop, port, runner = _spin_server(OpenAIServer(eng, _Tok(), "tiny",
                                                   drain_timeout_s=60.0))
    req = eng.submit(Request(prompt_ids=_ids(cfg_params[0], 11, 30),
                             max_new_tokens=40))
    try:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(120)
        assert eng.draining
        assert req.finish_reason == "length" and len(req.output_ids) == 40
        assert not eng._thread.is_alive()
    finally:
        loop.call_soon_threadsafe(loop.stop)
        eng.stop()
