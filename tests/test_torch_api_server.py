"""The port's HTTP front end (``ipex_llm_tpu_torch/serving/api_server.py``)
over the port engine on the CPU.

- Ports of the JAX package's HTTP tests (``tests/test_serving.py``):
  completions, two SSE chat streams in flight, a stop string, models and
  health, over aiohttp on 127.0.0.1.
- The route coroutines driven in process through ``OpenAIServer.call``,
  with no transport, so the protocol is held where aiohttp is absent.
- The JAX ``OpenAIServer`` and the port's serving one tiny llama from the
  same weights: the same greedy ``/v1/completions`` and ``/generate``
  bodies give the same text token for token, the same ``finish_reason``
  and the same ``usage``; the ``/health`` blocks both have carry the same
  keys; ``/metrics`` exposes the same series but for the stated
  exceptions.  The prompts are those of ``tests/test_torch_engine.py``'s
  ``GREEDY_SEED``, along whose greedy streams the emitted token leads its
  runner-up by at least five bf16 ulps, so the two sides cannot fork.
- The pure helpers of both servers agree over every finish reason.
"""

import asyncio
import json
import pathlib
import subprocess
import sys
import textwrap
import threading
import urllib.request
import zlib

import pytest

from ipex_llm_tpu_torch.serving.api_server import (EventStream,
                                                   OpenAIServer, Reply,
                                                   _req_failed)
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.serving.faults import EngineOverloaded
from tests.test_torch_decoder import tiny_pair
from tests.test_torch_engine import _prompts

ROOT = pathlib.Path(__file__).resolve().parents[1]
EC = dict(max_rows=2, max_seq_len=128, page_size=16, prefill_bucket=32)
VOCAB = 256


class _Tok:
    """Id-passthrough tokenizer: a number is its id (mod the vocabulary),
    any other word a fixed hash of it."""

    eos_token_id = None
    chat_template = None

    def __call__(self, text):
        def tid(x):
            try:
                return int(x) % VOCAB
            except ValueError:
                return zlib.crc32(x.encode()) % VOCAB
        return {"input_ids": [tid(x) for x in text.split()]}

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _spin_server(srv):
    """Serve ``srv.app`` on 127.0.0.1 at a free port from a thread of its
    own; returns (loop, port, runner)."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(srv.app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        holder["port"] = site._server.sockets[0].getsockname()[1]
        holder["runner"] = runner
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(30)
    return loop, holder["port"], holder["runner"]


def _post(port, path, body, timeout=120, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=30).read()


def _run(coro):
    return asyncio.run(coro)


async def _frames(stream: EventStream) -> list:
    """The JSON payloads of an event stream, and "[DONE]" where sent."""
    out = []
    async for frame in stream.events:
        line = frame.decode()
        assert line.startswith("data: ") and line.endswith("\n\n")
        body = line[6:].strip()
        out.append(body if body == "[DONE]" else json.loads(body))
    return out


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("bf16")


@pytest.fixture(scope="module")
def server(pair):
    _, _, port_cfg, port_params = pair
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(trace_requests=True, **EC),
                        device="cpu").start()
    yield OpenAIServer(eng, _Tok(), "tiny")
    eng.stop()


@pytest.fixture(scope="module")
def http_server(server):
    pytest.importorskip("aiohttp")
    loop, port, _ = _spin_server(server)
    yield port
    loop.call_soon_threadsafe(loop.stop)


# -- ports of tests/test_serving.py's HTTP tests ------------------------------

def test_http_completions(http_server):
    body = json.loads(_post(http_server, "/v1/completions",
                            {"prompt": "1 2 3 4 5 6",
                             "max_tokens": 6}).read())
    assert body["object"] == "text_completion"
    assert len(body["choices"][0]["text"].split()) == 6


def test_http_chat_stream_two_in_flight(http_server):
    """Two streaming chat requests in flight; both must complete."""
    results = {}

    def worker(name, msg):
        resp = _post(http_server, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": msg}],
            "max_tokens": 8, "stream": True})
        chunks = []
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                chunks.append(json.loads(line[6:]))
        results[name] = chunks

    threads = [threading.Thread(target=worker, args=a)
               for a in (("a", "7 8 9 10"), ("b", "11 12 13 14 15"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for name in ("a", "b"):
        chunks = results[name]
        pieces = [c["choices"][0]["delta"].get("content", "")
                  for c in chunks]
        assert sum(1 for p in pieces if p) == 8
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"


def test_http_stop_sequence(http_server):
    """A stop string truncates output and finishes with reason 'stop'."""
    body = {"prompt": "20 21 22 23 24", "max_tokens": 6, "temperature": 0.0}
    full = json.loads(_post(http_server, "/v1/completions", body).read())[
        "choices"][0]["text"].split()
    stop_word = full[2]
    got = json.loads(_post(http_server, "/v1/completions",
                           dict(body, stop=stop_word)).read())
    assert stop_word not in got["choices"][0]["text"].split()
    assert got["choices"][0]["finish_reason"] == "stop"


def test_http_models_and_health(http_server):
    body = json.loads(_get(http_server, "/v1/models"))
    assert body["data"][0]["id"] == "tiny"
    health = json.loads(_get(http_server, "/health"))
    assert health["status"] == "ok"
    dec = health["decode"]
    assert set(dec) == {"tokens_per_sync", "host_sync_s",
                        "decode_horizon_effective", "mixed_steps",
                        "prefill_tokens_per_step", "ttft_p95_s"}
    assert dec["host_sync_s"] >= 0.0
    assert dec["ttft_p95_s"] >= 0.0


def test_http_traceparent_and_metrics(http_server):
    """A W3C traceparent header keys the engine's spans; /metrics serves
    Prometheus text and JSON over the transport."""
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    _post(http_server, "/v1/completions", {"prompt": "3 4 5",
                                           "max_tokens": 3},
          headers={"traceparent": f"00-{tid}-00f067aa0ba902b7-01"}).read()
    trace = json.loads(_get(http_server, f"/trace/{tid}"))
    assert {"queue", "first_token", "finish"} <= {
        s["name"] for s in trace["spans"]}
    text = _get(http_server, "/metrics").decode()
    assert "ipex_llm_tpu_ttft_s_count" in text
    js = json.loads(_get(http_server, "/metrics?format=json"))
    assert js["metrics"]["tokens"] > 0 and "ttft_s" in js["histograms"]


# -- the route coroutines, with no transport ----------------------------------

def test_call_completions_with_logprobs(server):
    r = _run(server.call("POST", "/v1/completions",
                         {"prompt": "9 8 7 6", "max_tokens": 5,
                          "temperature": 0, "logprobs": True}))
    assert isinstance(r, Reply) and r.status == 200
    ch = r.body["choices"][0]
    assert ch["finish_reason"] == "length"
    assert ch["logprobs"]["tokens"] == ch["text"].split()
    lps = ch["logprobs"]["token_logprobs"]
    assert len(lps) == 5 and all(lp <= 0 for lp in lps)
    assert r.body["usage"] == {"prompt_tokens": 4, "completion_tokens": 5,
                               "total_tokens": 9}


def test_call_chat_stream_and_whole_agree(server):
    """A greedy chat request streamed and whole: the same text, the
    stream's frames in the OpenAI chunk shape, then [DONE]."""
    body = {"messages": [{"role": "user", "content": "10 20 30"}],
            "max_tokens": 6, "temperature": 0}
    whole = _run(server.call("POST", "/v1/chat/completions", body))
    stream = _run(server.call("POST", "/v1/chat/completions",
                              dict(body, stream=True)))
    assert isinstance(stream, EventStream)
    assert stream.headers["Content-Type"] == "text/event-stream"
    frames = _run(_frames(stream))
    assert frames[-1] == "[DONE]"
    chunks = frames[:-1]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    msg = whole.body["choices"][0]
    assert text == msg["message"]["content"]
    assert msg["finish_reason"] == chunks[-1]["choices"][0][
        "finish_reason"] == "length"
    assert whole.body["usage"]["completion_tokens"] == 6


def test_call_tgi_generate_and_stream(server):
    """TGI: /generate's generated_text equals /generate_stream's, whose
    token events carry ids and logprobs and whose last event the details;
    a stop sequence finishes "stop_sequence"."""
    body = {"inputs": "5 15 25 35", "parameters": {"max_new_tokens": 5}}
    whole = _run(server.call("POST", "/generate", body))
    assert whole.status == 200
    assert whole.body["details"] == {"finish_reason": "length",
                                     "generated_tokens": 5, "prefill": []}
    frames = _run(_frames(_run(server.call("POST", "/generate_stream",
                                           body))))
    assert "[DONE]" not in frames
    tokens, last = frames[:-1], frames[-1]
    assert len(tokens) == 5
    assert all(f["token"]["logprob"] <= 0 for f in tokens)
    assert " ".join(str(f["token"]["id"]) for f in tokens) == last[
        "generated_text"] == whole.body["generated_text"]
    assert last["details"]["finish_reason"] == "length"
    stop = whole.body["generated_text"].split()[1]
    cut = _run(server.call("POST", "/generate", {
        "inputs": body["inputs"],
        "parameters": {"max_new_tokens": 5, "stop": [stop]}}))
    assert cut.body["details"]["finish_reason"] == "stop_sequence"
    assert stop not in cut.body["generated_text"].split()


def test_call_metrics_text_and_json(server):
    _run(server.call("POST", "/v1/completions", {"prompt": "1 1 2 3",
                                                  "max_tokens": 4}))
    text = _run(server.call("GET", "/metrics"))
    assert isinstance(text.body, str)
    series = {}
    for line in text.body.splitlines():
        name, _, value = line.rpartition(" ")
        assert f'replica_id="{server.replica_id}"' in name
        series[name.split("{")[0]] = float(value)
    for name in ("tokens", "ticks", "host_sync_s", "queue_depth",
                 "rejected", "timeouts", "kv_pages_total",
                 "weights_weight_bytes", "uptime_s"):
        assert f"ipex_llm_tpu_{name}" in series, name
    for hist in ("ttft_s", "token_latency_s", "tick_sync_s"):
        assert series[f"ipex_llm_tpu_{hist}_count"] > 0
    js = _run(server.call("GET", "/metrics?format=json")).body
    assert js["replica_id"] == server.replica_id
    assert js["metrics"]["tokens"] == series["ipex_llm_tpu_tokens"]
    h = js["histograms"]["ttft_s"]
    assert sum(h["counts"]) == h["count"] > 0


def test_call_trace_and_debug_routes(server):
    tid = "0af7651916cd43dd8448eb211c80319c"
    r = _run(server.call("POST", "/v1/completions",
                         {"prompt": "2 4 6 8 10", "max_tokens": 4,
                          "traceparent": f"00-{tid}-b7ad6b7169203331-01"}))
    assert r.status == 200
    trace = _run(server.call("GET", f"/trace/{tid}")).body
    names = [s["name"] for s in trace["spans"]]
    for want in ("queue", "prefill_chunk", "first_token", "finish"):
        assert want in names
    assert "decode_horizon" in names
    assert trace["spans"][names.index("finish")]["attrs"] == {
        "reason": "length", "output_tokens": 4}
    chrome = _run(server.call("GET", f"/trace/{tid}",
                              query={"format": "chrome"})).body
    assert {e["ph"] for e in chrome["traceEvents"]} >= {"M", "X", "i"}
    ids = _run(server.call("GET", "/debug/traces")).body["trace_ids"]
    assert tid in ids
    assert _run(server.call("GET", "/trace/" + "9" * 32)).status == 404
    flight = _run(server.call("GET", "/debug/flight")).body
    assert flight["recorded"] > 0 and flight["ring"]
    rec = flight["ring"][-1]
    assert set(rec) == {"t", "tick", "dispatches", "sync_s", "rows_active",
                        "rows_prefilling", "queue_depth", "tokens",
                        "admitted", "pages_in_use", "pages_delta",
                        "prefix_evictions", "alloc_fail_clamps", "retries"}


def test_call_isolated_fault_and_health(pair):
    """A request bound to a poisoned fault gets the error object of an
    isolated failure (500, ``server_error``) while a request beside it
    completes; /health counts the retry of a transient fault and the
    isolation, reports "degraded" while the isolation is the engine's last
    event and "ok" again after a committed tick."""
    import threading

    from ipex_llm_tpu_torch.serving.faults import (DeterministicFault,
                                                   FaultInjector,
                                                   TransientFault)

    _, _, port_cfg, port_params = pair
    inj = (FaultInjector()
           .inject("mixed-step", TransientFault)
           .inject("decode-dispatch", DeterministicFault,
                   request_id="poisoned", times=None))
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(retry_backoff_s=0.001, **EC),
                        device="cpu", fault_injector=inj)
    poison = [7, 7, 7, 7]
    real_submit, real_tick = eng.submit, eng._tick
    held, release = threading.Event(), threading.Event()

    def submit(req):
        if req.prompt_ids == poison:    # bind the fault to this request
            req.request_id = "poisoned"
        return real_submit(req)

    def tick():
        # hold the engine thread after the isolation, before any
        # committed tick could clear it
        committed = real_tick()
        if eng.metrics["errors_isolated"] and not release.is_set():
            held.set()
            release.wait(60)
        return committed

    eng.submit, eng._tick = submit, tick
    srv = OpenAIServer(eng.start(), _Tok(), "tiny")

    async def scenario():
        bad = asyncio.create_task(srv.call(
            "POST", "/v1/completions", {"prompt": "7 7 7 7",
                                        "max_tokens": 6}))
        good = asyncio.create_task(srv.call(
            "POST", "/v1/completions", {"prompt": "1 2 3 4 5",
                                        "max_tokens": 8}))
        assert await asyncio.get_running_loop().run_in_executor(
            None, held.wait, 60)
        degraded = (await srv.call("GET", "/health")).body
        release.set()
        return await bad, await good, degraded

    try:
        bad, good, degraded = _run(scenario())
        assert bad.status == 500
        assert bad.body["error"]["type"] == "server_error"
        assert bad.body["error"]["code"] == "error"
        assert good.status == 200
        assert good.body["choices"][0]["finish_reason"] == "length"
        assert len(good.body["choices"][0]["text"].split()) == 8
        assert degraded["status"] == "degraded"
        assert "isolated to request poisoned" in degraded["last_error"]
        for _ in range(500):
            health = _run(srv.call("GET", "/health")).body
            if health["status"] == "ok":
                break
            threading.Event().wait(0.01)
        assert health["status"] == "ok" and "last_error" not in health
        assert health["fault_domain"]["errors_isolated"] == 1
        assert health["fault_domain"]["retries"] >= 1
        assert eng.metrics.get("errors", 0) == 0
    finally:
        release.set()
        eng.stop()


def test_call_refusals(server):
    """Unknown routes 404, a wrong method 405, response_format 400, and a
    bounded queue or a draining engine 429/503 with Retry-After."""
    assert _run(server.call("GET", "/v1/nothing")).status == 404
    r = _run(server.call("GET", "/v1/completions"))
    assert r.status == 405 and r.headers["Allow"] == "POST"
    r = _run(server.call("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "1"}],
        "response_format": {"type": "json_object"}}))
    assert r.status == 400
    assert r.body["error"]["code"] == "unsupported_response_format"

    class Full:
        ec = EngineConfig(max_rows=2)
        drain_seconds_left = 7.2

        def __init__(self, draining):
            self.draining = draining

        def submit(self, req):
            raise EngineOverloaded("refused", queue_depth=5,
                                   draining=self.draining)

    for draining, status, code, retry in ((False, 429, "queue_full", "3"),
                                          (True, 503, "engine_draining",
                                           "8")):
        srv = OpenAIServer(Full(draining), _Tok(), "tiny")
        r = _run(srv.call("POST", "/v1/completions", {"prompt": "1"}))
        assert r.status == status and r.headers == {"Retry-After": retry}
        assert r.body["error"] == {"message": "refused",
                                   "type": "overloaded_error", "code": code,
                                   "queue_depth": 5}


def test_stream_closed_early_aborts_the_request(server):
    """A reader that goes away mid-stream (the transport closes the event
    iterator) aborts the request, and its row frees."""
    stream = _run(server.call("POST", "/v1/completions",
                              {"prompt": "4 4 4", "max_tokens": 100,
                               "stream": True}))

    async def first_then_close():
        agen = stream.events
        first = await agen.__anext__()
        await agen.aclose()
        return first

    assert b'"text"' in _run(first_then_close())
    req = stream.request
    assert req.cancelled
    for _ in range(400):
        if req.finish_reason is not None:
            break
        threading.Event().wait(0.05)
    assert req.finish_reason == "abort" and len(req.output_ids) < 100
    assert req not in server.engine.rows
    assert not _req_failed(req)     # a client abort is no server failure


# -- against the JAX server ---------------------------------------------------

def test_server_matches_reference_server(pair, http_server):
    """The JAX OpenAIServer and the port's, one tiny llama from the same
    weights: greedy text, finish_reason and usage token for token over
    /v1/completions and /generate; the /health blocks both have carry the
    same keys; /metrics the same series but for the stated exceptions."""
    from ipex_llm_tpu.serving.api_server import OpenAIServer as RefServer
    from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
    from ipex_llm_tpu.serving.engine import ServingEngine as RefEngine

    cfg, params, _, _ = pair
    ref_eng = RefEngine(cfg, params, RefEngineConfig(
        planner="static", perfwatch=False, **EC)).start()
    loop, ref_port, _ = _spin_server(RefServer(ref_eng, _Tok(), "tiny"))
    port_port = http_server
    try:
        prompts = [" ".join(map(str, ids)) for ids, _ in _prompts(VOCAB)]
        for i, text in enumerate(prompts):
            if i % 2 == 0:
                path, body = "/v1/completions", {
                    "prompt": text, "max_tokens": 6, "temperature": 0}
            else:
                path, body = "/generate", {
                    "inputs": text, "parameters": {"max_new_tokens": 6}}
            got = [json.loads(_post(p, path, body).read())
                   for p in (ref_port, port_port)]
            if path == "/generate":
                assert got[0] == got[1]
                assert got[1]["details"]["generated_tokens"] == 6
                continue
            want, mine = (g["choices"][0] for g in got)
            assert mine["text"] == want["text"]
            assert len(mine["text"].split()) == 6
            assert mine["finish_reason"] == want["finish_reason"] == "length"
            assert got[1]["usage"] == got[0]["usage"]
        health = [json.loads(_get(p, "/health")) for p in (ref_port,
                                                            port_port)]
        for block in ("decode", "kv", "weights", "fault_domain"):
            assert set(health[1][block]) == set(health[0][block]), block
        assert health[1]["status"] == health[0]["status"] == "ok"
        names = []
        for p in (ref_port, port_port):
            names.append({line.split("{")[0] for line in
                          _get(p, "/metrics").decode().splitlines()})
        ref_only = {n for n in names[0]
                    if n.startswith("ipex_llm_tpu_perf_")
                    or n.startswith("ipex_llm_tpu_swap_in_s")}
        # the port's horizon loop reads the rows' liveness once a step;
        # the reference's on-device loop has no such read
        port_only = {"ipex_llm_tpu_liveness_syncs"}
        assert names[1] - port_only == names[0] - ref_only
        assert port_only <= names[1]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        ref_eng.stop()


FINISH = [None, "stop", "length", "abort", "error", "timeout", "stop_string"]


@pytest.mark.parametrize("cancelled", [False, True])
@pytest.mark.parametrize("finish", FINISH)
def test_pure_helpers_match_reference(finish, cancelled):
    from ipex_llm_tpu.serving import api_server as ref_api
    from ipex_llm_tpu.serving.engine import Request as RefRequest

    mine = Request(prompt_ids=[1], finish_reason=finish, cancelled=cancelled)
    theirs = RefRequest(prompt_ids=[1], finish_reason=finish,
                        cancelled=cancelled)
    Ref = ref_api.OpenAIServer
    assert _req_failed(mine) == ref_api._req_failed(theirs)
    assert OpenAIServer._openai_reason(finish) == Ref._openai_reason(finish)
    assert OpenAIServer._tgi_reason(finish) == Ref._tgi_reason(finish)
    assert OpenAIServer._error_payload(mine) == Ref._error_payload(theirs)
    assert (OpenAIServer._tgi_error_payload(mine)
            == Ref._tgi_error_payload(theirs))
    assert OpenAIServer._find_stop("a b c b", ["b", "c", ""]) == \
        Ref._find_stop("a b c b", ["b", "c", ""]) == 2


@pytest.mark.parametrize("draining", [False, True])
def test_retry_after_matches_reference(draining):
    from ipex_llm_tpu.serving.api_server import OpenAIServer as RefServer
    from ipex_llm_tpu.serving.faults import EngineOverloaded as RefOverloaded

    class Eng:
        def __init__(self, rows, left):
            self.ec = EngineConfig(max_rows=rows)
            self.drain_seconds_left = left

    class Holder:
        def __init__(self, eng):
            self.engine = eng

    for rows in (0, 1, 3, 16):
        for depth in (0, 1, 5, 17, 400):
            for left in (0.0, 0.4, 29.9):
                h = Holder(Eng(rows, left))
                assert (OpenAIServer._retry_after_s(
                    h, EngineOverloaded("x", depth, draining))
                    == RefServer._retry_after_s(
                        h, RefOverloaded("x", depth, draining)))


def test_api_server_imports_without_aiohttp():
    """With aiohttp (and JAX) unimportable the module imports, the routes
    serve in process, and only ``app`` asks for aiohttp."""
    code = textwrap.dedent("""
        import asyncio, sys
        sys.modules["aiohttp"] = None
        sys.modules["jax"] = None
        from ipex_llm_tpu_torch.serving.api_server import OpenAIServer

        class Eng:
            pass

        srv = OpenAIServer(Eng(), None, "m")
        r = asyncio.run(srv.call("GET", "/v1/models"))
        assert r.status == 200 and r.body["data"][0]["id"] == "m"
        try:
            srv.app
        except ImportError as e:
            assert "aiohttp" in str(e)
        else:
            raise AssertionError("app built without aiohttp")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
