"""OpenAI- and TGI-compatible HTTP front end over the port's
``ServingEngine`` (port of ``ipex_llm_tpu/serving/api_server.py``).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions`` (both
with server-sent events under ``"stream": true``; completions with
chosen-token ``logprobs``), ``GET /v1/models``, ``GET /health``, ``GET
/metrics`` (Prometheus text, or JSON with ``?format=json``), the TGI
``POST /generate`` and ``POST /generate_stream``, and the observability
routes ``GET /trace/{trace_id}``, ``GET /debug/traces`` and ``GET
/debug/flight``.

Admission maps onto HTTP: a full bounded queue is 429 and a draining
engine 503, both with ``Retry-After``; a request whose deadline expired is
408, one the drain shed 503, one the engine failed 500 (or, once a stream
has begun, a terminal error event).  A client that goes away mid-stream
has its request aborted.  On shutdown the server drains the engine.

Every route's logic is a coroutine free of any transport: it takes the
parsed JSON body, the request headers and the query, and returns a
``Reply`` (status, headers, a JSON or text body) or an ``EventStream``
(an async iterator of server-sent-event frames).  ``OpenAIServer.call``
routes a method and path to them in process; ``OpenAIServer.app`` wraps
them in aiohttp routes and imports aiohttp only then, so this module
imports, and its protocol can be driven, where aiohttp is absent.

To serve a checkpoint directory (an HF one, or a ``save_low_bit`` one)::

    ipex-llm-tpu-torch-serve --model DIR --low-bit sym_int4 --port 8000

or from Python, ``build_server(DIR)`` (it loads the checkpoint through
``from_pretrained`` or ``load_low_bit`` and starts the engine) and
``web.run_app(srv.app, ...)``; an engine built by hand serves the same
way through ``OpenAIServer(engine.start(), tokenizer, name)``.

Tensor-parallel serving (``--tensor-parallel-size N``, or
``build_server(DIR, tensor_parallel_size=N)``): this process is rank 0
and starts the N - 1 follower ranks itself (spawned processes that meet
it through a ``FileStore`` in a temporary directory), each loading the
checkpoint and running its rank's engine in lockstep
(``serving/engine.py``); rank 0 serves HTTP, and ``stop`` of its engine
ends them.  The backend is NCCL, one card a rank (rank r on ``cuda:r``),
unless ``--tp-backend gloo`` (``tp_backend="gloo"``) names gloo, which
runs every rank on ``--device`` (one card, or the CPU) with its
collectives through the host.  ``--collective-qtype`` is the all-reduce's
wire family.  ``/health`` then reports a ``parallel`` block.

Left out, with the ROADMAP items that bring them: ``/kv/prefill`` and
``/kv/import`` (item 11, KV transport and the spill tier); the ``perf``,
``planner`` and ``dispatch`` blocks of ``/health`` and ``/debug/profile``
(item 10, the planner and perfwatch); ``response_format`` (item 12, structured
decoding: refused with 400 here); ``/v1/audio/transcriptions`` (item 14,
whisper).  ``main`` refuses the flags of those machines by name.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Mapping

from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine,
                                               default_weight_qtype,
                                               next_stream_item,
                                               resolve_load_low_bit)
from ipex_llm_tpu_torch.serving.faults import EngineOverloaded
from ipex_llm_tpu_torch.serving.observe import Tracer, parse_traceparent


def _now() -> int:
    return int(time.time())


def _req_failed(req: Request) -> bool:
    """True when the request's terminal state is a server-side failure the
    client must see as an error object: an engine fault, an expired
    deadline, or a server-initiated abort (a drain's shed).  A
    client-initiated abort (``req.cancelled``: a disconnect or a stop
    string) is not a failure: the client asked for it."""
    return (req.finish_reason in ("error", "timeout")
            or (req.finish_reason == "abort" and not req.cancelled))


def _sse(obj) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


@dataclass
class Reply:
    """A whole response: a dict or list body is JSON, a str body text."""
    status: int = 200
    body: Any = None
    headers: dict[str, str] = field(default_factory=dict)


@dataclass
class EventStream:
    """A server-sent-event response: ``events`` yields each frame
    (``data: {...}\\n\\n``) of the engine request ``request``.  Closing
    it before its end (``aclose()``, what a transport does when the client
    goes away) aborts the request."""
    events: AsyncIterator[bytes]
    request: Request
    status: int = 200
    headers: dict[str, str] = field(default_factory=lambda: {
        "Content-Type": "text/event-stream", "Cache-Control": "no-cache"})


class Refused(Exception):
    """A route's early answer (429, 503, 400): the reply to send."""

    def __init__(self, reply: Reply):
        super().__init__(reply.status)
        self.reply = reply


def _match(pattern: str, path: str) -> dict[str, str] | None:
    """The ``{name}`` segments of ``pattern`` that ``path`` binds, or
    None when it does not match."""
    want, got = pattern.split("/"), path.split("/")
    if len(want) != len(got):
        return None
    params = {}
    for w, g in zip(want, got):
        if w.startswith("{") and w.endswith("}"):
            if not g:
                return None
            params[w[1:-1]] = urllib.parse.unquote(g)
        elif w != g:
            return None
    return params


class OpenAIServer:
    # (method, path, route coroutine)
    ROUTES = (
        ("POST", "/v1/chat/completions", "chat"),
        ("POST", "/v1/completions", "completions"),
        ("GET", "/v1/models", "models"),
        ("GET", "/health", "health"),
        ("GET", "/metrics", "metrics"),
        ("POST", "/generate", "tgi_generate"),
        ("POST", "/generate_stream", "tgi_generate_stream"),
        ("GET", "/trace/{trace_id}", "trace_get"),
        ("GET", "/debug/traces", "traces_export"),
        ("GET", "/debug/flight", "debug_flight"),
    )

    def __init__(self, engine: ServingEngine, tokenizer, model_name: str,
                 drain_timeout_s: float = 30.0):
        self.engine = engine
        self.tok = tokenizer
        self.model_name = model_name
        self.drain_timeout_s = drain_timeout_s
        # replica identity for a router: a uuid per server start (a
        # restart mints a new one) and the uptime /health reports
        self.replica_id = uuid.uuid4().hex
        self.started_monotonic = time.monotonic()
        self._app = None

    # -- transports ---------------------------------------------------------

    async def call(self, method: str, path: str, body: dict | None = None,
                   headers: Mapping[str, str] | None = None,
                   query: Mapping[str, str] | None = None
                   ) -> Reply | EventStream:
        """Serve one request in process: the route's ``Reply`` or
        ``EventStream``, or a 404/405 reply.  A query string in ``path`` is
        merged into ``query``; header names match in any case."""
        path, _, qs = path.partition("?")
        q = dict(urllib.parse.parse_qsl(qs))
        q.update(query or {})
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        allowed = []
        for m, pattern, name in self.ROUTES:
            params = _match(pattern, path)
            if params is None:
                continue
            if m != method:
                allowed.append(m)
                continue
            return await self._dispatch(name, body or {}, hdrs, q, params)
        if allowed:
            return Reply(405, {"error": {
                "message": f"{method} not allowed on {path}",
                "type": "invalid_request_error",
                "code": "method_not_allowed"}},
                {"Allow": ", ".join(allowed)})
        return Reply(404, {"error": {"message": f"no route {path!r}",
                                     "type": "invalid_request_error",
                                     "code": "not_found"}})

    async def _dispatch(self, name: str, body: dict, headers, query,
                        params: Mapping[str, str]) -> Reply | EventStream:
        try:
            return await getattr(self, name)(body, headers, query, **params)
        except Refused as e:
            return e.reply

    @property
    def app(self):
        """The aiohttp ``web.Application`` serving every route (built on
        first use; aiohttp is imported only here)."""
        if self._app is None:
            try:
                from aiohttp import web
            except ImportError as e:
                raise ImportError(
                    f"aiohttp is required to serve over HTTP ({e}); "
                    "OpenAIServer.call serves in process without it") from e
            app = web.Application()
            for method, path, name in self.ROUTES:
                app.router.add_route(method, path,
                                     self._aiohttp_route(name, web))
            # graceful drain: aiohttp's shutdown awaits on_shutdown before
            # it closes connections, so requests in flight finish inside
            # the drain window while /health reports "draining"
            app.on_shutdown.append(self._on_shutdown)
            self._app = app
        return self._app

    def _aiohttp_route(self, name: str, web):
        async def handler(request):
            body = await request.json() if request.method == "POST" else {}
            out = await self._dispatch(name, body, request.headers,
                                       request.query, request.match_info)
            if isinstance(out, Reply):
                if isinstance(out.body, str):
                    return web.Response(text=out.body, status=out.status,
                                        headers=out.headers,
                                        content_type="text/plain")
                return web.json_response(out.body, status=out.status,
                                         headers=out.headers)
            resp = web.StreamResponse(status=out.status, headers=out.headers)
            await resp.prepare(request)
            try:
                async for frame in out.events:
                    await resp.write(frame)
                await resp.write_eof()
            except (ConnectionResetError, asyncio.CancelledError):
                await out.events.aclose()   # the client went away: abort
                raise
            return resp
        return handler

    async def _on_shutdown(self, app):
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.engine.drain,
                                   self.drain_timeout_s)
        self.engine.stop()

    # -- helpers ------------------------------------------------------------

    def _encode_chat(self, messages: list[dict]) -> list[int]:
        if hasattr(self.tok, "apply_chat_template") and getattr(
                self.tok, "chat_template", None):
            return list(self.tok.apply_chat_template(
                messages, add_generation_prompt=True))
        text = "\n".join(f"{m['role']}: {m['content']}" for m in messages)
        text += "\nassistant:"
        return list(self.tok(text)["input_ids"])

    def _mk_request(self, body: dict, prompt_ids: list[int],
                    headers=None) -> Request:
        def num(key, default, cast):
            v = body.get(key)
            return cast(default if v is None else v)

        # W3C trace context: the HTTP header wins, the body field is the
        # carrier of callers that cannot set headers; either way the
        # engine's spans key to the caller's trace id
        tp = parse_traceparent((headers or {}).get("traceparent")
                               or body.get("traceparent"))
        eos: tuple[int, ...] = ()
        if self.tok.eos_token_id is not None:
            eos = (int(self.tok.eos_token_id),)
        req = Request(
            prompt_ids=prompt_ids,
            max_new_tokens=num("max_tokens", 128, int),
            # the OpenAI API's defaults: temperature 1.0, top_p 1.0
            temperature=num("temperature", 1.0, float),
            top_p=num("top_p", 1.0, float),
            top_k=int(body.get("top_k") or 0),
            seed=(int(body["seed"]) if body.get("seed") is not None
                  else None),
            eos_token_id=eos,
            request_id=str(uuid.uuid4()),
            # wall-clock budget covering queue wait and generation
            deadline_s=(float(body["deadline_s"])
                        if body.get("deadline_s") else None),
            trace_id=tp[0] if tp else None,
        )
        stop = body.get("stop")
        req.stop_strings = ([stop] if isinstance(stop, str) else stop) or []
        return req

    @staticmethod
    def _find_stop(text: str, stops: list[str]) -> int:
        """Earliest stop-sequence offset in ``text``, or -1."""
        hits = [text.find(s) for s in stops if s and text.find(s) >= 0]
        return min(hits) if hits else -1

    # Finish reasons: the engine's "stop" (EOS), "length", "abort", "error"
    # (an engine failure) and "timeout" (a deadline), and the server's
    # "stop_string" (stop-sequence truncation).  The OpenAI surface maps
    # stop_string to "stop" and answers error, timeout and a server-side
    # abort (_req_failed) with error objects (HTTP 500/408/503, or a
    # terminal SSE error event); the TGI surface maps stop to "eos_token",
    # stop_string to "stop_sequence" and failures to its {"error",
    # "error_type"} shape.
    @staticmethod
    def _openai_reason(fr: str | None) -> str | None:
        return "stop" if fr == "stop_string" else fr

    def _retry_after_s(self, e: EngineOverloaded) -> int:
        """Retry-After of a refused submission.  Draining: the rest of the
        drain window.  Queue full: the backlog in waves of the engine's
        rows (a queue of depth D ahead of R rows clears in about D/R
        admission waves), clamped to [1, 30] seconds."""
        if e.draining:
            return max(1, int(self.engine.drain_seconds_left) + 1)
        rows = max(1, self.engine.ec.max_rows)
        return max(1, min(30, -(-e.queue_depth // rows)))

    def _submit(self, req: Request) -> Request:
        """Engine submit with load shedding mapped onto HTTP: a full
        bounded queue is 429 (retry later), a draining engine 503 (this
        replica is going away), both OpenAI-style error objects with a
        Retry-After."""
        try:
            return self.engine.submit(req)
        except EngineOverloaded as e:
            raise Refused(Reply(
                503 if e.draining else 429,
                {"error": {"message": str(e), "type": "overloaded_error",
                           "code": ("engine_draining" if e.draining
                                    else "queue_full"),
                           "queue_depth": e.queue_depth}},
                {"Retry-After": str(self._retry_after_s(e))})) from None

    @staticmethod
    def _error_payload(req: Request) -> dict:
        if req.finish_reason == "timeout":
            return {"error": {"message": "request deadline exceeded "
                                         "(queue wait + generation)",
                              "type": "timeout_error", "code": "timeout"}}
        if req.finish_reason == "abort":
            return {"error": {"message": "request aborted: server "
                                         "draining (retry elsewhere)",
                              "type": "unavailable_error",
                              "code": "server_draining"}}
        return {"error": {"message": "request failed in the engine "
                                     "(isolated fault)",
                          "type": "server_error", "code": "error"}}

    @staticmethod
    def _error_status(req: Request) -> int:
        return {"timeout": 408, "abort": 503}.get(req.finish_reason, 500)

    async def _next_tok(self, req: Request) -> int | None:
        """One stream item through the engine's dead-engine-detecting
        fetch, off the event loop."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, next_stream_item,
                                          self.engine, req)

    async def _collect(self, req: Request) -> str:
        toks: list[int] = []
        drop = set(req.eos_token_id)
        while True:
            tok = await self._next_tok(req)
            if tok is None:
                break
            if tok in drop:
                continue
            toks.append(tok)
            if req.stop_strings:
                text = self.tok.decode(toks)
                cut = self._find_stop(text, req.stop_strings)
                if cut >= 0:
                    self.engine.abort(req)
                    req.finish_reason = "stop_string"
                    return text[:cut]
        return self.tok.decode(toks)

    def _stream_sse(self, req: Request, chunk_fn, final_fn=None,
                    send_done: bool = True, error_fn=None) -> EventStream:
        """The streaming loop of both surfaces.  ``chunk_fn(piece, finish,
        tok)`` renders one incremental event; ``final_fn(sent_text,
        finish_reason)`` (optional) renders the terminal event in place of
        ``chunk_fn("", finish, None)``; ``error_fn(req)`` (optional) renders
        the terminal error event of a failed request in the surface's own
        shape."""
        async def events():
            drop = set(req.eos_token_id)
            stops = req.stop_strings
            sent = ""
            toks: list[int] = []
            ended = False
            try:
                while True:
                    tok = await self._next_tok(req)
                    if tok is None:
                        break
                    if tok in drop:
                        continue
                    toks.append(tok)
                    text = self.tok.decode(toks)
                    cut = self._find_stop(text, stops) if stops else -1
                    if cut >= 0:
                        piece, done = text[:cut][len(sent):], True
                    else:
                        piece, done = text[len(sent):], False
                    if piece:
                        sent += piece
                        yield _sse(chunk_fn(piece, None, tok))
                    if done:
                        self.engine.abort(req)
                        req.finish_reason = "stop_string"
                        break
                if _req_failed(req):
                    # the stream's 200 status line is already out: an
                    # error object in the stream is the OpenAI convention
                    yield _sse((error_fn or self._error_payload)(req))
                else:
                    yield _sse(final_fn(sent, req.finish_reason) if final_fn
                               else chunk_fn("", req.finish_reason, None))
                if send_done:
                    yield b"data: [DONE]\n\n"
                ended = True
            finally:
                if not ended:
                    # the reader went away: free the engine row instead of
                    # decoding on
                    self.engine.abort(req)
        return EventStream(events(), req)

    def _usage(self, req: Request) -> dict:
        return {"prompt_tokens": len(req.prompt_ids),
                "completion_tokens": len(req.output_ids),
                "total_tokens": len(req.prompt_ids) + len(req.output_ids)}

    # -- OpenAI routes ------------------------------------------------------

    async def chat(self, body: dict, headers=None, query=None):
        rf = body.get("response_format") or {}
        if rf.get("type") in ("json_object", "json_schema"):
            return Reply(400, {"error": {
                "message": "response_format (constrained JSON decoding) is "
                           "not supported by this server",
                "type": "invalid_request_error",
                "code": "unsupported_response_format"}})
        ids = self._encode_chat(body.get("messages", []))
        req = self._submit(self._mk_request(body, ids, headers))
        rid = f"chatcmpl-{req.request_id[:12]}"

        if body.get("stream"):
            def chunk(piece: str, finish, tok=None):
                delta = {"content": piece} if piece else {}
                return {
                    "id": rid, "object": "chat.completion.chunk",
                    "created": _now(), "model": self.model_name,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason":
                                     self._openai_reason(finish)}],
                }
            return self._stream_sse(req, chunk)

        text = await self._collect(req)
        if _req_failed(req):
            return Reply(self._error_status(req), self._error_payload(req))
        return Reply(200, {
            "id": rid, "object": "chat.completion", "created": _now(),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": self._openai_reason(req.finish_reason),
            }],
            "usage": self._usage(req),
        })

    async def completions(self, body: dict, headers=None, query=None):
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0]
        ids = list(self.tok(prompt)["input_ids"])
        req = self._submit(self._mk_request(body, ids, headers))
        rid = f"cmpl-{req.request_id[:12]}"

        if body.get("stream"):
            def chunk(piece: str, finish, tok=None):
                return {
                    "id": rid, "object": "text_completion", "created": _now(),
                    "model": self.model_name,
                    "choices": [{"index": 0, "text": piece,
                                 "finish_reason":
                                     self._openai_reason(finish)}],
                }
            return self._stream_sse(req, chunk)

        text = await self._collect(req)
        if _req_failed(req):
            return Reply(self._error_status(req), self._error_payload(req))
        choice = {"index": 0, "text": text,
                  "finish_reason": self._openai_reason(req.finish_reason)}
        if body.get("logprobs"):
            # chosen-token logprobs (top alternatives are not tracked)
            choice["logprobs"] = {
                "tokens": [self.tok.decode([t]) for t in req.output_ids],
                "token_logprobs": [round(lp, 6) for lp in req.logprobs],
                "top_logprobs": None,
                "text_offset": [],
            }
        return Reply(200, {
            "id": rid, "object": "text_completion", "created": _now(),
            "model": self.model_name,
            "choices": [choice],
            "usage": self._usage(req),
        })

    async def models(self, body=None, headers=None, query=None):
        return Reply(200, {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "owned_by": "ipex_llm_tpu_torch"}],
        })

    async def health(self, body=None, headers=None, query=None):
        """Liveness that reflects the engine: a dead engine thread is 503;
        a recorded engine error reports "degraded"; a draining engine
        "draining", so that load balancers stop routing here."""
        eng = self.engine
        thread = eng._thread
        if thread is None or not thread.is_alive():
            return Reply(503, {"status": "dead",
                               "error": "engine thread not running"})
        m = dict(eng.metrics)   # one copy: the engine thread writes it
        body = {"status": "ok"}
        if m.get("last_error"):
            body = {"status": "degraded", "last_error": str(m["last_error"])}
        if eng.draining:
            body["status"] = "draining"
        # identity and liveness: `ticks` frozen while `uptime_s` advances
        # is the wedged-engine signal
        body["replica"] = {
            "replica_id": self.replica_id,
            "uptime_s": round(time.monotonic() - self.started_monotonic, 3),
            "ticks": m.get("ticks", 0),
        }
        # host-sync economics of the decode horizon and of admission waves
        body["decode"] = {
            "tokens_per_sync": m.get("tokens_per_sync", 0.0),
            "host_sync_s": m.get("host_sync_s", 0.0),
            "decode_horizon_effective": m.get("decode_horizon_effective", 0),
            "mixed_steps": m.get("mixed_steps", 0),
            "prefill_tokens_per_step": m.get("prefill_tokens_per_step", 0.0),
            "ttft_p95_s": m.get("ttft_p95_s", 0.0),
        }
        # the KV pool and the weights: the two byte lines of one HBM budget
        body["kv"] = eng.kv_stats()
        body["weights"] = eng.weight_stats()
        # tensor parallelism: tp, backend, wire family, the rank's pool
        # bytes (every rank holds the same share), collective counts
        par = eng.parallel_stats()
        if par is not None:
            body["parallel"] = par
        # admission backlog against its bound (what a 429 means), and the
        # refused, expired and isolated counts
        body["fault_domain"] = {
            "queue_depth": eng.queue_depth,
            "max_queue": eng.ec.max_queue,
            "errors_isolated": m.get("errors_isolated", 0),
            "retries": m.get("retries", 0),
            "rejected": m.get("rejected", 0),
            "timeouts": m.get("timeouts", 0),
        }
        if eng.ec.spec_k > 0:
            body["spec"] = eng.spec_stats()
        return Reply(200, body)

    def _metrics_numeric(self) -> dict:
        """Flat numeric series: engine metrics, the KV pool's (``kv_``) and
        the weights' (``weights_``) numbers, and the uptime."""
        def numeric(d: dict, prefix: str = "") -> dict:
            return {f"{prefix}{k}": v for k, v in d.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}

        out = numeric(dict(self.engine.metrics))
        out.update(numeric(self.engine.kv_stats(), "kv_"))
        out.update(numeric(self.engine.weight_stats(), "weights_"))
        out["uptime_s"] = round(time.monotonic() - self.started_monotonic, 3)
        return out

    async def metrics(self, body=None, headers=None, query=None):
        """Prometheus text exposition, every series labelled with this
        server's id, histograms as real ``_bucket``/``_sum``/``_count``
        series; ``?format=json`` gives the same as one JSON object."""
        vals = self._metrics_numeric()
        hists = self.engine.histograms()
        if (query or {}).get("format") == "json":
            return Reply(200, {
                "replica_id": self.replica_id, "metrics": vals,
                "histograms": {k: h.to_dict() for k, h in hists.items()}})
        label = f'replica_id="{self.replica_id}"'
        lines = [f"ipex_llm_tpu_{name}{{{label}}} {vals[name]}"
                 for name in sorted(vals)]
        for name in sorted(hists):
            lines.extend(hists[name].prometheus_lines(
                f"ipex_llm_tpu_{name}", labels=label))
        return Reply(200, "\n".join(lines) + "\n")

    # -- observability (serving/observe.py) ---------------------------------

    async def trace_get(self, body=None, headers=None, query=None, *,
                        trace_id: str):
        """One request's lifecycle trace (``?format=chrome`` renders Chrome
        trace events); 404 when tracing is off or the trace aged out."""
        tr = self.engine.trace_view(trace_id)
        if tr is None:
            return Reply(404, {"error": {
                "message": f"unknown trace {trace_id!r} (tracing disabled, "
                           "or aged out)",
                "type": "invalid_request_error", "code": "unknown_trace"}})
        if (query or {}).get("format") == "chrome":
            return Reply(200, Tracer.chrome_events([tr]))
        return Reply(200, tr)

    async def traces_export(self, body=None, headers=None, query=None):
        """Every trace still held: their ids, or (``?format=chrome``) one
        Chrome trace-event document."""
        tracer = self.engine.tracer
        if tracer is None:
            return Reply(404, {"error": {
                "message": "tracing disabled (EngineConfig.trace_requests)",
                "type": "invalid_request_error",
                "code": "tracing_disabled"}})
        if (query or {}).get("format") == "chrome":
            return Reply(200, tracer.export_chrome())
        return Reply(200, {"trace_ids": tracer.trace_ids()})

    async def debug_flight(self, body=None, headers=None, query=None):
        """The tick flight recorder: the last working ticks' records and
        the frozen dumps (``_fail_all`` takes one)."""
        return Reply(200, self.engine.flight.view())

    # -- TGI protocol -------------------------------------------------------

    def _tgi_request(self, body: dict, headers=None) -> Request:
        """TGI's ``{"inputs": str, "parameters": {...}}``."""
        p = body.get("parameters") or {}
        mapped = {
            "max_tokens": p.get("max_new_tokens", 64),
            "temperature": (p.get("temperature", 1.0)
                            if p.get("do_sample", False) else 0.0),
            "top_p": p.get("top_p", 1.0),
            "top_k": p.get("top_k", 0),
            "stop": p.get("stop"),
            "seed": p.get("seed"),
            "deadline_s": body.get("deadline_s"),
        }
        if body.get("traceparent"):
            mapped["traceparent"] = body["traceparent"]
        ids = list(self.tok(body.get("inputs", ""))["input_ids"])
        return self._mk_request(mapped, ids, headers)

    @staticmethod
    def _tgi_reason(fr: str | None) -> str:
        return {"stop": "eos_token", "stop_string": "stop_sequence"}.get(
            fr, fr or "length")

    @staticmethod
    def _tgi_error_payload(req: Request) -> dict:
        """TGI's error shape: a flat {"error", "error_type"}."""
        if req.finish_reason == "timeout":
            return {"error": "request deadline exceeded",
                    "error_type": "timeout"}
        if req.finish_reason == "abort":
            return {"error": "request aborted: server draining",
                    "error_type": "unavailable"}
        return {"error": "request failed in the engine (isolated fault)",
                "error_type": "generation"}

    async def tgi_generate(self, body: dict, headers=None, query=None):
        req = self._submit(self._tgi_request(body, headers))
        text = await self._collect(req)
        if _req_failed(req):
            return Reply(self._error_status(req),
                         self._tgi_error_payload(req))
        return Reply(200, {
            "generated_text": text,
            "details": {
                "finish_reason": self._tgi_reason(req.finish_reason),
                "generated_tokens": len(req.output_ids),
                "prefill": [],
            },
        })

    async def tgi_generate_stream(self, body: dict, headers=None,
                                  query=None):
        req = self._submit(self._tgi_request(body, headers))

        def chunk(piece, finish, tok):
            n = len(req.output_ids)
            lp = req.logprobs[n - 1] if 0 < n <= len(req.logprobs) else 0.0
            return {"token": {"id": int(tok), "text": piece,
                              "logprob": round(float(lp), 6),
                              "special": False},
                    "generated_text": None}

        def final(sent, finish):
            return {"token": None, "generated_text": sent,
                    "details": {"finish_reason": self._tgi_reason(finish),
                                "generated_tokens": len(req.output_ids)}}

        return self._stream_sse(req, chunk, final_fn=final, send_done=False,
                                error_fn=self._tgi_error_payload)


def build_server(model_path: str, low_bit: str = "sym_int4",
                 engine_config: EngineConfig | None = None,
                 model=None, tokenizer=None, drain_timeout_s: float = 30.0,
                 device=None, tensor_parallel_size: int = 1,
                 tp_backend: str = "nccl",
                 tp_timeout_s: float | None = None) -> OpenAIServer:
    """An ``OpenAIServer`` over a started ``ServingEngine`` serving the
    checkpoint at ``model_path`` on ``device`` (``None`` = cuda).

    A directory holding ``bigdl_config.json`` (a ``save_low_bit`` one)
    reloads at its recorded width; any other loads through
    ``from_pretrained`` at :func:`resolve_load_low_bit`'s width (a pinned
    ``EngineConfig.weight_qtype`` outranks ``low_bit``).  The loaded width
    then becomes the engine's ``weight_qtype`` unless the caller pinned
    one, so ``/health``'s ``weights`` block reports what the tree holds.
    A ``model`` handed in keeps its width (a caller's full-width tree is
    repacked only through ``EngineConfig(weight_qtype=...)``).  Without a
    ``tokenizer`` the checkpoint's is loaded through ``transformers``.

    ``tensor_parallel_size`` > 1: this process is rank 0 and starts the
    follower ranks (module docstring); every rank loads ``model_path``
    itself (a ``model`` handed in is rank 0's only), on ``tp_backend``
    with a group timeout of ``tp_timeout_s``."""
    ec = engine_config or EngineConfig()
    tp, procs = None, []
    if tensor_parallel_size > 1:
        tp, procs = _start_tp_group(
            tensor_parallel_size, tp_backend, tp_timeout_s,
            (model_path, low_bit, ec, device), ec.collective_qtype)
        device = tp.device
    try:
        if model is None:
            model, ec = _load_for_serving(model_path, low_bit, ec, device)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path,
                                                      trust_remote_code=True)
        engine = ServingEngine(
            model.config, model.params, ec,
            default_eos=model.generation_config.eos_token_id,
            device=model.device, tp=tp)
    except BaseException:
        for p in procs:     # the followers would wait out the timeout
            p.terminate()
        raise
    engine._tp_procs = procs
    return OpenAIServer(engine.start(), tokenizer, model_name=model_path,
                        drain_timeout_s=drain_timeout_s)


def _load_for_serving(model_path: str, low_bit: str, ec: EngineConfig,
                      device):
    """The checkpoint at the serving width rule (``build_server``'s
    docstring): (model, the engine config with its width)."""
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM

    if os.path.exists(os.path.join(model_path, "bigdl_config.json")):
        model = AutoModelForCausalLM.load_low_bit(model_path, device=device)
        return model, default_weight_qtype(ec, model.qtype)
    load_q = resolve_load_low_bit(ec, low_bit)
    model = AutoModelForCausalLM.from_pretrained(
        model_path, load_in_low_bit=load_q, device=device)
    return model, default_weight_qtype(ec, load_q)


def _start_tp_group(size: int, backend: str, timeout_s: float | None,
                    load_args: tuple, collective_qtype: str | None):
    """Start follower ranks 1..size-1 (spawned processes running
    :func:`_tp_follower`) and join the group as rank 0 through a
    ``FileStore`` in a fresh temporary directory; returns (rank 0's
    ``TPGroup``, the follower processes)."""
    import multiprocessing
    import tempfile

    import torch.distributed as dist

    from ipex_llm_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S,
                                                  init_tp_group,
                                                  rank_device)

    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    device = load_args[3]
    rank_device(backend, 0, size, device)    # refuse before spawning
    path = os.path.join(tempfile.mkdtemp(prefix="ipex_llm_tp_"), "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tp_follower, daemon=True,
                         args=(r, size, path, backend, timeout_s, load_args,
                               collective_qtype))
             for r in range(1, size)]
    for p in procs:
        p.start()
    try:
        tp = init_tp_group(size, 0, backend=backend, device=device,
                           store=dist.FileStore(path, size),
                           timeout_s=timeout_s,
                           collective_qtype=collective_qtype)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    return tp, procs


def _tp_follower(rank: int, size: int, path: str, backend: str,
                 timeout_s: float, load_args: tuple,
                 collective_qtype: str | None):
    """A follower rank's process: join the group, load the checkpoint as
    rank 0 does, and run the rank's engine until rank 0 stops it."""
    import torch
    import torch.distributed as dist

    from ipex_llm_tpu_torch.parallel.mesh import (destroy_tp_group,
                                                  init_tp_group)

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if backend == "gloo":
        torch.set_num_threads(1)
    model_path, low_bit, ec, device = load_args
    tp = init_tp_group(size, rank, backend=backend, device=device,
                       store=dist.FileStore(path, size), timeout_s=timeout_s,
                       collective_qtype=collective_qtype)
    model, ec = _load_for_serving(model_path, low_bit, ec, tp.device)
    engine = ServingEngine(
        model.config, model.params, ec,
        default_eos=model.generation_config.eos_token_id,
        device=model.device, tp=tp).start()
    engine.join()
    destroy_tp_group()


# flags of the reference's server whose machinery the port does not have:
# (flag, attribute, the value that asks for nothing, ROADMAP item)
_REFUSED_FLAGS = (
    ("--asr-model", "asr_model", None, "14, whisper"),
    ("--kv-spill-bytes", "kv_spill_bytes", 0, "11, the host spill tier"),
    ("--kv-import-token", "kv_import_token", None, "11, KV transport"),
    ("--profile-dir", "profile_dir", None, "10, perfwatch's /debug/profile"),
    ("--planner", "planner", "static", "10, the tick planner"),
)


def main(argv=None):
    """The OpenAI/TGI server's command line (the reference's flags that map
    onto the port's engine).  The port has no tick planner yet, so
    ``--planner static`` is its only value and its default until ROADMAP
    item 10; that flag and the others of machinery not ported
    (``--asr-model``, ``--kv-spill-bytes``, ``--kv-import-token``,
    ``--profile-dir``) exit with an error naming their ROADMAP item.
    ``--tensor-parallel-size N`` starts the N - 1 follower ranks itself
    (module docstring)."""
    ap = argparse.ArgumentParser("ipex-llm-tpu-torch OpenAI-compatible server")
    ap.add_argument("--model", required=True,
                    help="a local HF checkpoint or save_low_bit directory")
    ap.add_argument("--low-bit", default="sym_int4")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; cpu "
                         "runs every kernel's plain version)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-rows", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=4096)
    ap.add_argument("--spec-k", "--speculative", type=int, default=0,
                    metavar="K", dest="spec_k",
                    help="prompt-lookup speculative serving: up to K drafts "
                         "per row per decode step, verified on the device "
                         "inside the tick")
    ap.add_argument("--spec-ngram", type=int, default=3, metavar="N",
                    help="longest n-gram the lookup proposer matches")
    ap.add_argument("--decode-horizon", type=int, default=1, metavar="H",
                    help="decode steps per tick (one host sync per H "
                         "tokens)")
    ap.add_argument("--step-token-budget", type=int, default=None,
                    metavar="B",
                    help="prefill tokens of a mixed tick (default: the "
                         "prefill bucket; 0 = one row, one chunk a tick)")
    ap.add_argument("--weight-qtype", default=None, metavar="QTYPE",
                    help="serving weight width (default: --low-bit); the "
                         "checkpoint loads at this width, a save_low_bit "
                         "one keeps its own")
    ap.add_argument("--kv-storage", default="bf16", choices=("bf16", "fp8"),
                    metavar="FMT", help="paged KV pool: bf16 or fp8 (e5m2)")
    ap.add_argument("--kv-pool-bytes", type=int, default=0, metavar="BYTES",
                    help="KV pool byte budget (0 = sized in pages)")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="bounded admission queue (429 beyond it; 0 = "
                         "unbounded)")
    ap.add_argument("--request-deadline", type=float, default=0.0,
                    metavar="SECONDS",
                    help="default per-request deadline (408; 0 = none)")
    ap.add_argument("--max-step-retries", type=int, default=3,
                    help="retries of a transient tick fault before the "
                         "engine bisects it to one request")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    metavar="SECONDS",
                    help="graceful-drain window on shutdown")
    ap.add_argument("--trace", action="store_true",
                    help="request-lifecycle tracing (/trace/{id}, "
                         "/debug/traces)")
    ap.add_argument("--tensor-parallel-size", type=int, default=1,
                    metavar="N",
                    help="serve over N ranks; this process is rank 0 and "
                         "starts the others")
    ap.add_argument("--collective-qtype", default=None,
                    choices=("bf16", "e5m2", "int8"), metavar="FAMILY",
                    help="the tp all-reduce's wire family: bf16 = exact "
                         "(fp32 sums), e5m2/int8 = coded partials, bounded "
                         "error (default: IPEX_LLM_TPU_COLLECTIVE_QTYPE, "
                         "else bf16)")
    ap.add_argument("--tp-backend", default="nccl", choices=("nccl", "gloo"),
                    help="nccl: one card a rank (rank r on cuda:r); gloo: "
                         "every rank on --device, collectives through the "
                         "host")
    ap.add_argument("--tp-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="the group's timeout: a rank that does not answer "
                         "within it ends every rank")
    ap.add_argument("--asr-model", default=None)
    ap.add_argument("--kv-spill-bytes", type=int, default=0)
    ap.add_argument("--kv-import-token", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--planner", default="static", choices=("mpc", "static"))
    args = ap.parse_args(argv)
    for flag, attr, idle, item in _REFUSED_FLAGS:
        if getattr(args, attr) != idle:
            ap.error(f"{flag}={getattr(args, attr)} is not ported "
                     f"(ROADMAP item {item})")
    srv = build_server(
        args.model, args.low_bit,
        EngineConfig(max_rows=args.max_rows, max_seq_len=args.max_seq_len,
                     spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                     decode_horizon=args.decode_horizon,
                     step_token_budget=args.step_token_budget,
                     kv_storage=args.kv_storage,
                     kv_pool_bytes=args.kv_pool_bytes,
                     weight_qtype=args.weight_qtype,
                     max_queue=args.max_queue,
                     request_deadline_s=args.request_deadline,
                     max_step_retries=args.max_step_retries,
                     trace_requests=args.trace,
                     collective_qtype=args.collective_qtype),
        drain_timeout_s=args.drain_timeout, device=args.device,
        **({} if args.tensor_parallel_size == 1 else dict(
            tensor_parallel_size=args.tensor_parallel_size,
            tp_backend=args.tp_backend, tp_timeout_s=args.tp_timeout)))
    from aiohttp import web

    web.run_app(srv.app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
