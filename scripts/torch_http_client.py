"""Drive an ``OpenAIServer`` from a script on the card: an id tokenizer, a
client that serves the app on an event loop of its own and reaches it over
127.0.0.1 (or, without aiohttp, through the route coroutines in process),
and a gate that holds an engine's first working tick until a wave of
requests waits.  ``chip_smoke.py``'s ``serve_http`` phase and
``scripts/torch_load_smoke.py`` share them.
"""

from __future__ import annotations

import json
import threading
import time
import zlib


def http_transport() -> str:
    """``"http"`` when aiohttp imports, else ``"in_process"``."""
    try:
        import aiohttp  # noqa: F401
        return "http"
    except ImportError:
        return "in_process"


class IdTokenizer:
    """Id passthrough: a number is its id (mod ``vocab``), another word a
    hash; decoding joins the ids with spaces."""
    eos_token_id = None
    chat_template = None

    def __init__(self, vocab: int):
        self.vocab = vocab

    def __call__(self, text):
        return {"input_ids": [
            int(w) % self.vocab if w.isdigit()
            else zlib.crc32(w.encode()) % self.vocab for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def parse_events(lines) -> list:
    """The ``data:`` payloads of a server-sent-event stream (``[DONE]``
    kept as the string)."""
    out = []
    for ln in lines:
        ln = ln.strip()
        if ln.startswith("data: "):
            ev = ln[6:]
            out.append(ev if ev == "[DONE]" else json.loads(ev))
    return out


class Client:
    """One server on an event loop of its own, reached over 127.0.0.1
    (``transport`` "http") or through ``OpenAIServer.call``; ``fail(msg)``
    ends the run."""

    def __init__(self, srv, transport: str, fail):
        import asyncio

        self.srv, self.transport, self.fail = srv, transport, fail
        self.asyncio = asyncio
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            if transport == "http":
                from aiohttp import web
                self.runner = web.AppRunner(srv.app)
                self.loop.run_until_complete(self.runner.setup())
                site = web.TCPSite(self.runner, "127.0.0.1", 0)
                self.loop.run_until_complete(site.start())
                self.port = site._server.sockets[0].getsockname()[1]
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not ready.wait(60):
            fail("the server did not start")

    def request(self, method, path, body=None, headers=None):
        """(status, headers, payload): the JSON body, the text body, or the
        list of an event stream's events."""
        if self.transport == "http":
            import urllib.error
            import urllib.request
            rq = urllib.request.Request(
                f"http://127.0.0.1:{self.port}{path}",
                data=None if body is None else json.dumps(body).encode(),
                method=method, headers={"Content-Type": "application/json",
                                        **(headers or {})})
            try:
                resp = urllib.request.urlopen(rq, timeout=600)
            except urllib.error.HTTPError as e:
                resp = e
            raw = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
            if "event-stream" in ctype:
                payload = parse_events(raw.splitlines())
            elif "json" in ctype:
                payload = json.loads(raw)
            else:
                payload = raw
            return resp.getcode(), dict(resp.headers), payload

        from ipex_llm_tpu_torch.serving.api_server import EventStream

        async def go():
            out = await self.srv.call(method, path, body, headers)
            if isinstance(out, EventStream):
                frames = [f.decode() async for f in out.events]
                return out.status, out.headers, parse_events(frames)
            return out.status, out.headers, out.body
        return self.asyncio.run_coroutine_threadsafe(
            go(), self.loop).result(600)

    def close(self):
        """Shut the server down (over HTTP, aiohttp's shutdown drains and
        stops the engine), then its loop."""
        if self.transport == "http":
            self.asyncio.run_coroutine_threadsafe(
                self.runner.cleanup(), self.loop).result(180)
        else:
            self.srv.engine.drain(self.srv.drain_timeout_s)
            self.srv.engine.stop()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        if self.srv.engine._thread.is_alive():
            self.fail("the engine thread did not stop")


def hold_first_tick(eng, n_wave: int):
    """Make ``eng``'s thread hold its first working tick until ``n_wave``
    requests wait, so that two engines given the same wave admit it whole
    and run the same ticks (works on a started engine too: the loop looks
    ``_tick`` up on every turn)."""
    tick, gate = eng._tick, threading.Event()

    def gated_tick():
        if gate.is_set() or eng.queue_depth >= n_wave:
            gate.set()
            return tick()
        time.sleep(0.001)
        return True
    eng._tick = gated_tick
    return eng
