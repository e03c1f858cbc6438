#!/usr/bin/env python3
"""Tensor-parallel serving on one card: two ranks (processes) of a gloo
group share ``cuda:0``, each holding its slices of the model and its kv
heads of the pool, running the engine's ticks in lockstep
(``ipex_llm_tpu_torch/serving/engine.py``, ``parallel/``).  gloo's
collectives go through the host, so nothing here measures NCCL or tp's
speed; it shows that every sharded kernel runs at its shard shapes and
that tp = 2 serves what tp = 1 serves.

``chip_smoke.py`` runs this as its ``serve_tp`` phase; alone, from the
root of a checkout on a machine with a CUDA card:

    python3 scripts/torch_tp_smoke.py [kernels] [gqa] [serve]

(no step named: all three).  The kernels are built once, here, before
any rank is spawned; every rank prints its backend.  Steps (each fails
the run on a miss):

1. ``kernels``: on two ranks, B1s (16/16 heads a rank over a bf16 and an
   e5m2 pool at decode, C = 4 and C = 128), B2s col (Llama-2-7B's qkv N =
   6144, gate_up N = 11008, lm head N = 16000 a rank) and row (o K =
   2048, down K = 5504 a rank) at M = 1, 8 and 128, B3s, B4s and B5s
   (prefill and decode) at Mistral-7B's 16/4 heads a rank, each against
   the unsharded kernel on the same global inputs sliced per rank: the
   head and column splits bitwise where the kernel's launch plan is the
   same at both widths (reported per case) and otherwise within one bf16
   ulp of each row's largest value, B2 row (summed in fp32 over the
   ranks) within one bf16 ulp of each row's largest value; then each
   wrapper timed at its shard shapes here (device time from CUDA-graph
   replays, one rank's work alone) beside its bound, its plain version
   and SDPA or ``torch.matmul`` at the same shapes, and the all-reduce's
   host time a call over gloo;
2. ``gqa``: four ranks, 8 query heads over 2 kv heads (tp % Hkv == 0, the
   reference's repeat rule: rank r reads kv head r // 2): B1s and B5s
   against the unsharded kernel;
3. ``serve``: Llama-2-7B widths, sym_int4, 8 layers, tp = 2: the serve
   phase's eight requests over a bf16 pool, then two over e5m2;
   Mistral-7B-v0.1 widths, 8 layers, four requests over the gathered
   route (B3s and B4s on the serving path); the e5m2 and int8 all-reduce
   families on the Llama run's four greedy requests.  Every request
   finishes with its tokens, no plain version runs, every kernel of the
   path launches and B5 (B1's oracle) never does; per rank tok/s, TTFT, peak memory, launches by kernel,
   and collectives a tick with their time.  Each run is held against a
   tp = 1 engine on the same seed's model here: equal tokens, or a greedy
   fork to a token within ``SPEC_ULPS`` bf16 ulps of the top logit of a
   one-shot prefill (a near-tie), and logprobs before any fork within
   ``LP_MEAN_NATS`` on average; the quantized families within the
   reference's bounded-error gate (their greedy streams' perplexity under
   ``PPL_RATIO`` times the exact family's,
   ``tests/test_serving_tp_manual.py:158``).

Prints the card's name and power limit first and, last, one JSON object
(``kernels``: the rows ``chip_smoke.py`` puts in its ``kernels`` line).
"""

from __future__ import annotations

import io
import json
import math
import os
import pathlib
import queue
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = ("kernels", "gqa", "serve")
TP = 2
GQA_TP = 4
SERVE_LAYERS = 8
GROUP_TIMEOUT_S = 300.0
JOIN_TIMEOUT_S = 900.0
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
TOL_REL = 2.0 ** -7          # one bf16 ulp of a row's largest value
SPEC_ULPS = 8                # chip_smoke.py's near-tie rule
LP_MEAN_NATS = 0.05
PPL_RATIO = 1.25
# Llama-2-7B's weights: (in, out, split)
B2_SHAPES = {"qkv": (4096, 12288, "col"), "gate_up": (4096, 22016, "col"),
             "o": (4096, 4096, "row"), "down": (11008, 4096, "row"),
             "lm_head": (4096, 32000, "col")}
B2_ROWS = (1, 8, 128)
_PALLAS = "ipex_llm_tpu/ops/pallas/"
_CSRC = "ipex_llm_tpu_torch/csrc/"
KERNELS = {   # name: (csrc source, the TPU kernel it replaces)
    "B1s": ("ragged_paged_attention.cu",
            "ragged_paged_attention.py:233"),
    "B2s col": ("qmatmul.cu", "qmatmul.py:261"),
    "B2s row": ("qmatmul.cu", "qmatmul.py:261"),
    "B3s": ("decode_attention.cu", "decode_attention.py:211"),
    "B4s": ("flash_attention.cu", "flash_attention.py:214"),
    "B5s prefill": ("paged_attention.cu", "paged_attention.py:207"),
    "B5s decode": ("paged_attention.cu", "paged_attention.py:237"),
}


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str):
    print(f"torch_tp_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- inputs, made alike in every process from seeds on cuda:0 -----------------

class Inputs:
    """The kernel cases' global inputs, each from its own seed on the card
    (every process draws the same values)."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self._w = {}

    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def b2(self, name, m):
        """(x [M, K] bf16, the sym_int4 weight, its split)."""
        from ipex_llm_tpu_torch.quantize.core import quantize
        torch = self.torch
        k, n, mode = B2_SHAPES[name]
        if name not in self._w:
            g = self.gen(1000 + list(B2_SHAPES).index(name))
            w = torch.randn(k, n, generator=g, device=self.dev) * k ** -0.5
            self._w[name] = quantize(w, "sym_int4")
        x = torch.randn(m, k, generator=self.gen(2000 + m + k),
                        device=self.dev).to(torch.bfloat16)
        return x, self._w[name], mode

    def ragged(self, pool, c, hq=32, hkv=32, r=8, d=128, ps=128, maxp=16):
        """B1's row mix (chip_smoke.py's): even rows decode at full
        history, odd rows take a ragged chunk, the last two rows idle."""
        import numpy as np
        torch = self.torch
        g = self.gen(3000 + c + 7 * hkv + (pool == "e5m2"))
        dt = torch.bfloat16 if pool == "bf16" else torch.float8_e5m2
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=g,
                         device=self.dev).to(dt)
        vp = torch.randn(n_pages, hkv, ps, d, generator=g,
                         device=self.dev).to(dt)
        tables = (1 + torch.randperm(r * maxp, generator=g, device=self.dev)
                  ).to(torch.int32).reshape(r, maxp)
        chunk = np.where(np.arange(r) % 2 == 0, 1,
                         1 + (37 * np.arange(r)) % c).astype(np.int32)
        kv_len = np.where(chunk == 1, maxp * ps,
                          maxp * ps - c + chunk).astype(np.int32)
        chunk[-2:] = 0
        kv_len[-2:] = maxp * ps
        tables[-2:] = -1
        q = torch.randn(r, c, hq, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        return (q, kp, vp, tables, torch.from_numpy(kv_len).to(self.dev),
                torch.from_numpy(chunk).to(self.dev))

    def paged(self, c, hq=32, hkv=8, r=8, d=128, ps=128, maxp=16):
        """B5's inputs: rows of 1 to 2048 slots, C queries each."""
        torch = self.torch
        g = self.gen(4000 + c + hkv)
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=g,
                         device=self.dev).to(torch.bfloat16)
        vp = torch.randn(n_pages, hkv, ps, d, generator=g,
                         device=self.dev).to(torch.bfloat16)
        tables = (1 + torch.randperm(r * maxp, generator=g, device=self.dev)
                  ).to(torch.int32).reshape(r, maxp)
        kv_len = torch.tensor([2048, 1900, 1500, 1024, 700, 300, 130, c],
                              dtype=torch.int32, device=self.dev)[:r]
        q = torch.randn(r, c, hq, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        return q, kp, vp, tables, kv_len

    def dense_decode(self, b=8, s=2304, hq=32, hkv=8, d=128):
        """B3's inputs: a gathered head-major layer, rows of ragged fill."""
        torch = self.torch
        g = self.gen(5000)
        q = torch.randn(b, 1, hq, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        kv_len = torch.tensor([2304, 2000, 1500, 1023, 700, 256, 64, 1],
                              dtype=torch.int32, device=self.dev)[:b]
        return q, k, v, dict(kv_len=kv_len, window=4096)

    def dense_prefill(self, b=8, t=128, s=1024, hq=32, hkv=8, d=128):
        """B4's inputs: 128-query chunks at the end of rows of 1024 slots
        ([B, S, Hkv, D] views of a head-major layer, as the gathered route
        hands them over)."""
        torch = self.torch
        g = self.gen(6000)
        q = torch.randn(b, t, hq, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=g, device=self.dev).to(
            torch.bfloat16)
        kv_len = torch.full((b,), s, dtype=torch.int32, device=self.dev)
        qpos = (s - t + torch.arange(t, device=self.dev))[None].expand(b, t)
        return q, k.transpose(1, 2), v.transpose(1, 2), dict(
            q_positions=qpos, kv_len=kv_len, window=4096)


# B1's row mix idles its last two rows (zero outputs, compared apart)
B1_LIVE = [True] * 6 + [False] * 2


def heads(x, axis, tp, rank):
    n = x.shape[axis] // tp
    return x.narrow(axis, rank * n, n).contiguous()


def rank_pool(pool, hkv, tp, rank):
    """A rank's pool: its kv heads where they divide tp, all of them
    where the rank reads one by the repeat rule."""
    return heads(pool, 1, tp, rank) if hkv % tp == 0 else pool


# -- the sharded calls, one rank's (the ranks run them; here they are timed) --

def b2_call(inp, group, tp, rank, name, m):
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.parallel.shard import shard_qtensor
    x, qt, mode = inp.b2(name, m)
    q_r = shard_qtensor(qt, mode, tp, rank)
    if mode == "col":
        return lambda: b2.qmatmul_sharded(x, q_r, "col")
    x_r = heads(x, 1, tp, rank)
    return lambda: b2.qmatmul_sharded(x_r, q_r, "row", group)


def attn_calls(inp, tp, rank, gqa=False):
    """{case: (the rank's sharded call on its operands, sliced here, the
    unsharded call, the head axis of the output)}."""
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
    calls = {}
    shapes = ([("bf16", 1), ("bf16", 4)] if gqa else
              [(p, c) for p in ("bf16", "e5m2") for c in (1, 4, 128)])
    kw = dict(hq=8, hkv=2) if gqa else {}
    for pool, c in shapes:
        q, kp, vp, tb, kl, ch = inp.ragged(pool, c, **kw)
        hkv = kp.shape[1]
        mine = (heads(q, 2, tp, rank), rank_pool(kp, hkv, tp, rank),
                rank_pool(vp, hkv, tp, rank))
        calls[f"B1s {pool} C={c}"] = (
            lambda m=mine, tb=tb, kl=kl, ch=ch, hkv=hkv:
            b1.ragged_paged_sdpa_sharded(*m, tb, kl, ch, tp=tp, rank=rank,
                                         n_kv_heads=hkv),
            lambda q=q, kp=kp, vp=vp, tb=tb, kl=kl, ch=ch:
            b1.ragged_paged_sdpa(q, kp, vp, tb, kl, ch), 2)
    for c, label, fn, fn1 in (
            (128, "B5s prefill", b5.paged_prefill_sdpa_sharded,
             b5.paged_prefill_sdpa),
            (1, "B5s decode", b5.paged_decode_sdpa_sharded,
             b5.paged_decode_sdpa)):
        q, kp, vp, tb, kl = inp.paged(c, **kw)
        hkv = kp.shape[1]
        mine = (heads(q, 2, tp, rank), rank_pool(kp, hkv, tp, rank),
                rank_pool(vp, hkv, tp, rank))
        calls[label] = (
            lambda m=mine, tb=tb, kl=kl, hkv=hkv, fn=fn: fn(
                *m, tb, kl, tp=tp, rank=rank, n_kv_heads=hkv),
            lambda q=q, kp=kp, vp=vp, tb=tb, kl=kl, fn1=fn1:
            fn1(q, kp, vp, tb, kl), 2)
    if gqa:
        return calls
    q, k, v, kw3 = inp.dense_decode()
    mine = (heads(q, 2, tp, rank), heads(k, 1, tp, rank),
            heads(v, 1, tp, rank))
    calls["B3s"] = (
        lambda: b3.decode_sdpa_sharded(*mine, tp=tp, rank=rank,
                                       n_kv_heads=k.shape[1], **kw3),
        lambda: b3.decode_sdpa(q, k, v, **kw3), 2)
    q4, k4, v4, kw4 = inp.dense_prefill()
    n4 = k4.shape[2] // tp
    mine4 = (heads(q4, 2, tp, rank), k4.narrow(2, rank * n4, n4),
             v4.narrow(2, rank * n4, n4))     # views, as the route has them
    calls["B4s"] = (
        lambda: b4.flash_sdpa_sharded(*mine4, tp=tp, n_kv_heads=k4.shape[2],
                                      **kw4),
        lambda: b4.flash_sdpa(q4, k4, v4, **kw4), 2)
    return calls


# -- the rank processes ------------------------------------------------------

def _rank_entry(rank, size, store, steps, q):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        sys.path.insert(0, str(ROOT))
        import torch
        import torch.distributed as dist

        from ipex_llm_tpu_torch.parallel.mesh import (destroy_tp_group,
                                                      init_tp_group)
        group = init_tp_group(size, rank, backend="gloo", device="cuda:0",
                              store=dist.FileStore(store, size),
                              timeout_s=GROUP_TIMEOUT_S)
        print(f"rank {rank} of {size}: backend {group.backend} on "
              f"{group.device} ({torch.cuda.get_device_name(0)})",
              flush=True)
        out = {}
        inp = Inputs(torch, group.device)
        if "kernels" in steps:
            out["kernels"] = rank_kernels(torch, inp, group)
        if "gqa" in steps:
            out["gqa"] = {k: fn().cpu() for k, (fn, _, _) in attn_calls(
                inp, size, rank, gqa=True).items()}
        if "serve" in steps:
            out["serve"] = rank_serve(torch, group)
        buf = io.BytesIO()      # by value: this process may end first
        torch.save(out, buf)
        q.put((rank, True, buf.getvalue()))
        destroy_tp_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        q.put((rank, False, traceback.format_exc()))


def rank_kernels(torch, inp, group):
    from ipex_llm_tpu_torch.ops import collectives
    out = {}
    collectives.COUNTS.reset()
    for name in B2_SHAPES:
        for m in B2_ROWS:
            out[f"B2s {name} M={m}"] = b2_call(
                inp, group, group.size, group.rank, name, m)().cpu()
    for case, (fn, _, _) in attn_calls(inp, group.size, group.rank).items():
        out[case] = fn().cpu()
    torch.cuda.synchronize()
    out["all_reduce"] = dict(calls=collectives.COUNTS.calls["all_reduce"],
                             seconds=collectives.COUNTS.seconds["all_reduce"])
    return out


def serve_runs():
    """(label, model, pool, wire family, request indices) of each run."""
    return [("llama bf16 pool", "llama", "bf16", "bf16", "serve8"),
            ("llama e5m2 pool", "llama", "fp8", "bf16", "serve2"),
            ("mistral bf16 pool", "mistral", "bf16", "bf16", "mistral4"),
            ("llama e5m2 family", "llama", "bf16", "e5m2", "greedy4"),
            ("llama int8 family", "llama", "bf16", "int8", "greedy4")]


def model(name: str, dev):
    from ipex_llm_tpu_torch.models.random_init import (llama2_7b_config,
                                                       mistral_7b_config,
                                                       random_params)
    cfg = (llama2_7b_config(num_layers=SERVE_LAYERS) if name == "llama"
           else mistral_7b_config(num_layers=SERVE_LAYERS))
    return cfg, random_params(cfg, "sym_int4", seed=0, device=dev)


def requests(kind: str, vocab: int) -> list[dict]:
    """The serve phase's requests (chip_smoke.py: 64-1000 ids, 32-64 new
    tokens, half greedy) and subsets of them."""
    import numpy as np
    n_req, seed = {"serve8": (8, 7), "serve2": (2, 8), "mistral4": (4, 9),
                   "greedy4": (8, 7)}[kind]
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1001, n_req)
    news = rng.integers(32, 65, n_req)
    reqs = [dict(prompt_ids=[int(v) for v in rng.integers(1, vocab, n)],
                 max_new_tokens=int(m), temperature=0.8 if i % 2 else 0.0,
                 top_p=0.9 if i % 2 else 1.0,
                 seed=1000 + i if i % 2 else None, request_id=f"{kind}-{i}")
            for i, (n, m) in enumerate(zip(lens, news))]
    return reqs[::2] if kind == "greedy4" else reqs


def engine_config(pool: str, family: str | None = None):
    from ipex_llm_tpu_torch.serving.engine import EngineConfig
    return EngineConfig(max_rows=8, max_seq_len=2048, page_size=128,
                        prefill_bucket=128, decode_horizon=4,
                        kv_storage=pool, collective_qtype=family)


def _all_counts():
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
    return {"B1": b1.COUNTS, "B2": b2.COUNTS, "B3": b3.COUNTS,
            "B4": b4.COUNTS, "B5": b5.COUNTS, "B1s": b1.SHARDED,
            "B2s col": b2.SHARDED_COL, "B2s row": b2.SHARDED_ROW,
            "B3s": b3.SHARDED, "B4s": b4.SHARDED,
            "B5s prefill": b5.SHARDED_PREFILL,
            "B5s decode": b5.SHARDED_DECODE}


def rank_serve(torch, group) -> list[dict]:
    from ipex_llm_tpu_torch.ops import collectives
    from ipex_llm_tpu_torch.serving.engine import (Request, ServingEngine,
                                                   stream_tokens)
    dev = group.device
    models, out = {}, []
    for label, name, pool, family, kind in serve_runs():
        if name not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[name] = model(name, dev)
        cfg, params = models[name]
        eng = ServingEngine(cfg, params, engine_config(pool, family),
                            device=dev, tp=group)
        for c in _all_counts().values():
            c.reset()
        collectives.COUNTS.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.start()
        t0 = time.perf_counter()
        if group.leader:
            reqs = [eng.submit(Request(**f))
                    for f in requests(kind, cfg.vocab_size)]
            streams = [list(stream_tokens(r, timeout=600)) for r in reqs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng.stop()
        else:
            eng.join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reqs, streams = [], []
        counts = {k: (c.launches, c.plain_calls)
                  for k, c in _all_counts().items()}
        m = eng.metrics
        res = dict(run=label, rank=group.rank, wall_s=wall,
                   ticks=m["ticks"],
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches={k: v[0] for k, v in counts.items()},
                   plain_calls=sum(v[1] for v in counts.values()),
                   collective_calls=dict(collectives.COUNTS.calls),
                   collective_s=dict(collectives.COUNTS.seconds),
                   staged_copies=dict(collectives.COUNTS.staged_copies),
                   kv_pool_bytes=eng.parallel_stats()[
                       "kv_pool_bytes_per_rank"],
                   finish=[r.finish_reason for r in reqs],
                   tokens=[list(r.output_ids) for r in reqs],
                   streams_equal=all(s == r.output_ids
                                     for s, r in zip(streams, reqs)),
                   logprobs=[list(r.logprobs) for r in reqs],
                   ttft=[r.first_token_s for r in reqs])
        calls = sum(res["collective_calls"].values())
        res["collectives_per_tick"] = calls / max(1, m["ticks"])
        res["collective_ms_per_call"] = {
            k: 1e3 * res["collective_s"][k] / n
            for k, n in res["collective_calls"].items() if n}
        if reqs:
            out_tok = sum(len(r.output_ids) for r in reqs)
            res.update(output_tokens=out_tok, output_tok_s=out_tok / wall,
                       ttft_mean_s=sum(res["ttft"]) / len(reqs),
                       ttft_max_s=max(res["ttft"]))
        print(f"rank {group.rank} serve " + json.dumps(
            {k: v for k, v in res.items()
             if k not in ("tokens", "logprobs", "ttft")}), flush=True)
        out.append(res)
        del eng
        torch.cuda.empty_cache()
    return out


def spawn(size: int, steps, join_s: float = JOIN_TIMEOUT_S) -> dict:
    """Run the ranks' ``steps`` in ``size`` spawned processes on cuda:0
    under gloo (a ``FileStore`` in a fresh temporary directory); returns
    {rank: report}.  A rank that fails, or does not answer in ``join_s``,
    fails the run."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="tp_smoke_"), "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, size, store, tuple(steps), q))
             for r in range(size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + join_s
    try:
        while len(out) < size:
            try:
                rank, ok, res = q.get(timeout=5.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    fail(f"ranks {sorted(out)} of {size} answered within "
                         f"{join_s} s")
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    fail(f"a rank exited with {dead[0]} before answering")
                continue
            if not ok:
                fail(f"rank {rank} of {size}:\n{res}")
            import torch
            out[rank] = torch.load(io.BytesIO(res))
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return out


# -- the parent's checks -------------------------------------------------------

def rows_err(got, want):
    """(max abs err, the worst row's err over its largest |want|) over the
    leading two axes' rows."""
    g, w = got.float(), want.float()
    g = g.reshape(g.shape[0] * (g.shape[1] if g.dim() > 3 else 1), -1)
    w = w.reshape(g.shape)
    err = (g - w).abs().amax(dim=1)
    top = w.abs().amax(dim=1)
    return float(err.max()), float((err / top.clamp_min(1e-30)).max())


def check_split(torch, label, parts, want, axis, live=None) -> dict:
    """The ranks' parts against the unsharded kernel's slices: bitwise, or
    within one bf16 ulp of each row's largest value."""
    tp = len(parts)
    bitwise, err, ratio = True, 0.0, 0.0
    for r, got in enumerate(parts):
        w = heads(want, axis, tp, r).cpu()
        if live is not None:
            got, w = got[live], w[live]
        if not torch.isfinite(got.float()).all():
            fail(f"{label} rank {r}: not finite")
        bitwise &= bool(torch.equal(got, w))
        e, q = rows_err(got, w)
        err, ratio = max(err, e), max(ratio, q)
    if ratio > TOL_REL:
        fail(f"{label}: a row's error is {ratio} of its largest value "
             f"(bound {TOL_REL})")
    return dict(case=label, bitwise=bitwise, max_abs_err=err,
                worst_row_ratio=ratio)


def kernels_step(torch, dev, card, graph_ms) -> dict:
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
    from ipex_llm_tpu_torch.quantize.core import dequantize_padded
    t0 = time.perf_counter()
    ranks = spawn(TP, ["kernels"])
    inp = Inputs(torch, dev)
    checks = []
    for name in B2_SHAPES:
        for m in B2_ROWS:
            x, qt, mode = inp.b2(name, m)
            want = b2.qmatmul(x, qt)
            label = f"B2s {name} M={m}"
            parts = [ranks[r]["kernels"][label] for r in range(TP)]
            if mode == "col":
                checks.append(dict(kernel="B2s col", **check_split(
                    torch, label, parts, want, 1)))
                continue
            errs = [rows_err(got, want.cpu()) for got in parts]
            worst = max(q for _, q in errs)
            if worst > TOL_REL or any(not torch.equal(got, parts[0])
                                      for got in parts):
                fail(f"{label}: worst row {worst} of its largest value "
                     f"(bound {TOL_REL}), or the ranks differ")
            checks.append(dict(kernel="B2s row", case=label,
                               bitwise=bool(torch.equal(parts[0],
                                                        want.cpu())),
                               max_abs_err=max(e for e, _ in errs),
                               worst_row_ratio=worst))
    for case, (_, unsharded, axis) in attn_calls(inp, TP, 0).items():
        parts = [ranks[r]["kernels"][case] for r in range(TP)]
        want = unsharded()
        live = B1_LIVE if case.startswith("B1s") else None
        kernel = case.split(" ")[0] if not case.startswith("B5s") else \
            " ".join(case.split(" ")[:2])
        checks.append(dict(kernel=kernel, **check_split(
            torch, case, parts, want, axis, live)))
    ar = ranks[0]["kernels"]["all_reduce"]
    print("serve_tp kernels " + json.dumps(checks), flush=True)

    # timing at the shard shapes, one rank's work alone
    def time_ms(fn, iters=1):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    import torch.nn.functional as F
    from ipex_llm_tpu_torch.parallel.shard import shard_qtensor
    timed = []
    for name, m in (("qkv", 1), ("gate_up", 1), ("lm_head", 1), ("qkv", 128),
                    ("o", 1), ("down", 1), ("down", 128)):
        x, qt, mode = inp.b2(name, m)
        q_r = shard_qtensor(qt, mode, TP, 0)
        x_r = x if mode == "col" else heads(x, 1, TP, 0)
        kern = (lambda: b2.qmatmul_sharded(x_r, q_r, "col")) \
            if mode == "col" else (lambda: b2.qmatmul(x_r, q_r,
                                                      keep_f32=True))
        w_bf = dequantize_padded(q_r).to(torch.bfloat16)
        k, n = x_r.shape[1], q_r.out_features
        nb, fl = (q_r.nbytes + 2 * m * k + (2 if mode == "col" else 4)
                  * m * n), 2.0 * m * n * k
        b_ms, b_by = bound(nb, fl)
        timed.append(dict(
            name=f"B2s {mode}", case=f"{name} M={m} K={k} N={n}",
            ms=graph_ms(torch, [kern] * 5), bound_ms=b_ms, bound_by=b_by,
            plain_ms=time_ms(lambda: b2.qmatmul_plain(x_r, q_r)),
            library_ms=graph_ms(torch, [lambda: torch.matmul(x_r, w_bf)]
                                * 5),
            library_call="torch.matmul, bf16 weight"))
    calls = attn_calls(inp, TP, 0)

    def attn_row(name, case, key, nbytes, flops, plain, library):
        b_ms, b_by = bound(nbytes, flops)
        timed.append(dict(name=name, case=case,
                          ms=graph_ms(torch, [calls[key][0]] * 5),
                          bound_ms=b_ms, bound_by=b_by,
                          plain_ms=time_ms(plain), library_ms=graph_ms(
                              torch, [library] * 5),
                          library_call="F.scaled_dot_product_attention"))

    for pool, c in (("bf16", 1), ("bf16", 128), ("e5m2", 1)):
        q, kp, vp, tb, kl, ch = inp.ragged(pool, c)
        q_r, kp_r, vp_r = heads(q, 2, TP, 0), heads(kp, 1, TP, 0), \
            heads(vp, 1, TP, 0)
        nb, fl = ragged_work(q_r, kp_r, kl, ch)
        lib = ragged_library(torch, F, q_r, kp_r, vp_r, tb, kl, ch)
        attn_row("B1s", f"{pool} R=8 C={c} 16/16 heads", f"B1s {pool} C={c}",
                 nb, fl, lambda: b1.ragged_paged_sdpa_plain(
                     q_r, kp_r, vp_r, tb, kl, ch, scale=128 ** -0.5), lib)
    q, k, v, kw = inp.dense_decode()
    q_r, k_r, v_r = heads(q, 2, TP, 0), heads(k, 1, TP, 0), heads(v, 1, TP, 0)
    kl = kw["kv_len"]
    nb = 2 * q_r.numel() * 2 + 2 * int(kl.sum()) * k_r.shape[1] * 128 * 2
    fl = 4.0 * 128 * q_r.shape[2] * int(kl.sum())
    mask = (torch.arange(k.shape[2], device=dev)[None, :] < kl[:, None])
    attn_row("B3s", "B=8 S=2304 16/4 heads", "B3s", nb, fl,
             lambda: b3.decode_sdpa_plain(
                 q_r, k_r, v_r, scale=128 ** -0.5, kv_len=kl,
                 kv_start=torch.zeros_like(kl), won=torch.ones_like(kl),
                 window=4096, softcap=None),
             lambda: F.scaled_dot_product_attention(
                 q_r.transpose(1, 2), k_r, v_r,
                 attn_mask=mask[:, None, None, :], enable_gqa=True))
    q, k, v, kw = inp.dense_prefill()
    q_r = heads(q, 2, TP, 0)
    k_r = k.narrow(2, 0, k.shape[2] // TP)
    v_r = v.narrow(2, 0, v.shape[2] // TP)
    b_, t_, s_ = q.shape[0], q.shape[1], k.shape[1]
    pairs = b_ * sum(s_ - t_ + j + 1 for j in range(t_))
    nb = 2 * q_r.numel() * 2 + 2 * b_ * s_ * k_r.shape[2] * 128 * 2
    fl = 4.0 * 128 * q_r.shape[2] * pairs
    causal = (torch.arange(s_, device=dev)[None, :]
              <= kw["q_positions"][0][:, None])
    attn_row("B4s", "B=8 T=128 S=1024 16/4 heads", "B4s", nb, fl,
             lambda: b4.flash_sdpa_plain(
                 q_r, k_r, v_r, scale=128 ** -0.5, causal=True,
                 q_positions=kw["q_positions"].long(), kv_len=kw["kv_len"],
                 kv_start=torch.zeros_like(kw["kv_len"]),
                 won=torch.ones_like(kw["kv_len"]), window=4096,
                 softcap=None),
             lambda: F.scaled_dot_product_attention(
                 q_r.transpose(1, 2), k_r.transpose(1, 2),
                 v_r.transpose(1, 2), attn_mask=causal[None, None],
                 enable_gqa=True))
    for c, label in ((128, "B5s prefill"), (1, "B5s decode")):
        q, kp, vp, tb, kl = inp.paged(c)
        q_r, kp_r, vp_r = heads(q, 2, TP, 0), heads(kp, 1, TP, 0), \
            heads(vp, 1, TP, 0)
        ch = torch.full_like(kl, c)
        nb, fl = ragged_work(q_r, kp_r, kl, ch)
        attn_row(label, f"R=8 C={c} 16/4 heads", label, nb, fl,
                 lambda: b5.paged_sdpa_plain(q_r, kp_r, vp_r, tb, kl,
                                             scale=128 ** -0.5),
                 ragged_library(torch, F, q_r, kp_r, vp_r, tb, kl, ch))
    print("serve_tp kernel times " + json.dumps(timed), flush=True)
    return dict(checks=checks, times=timed, all_reduce=dict(
        calls=ar["calls"], ms_per_call=1e3 * ar["seconds"]
        / max(1, ar["calls"]), backend="gloo through the host, one card"),
        step_s=time.perf_counter() - t0)


def ragged_work(q, kp, kv_len, chunk):
    """(bytes, operations) of paged attention over these rows: q in and
    out, each live row's K and V once, 4 D a visible (query, key)."""
    r, c, hq, d = q.shape
    hkv, item = kp.shape[1], kp.element_size()
    nbytes, pairs = 2 * r * c * hq * d * 2, 0
    for kvl, ch in zip(kv_len.tolist(), chunk.tolist()):
        if ch <= 0:
            continue
        nbytes += 2 * kvl * hkv * d * item
        pairs += sum(kvl - ch + j + 1 for j in range(ch))
    return nbytes, 4.0 * d * hq * pairs


def ragged_library(torch, F, q, kp, vp, tables, kv_len, chunk):
    """SDPA over the gathered pages (the gather outside the timing)."""
    r, c, hq, d = q.shape
    maxp, ps = tables.shape[1], kp.shape[2]
    idx = tables.long().clamp(0, kp.shape[0] - 1)

    def gather(pool):
        g = pool[idx].to(torch.bfloat16)
        return g.permute(0, 2, 1, 3, 4).reshape(r, -1, maxp * ps, d)
    kg, vg = gather(kp), gather(vp)
    kpos = torch.arange(maxp * ps, device=q.device)
    qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
        kpos[None, None, :] < kv_len[:, None, None])
    mask[..., 0] = True
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=mask[:, None],
        enable_gqa=qt.shape[1] != kg.shape[1])


def gqa_step(torch, dev) -> dict:
    t0 = time.perf_counter()
    ranks = spawn(GQA_TP, ["gqa"])
    inp = Inputs(torch, dev)
    checks = []
    for case, (_, unsharded, axis) in attn_calls(inp, GQA_TP, 0,
                                                 gqa=True).items():
        parts = [ranks[r]["gqa"][case] for r in range(GQA_TP)]
        live = B1_LIVE if case.startswith("B1s") else None
        checks.append(check_split(torch, f"GQA tp=4 8/2 heads {case}",
                                  parts, unsharded(), axis, live))
    print("serve_tp gqa " + json.dumps(checks), flush=True)
    return dict(checks=checks, step_s=time.perf_counter() - t0)


def serve_step(torch, dev) -> dict:
    """The ranks' runs, then each held against tp = 1 here."""
    import numpy as np

    from ipex_llm_tpu_torch.kv import PagedKVCache
    from ipex_llm_tpu_torch.models.decoder import decoder_forward
    from ipex_llm_tpu_torch.serving.engine import (Request, ServingEngine,
                                                   stream_tokens)
    t0 = time.perf_counter()
    ranks = spawn(TP, ["serve"])
    runs = {r["run"]: {rank: ranks[rank]["serve"][i] for rank in range(TP)}
            for i, r in enumerate(ranks[0]["serve"])}
    path = {"llama": ("B1s", "B2s col", "B2s row"),
            "mistral": ("B3s", "B4s", "B2s col", "B2s row")}
    for label, name, pool, family, kind in serve_runs():
        for rank, res in runs[label].items():
            if res["plain_calls"]:
                fail(f"{label} rank {rank}: {res['plain_calls']} plain "
                     "calls")
            missing = [k for k in path[name] if res["launches"][k] == 0]
            if missing:
                fail(f"{label} rank {rank}: {missing} never launched")
            oracle = {k: res["launches"][k] for k in
                      ("B5", "B5s prefill", "B5s decode")
                      if res["launches"][k]}
            if oracle:   # B5 is B1's oracle, never dispatched
                fail(f"{label} rank {rank}: B5 launched {oracle}")
        lead = runs[label][0]
        n_req = len(requests(kind, 32000))
        if lead["finish"] != ["length"] * n_req or not lead["streams_equal"]:
            fail(f"{label}: finish reasons {lead['finish']}")
        if any(runs[label][r]["launches"] != lead["launches"]
               for r in range(TP)):
            fail(f"{label}: the ranks launched different kernels")

    def one_shot_logits(cfg, params, prompt, out, storage):
        """The logits after ``prompt + out`` from one prefill over a fresh
        one-row pool of ``storage`` (a numeric path of its own: B2 at M =
        the whole sequence), the arbiter of a greedy fork."""
        ids = list(prompt) + list(out)
        t = len(ids)
        maxp = -(-t // 128)
        cache = PagedKVCache.init(cfg.num_layers, 1 + maxp, 1, maxp,
                                  cfg.num_kv_heads, 128, cfg.head_dim,
                                  storage=storage, device=dev)
        cache.tables.copy_(1 + torch.arange(maxp, dtype=torch.int32))
        logits, _ = decoder_forward(
            cfg, params, torch.tensor([ids], dtype=torch.int32, device=dev),
            cache, torch.arange(t, device=dev)[None],
            slot_offsets=torch.zeros(1, dtype=torch.int32, device=dev))
        return logits[0, len(prompt) - 1:].float()

    def ulps_below_top(row, tok):
        top = float(row.max())
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        return (top - float(row[tok])) / ulp

    gates, tp1_runs, models, misses = [], {}, {}, []
    for label, name, pool, family, kind in serve_runs()[:3]:
        if name not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[name] = model(name, dev)
        cfg, params = models[name]
        eng = ServingEngine(cfg, params, engine_config(pool), device=dev)
        eng.start()
        t1 = time.perf_counter()
        reqs = [eng.submit(Request(**f))
                for f in requests(kind, cfg.vocab_size)]
        for r in reqs:
            list(stream_tokens(r, timeout=600))
        wall = time.perf_counter() - t1
        eng.stop()
        out_tok = sum(len(r.output_ids) for r in reqs)
        tp1_runs[label] = dict(output_tok_s=out_tok / wall, wall_s=wall,
                               ttft_mean_s=float(np.mean(
                                   [r.first_token_s for r in reqs])))
        lead = runs[label][0]
        for i, r in enumerate(reqs):
            a, lp_a = lead["tokens"][i], lead["logprobs"][i]
            b, lp_b = r.output_ids, r.logprobs
            j = next((j for j in range(min(len(a), len(b)))
                      if a[j] != b[j]), None)
            n = len(a) if j is None else j
            dlp = np.abs(np.subtract(lp_a[:n], lp_b[:n])) if n else [0.0]
            gate = dict(run=label, request=i, greedy=r.temperature == 0,
                        first_fork=j, prefix=n,
                        logprob_mean_nats=float(np.mean(dlp)),
                        logprob_max_nats=float(np.max(dlp)))
            if gate["logprob_mean_nats"] > LP_MEAN_NATS:
                misses.append(f"{label} request {i}: logprobs before the "
                              f"fork differ by {gate['logprob_mean_nats']} "
                              "nats on average")
            if j is not None and gate["greedy"]:
                row = one_shot_logits(cfg, params, r.prompt_ids, b[:j],
                                      pool)[j]
                top2 = torch.topk(row, 2)
                gate.update(tp2_token=a[j], tp1_token=b[j],
                            tp2_below_top_ulps=ulps_below_top(row, a[j]),
                            tp1_below_top_ulps=ulps_below_top(row, b[j]),
                            one_shot_top2=top2.indices.tolist(),
                            top2_gap_ulps=ulps_below_top(
                                row, int(top2.indices[1])))
                low = max(gate["tp2_below_top_ulps"],
                          gate["tp1_below_top_ulps"])
                if low > SPEC_ULPS:
                    misses.append(
                        f"{label} request {i}: greedy streams fork at token "
                        f"{j} to a token {low:.2f} ulps below the top logit "
                        f"(bound {SPEC_ULPS})")
            gates.append(gate)
        del eng
        torch.cuda.empty_cache()
    # the quantized families against the exact one on the same requests
    exact = runs["llama bf16 pool"][0]
    fam_gate = []
    for label in ("llama e5m2 family", "llama int8 family"):
        run = runs[label][0]
        base_lp = [exact["logprobs"][i] for i in range(0, 8, 2)]
        base_tok = [exact["tokens"][i] for i in range(0, 8, 2)]

        def ppl(lps):
            flat = [x for row in lps for x in row]
            return math.exp(-sum(flat) / max(len(flat), 1))
        ratio = ppl(run["logprobs"]) / ppl(base_lp)
        pairs = [(g, b) for gr, br in zip(run["tokens"], base_tok)
                 for g, b in zip(gr, br)]
        match = sum(g == b for g, b in pairs) / len(pairs)
        fam_gate.append(dict(run=label, ppl_ratio=ratio,
                             greedy_token_match=match))
        if ratio >= PPL_RATIO:
            misses.append(f"{label}: perplexity {ratio} of the exact "
                          f"family's (bound {PPL_RATIO})")
    print("serve_tp gate " + json.dumps(dict(forks=[
        g for g in gates if g["first_fork"] is not None],
        families=fam_gate, tp1=tp1_runs)), flush=True)
    if misses:
        fail("; ".join(misses))
    summary = {label: {rank: {k: v for k, v in res.items()
                              if k not in ("tokens", "logprobs", "ttft",
                                           "finish")}
                       for rank, res in by_rank.items()}
               for label, by_rank in runs.items()}
    for by_rank in summary.values():    # a follower emits rank 0's tokens
        for res in by_rank.values():
            res["output_tok_s"] = by_rank[0]["output_tokens"] / res["wall_s"]
    return dict(runs=summary, gates=gates, families=fam_gate, tp1=tp1_runs,
                step_s=time.perf_counter() - t0)


def kernel_rows(report: dict) -> list[dict]:
    """The ``kernels`` line's rows of the sharded wrappers: launches from
    rank 0 of the serving runs (B5s, B1s's oracle, shows the 0 that
    ``serve_step`` requires), the
    worst error against the unsharded kernel, one timed shape each."""
    launches = {}
    for res in report.get("serve", {}).get("runs", {}).values():
        for k, n in res[0]["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rows = []
    checks = report["kernels"]["checks"] + [
        dict(c, kernel=" ".join(c["case"].split(" ")[4:6])
             if "B5s" in c["case"] else c["case"].split(" ")[4])
        for c in report.get("gqa", {}).get("checks", [])]
    for name, (src, replaces) in KERNELS.items():
        t = next(r for r in report["kernels"]["times"] if r["name"] == name)
        errs = [c["max_abs_err"] for c in checks if c["kernel"] == name]
        rows.append(dict(
            name=name, route="cuda", source=_CSRC + src,
            replaces=_PALLAS + replaces, launches=launches.get(name, 0),
            max_abs_err=max(errs), ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], case=t["case"],
            bitwise={c["case"]: c["bitwise"] for c in checks
                     if c["kernel"] == name}))
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_tp_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_tp_smoke: steps are {STEPS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import (_build, decode_attention,
                                             flash_attention, paged_attention,
                                             qmatmul, ragged_paged_attention)
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (qmatmul, ragged_paged_attention, decode_attention,
            flash_attention, paged_attention)
    build_s = _build.build(_build.sources(mods))   # before any rank
    print(f"kernel build: {build_s:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    report = dict(card=card, build_s=build_s)
    if "kernels" in steps:
        report["kernels"] = kernels_step(torch, dev, card, graph_ms)
        torch.cuda.empty_cache()
    if "gqa" in steps:
        report["gqa"] = gqa_step(torch, dev)
    if "serve" in steps:
        report["serve"] = serve_step(torch, dev)
    report["phase_s"] = time.perf_counter() - t0
    if "kernels" in steps:
        report["kernel_rows"] = kernel_rows(report)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tp_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(dict(ok=True, phase_s=report["phase_s"],
                          kernels=report.get("kernel_rows", []))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
