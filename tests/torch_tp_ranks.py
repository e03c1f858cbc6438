"""Tensor-parallel ranks for the CPU tests: each rank a spawned process of
a gloo group over CPU tensors, meeting the others through a ``FileStore``
under the test's ``tmp_path`` (never a fixed TCP port: the suite runs
under several xdist workers), with one thread, ``GLOO_SOCKET_IFNAME=lo``,
a group timeout of a few seconds (joining the group may take minutes:
``parallel/mesh.py``'s ``RENDEZVOUS_S``) and a join timeout on every
spawn.

This module imports neither JAX nor the JAX package, so a rank process
starts with torch and the port alone; the test files compute the JAX side
in the parent and hand the ranks numpy or torch inputs.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback

GROUP_TIMEOUT_S = 10.0
JOIN_TIMEOUT_S = 120.0


def spawn(fn, size: int, tmp_path, *args, timeout_s: float = GROUP_TIMEOUT_S,
          join_s: float = JOIN_TIMEOUT_S, device: str = "cpu") -> dict:
    """Run ``fn(group, *args)`` on ranks 0..size-1, each in a spawned
    process with its group on ``device`` (every rank on the same one);
    returns {rank: its result, "wall_s": {rank: seconds}}.  A rank that
    raises, or that has not answered within ``join_s``, fails the call
    (the processes are terminated)."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{size}")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(rank, size, store, timeout_s, fn, args, q,
                               device))
             for rank in range(size)]
    for p in procs:
        p.start()
    out: dict = {"wall_s": {}}
    deadline = time.monotonic() + join_s
    try:
        while len(out) - 1 < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn.__name__}: ranks {sorted(out)} "
                                   f"answered within {join_s} s")
            try:
                rank, ok, res, wall = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"{fn.__name__}: a rank exited with "
                        f"{dead[0].exitcode} before answering")
                continue
            if not ok:
                raise RuntimeError(f"{fn.__name__} rank {rank}:\n{res}")
            out[rank] = res
            out["wall_s"][rank] = wall
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return out


def _entry(rank, size, store_path, timeout_s, fn, args, q, device):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    import torch

    torch.set_num_threads(1)
    t0 = time.monotonic()
    try:
        import torch.distributed as dist

        from ipex_llm_tpu_torch.parallel.mesh import (destroy_tp_group,
                                                      init_tp_group)

        group = init_tp_group(size, rank, backend="gloo", device=device,
                              store=dist.FileStore(store_path, size),
                              timeout_s=timeout_s)
        res = fn(group, *args)
        q.put((rank, True, res, time.monotonic() - t0))
        destroy_tp_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent
        q.put((rank, False, traceback.format_exc(), time.monotonic() - t0))


# -- rank functions ------------------------------------------------------------

def collectives_rank(group, x, qtypes, cases):
    """Every family's all-reduce of this rank's share of ``x`` (axis 0
    split over the ranks), ``psum_exact`` of bf16 values, the all-gather of
    the rank's block along the last axis and the group's health; then B2s
    row over ``cases`` [(x [M, K], QTensor, family)]: this rank's
    contraction rows of each weight against its columns of ``x``, the fp32
    partials summed under the family (outputs, each case's fp32 partial on
    this rank from B2 itself, plain calls made through B2s row)."""
    import torch

    from ipex_llm_tpu_torch.ops import collectives
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.parallel.bootstrap import health
    from ipex_llm_tpu_torch.parallel.shard import shard_qtensor

    n = x.shape[0] // group.size
    mine = torch.from_numpy(x[group.rank * n:(group.rank + 1) * n])
    out = {q: collectives.all_reduce(mine, group, q).numpy()
           for q in qtypes}
    out["psum_bf16"] = collectives.psum_exact(
        mine.to(torch.bfloat16), group).float().numpy()
    out["gather"] = collectives.all_gather_last(mine, group).numpy()
    out["calls"] = dict(collectives.COUNTS.calls)
    out["health"] = health(group)
    rows, partials = [], []
    for xc, qt, qtype in cases:
        k = xc.shape[-1] // group.size
        xr = xc[:, group.rank * k:(group.rank + 1) * k].contiguous()
        qr = shard_qtensor(qt, "row", group.size, group.rank)
        y = b2.qmatmul_sharded(xr, qr, "row", group, qtype=qtype)
        rows.append(y.float().numpy())
        partials.append(b2.qmatmul(xr, qr, keep_f32=True).numpy())
    return out, (rows, partials, b2.SHARDED_ROW.plain_calls)


def engine_rank(group, models, runs):
    """Each of ``runs`` (dicts: ``model`` an index into ``models``, (cfg,
    whole param tree) pairs; ``ec`` the EngineConfig fields, ``reqs``
    the requests' fields, ``faults`` the injector's script, dicts of
    ``FaultInjector.inject``'s arguments with ``exc`` a class name of
    ``serving/faults.py`` and ``ranks`` the ranks it is scripted on)
    through a fresh tp engine, driven tick by tick (rank 0 submits, a
    follower records the requests its tick messages bring); returns each
    run's streams, finish reasons and metrics."""
    from ipex_llm_tpu_torch.serving import engine as engine_mod
    from ipex_llm_tpu_torch.serving import faults
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine)

    followed = []

    class _Recorded(Request):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            followed.append(self)

    engine_mod.Request = _Recorded
    out = []
    for run in runs:
        inj = None
        if run.get("faults"):
            inj = faults.FaultInjector()
            for f in run["faults"]:
                f = dict(f)
                if group.rank in f.pop("ranks"):
                    inj.inject(f.pop("site"), getattr(faults, f.pop("exc")),
                               **f)
        followed.clear()
        cfg, params = models[run["model"]]
        eng = ServingEngine(cfg, params, EngineConfig(**run["ec"]),
                            device="cpu", tp=group, fault_injector=inj)
        t0 = time.monotonic()
        if group.leader:
            reqs = [eng.submit(Request(**f)) for f in run["reqs"]]
            while any(r.finish_reason is None for r in reqs) \
                    and not eng._stop.is_set():
                eng._tick()
            eng.stop()
        else:
            while not eng._stop.is_set():
                eng._tick()
            reqs = list(followed)
        out.append(dict(
            tokens=[list(r.output_ids) for r in reqs],
            logprobs=[list(r.logprobs) for r in reqs],
            finish=[r.finish_reason for r in reqs],
            metrics={k: eng.metrics.get(k, 0)
                     for k in ("retries", "errors_isolated", "errors",
                               "ticks", "spec_steps")},
            last_error=str(eng.metrics.get("last_error", "")),
            parallel=eng.parallel_stats(),
            seconds=time.monotonic() - t0))
        if eng._tp_dead:
            break
    return out


def cuda_cases(dev, group=None) -> dict:
    """B1s (split and tiles), B2s col and row, B4s on inputs drawn from
    seeds on ``dev``: with a ``group``, the rank's outputs (B2 row summed
    over the group); without, the unsharded kernels'.  float32 numpy."""
    import torch

    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
    from ipex_llm_tpu_torch.parallel.shard import shard_qtensor
    from ipex_llm_tpu_torch.quantize.core import quantize

    tp, rank = (1, 0) if group is None else (group.size, group.rank)
    g = torch.Generator(device=dev).manual_seed(5)

    def heads(x, axis):
        n = x.shape[axis] // tp
        return x.narrow(axis, rank * n, n).contiguous()

    out = {}
    for mode, k, n in (("col", 1024, 768), ("row", 1024, 512)):
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      "sym_int4")
        for m in (1, 40):
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            if group is None:
                y = b2.qmatmul(x, qt)
            elif mode == "col":
                y = b2.qmatmul_sharded(x, shard_qtensor(qt, "col", tp, rank),
                                       "col")
            else:
                y = b2.qmatmul_sharded(heads(x, 1), shard_qtensor(
                    qt, "row", tp, rank), "row", group)
            out[f"b2 {mode} M={m}"] = y.float().cpu().numpy()
    r, hq, hkv, d, ps, maxp = 4, 8, 4, 128, 64, 6
    kp = torch.randn(1 + r * maxp, hkv, ps, d, generator=g,
                     device=dev).to(torch.bfloat16)
    vp = torch.randn(kp.shape, generator=g, device=dev).to(torch.bfloat16)
    tables = (1 + torch.randperm(r * maxp, generator=g, device=dev)).to(
        torch.int32).reshape(r, maxp)
    kv_len = torch.tensor([384, 200, 65, 7], dtype=torch.int32, device=dev)
    for c in (1, 64):
        q = torch.randn(r, c, hq, d, generator=g, device=dev).to(
            torch.bfloat16)
        chunk = torch.full((r,), c, dtype=torch.int32, device=dev).minimum(
            kv_len)
        if group is None:
            y = b1.ragged_paged_sdpa(q, kp, vp, tables, kv_len, chunk)
        else:
            y = b1.ragged_paged_sdpa_sharded(
                heads(q, 2), heads(kp, 1), heads(vp, 1), tables, kv_len,
                chunk, tp=tp, rank=rank, n_kv_heads=hkv)
        out[f"b1 C={c}"] = y.float().cpu().numpy()
    q = torch.randn(2, 96, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kk = torch.randn(2, 96, hkv, d, generator=g, device=dev).to(
        torch.bfloat16)
    vv = torch.randn(2, 96, hkv, d, generator=g, device=dev).to(
        torch.bfloat16)
    ks = torch.tensor([0, 30], dtype=torch.int32, device=dev)
    y = (b4.flash_sdpa(q, kk, vv, kv_start=ks) if group is None else
         b4.flash_sdpa_sharded(heads(q, 2), heads(kk, 2), heads(vv, 2),
                               tp=tp, n_kv_heads=hkv, kv_start=ks))
    out["b4"] = y.float().cpu().numpy()
    if group is not None:
        out["launches"] = (b1.SHARDED.launches, b2.SHARDED_COL.launches,
                           b2.SHARDED_ROW.launches, b4.SHARDED.launches)
        out["plain"] = (b1.SHARDED.plain_calls + b2.SHARDED_COL.plain_calls
                        + b2.SHARDED_ROW.plain_calls + b4.SHARDED.plain_calls)
    return out


def cuda_sharded_rank(group):
    """:func:`cuda_cases` for this rank on its card."""
    return cuda_cases(group.device, group)


def server_rank0(tmp_dir, ckpt, tokenizer):
    """Rank 0 of ``build_server(tensor_parallel_size=2)`` (which starts
    rank 1 itself) over gloo on the CPU: /health's ``parallel`` block and
    one completion's text; the engine's stop ends rank 1."""
    import asyncio

    from ipex_llm_tpu_torch.parallel.mesh import destroy_tp_group
    from ipex_llm_tpu_torch.serving.api_server import build_server
    from ipex_llm_tpu_torch.serving.engine import EngineConfig

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    srv = build_server(ckpt, "sym_int4", EngineConfig(
        max_rows=2, max_seq_len=128, page_size=16, prefill_bucket=16,
        collective_qtype="int8"), tokenizer=tokenizer, device="cpu",
        tensor_parallel_size=2, tp_backend="gloo", tp_timeout_s=30.0)
    try:
        done = asyncio.run(srv.call("POST", "/v1/completions", {
            "prompt": "1 2 3", "max_tokens": 4})).body
        health = asyncio.run(srv.call("GET", "/health")).body
    finally:
        srv.engine.stop()
        procs_done = all(p.exitcode is not None for p in srv.engine._tp_procs)
        destroy_tp_group()
    return health, done, procs_done


def run_server_rank0(tmp_path, ckpt, tokenizer) -> tuple:
    """:func:`server_rank0` in one spawned process (the group must not
    live in the test process)."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    # not a daemon: it starts the follower rank itself
    p = ctx.Process(target=_server_entry,
                    args=(str(tmp_path), ckpt, tokenizer, q))
    p.start()
    try:
        ok, res = q.get(timeout=JOIN_TIMEOUT_S)
    finally:
        p.join(30)
        if p.is_alive():
            p.terminate()
    if not ok:
        raise RuntimeError(res)
    return res


def _server_entry(tmp_dir, ckpt, tokenizer, q):
    import torch

    torch.set_num_threads(1)
    try:
        q.put((True, server_rank0(tmp_dir, ckpt, tokenizer)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        q.put((False, traceback.format_exc()))
