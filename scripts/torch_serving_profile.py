#!/usr/bin/env python3
"""Where the time of the PyTorch port's serving ticks goes, on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_serving_profile.py

It serves Llama-2-7B widths (random sym_int4 weights from a seed) with the
engine of ``chip_smoke.py`` (8 rows, page 128, prefill bucket 128, decode
horizon 4), driving the engine's transactional tick (``_tick``, what the
engine thread runs) by hand, over two windows: the
admission wave (mixed ticks, 8 prompts of 512 tokens) and the steady
decode that follows (64 new tokens each); first without speculation, then
with prompt-lookup speculation (``spec_k`` 3) on the same traffic.  The
traffic runs twice: once for the host wall clock, once under
``torch.profiler`` for the kernels' device time.  For each window it
prints the wall time, the summed device time of the kernels, the device's
idle share (1 - device time / wall), the kernel launches per tick, the
decode iterations (verify rounds with speculation), the host time per tick
of the transaction's checkpoint and of its commit (which flushes the
tick's staged emissions to the client queues) on the unprofiled pass, and
the kernels ranked by device time.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def profile_engine(eng, cfg, spec_k: int) -> list:
    """The two windows of one engine, unprofiled then profiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ipex_llm_tpu_torch.serving.engine import Request

    gen = torch.Generator().manual_seed(5)

    def submit_wave(n_req, n_prompt, n_new):
        reqs = [Request(prompt_ids=torch.randint(
            1, cfg.vocab_size, (n_prompt,), generator=gen).tolist(),
            max_new_tokens=n_new) for _ in range(n_req)]
        for r in reqs:
            eng.submit(r)
        return reqs

    # host seconds inside the transaction's checkpoint and commit
    txn = {"checkpoint": 0.0, "commit": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                txn[name] += time.perf_counter() - t0
        return run

    eng._checkpoint = timed("checkpoint", eng._checkpoint)
    eng._commit = timed("commit", eng._commit)

    def run_window(more) -> tuple[float, int, int, dict]:
        torch.cuda.synchronize()
        txn0 = dict(txn)
        t0 = time.perf_counter()
        ticks, steps = 0, eng.metrics["steps"]
        while more():
            if not eng._tick():
                raise RuntimeError(f"tick rolled back: "
                                   f"{eng.metrics.get('last_error')}")
            ticks += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, ticks,
                eng.metrics["steps"] - steps,
                {k: txn[k] - txn0[k] for k in txn})

    # warm-up: builds the kernels and touches every code path
    warm = submit_wave(2, 128, 8)
    run_window(lambda: not all(r.finish_reason for r in warm))

    # the same traffic twice: unprofiled for the wall clock, then under
    # the profiler for the kernels' device time (profiling slows the host)
    walls, rows = {}, []
    names = ("admission wave (mixed ticks)", "steady decode (horizon 4)")
    for profiled in (False, True):
        reqs = submit_wave(8, 512, 64)
        windows = (lambda: bool(eng._pending or eng._prefilling
                                or not eng._inbox.empty()),
                   lambda: not all(r.finish_reason for r in reqs))
        for name, more in zip(names, windows):
            if not profiled:
                walls[name] = run_window(more)
                continue
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_prof, _, _, _ = run_window(more)
            kern: dict[str, list] = {}
            for ev in prof.events():
                if ev.device_type != DeviceType.CUDA:
                    continue
                k = kern.setdefault(ev.name, [0.0, 0])
                k[0] += ev.device_time_total / 1e6
                k[1] += 1
            wall, ticks, steps, host = walls[name]
            busy = sum(v[0] for v in kern.values())
            top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
            row = {"spec_k": spec_k, "window": name, "ticks": ticks,
                   "decode_iterations": steps, "wall_s": wall,
                   "wall_s_profiled": wall_prof, "device_s": busy,
                   "idle_share": 1.0 - busy / wall,
                   "launches_per_tick": sum(v[1] for v in kern.values())
                   / max(ticks, 1),
                   "checkpoint_ms_per_tick": 1e3 * host["checkpoint"]
                   / max(ticks, 1),
                   "commit_ms_per_tick": 1e3 * host["commit"]
                   / max(ticks, 1),
                   "checkpoint_share_of_wall": host["checkpoint"] / wall,
                   "top": [{"kernel": k[:80], "s": v[0], "launches": v[1]}
                           for k, v in top]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ipex_llm_tpu_torch.models.random_init import (llama2_7b_config,
                                                       random_params)
    from ipex_llm_tpu_torch.serving.engine import EngineConfig, ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = llama2_7b_config()
    params = random_params(cfg, "sym_int4", seed=0, device=dev)
    rows = []
    for spec_k in (0, 3):
        eng = ServingEngine(cfg, params, EngineConfig(
            max_rows=8, max_seq_len=2048, page_size=128, prefill_bucket=128,
            decode_horizon=4, spec_k=spec_k), device=dev)
        rows += profile_engine(eng, cfg, spec_k)
        del eng
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_serving_profile.json").write_text(
        json.dumps({"card": card, "windows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
