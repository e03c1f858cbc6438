#!/usr/bin/env python3
"""The port's model families beyond llama on one card: small qwen2 and
gemma2 decoders against the CPU, then Mistral-7B-v0.1, Qwen2-7B and
Gemma-2-9B at full width, cut to ``SERVE_LAYERS`` layers, through
``ServingEngine`` (and ``generate()`` for the last two), from random
sym_int4 weights drawn on the card from a seed.

``chip_smoke.py`` runs this as its ``families`` phase; alone, from the
root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_families_smoke.py

Steps (each fails the run on a miss; nothing retries on the CPU):

1. a small qwen2 (hidden 512, 7 query heads over 1 kv head of 128: B1 at
   G = 7, a qkv bias) and a small gemma2 (hidden 512, 4 query heads over 2
   kv heads of 256, a window of 24 on its first layer, softcaps 50 and 30:
   the gathered route, B3 and B4 at head_dim 256; an attention scale of 6
   so that the softcap binds) on the card against the same models on the
   CPU's plain versions, paged (prefill chunks of 40, 17 and 29 ids, three
   decode steps) and dense (a left-padded prefill of the same rows, four
   decode steps): logits within 2.5% of their range, and gemma2's
   attention softcap moving the CPU's logits by more than twice that;
2. each of Mistral-7B-v0.1, Qwen2-7B and Gemma-2-9B (their published
   ``config.json`` widths, the first ``SERVE_LAYERS`` layers: the depth
   is cut so that ``chip_smoke.py`` keeps within its time with the phases
   after this one; every layer of a model runs the same kernels, so the
   cut changes launches and time a tick, not which kernels run) through
   ``ServingEngine`` with
   ``SERVE_EC`` over a bf16 pool: eight requests, six of 64-1000 ids and
   two of 4300-5000 (past the 4096 window), 32-64 new tokens, half greedy
   and half seeded; then two of them over an e5m2 pool.  Every request
   finishes with its tokens; B2 launches on every path, B1 on Qwen2's
   (its layers have no window or softcap), B3 and B4 on the windowed ones
   (the gathered route), where B1 launches zero times; no plain version
   runs.  For the windowed models one decode tick (eight rows, horizon
   4) is profiled under ``torch.profiler``: the device time of the
   gather (``kv.gather_rows``: the index over the pool and the copy into
   the head-major layer) over the tick's;
3. ``generate()`` for Qwen2-7B and Gemma-2-9B: four prompts of 4500,
   1990, 611 and 203 ids, 32 new tokens, greedy, bf16 cache: B2, B3 and
   B4 launch, no plain version runs, every row gets its tokens.

Printed, beside the card's name and power limit: output tok/s and TTFT,
peak device memory (``torch.cuda.max_memory_allocated`` over each run)
and the gather's share.  Each model is freed before the next.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from dataclasses import replace

ROOT = pathlib.Path(__file__).resolve().parents[1]

SERVE_EC = dict(max_rows=8, max_seq_len=6144, page_size=128,
                prefill_bucket=128, decode_horizon=4)
# the layers each full-width model keeps (of 32, 28 and 42; Gemma-2-9B's
# first eight alternate sliding and full as its 42 do)
SERVE_LAYERS = 8
GENERATE_LENGTHS = (4500, 1990, 611, 203)


def small_check(cfg, seed, dev, fail, label: str | None = None,
                forms=("paged", "dense"), params=None,
                paged_decode_steps: int = 3) -> dict:
    """A decoder on the card (``dev``) against the same decoder on the
    CPU's plain versions, paged (prefill chunks of 40, 17 and 29 ids,
    ``paged_decode_steps`` decode steps) and dense (a left-padded prefill
    of the same rows, four decode steps), or the ``forms`` named, over
    ``params`` (a CPU tree; by default ``random_params`` of ``seed`` on
    the CPU): the worst card-vs-CPU logit gap of each form over
    the logits' range (bound 2.5%); with an attention softcap, also the
    gap it makes on the CPU (``softcap_gap``, the dense form without the
    cap), which must pass twice the bound so a kernel that left it out
    would fail."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
    from ipex_llm_tpu_torch.models.decoder import decoder_forward
    from ipex_llm_tpu_torch.models.random_init import random_params

    label = label or cfg.model_type
    p_cpu = params if params is not None else random_params(
        cfg, "sym_int4", seed=seed, device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev) if hasattr(tree, "to") else tree
    p_dev = to_dev(p_cpu)
    rng = np.random.default_rng(seed)
    r, t, ps, maxp = 3, 40, 128, 2
    lengths = np.array([40, 17, 29], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (r, t)).astype(np.int32)
    decode = [rng.integers(0, cfg.vocab_size, (r, 1)).astype(np.int32)
              for _ in range(4)]
    worst = {}
    for form in forms:
        outs = {}
        runs = [("cpu", "cpu", p_cpu, cfg), ("cuda", dev, p_dev, cfg)]
        if form == "dense" and cfg.attn_softcap is not None:
            runs.append(("uncapped", "cpu", p_cpu,
                         replace(cfg, attn_softcap=None)))
        for name, where, params, cfg_ in runs:
            def to(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(
                    where)
            logits = []
            if form == "paged":
                c = PagedKVCache.init(cfg_.num_layers, 1 + r * maxp, r,
                                      maxp, cfg_.num_kv_heads, ps,
                                      cfg_.head_dim, device=where,
                                      v_head_dim=cfg_.v_dim)
                c.tables.copy_(1 + torch.arange(
                    r * maxp, dtype=torch.int32).reshape(r, maxp))
                zero = np.zeros(r, np.int32)
                lg, _ = decoder_forward(
                    cfg_, params, to(toks), c,
                    to(np.arange(t)[None].repeat(r, 0)),
                    slot_offsets=to(zero), chunk_lens=to(lengths),
                    gather_positions=to(lengths - 1))
                logits.append(lg)
                lens = lengths.copy()
                for tk in decode[:paged_decode_steps]:
                    lg, _ = decoder_forward(
                        cfg, params, to(tk), c, to(lens[:, None]),
                        slot_offsets=to(lens), last_token_only=True)
                    logits.append(lg)
                    lens = lens + 1
            else:
                padded = np.zeros_like(toks)
                for i, n in enumerate(lengths):
                    padded[i, t - n:] = toks[i, :n]
                kv_start = (t - lengths).astype(np.int32)
                pos = np.maximum(np.arange(t)[None] - kv_start[:, None],
                                 0)
                c = make_cache("normal", cfg_.num_layers, r, t + 16,
                               cfg_.num_kv_heads, cfg_.head_dim,
                               v_head_dim=cfg_.v_dim, device=where)
                steps = [(padded, pos)] + [
                    (tk, (lengths + i)[:, None])
                    for i, tk in enumerate(decode)]
                for tk, p in steps:
                    lg, _ = decoder_forward(cfg_, params, to(tk), c,
                                            to(p), to(kv_start),
                                            last_token_only=True)
                    logits.append(lg)
            outs[name] = [lg.float().cpu().numpy() for lg in logits]
        w = 0.0
        for a, b in zip(outs["cuda"], outs["cpu"]):
            span = b.max() - b.min()
            diff = float(np.abs(a - b).max() / span)
            if not np.isfinite(a).all() or diff > 0.025:
                fail(f"small {label} {form}: card vs "
                     f"CPU logits differ by {diff:.4f} of the range "
                     "(bound 0.025)")
            w = max(w, diff)
        worst[form] = w
        if "uncapped" in outs:
            gap = max(float(np.abs(a - b).max() / (b.max() - b.min()))
                      for a, b in zip(outs["uncapped"], outs["cpu"]))
            if gap < 0.05:
                fail(f"small {label}: the attention "
                     f"softcap moves the logits by {gap:.4f} of their "
                     "range, under twice the bound")
            worst["softcap_gap"] = gap
    return worst


def families_phase(kernels: dict, card: str, fail, device) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ipex_llm_tpu_torch.models.random_init import (
        GEMMA2_9B_HF, MISTRAL_7B_V01_HF, QWEN2_7B_HF, gemma2_9b_config,
        mistral_7b_config, qwen2_7b_config, random_params)
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    dev = device
    res: dict = {"card": card}
    t_phase = time.perf_counter()

    def reset():
        for mod in kernels.values():
            mod.COUNTS.reset()

    def gate(what, need, absent):
        """Every kernel of ``need`` launched, none of ``absent``, no plain
        version run; returns the launches by kernel."""
        out = {}
        for name, mod in kernels.items():
            n, plain = mod.COUNTS.launches, mod.COUNTS.plain_calls
            if plain or (mod in need and n == 0) or (mod in absent and n):
                fail(f"families {what}: {name} launched {n} times, plain "
                     f"version called {plain} times")
            out[name] = n
        return out

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev) if hasattr(tree, "to") else tree

    # -- 1. small decoders, card against CPU ---------------------------------
    reset()
    small_qwen2 = qwen2_7b_config(hidden_size=512, intermediate_size=1024,
                                  num_layers=2, num_heads=7, num_kv_heads=1,
                                  vocab_size=512)
    # an attention scale of 6 (96 times the published 256 ** -0.5) so that
    # the scores pass the attention softcap of 50
    small_gemma2 = gemma2_9b_config(
        hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4,
        num_kv_heads=2, vocab_size=512, sliding_window=24,
        layer_types=("sliding_attention", "full_attention"), attn_scale=6.0)
    res["small"] = {"qwen2": small_check(small_qwen2, 3, dev, fail),
                    "gemma2": small_check(small_gemma2, 4, dev, fail)}
    res["small_launches"] = {n: m.COUNTS.launches for n, m in kernels.items()}
    res["small_launches_by_head_dim"] = {
        "decode_attention": dict(b3.COUNTS.by_head_dim),
        "flash_attention": dict(b4.COUNTS.by_head_dim)}
    if not (b3.COUNTS.by_head_dim[256] and b4.COUNTS.by_head_dim[256]
            and b1.COUNTS.launches):
        fail(f"families small: launches {res['small_launches']} "
             f"{res['small_launches_by_head_dim']}")
    print("families small decoders card vs CPU, worst logit diff over the "
          "range (bound 0.025): " + json.dumps(res["small"]), flush=True)

    # -- 2. full width through the engine, 3. generate() ---------------------
    def requests(cfg, n_req, seed):
        rng = np.random.default_rng(seed)
        lens = list(rng.integers(64, 1001, 6)) + list(
            rng.integers(4300, 5001, 2))
        lens = [lens[i] for i in rng.permutation(8)][:n_req]
        news = rng.integers(32, 65, n_req)
        return [Request(prompt_ids=[int(v) for v in rng.integers(
                    1, cfg.vocab_size, int(n))], max_new_tokens=int(m),
                        temperature=0.8 if i % 2 else 0.0,
                        top_p=0.9 if i % 2 else 1.0,
                        seed=3000 + i if i % 2 else None)
                for i, (n, m) in enumerate(zip(lens, news))]

    def serve(label, cfg, params, storage, n_req, seed, need, absent):
        eng = ServingEngine(cfg, params, EngineConfig(kv_storage=storage,
                                                      **SERVE_EC),
                            device=dev)
        reqs = requests(cfg, n_req, seed)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.start()
        t0 = time.perf_counter()
        for q in reqs:
            eng.submit(q)
        streams = [list(stream_tokens(q, timeout=900)) for q in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.stop()
        launches = gate(f"{label} serve {storage}", need, absent)
        for q, st in zip(reqs, streams):
            if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                    or st != q.output_ids or not all(
                        0 <= v < cfg.vocab_size for v in st):
                fail(f"families {label} {storage}: a request finished "
                     f"{q.finish_reason} with {len(st)} of "
                     f"{q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
        out_tok = sum(len(st) for st in streams)
        ttft = [q.first_token_s for q in reqs]
        row = dict(model=label, card=card, storage=storage,
                   layers=cfg.num_layers, requests=len(reqs),
                   prompt_tokens=sum(len(q.prompt_ids) for q in reqs),
                   longest_prompt=max(len(q.prompt_ids) for q in reqs),
                   output_tokens=out_tok, wall_s=wall,
                   output_tok_s=out_tok / wall,
                   ttft_mean_s=float(np.mean(ttft)),
                   ttft_max_s=float(np.max(ttft)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches,
                   launches_by_head_dim={
                       "decode_attention": dict(b3.COUNTS.by_head_dim),
                       "flash_attention": dict(b4.COUNTS.by_head_dim)},
                   b1_launches_by_route=dict(b1.COUNTS.by_route),
                   ticks=eng.metrics["steps"])
        print("families serve " + json.dumps(row), flush=True)
        del eng
        torch.cuda.empty_cache()
        return row

    def gather_share(label, cfg, params) -> dict:
        """One decode tick (eight rows of 64-1000 ids, horizon 4) under
        ``torch.profiler``: the device time of ``kv.gather_rows`` (the
        index over a pool layer, then the copy into the head-major layer,
        found by their input shapes) over all the tick's device time."""
        eng = ServingEngine(cfg, params, EngineConfig(**SERVE_EC),
                            device=dev)
        rng = np.random.default_rng(9)
        reqs = [eng.submit(Request(prompt_ids=[int(v) for v in rng.integers(
            1, cfg.vocab_size, int(n))], max_new_tokens=64))
            for n in rng.integers(64, 1001, 8)]
        for _ in range(200):
            eng._tick()
            if all(q.output_ids for q in reqs):
                break
        eng._tick()
        torch.cuda.synchronize()
        pool = list(eng.cache.k.shape[1:])           # [P, Hkv, page, D]
        head_major = [pool[1], eng.ec.max_pages, pool[2], pool[3]]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            eng._tick()
            torch.cuda.synchronize()
        total = gather = 0.0
        n_gather = 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                total += ev.device_time_total
            elif ev.input_shapes and ev.input_shapes[0] and (
                    (ev.name == "aten::index"
                     and list(ev.input_shapes[0]) == pool)
                    or (ev.name == "aten::reshape"
                        and list(ev.input_shapes[0])[1:] == head_major)):
                gather += ev.device_time_total
                n_gather += 1
        row = dict(model=label, card=card, rows=len(reqs),
                   horizon=eng.ec.decode_horizon,
                   tick_device_ms=total / 1e3, gather_device_ms=gather / 1e3,
                   gather_ops=n_gather,
                   gather_share=gather / total if total else None,
                   gathered_bytes_per_layer=2 * 2 * len(reqs) * pool[1]
                   * eng.ec.max_pages * pool[2] * pool[3]
                   * eng.cache.k.element_size())
        print("families gather " + json.dumps(row), flush=True)
        del eng
        torch.cuda.empty_cache()
        return row

    def generate(label, cfg, hf, params) -> dict:
        model = TPUModelForCausalLM(cfg, params, hf, "sym_int4")
        rng = np.random.default_rng(13)
        width = max(GENERATE_LENGTHS)
        ids = np.zeros((len(GENERATE_LENGTHS), width), np.int64)
        mask = np.zeros_like(ids)
        for i, n in enumerate(GENERATE_LENGTHS):
            ids[i, width - n:] = rng.integers(3, cfg.vocab_size, n)
            mask[i, width - n:] = 1
        new = 32
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.generate(torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask),
                             max_new_tokens=new, eos_token_id=())
        wall = time.perf_counter() - t0
        launches = gate(f"{label} generate", (b2, b3, b4), ())
        got = model.last_result
        if tuple(out.shape) != (len(GENERATE_LENGTHS), width + new) or list(
                got.num_new_tokens) != [new] * len(GENERATE_LENGTHS) or int(
                out[:, -new:].max()) >= cfg.vocab_size:
            fail(f"families {label} generate: sequences {tuple(out.shape)}, "
                 f"new tokens {list(got.num_new_tokens)}")
        row = dict(model=label, card=card, rows=len(GENERATE_LENGTHS),
                   prompt_tokens=sum(GENERATE_LENGTHS), new_tokens=new,
                   wall_s=wall, output_tok_s=len(GENERATE_LENGTHS) * new
                   / wall, first_cost_s=model.first_cost,
                   rest_cost_mean_s=model.rest_cost_mean,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches,
                   launches_by_head_dim={
                       "decode_attention": dict(b3.COUNTS.by_head_dim),
                       "flash_attention": dict(b4.COUNTS.by_head_dim)})
        print("families generate " + json.dumps(row), flush=True)
        del model
        return row

    cut = dict(num_layers=SERVE_LAYERS)
    gemma2 = gemma2_9b_config()
    paths = (
        ("Mistral-7B-v0.1", mistral_7b_config(**cut), MISTRAL_7B_V01_HF,
         (b2, b3, b4), (b1,), False),
        ("Qwen2-7B", qwen2_7b_config(**cut), QWEN2_7B_HF, (b2, b1), (b3, b4),
         True),
        ("Gemma-2-9B", gemma2_9b_config(
            **cut, layer_types=gemma2.layer_types[:SERVE_LAYERS]),
         GEMMA2_9B_HF, (b2, b3, b4), (b1,), True),
    )
    res["serve"], res["gather"], res["generate"] = [], [], []
    for i, (label, cfg, hf, need, absent, gen) in enumerate(paths):
        t0 = time.perf_counter()
        params = random_params(cfg, "sym_int4", seed=10 + i, device=dev)
        torch.cuda.synchronize()
        print(f"{label}-width random sym_int4 weights: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)
        res["serve"].append(serve(label, cfg, params, "bf16", 8, 20 + i,
                                  need, absent))
        res["serve"].append(serve(label, cfg, params, "fp8", 2, 30 + i,
                                  need, absent))
        if cfg.sliding_window is not None:
            res["gather"].append(gather_share(label, cfg, params))
        if gen:
            res["generate"].append(generate(label, cfg, hf, params))
        del params
        torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    def fail(msg):
        print(f"torch_families_smoke: FAILED: {msg}", file=sys.stderr,
              flush=True)
        sys.exit(1)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kernels = {m.NAME: m for m in (b2, b1, b3, b4, b5)}
    print(f"kernel build: {_build.build(list(kernels)):.1f} s", flush=True)
    res = families_phase(kernels, card, fail, torch.device("cuda", 0))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
