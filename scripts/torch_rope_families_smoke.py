#!/usr/bin/env python3
"""Rope scaling and the phi3, gemma and gemma3 families on one card: the
rope tables card against CPU, B1 at head_dim 256 and B3 and B4 at 96
against their plain versions, small decoders card against CPU, then
Phi-3-mini-4k, Gemma-7B and Gemma-3-4B at full width and depth through
``ServingEngine`` and one Gemma-3-4B ``generate()``, from random sym_int4
weights drawn on the card from a seed.

``chip_smoke.py`` runs this as its ``rope_families`` phase; alone, from
the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_rope_families_smoke.py [tables] [kernels]
        [small] [serve] [generate]

(no step named: all five).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``tables``: the rope leaves (``models.build.rope_buffers``: the table
   at the model's ``max_position_embeddings``, ``mscale``, gemma3's local
   table) of every kind the port builds, at published settings (Llama-3.1-
   8B's llama3, Gemma-3-4B's linear 8 and its local table, Phi-3.5-mini's
   longrope at full rotary and at Phi-4-mini's 0.75, a yarn 4 and a
   dynamic 2 over Llama-3.1-8B's widths, Phi-3-mini's default), made on
   the card equal bit for bit to the CPU's, and their cos/sin over 4096
   positions spread to the model's limit within ``COS_TOL``;
2. ``kernels``: B1's head_dim-256 instances at Gemma-7B's heads (16 over
   16) and Gemma-3-4B's (8 over 4), C = 1, 4 (the key split) and 128
   (query tiles: decode, chunk and idle rows), over bf16 and e5m2 pools of
   16-slot pages, 2400 slots a row (not a multiple of the 64-key tile),
   ragged ``kv_len``; B3's head_dim-96 instance at Phi-3-mini's heads (32
   over 32), 8 rows of the gathered 4096-slot layer with the 2047 window
   cutting, bf16 and e5m2; B4's at the same heads over the same layer,
   the gathered route's chunks (8 rows of T = 128 at their own slots) and
   its verify width (T = 4): every query row within ``ATTN_TOL_REL`` of
   its largest plain output, then each timed as device time from
   CUDA-graph replays beside its bound and ``scaled_dot_product_attention``
   (over the gathered pages for B1, with the same mask);
3. ``small``: small phi3 (head_dim 96, a window of 24), gemma (head_dim
   256, the exact GELU) and gemma3 (head_dim 256, a window of 24 on its
   first layer, both rope tables) decoders, paged and dense, and 2-layer
   decoders with Llama-3.1-8B's llama3 rope (head_dim 128) and with
   Phi-3.5-mini's longrope over Phi-4-mini's partial rotary of 0.75
   (head_dim 96), their rope tables at the published lengths over narrow
   layers (hidden 512 and 384, 4 heads, vocabulary 512), each on the
   card against the same decoder on the CPU's plain versions
   (``torch_families_smoke.small_check``: logits within 2.5% of their
   range);
4. ``serve``: Phi-3-mini-4k, Gemma-7B and Gemma-3-4B (their published
   ``config.json`` widths, all layers) through ``ServingEngine`` with
   ``SERVE_EC`` and mixed ticks of up to 8 x 128 prompt tokens (the
   gathered route's chunks are 8 rows of T = 128) over a bf16 pool: eight
   requests, six of 64-1000 ids and two near the model's limit
   (``MODELS``: past Phi-3-mini's 2047 window and Gemma-3's 1024), 24-48
   new tokens, half greedy and half seeded; then two of them over an
   e5m2 pool.  Every request finishes with its tokens, B2 launches, no
   plain version runs, and the attention kernels follow the layers:
   Gemma-7B runs B1's 256 instances on every layer and B3/B4 never;
   Gemma-3-4B runs B1 on its full layers only (5 of 34: its launches and
   B3's and B4's at 256 count the same forwards) and B3/B4 at 256 on the
   sliding ones; Phi-3-mini runs B3/B4 at 96 on every layer and B1 never;
5. ``generate``: Gemma-3-4B's ``generate()`` on four prompts of 1990,
   1327, 611 and 203 ids (its window of 1024 cuts the longer ones), 32
   new tokens, greedy, bf16 cache: B2, B3 and B4 at 256 launch, no plain
   version runs, every row gets its tokens.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory (``torch.cuda.max_memory_allocated`` over each
run) and the weight bytes.  Each model is freed before the next.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from dataclasses import replace

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("tables", "kernels", "small", "serve", "generate")
# the attention kernels against their float64 plain versions: within 2^-7
# of the row's largest output (chip_smoke.py's ATTN_TOL_REL)
ATTN_TOL_REL = 2.0 ** -7
# cos/sin of the same fp32 angles on the card and on the CPU: the two
# libraries' cos and sin differ by a few fp32 ulps
COS_TOL = 4e-6
SERVE_EC = dict(max_rows=8, page_size=128, prefill_bucket=128,
                decode_horizon=4, step_token_budget=1024)
# (label, config name in random_init, engine max_seq_len, the two long
# prompts' range): the limit is the model's own, Gemma-3-4B's 131072
# positions cut to the 8192 of Gemma-7B
MODELS = (("Phi-3-mini-4k", "phi3_mini_4k_config", 4096, (2500, 3900)),
          ("Gemma-7B", "gemma_7b_config", 8192, (6000, 8000)),
          ("Gemma-3-4B", "gemma3_4b_config", 8192, (6000, 8000)))
GENERATE_LENGTHS = (1990, 1327, 611, 203)


def rope_families_phase(kernels: dict, card: str, fail, device, graph_ms,
                        steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ipex_llm_tpu_torch.models import random_init as ri
    from ipex_llm_tpu_torch.models.build import rope_buffers
    from ipex_llm_tpu_torch.models.families import config_from_hf
    from ipex_llm_tpu_torch.ops.rope import cos_sin
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM
    from torch_families_smoke import small_check
    from torch_moe_smoke import bound    # the H100's least time for work

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    dev = device
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)

    def reset():
        for mod in kernels.values():
            mod.COUNTS.reset()

    def time_ms(fn, iters: int) -> float:
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

    def check_rows(out, ref, rows, what: str):
        """Per (row, query) of ``rows`` (a list of (row, queries)): the
        worst |out - ref| within ATTN_TOL_REL of the largest |ref| over
        heads and dims; returns the worst abs error and ratio."""
        o, r = out.float(), ref.float()
        if not torch.isfinite(o).all():
            fail(f"{what}: output not finite")
        err = (o - r).abs().amax(dim=(2, 3))
        top = r.abs().amax(dim=(2, 3))
        worst = rel = 0.0
        for i, n in rows:
            e, t = err[i, :n], top[i, :n]
            if bool((e > ATTN_TOL_REL * t).any()):
                j = int((e > ATTN_TOL_REL * t).nonzero()[0])
                fail(f"{what}: row {i} query {j} max abs err "
                     f"{e[j].item()} > {ATTN_TOL_REL} * {t[j].item()}")
            worst = max(worst, e.max().item())
            rel = max(rel, (e / t.clamp_min(1e-30)).max().item())
        return worst, rel

    # -- 1. rope tables, card against CPU -----------------------------------
    if "tables" in steps:
        llama = ri.LLAMA31_8B_HF
        scalings = (
            ("Llama-3.1-8B llama3", llama),
            ("Gemma-3-4B linear 8, local 1e4", ri.GEMMA3_4B_HF),
            ("Phi-3.5-mini longrope", ri.phi35_mini_hf(seed=3)),
            ("Phi-3.5-mini longrope, partial rotary 0.75",
             ri.phi35_mini_hf(seed=4, partial_rotary_factor=0.75)),
            ("Llama-3.1-8B widths, yarn 4", {**llama, "rope_scaling": {
                "rope_type": "yarn", "factor": 4.0,
                "original_max_position_embeddings": 32768}}),
            ("Llama-3.1-8B widths, dynamic 2", {**llama, "rope_scaling": {
                "rope_type": "dynamic", "factor": 2.0,
                "original_max_position_embeddings": 8192}}),
            ("Phi-3-mini-4k default", ri.PHI3_MINI_4K_HF))
        rows = []
        for label, hf in scalings:
            cfg = config_from_hf(hf)
            on_card, on_cpu = rope_buffers(cfg, dev), rope_buffers(cfg, "cpu")
            if on_card["rope_mscale"] != on_cpu["rope_mscale"]:
                fail(f"rope {label}: mscale {on_card['rope_mscale']} on the "
                     f"card, {on_cpu['rope_mscale']} on the CPU")
            pos = torch.linspace(0, cfg.max_position_embeddings - 1, 4096
                                 ).round().to(torch.int32)[None]
            cos_err = 0.0
            for key in ("inv_freq", "inv_freq_local"):
                if key not in on_cpu:
                    continue
                a, b = on_card[key], on_cpu[key]
                if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                    fail(f"rope {label}: {key} on the card differs from the "
                         "CPU's")
                ms = on_cpu["rope_mscale"] if key == "inv_freq" else 1.0
                for x, y in zip(cos_sin(pos.to(dev), a, ms), cos_sin(pos, b,
                                                                     ms)):
                    cos_err = max(cos_err, (x.cpu() - y).abs().max().item())
            if cos_err > COS_TOL:
                fail(f"rope {label}: cos/sin on the card {cos_err} from the "
                     f"CPU's (bound {COS_TOL})")
            rows.append(dict(scaling=label, kind=cfg.rope.kind,
                             rotary_dim=cfg.rope.rotary_dim,
                             positions=cfg.max_position_embeddings,
                             mscale=on_cpu["rope_mscale"],
                             local="inv_freq_local" in on_cpu,
                             table_equal=True, cos_sin_max_abs_err=cos_err))
            print("rope table " + json.dumps(rows[-1]), flush=True)
        res["tables"] = rows

    # -- 2. the kernel instances of this path --------------------------------
    def b1_case(pool_dtype, c, hq, hkv, d=256, r=8, ps=16, maxp=150):
        """Rows over 16-slot pages in random order, -1 past each row's last
        page.  C = 1 and 4: every row decodes or verifies at staggered
        lengths up to the 2400-slot capacity; C = 128: full and part
        chunks, decode rows, a chunk at the row's first slots and an idle
        row (kv_len the sentinel at the capacity)."""
        cap = maxp * ps
        kp = torch.randn(1 + r * maxp, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(1 + r * maxp, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        if c <= 4:
            chunk = [c] * r
            kv_len = [130, 300, 511, 700, 901, 1064, 1500, cap - 3]
        else:
            chunk = [128, 1, 77, 128, 1, 5, 128, 0]
            kv_len = [cap, 1001, 700, 128, cap - 1, 300, 1500, cap]
        tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)
                  ).to(torch.int32).reshape(r, maxp)
        for i, n in enumerate(kv_len):
            if chunk[i] == 0:
                tables[i] = -1
            else:
                tables[i, -(-n // ps):] = -1
        q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        return (q, kp, vp, tables,
                torch.tensor(kv_len, dtype=torch.int32, device=dev),
                torch.tensor(chunk, dtype=torch.int32, device=dev))

    def b1_rows(args):
        out = []
        for i, n in enumerate(args[5].tolist()):
            if n:
                out.append((i, n))
        return out

    def b1_work(q, kp, kv_len, chunk):
        r, c, hq, d = q.shape
        item = kp.element_size()
        nbytes = 2 * r * c * hq * d * 2
        pairs = 0
        for n_kv, n_q in zip(kv_len.tolist(), chunk.tolist()):
            if n_q:
                nbytes += 2 * n_kv * kp.shape[1] * d * item
                pairs += sum(n_kv - n_q + j + 1 for j in range(n_q))
        return bound(nbytes, 4.0 * d * hq * pairs)

    def b1_library(q, kp, vp, tables, kv_len, chunk):
        """SDPA over the gathered pages (the gather outside the timing)."""
        r, c, hq, d = q.shape
        maxp, ps = tables.shape[1], kp.shape[2]
        idx = tables.long().clamp(0, kp.shape[0] - 1)

        def gather(pool):
            g = pool[idx].to(torch.bfloat16)         # [R, maxP, H, ps, D]
            return g.permute(0, 2, 1, 3, 4).reshape(r, -1, maxp * ps, d)
        kg, vg = gather(kp), gather(vp)
        kpos = torch.arange(maxp * ps, device=dev)
        qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kv_len[:, None, None])
        mask[..., 0] = True          # idle rows: keep the softmax defined
        qt = q.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask[:, None],
            enable_gqa=qt.shape[1] != kg.shape[1])

    def dense_case(b, t, hq, hkv, d, s, kv_len, kv_dtype, window):
        """Query rows at each row's last ``t`` slots below ``kv_len`` of a
        head-major [B, Hkv, S, D] layer (the gathered route's layer)."""
        q = torch.randn(b, t, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(kv_dtype)
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        qpos = (kvl.long() - t)[:, None] + torch.arange(t, device=dev)
        kpos = torch.arange(s, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kvl[:, None, None]) & (
            kpos[None, None, :] > qpos[:, :, None] - window)
        return q, k, v, kvl, qpos, mask

    def dense_work(q, k, mask):
        """Bytes: q and out, and the K/V slots some query sees; operations:
        4 D for each visible (query, key) pair and head."""
        b, t, hq, d = q.shape
        seen = mask.any(dim=1).sum().item()          # slots any query sees
        nbytes = 2 * q.numel() * 2 + 2 * seen * k.shape[1] * d \
            * k.element_size()
        return bound(nbytes, 4.0 * d * hq * mask.sum().item())

    def timed_row(kind, label, run, plain, lib, work, err, extra):
        ms = graph_ms(torch, [run] * 10)
        plain_ms = time_ms(plain, 1)
        lib_ms = graph_ms(torch, [lib] * 10)
        bms, by = work
        row = dict(kernel=kind, case=label, max_abs_err=err[0],
                   max_rel_err=err[1], tol_rel=ATTN_TOL_REL, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                   bound_by=by, **extra)
        print("rope_families kernel " + json.dumps(row), flush=True)
        return row

    if "kernels" in steps:
        rows = []
        for model, hq, hkv in (("Gemma-7B", 16, 16), ("Gemma-3-4B", 8, 4)):
            for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                          ("e5m2", torch.float8_e5m2)):
                for c in (1, 4, 128):
                    args = b1_case(pool_dtype, c, hq, hkv)
                    before = dict(b1.COUNTS.by_route)
                    n256 = b1.COUNTS.by_head_dim[256]
                    out = b1.ragged_paged_sdpa(*args)
                    route = [r for r, v in b1.COUNTS.by_route.items()
                             if v > before[r]]
                    want = "split" if hq // hkv * c <= 16 else "tiles"
                    if route != [want] or b1.COUNTS.by_head_dim[256] == n256:
                        fail(f"B1 D=256 {model} C={c}: ran {route}, want "
                             f"{want} at head_dim 256")
                    ref = b1.ragged_paged_sdpa_plain(*args,
                                                     scale=256 ** -0.5)
                    label = f"D=256 {model} Hq={hq} Hkv={hkv} C={c}"
                    err = check_rows(out, ref, b1_rows(args),
                                     f"B1 {label} {pool_name}")
                    for i, n in enumerate(args[5].tolist()):
                        if n == 0 and out[i].abs().max().item() != 0.0:
                            fail(f"B1 {label}: idle row {i} is not zero")
                    rows.append(timed_row(
                        "ragged_paged_attention", label,
                        lambda a=args: b1.ragged_paged_sdpa(*a),
                        lambda a=args: b1.ragged_paged_sdpa_plain(
                            *a, scale=256 ** -0.5),
                        b1_library(*args), b1_work(args[0], args[1],
                                                   args[4], args[5]),
                        err, dict(pool=pool_name, route=want, head_dim=256,
                                  capacity=args[3].shape[1] * 16)))
                    del args, out, ref
        # B3 and B4 at head_dim 96: Phi-3-mini's heads over the gathered
        # 4096-slot layer, the 2047 window cutting
        hq = hkv = 32
        s, window = 4096, 2047
        kv_len = [64, 700, 1500, 2047, 2048, 2600, 3500, 4000]
        for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
            q, k, v, kvl, qpos, mask = dense_case(8, 1, hq, hkv, 96, s,
                                                  kv_len, kv_dtype, window)
            kw = dict(kv_len=kvl, window=window)
            n96 = b3.COUNTS.by_head_dim[96]
            out = b3.decode_sdpa(q, k, v, **kw)
            if b3.COUNTS.by_head_dim[96] != n96 + 2:
                fail("B3 D=96: not the head_dim-96 instance")
            ref = b3.decode_sdpa_plain(
                q, k, v, scale=96 ** -0.5, kv_len=kvl,
                kv_start=torch.zeros_like(kvl), won=torch.ones_like(kvl),
                window=window, softcap=None)
            label = f"D=96 Phi-3-mini B=8 S={s} window {window}"
            err = check_rows(out, ref, [(i, 1) for i in range(8)],
                             f"B3 {label} {kv_name}")
            kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
            rows.append(timed_row(
                "decode_attention", label,
                lambda q=q, k=k, v=v, kw=kw: b3.decode_sdpa(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: b3.decode_sdpa_plain(
                    q, k, v, scale=96 ** -0.5, kv_len=kw["kv_len"],
                    kv_start=torch.zeros_like(kw["kv_len"]),
                    won=torch.ones_like(kw["kv_len"]), window=window,
                    softcap=None),
                lambda q=q, kb=kb, vb=vb, m=mask:
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), kb, vb, attn_mask=m[:, None]),
                dense_work(q, k, mask), err,
                dict(pool=kv_name, head_dim=96)))
            del q, k, v, kb, vb, out, ref
        for t, what in ((128, "chunks"), (4, "verify")):
            q, k, v, kvl, qpos, mask = dense_case(
                8, t, hq, hkv, 96, s, [max(n, t) for n in kv_len],
                torch.bfloat16, window)
            kd, vd = k.transpose(1, 2), v.transpose(1, 2)
            kw = dict(q_positions=qpos, kv_len=kvl, window=window)
            n96 = b4.COUNTS.by_head_dim[96]
            out = b4.flash_sdpa(q, kd, vd, **kw)
            if b4.COUNTS.by_head_dim[96] != n96 + 1:
                fail("B4 D=96: not the head_dim-96 instance")

            def plain(q=q, kd=kd, vd=vd, kw=kw):
                return b4.flash_sdpa_plain(
                    q, kd, vd, scale=96 ** -0.5, causal=True,
                    q_positions=kw["q_positions"], kv_len=kw["kv_len"],
                    kv_start=torch.zeros_like(kw["kv_len"]),
                    won=torch.ones_like(kw["kv_len"]), window=window,
                    softcap=None)
            ref = plain()
            label = f"D=96 Phi-3-mini T={t} x 8 {what} S={s} window {window}"
            err = check_rows(out, ref, [(i, t) for i in range(8)],
                             f"B4 {label}")
            rows.append(timed_row(
                "flash_attention", label,
                lambda q=q, kd=kd, vd=vd, kw=kw: b4.flash_sdpa(q, kd, vd,
                                                               **kw),
                plain,
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=m[:, None]),
                dense_work(q, k, mask), err, dict(t=t, head_dim=96)))
            del q, k, v, kd, vd, out, ref
        torch.cuda.empty_cache()
        res["kernels"] = rows

    # -- 3. small decoders, card against CPU ---------------------------------
    if "small" in steps:
        reset()
        small = dict(num_layers=2, vocab_size=512)
        cases = (
            ("phi3", ri.phi3_mini_4k_config(
                hidden_size=384, intermediate_size=1024, num_heads=4,
                num_kv_heads=4, sliding_window=24, **small)),
            ("gemma", ri.gemma_7b_config(
                hidden_size=512, intermediate_size=1024, num_heads=4,
                num_kv_heads=2, **small)),
            ("gemma3", ri.gemma3_4b_config(
                hidden_size=512, intermediate_size=1024, num_heads=4,
                num_kv_heads=2, sliding_window=24,
                layer_types=("sliding_attention", "full_attention"),
                **small)),
            # the rope kinds of Llama-3.1-8B and Phi-3.5-mini at their head
            # widths and rope tables, over narrow layers (the float64 CPU
            # oracle at the published widths took most of the phase)
            ("Llama-3.1-8B llama3, 2 narrow layers", replace(
                config_from_hf(ri.LLAMA31_8B_HF), hidden_size=512,
                intermediate_size=1024, num_heads=4, num_kv_heads=2,
                **small)),
            ("Phi-3.5-mini longrope, partial rotary 0.75, 2 narrow layers",
             replace(config_from_hf(ri.phi35_mini_hf(
                 seed=5, partial_rotary_factor=0.75)), hidden_size=384,
                 intermediate_size=1024, num_heads=4, num_kv_heads=4,
                 **small)))
        res["small"] = {}
        for i, (label, cfg) in enumerate(cases):
            t0 = time.perf_counter()
            forms = ("dense",) if cfg.hidden_size > 512 else ("paged",
                                                              "dense")
            res["small"][label] = small_check(cfg, 40 + i, dev, fail, label,
                                              forms)
            res["small"][label]["seconds"] = time.perf_counter() - t0
            print(f"rope_families small {label}: " + json.dumps(
                res["small"][label]), flush=True)
        res["small_launches"] = {
            "ragged_paged_attention": dict(b1.COUNTS.by_head_dim),
            "decode_attention": dict(b3.COUNTS.by_head_dim),
            "flash_attention": dict(b4.COUNTS.by_head_dim)}
        if not (b1.COUNTS.by_head_dim[256] and b3.COUNTS.by_head_dim[96]
                and b4.COUNTS.by_head_dim[96] and b3.COUNTS.by_head_dim[256]
                and b4.COUNTS.by_head_dim[256]):
            fail(f"rope_families small: launches {res['small_launches']}")

    # -- 4. full width through the engine ------------------------------------
    def requests(cfg, long, n_req, seed):
        rng = np.random.default_rng(seed)
        lens = list(rng.integers(64, 1001, 6)) + list(
            rng.integers(long[0], long[1] + 1, 2))
        lens = [lens[i] for i in rng.permutation(8)][:n_req]
        news = rng.integers(24, 49, n_req)
        return [Request(prompt_ids=[int(v) for v in rng.integers(
                    1, cfg.vocab_size, int(n))], max_new_tokens=int(m),
                        temperature=0.8 if i % 2 else 0.0,
                        top_p=0.9 if i % 2 else 1.0,
                        seed=3000 + i if i % 2 else None)
                for i, (n, m) in enumerate(zip(lens, news))]

    def attention_gate(label, cfg):
        """The attention kernels each model's layers must run: the counts
        of one serving run (B1 a forward: one launch a layer for its query
        tiles, two for its key split; B3 two, B4 one)."""
        n_full = sum(not cfg.layer_is_sliding(i)
                     for i in range(cfg.num_layers))
        n_slide = cfg.num_layers - n_full
        d = cfg.head_dim
        r1 = b1.COUNTS.by_route

        def forwards(per_call: dict, layers: int):
            """Forwards that ``per_call`` (launches -> launches a call)
            counts over ``layers`` layers a forward; None where a count is
            not a whole number of forwards."""
            n = 0
            for launches, k in per_call.items():
                if launches % (k * layers):
                    return None
                n += launches // (k * layers)
            return n
        b1_fwd = forwards({r1["tiles"]: 1, r1["split"]: 2}, n_full) \
            if n_full else 0
        gath_fwd = forwards({b4.COUNTS.by_head_dim[d]: 1,
                             b3.COUNTS.by_head_dim[d]: 2}, n_slide) \
            if n_slide else 0
        same_d = all(m.COUNTS.by_head_dim[d] == m.COUNTS.launches
                     for m in (b1, b3, b4))
        ok = same_d and b1_fwd is not None and gath_fwd is not None and {
            # Gemma-7B: no window, so every layer reads the pool with B1
            "Gemma-7B": b1_fwd > 0 and b3.COUNTS.launches
            == b4.COUNTS.launches == 0,
            # Gemma-3-4B: B1 on its 5 full layers, B3/B4 at 256 on the 29
            # sliding ones, over the same forwards
            "Gemma-3-4B": b1_fwd == gath_fwd > 0
            and b3.COUNTS.launches > 0 and b4.COUNTS.launches > 0,
            # Phi-3-mini: the window on every layer: B3/B4 at 96, no B1
            "Phi-3-mini-4k": b1.COUNTS.launches == 0 and gath_fwd > 0
            and b3.COUNTS.launches > 0 and b4.COUNTS.launches > 0,
        }[label]
        counts = dict(b1_by_route=dict(r1),
                      b1_by_head_dim=dict(b1.COUNTS.by_head_dim),
                      b3_by_head_dim=dict(b3.COUNTS.by_head_dim),
                      b4_by_head_dim=dict(b4.COUNTS.by_head_dim),
                      b1_forwards=b1_fwd, gathered_forwards=gath_fwd)
        if not ok:
            fail(f"rope_families {label}: attention launches {counts}")
        return counts

    def gate(what):
        out = {}
        for name, mod in kernels.items():
            n, plain = mod.COUNTS.launches, mod.COUNTS.plain_calls
            if plain or (mod is b2 and n == 0):
                fail(f"rope_families {what}: {name} launched {n} times, "
                     f"plain version called {plain} times")
            out[name] = n
        return out

    def serve(label, cfg, params, max_seq, long, storage, n_req, seed):
        eng = ServingEngine(cfg, params, EngineConfig(
            kv_storage=storage, max_seq_len=max_seq, **SERVE_EC), device=dev)
        reqs = requests(cfg, long, n_req, seed)
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
        launches = gate(f"{label} serve {storage}")
        attn = attention_gate(label, cfg)
        for q, st in zip(reqs, streams):
            if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                    or st != q.output_ids or not all(
                        0 <= v < cfg.vocab_size for v in st):
                fail(f"rope_families {label} {storage}: a request finished "
                     f"{q.finish_reason} with {len(st)} of "
                     f"{q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
        out_tok = sum(len(st) for st in streams)
        ttft = [q.first_token_s for q in reqs]
        row = dict(model=label, card=card, storage=storage,
                   layers=cfg.num_layers, head_dim=cfg.head_dim,
                   max_seq_len=max_seq, requests=len(reqs),
                   prompt_tokens=sum(len(q.prompt_ids) for q in reqs),
                   longest_prompt=max(len(q.prompt_ids) for q in reqs),
                   output_tokens=out_tok, wall_s=wall,
                   output_tok_s=out_tok / wall,
                   ttft_mean_s=float(np.mean(ttft)),
                   ttft_max_s=float(np.max(ttft)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   weight_bytes=eng.weight_stats()["weight_bytes"],
                   launches=launches, attention=attn,
                   ticks=eng.metrics["steps"])
        print("rope_families serve " + json.dumps(row), flush=True)
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
        launches = gate(f"{label} generate")
        if not (b3.COUNTS.by_head_dim[256] and b4.COUNTS.by_head_dim[256]):
            fail(f"rope_families {label} generate: B3/B4 at 256 launched "
                 f"{dict(b3.COUNTS.by_head_dim)} "
                 f"{dict(b4.COUNTS.by_head_dim)}")
        got = model.last_result
        if tuple(out.shape) != (len(GENERATE_LENGTHS), width + new) or list(
                got.num_new_tokens) != [new] * len(GENERATE_LENGTHS) or int(
                out[:, -new:].max()) >= cfg.vocab_size:
            fail(f"rope_families {label} generate: sequences "
                 f"{tuple(out.shape)}, new tokens {list(got.num_new_tokens)}")
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
        print("rope_families generate " + json.dumps(row), flush=True)
        del model
        return row

    if "serve" in steps or "generate" in steps:
        res["serve"], res["generate"] = [], []
        for i, (label, make, max_seq, long) in enumerate(MODELS):
            gemma3 = label == "Gemma-3-4B"
            if "serve" not in steps and not gemma3:
                continue
            cfg = getattr(ri, make)()
            t0 = time.perf_counter()
            params = ri.random_params(cfg, "sym_int4", seed=60 + i,
                                      device=dev)
            torch.cuda.synchronize()
            print(f"{label}-width random sym_int4 weights: "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
                  "card", flush=True)
            if "serve" in steps:
                res["serve"].append(serve(label, cfg, params, max_seq, long,
                                          "bf16", 8, 70 + i))
                res["serve"].append(serve(label, cfg, params, max_seq, long,
                                          "fp8", 2, 80 + i))
            if gemma3 and "generate" in steps:
                res["generate"].append(generate(label, cfg,
                                                ri.GEMMA3_4B_HF, params))
            del params
            torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_rope_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_attention_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    def fail(msg):
        print(f"torch_rope_families_smoke: FAILED: {msg}", file=sys.stderr,
              flush=True)
        sys.exit(1)

    steps = tuple(a for a in sys.argv[1:] if a in STEPS) or STEPS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kernels = {m.NAME: m for m in (b2, b1, b3, b4)}
    print(f"kernel build: {_build.build(list(kernels)):.1f} s", flush=True)
    res = rope_families_phase(kernels, card, fail, torch.device("cuda", 0),
                              graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
