#!/usr/bin/env python3
"""The GPT-style families on one card: B1, B3 and B4 at head_dim 80
against their plain versions, 2-layer Phi-2, phixtral, Pythia-6.9B and
GPT-J-6B decoders card against CPU, the four at full width through
``ServingEngine`` (Phi-2 at its full depth) and Phi-2 through
``generate()``, and a Phi-2-width checkpoint through ``from_pretrained``,
``save_low_bit``/``load_low_bit`` and ``generate()``, from random sym_int4
weights drawn on the card from a seed.

``chip_smoke.py`` runs this as its ``gpt_families`` phase; alone, from the
root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_gpt_families_smoke.py [kernels] [small] [serve]
        [load]

(no step named: all four).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: B1's head_dim-80 instances at Phi-2's heads (32 over 32),
   C = 1 and 4 (the key split) and C = 128 (query tiles: chunk, decode and
   idle rows), over bf16 and e5m2 pools of 128-slot pages, ragged
   ``kv_len``; B3's at B = 8 rows of a 2048-slot dense layer (bf16 and
   e5m2); B4's at 8 rows of T = 128 at their own slots of a 2048-slot
   layer and 2 rows of T = 2048 from slot 0: every query row within
   ``ATTN_TOL_REL`` of its largest plain output, then each timed as device
   time from CUDA-graph replays beside its bound (bytes over 3.35 TB/s,
   operations over 989 TFLOP/s) and ``scaled_dot_product_attention`` on
   the same inputs and mask;
2. ``small``: each family's published widths (hidden, heads, head_dim,
   ffn, experts) at 2 layers and a vocabulary cut to ``SMALL_VOCAB`` (the
   CPU's float64 plain versions of a 50k-row head would take most of the
   phase), the sym_int4 weights drawn and packed on the card and copied
   to the CPU, paged (prefill chunks of 40, 17 and 29 ids, one decode
   step: the CPU's float64 forwards are most of the phase) on the card
   against the CPU: logits within 2.5% of their range;
   phixtral's card forward takes the CPU's expert selections (recorded
   call by call), so a near-tie of the router cannot move its logits, and
   the selections the card would have made are counted;
3. ``serve``: Phi-2 at full width and depth (32 layers), phixtral,
   Pythia-6.9B and GPT-J-6B at full width and ``SERVE_LAYERS`` layers,
   through ``ServingEngine`` with ``SERVE_EC`` over a bf16 pool: eight
   requests of 64-1000 ids, 32-64 new tokens, half greedy and half
   seeded; B1 (at 80 for Phi-2 and phixtral, 128 for Pythia, 256 for
   GPT-J) and B2 (and B2e for phixtral) launch, no plain version runs;
   tok/s, TTFT, peak memory, weight bytes and the launches by instance;
   then Phi-2's ``generate()`` on four prompts of 1990, 1327, 611 and 203
   ids, 32 new tokens: B2, B3 and B4 at 80 launch;
4. ``load``: a 4-layer Phi-2-width checkpoint under the published names
   (bf16 weights drawn on the card) written to ``TMPDIR``, through
   ``from_pretrained(load_in_low_bit="sym_int4")`` (layer 0's qkv and fc1
   planes against the CPU codec of the same tensors), ``save_low_bit`` and
   ``load_low_bit`` (every leaf bitwise) and one ``generate()`` call of
   the reloaded model (B2, B3, B4), then removed.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the weight bytes.  Each model is freed
before the next.
"""

from __future__ import annotations

import functools
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "serve", "load")
# the attention kernels against their float64 plain versions: within 2^-7
# of the row's largest output (chip_smoke.py's ATTN_TOL_REL)
ATTN_TOL_REL = 2.0 ** -7
D = 80                      # Phi-2's and phixtral's head width
HEADS = 32
SERVE_EC = dict(max_rows=8, max_seq_len=2048, page_size=128,
                prefill_bucket=128, decode_horizon=4)
SERVE_LAYERS = 8            # phixtral's, Pythia's and GPT-J's (Phi-2: 32)
SMALL_VOCAB = 4096
GENERATE_LENGTHS = (1990, 1327, 611, 203)
LOAD_LAYERS = 4


def phi_hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """HF names and shapes of a Phi-2 checkpoint (``PhiForCausalLM``)."""
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    out = {"model.embed_tokens.weight": (v, h),
           "model.final_layernorm.weight": (h,),
           "model.final_layernorm.bias": (h,),
           "lm_head.weight": (v, h), "lm_head.bias": (v,)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({p + "input_layernorm.weight": (h,),
                    p + "input_layernorm.bias": (h,)})
        for name, shape in (("self_attn.q_proj", (h, h)),
                            ("self_attn.k_proj", (h, h)),
                            ("self_attn.v_proj", (h, h)),
                            ("self_attn.dense", (h, h)),
                            ("mlp.fc1", (f, h)), ("mlp.fc2", (h, f))):
            out[p + name + ".weight"] = shape
            out[p + name + ".bias"] = (shape[0],)
    return out


def reset_counts(kernels: dict) -> None:
    for mod in kernels.values():
        mod.COUNTS.reset()


def time_ms(fn, iters: int) -> float:
    """Event-timed ms a call of ``fn`` over ``iters`` calls, after one."""
    import torch

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


def width_label(d: int, dv: int) -> str:
    return f"D={d}" if d == dv else f"({d}, {dv})"


def heads_label(hq: int, hkv: int) -> str:
    return f"Hq=Hkv={hq}" if hq == hkv else f"Hq={hq} Hkv={hkv}"


def attention_cases(kernels: dict, fail, dev, graph_ms, *, tag: str,
                    model: str, d: int, hq: int, hkv: int, seed: int,
                    dv: int | None = None, cases=("b1", "b3", "b4"),
                    s: int = 2048, b1_chunks=(1, 4, 128),
                    b3_windows=(None,)) -> list[dict]:
    """B1, B3 and B4's instances at K width ``d`` and V width ``dv`` (None:
    ``d``), ``hq`` query heads over ``hkv`` kv heads, against their plain
    versions, each timed beside its bound and SDPA (step 1 of the module
    docstring, which names the cases; B1 at the query counts
    ``b1_chunks``, B3 with each window of ``b3_windows``, None for none);
    ``cases`` picks the kernels.  Returns the rows; ``tag`` prefixes each
    printed row."""
    import torch
    import torch.nn.functional as F

    from torch_moe_smoke import bound    # the H100's least time for work

    b1 = kernels["ragged_paged_attention"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    dv = d if dv is None else dv
    gqa = dict(enable_gqa=True) if hq != hkv else {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = d ** -0.5
    wd, hd = width_label(d, dv), heads_label(hq, hkv)

    def check_rows(out, ref, rows, what: str):
        """Per (row, query) of ``rows`` (a list of (row, queries)): the
        worst |out - ref| within ATTN_TOL_REL of the largest |ref| over
        heads and dims; returns the worst abs error and ratio."""
        o, r = out.float(), ref.float()
        if tuple(o.shape) != tuple(r.shape) or o.shape[-1] != dv:
            fail(f"{what}: output {tuple(o.shape)}, plain {tuple(r.shape)}")
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

    def timed_row(kind, label, run, plain, lib, work, err, extra):
        ms = graph_ms(torch, [run] * 10)
        plain_ms = time_ms(plain, 1)
        lib_ms = graph_ms(torch, [lib] * 10)
        bms, by = work
        row = dict(kernel=kind, case=label, max_abs_err=err[0],
                   max_rel_err=err[1], tol_rel=ATTN_TOL_REL, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                   bound_by=by, head_dim=d, v_head_dim=dv, **extra)
        print(f"{tag} kernel " + json.dumps(row), flush=True)
        return row

    def b1_case(pool_dtype, c, r=8, ps=128, maxp=16):
        """Rows over 128-slot pages in random order, -1 past each row's
        last page.  C <= 4: every row decodes or verifies at staggered
        lengths up to the capacity; C = 128: full and part chunks, decode
        rows, a chunk at the row's first slots and an idle row (kv_len the
        sentinel at the capacity)."""
        cap = maxp * ps
        kp = torch.randn(1 + r * maxp, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(1 + r * maxp, hkv, ps, dv, generator=gen,
                         device=dev).to(pool_dtype)
        if c <= 4:
            chunk = [c] * r
            kv_len = [int(cap * f) for f in (0.05, 0.12, 0.2, 0.3, 0.37,
                                             0.44, 0.62)] + [cap - 3]
        else:
            chunk = [128, 1, 77, 128, 1, 5, 128, 0]
            kv_len = [cap, cap // 2, cap // 3, 128, cap - 1, cap // 8,
                      cap * 5 // 8, cap]
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

    def b1_work(q, kp, kv_len, chunk):
        """Bytes: q, out and each row's live K and V slots; operations:
        2 (D + Dv) at each visible (query, key) pair and query head."""
        r, c, _, _ = q.shape
        item = kp.element_size()
        nbytes = r * c * hq * (d + dv) * 2
        pairs = 0
        for n_kv, n_q in zip(kv_len.tolist(), chunk.tolist()):
            if n_q:
                nbytes += n_kv * hkv * (d + dv) * item
                pairs += sum(n_kv - n_q + j + 1 for j in range(n_q))
        return bound(nbytes, 2.0 * (d + dv) * hq * pairs)

    def b1_library(q, kp, vp, tables, kv_len, chunk):
        """SDPA over the gathered pages (the gather outside the timing)."""
        r, c, _, _ = q.shape
        maxp, ps = tables.shape[1], kp.shape[2]
        idx = tables.long().clamp(0, kp.shape[0] - 1)

        def gather(pool):
            g = pool[idx].to(torch.bfloat16)         # [R, maxP, H, ps, d]
            return g.permute(0, 2, 1, 3, 4).reshape(r, hkv, maxp * ps, -1)
        kg, vg = gather(kp), gather(vp)
        kpos = torch.arange(maxp * ps, device=dev)
        qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kv_len[:, None, None])
        mask[..., 0] = True          # idle rows: keep the softmax defined
        qt = q.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask[:, None], scale=scale, **gqa)

    def dense_case(b, t, kv_len, kv_dtype):
        """Query rows at each row's last ``t`` slots below ``kv_len`` of a
        head-major [B, H, S, D] K/V layer."""
        q = torch.randn(b, t, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(
            kv_dtype)
        v = torch.randn(b, hkv, s, dv, generator=gen, device=dev).to(
            kv_dtype)
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        qpos = (kvl.long() - t)[:, None] + torch.arange(t, device=dev)
        kpos = torch.arange(s, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kvl[:, None, None])
        return q, k, v, kvl, qpos, mask

    def dense_work(q, k, mask):
        """Bytes: q, out and the K/V slots some query sees; operations:
        2 (D + Dv) for each visible (query, key) pair and query head."""
        b, t, _, _ = q.shape
        seen = mask.any(dim=1).sum().item()          # slots any query sees
        nbytes = (b * t * hq * (d + dv) * 2
                  + seen * hkv * (d + dv) * k.element_size())
        return bound(nbytes, 2.0 * (d + dv) * hq * mask.sum().item())

    rows = []
    if "b1" in cases:
        for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                      ("e5m2", torch.float8_e5m2)):
            for c in b1_chunks:
                args = b1_case(pool_dtype, c)
                before = dict(b1.COUNTS.by_route)
                n_d = b1.COUNTS.by_head_dim[d]
                out = b1.ragged_paged_sdpa(*args, scale=scale)
                route = [r for r, v in b1.COUNTS.by_route.items()
                         if v > before[r]]
                want = "split" if c * hq // hkv <= 16 else "tiles"
                if route != [want] or b1.COUNTS.by_head_dim[d] == n_d:
                    fail(f"B1 {wd} C={c}: ran {route}, want {want} at "
                         f"head_dim {d}")
                ref = b1.ragged_paged_sdpa_plain(*args, scale=scale)
                label = f"{wd} {model} {hd} C={c}"
                err = check_rows(out, ref, [
                    (i, n) for i, n in enumerate(args[5].tolist()) if n],
                    f"B1 {label} {pool_name}")
                for i, n in enumerate(args[5].tolist()):
                    if n == 0 and out[i].abs().max().item() != 0.0:
                        fail(f"B1 {label}: idle row {i} is not zero")
                rows.append(timed_row(
                    "ragged_paged_attention", label,
                    lambda a=args: b1.ragged_paged_sdpa(*a, scale=scale),
                    lambda a=args: b1.ragged_paged_sdpa_plain(
                        *a, scale=scale),
                    b1_library(*args), b1_work(args[0], args[1], args[4],
                                               args[5]),
                    err, dict(pool=pool_name, route=want, heads=hq,
                              kv_heads=hkv, capacity=16 * 128)))
                del args, out, ref
    kv_len8 = [64, 300, 700, 1023, 1024, 1300, 1750, 2048]
    if "b3" in cases:
        for (kv_name, kv_dtype), w in ((kv, w) for kv in (
                ("bf16", torch.bfloat16), ("e5m2", torch.float8_e5m2))
                for w in b3_windows):
            q, k, v, kvl, qpos, mask = dense_case(8, 1, kv_len8, kv_dtype)
            if w is not None:         # keys past the window's reach
                mask &= torch.arange(s, device=dev) > qpos[:, :, None] - w
            n_d = b3.COUNTS.by_head_dim[d]
            out = b3.decode_sdpa(q, k, v, kv_len=kvl, scale=scale, window=w)
            if b3.COUNTS.by_head_dim[d] != n_d + 2:
                fail(f"B3 {wd}: not the head_dim-{d} instance")

            def plain(q=q, k=k, v=v, kvl=kvl, w=w):
                return b3.decode_sdpa_plain(
                    q, k, v, scale=scale, kv_len=kvl,
                    kv_start=torch.zeros_like(kvl), won=torch.ones_like(kvl),
                    window=w, softcap=None)
            label = f"{wd} {model} B=8 {hd} S={s}" + (
                "" if w is None else f" window {w}")
            err = check_rows(out, plain(), [(i, 1) for i in range(8)],
                             f"B3 {label} {kv_name}")
            kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
            rows.append(timed_row(
                "decode_attention", label,
                lambda q=q, k=k, v=v, kvl=kvl, w=w: b3.decode_sdpa(
                    q, k, v, kv_len=kvl, scale=scale, window=w), plain,
                lambda q=q, kb=kb, vb=vb, m=mask:
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), kb, vb, attn_mask=m[:, None],
                        scale=scale, **gqa),
                dense_work(q, k, mask), err, dict(pool=kv_name, rows=8,
                                                  window=w)))
            del q, k, v, kb, vb, out
    if "b4" in cases:
        for b, t, what in ((8, 128, "chunks"), (2, 2048, "prefill")):
            kvl_list = ([max(n, t) for n in kv_len8] if b == 8 else [s] * b)
            q, k, v, kvl, qpos, mask = dense_case(b, t, kvl_list,
                                                  torch.bfloat16)
            kd, vd = k.transpose(1, 2), v.transpose(1, 2)
            kw = dict(q_positions=qpos, kv_len=kvl, scale=scale)
            n_d = b4.COUNTS.by_head_dim[d]
            out = b4.flash_sdpa(q, kd, vd, **kw)
            if b4.COUNTS.by_head_dim[d] != n_d + 1:
                fail(f"B4 {wd}: not the head_dim-{d} instance")

            def plain(q=q, kd=kd, vd=vd, kw=kw):
                return b4.flash_sdpa_plain(
                    q, kd, vd, scale=scale, causal=True,
                    q_positions=kw["q_positions"], kv_len=kw["kv_len"],
                    kv_start=torch.zeros_like(kw["kv_len"]),
                    won=torch.ones_like(kw["kv_len"]), window=None,
                    softcap=None)
            label = f"{wd} {model} T={t} x {b} {what} S={s}"
            err = check_rows(out, plain(), [(i, t) for i in range(b)],
                             f"B4 {label}")
            rows.append(timed_row(
                "flash_attention", label,
                lambda q=q, kd=kd, vd=vd, kw=kw: b4.flash_sdpa(q, kd, vd,
                                                               **kw),
                plain,
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=m[:, None],
                    scale=scale, **gqa),
                dense_work(q, k, mask), err, dict(t=t, rows=b)))
            del q, k, v, kd, vd, out
    torch.cuda.empty_cache()
    return rows


def launch_gate(kernels: dict, fail, tag: str, what: str, need,
                head_dim: int) -> dict:
    """Every kernel of ``need`` launched, no plain version run; the
    attention kernels at K width ``head_dim`` only; returns the
    launches."""
    out = {}
    for name, mod in kernels.items():
        n, plain = mod.COUNTS.launches, mod.COUNTS.plain_calls
        if plain or (mod in need and n == 0):
            fail(f"{tag} {what}: {name} launched {n} times, plain version "
                 f"called {plain} times")
        out[name] = n
    for name in ("ragged_paged_attention", "decode_attention",
                 "flash_attention"):
        mod = kernels[name]
        if mod.COUNTS.launches != mod.COUNTS.by_head_dim[head_dim]:
            fail(f"{tag} {what}: {mod.NAME} launched at head widths "
                 f"{dict(mod.COUNTS.by_head_dim)}")
    return out


def serving_requests(cfg, n_req: int, seed: int):
    """``n_req`` requests of 64-1000 ids and 32-64 new tokens, half greedy
    and half seeded."""
    import numpy as np

    from ipex_llm_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1001, n_req)
    news = rng.integers(32, 65, n_req)
    return [Request(prompt_ids=[int(v) for v in rng.integers(
                1, cfg.vocab_size, int(n))], max_new_tokens=int(m),
                    temperature=0.8 if i % 2 else 0.0,
                    top_p=0.9 if i % 2 else 1.0,
                    seed=5000 + i if i % 2 else None)
            for i, (n, m) in enumerate(zip(lens, news))]


def serve_run(kernels: dict, card: str, fail, dev, tag: str, label: str,
              cfg, params, n_req: int, seed: int, need) -> dict:
    """``n_req`` requests (:func:`serving_requests`) through
    ``ServingEngine`` with ``SERVE_EC`` over a bf16 pool; every request
    must finish with its tokens, the kernels of ``need`` launch, no plain
    version runs; returns the run's row (tok/s, TTFT, peak memory, weight
    bytes, launches by instance)."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.serving.engine import (EngineConfig,
                                                   ServingEngine,
                                                   stream_tokens)

    b1 = kernels["ragged_paged_attention"]
    b2e = kernels["qmatmul_experts"]
    eng = ServingEngine(cfg, params, EngineConfig(**SERVE_EC), device=dev)
    reqs = serving_requests(cfg, n_req, seed)
    reset_counts(kernels)
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
    launches = launch_gate(kernels, fail, tag, f"{label} serve", need,
                           cfg.head_dim)
    for q, st in zip(reqs, streams):
        if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                or st != q.output_ids or not all(
                    0 <= v < cfg.vocab_size for v in st):
            fail(f"{tag} {label}: a request finished {q.finish_reason} "
                 f"with {len(st)} of {q.max_new_tokens} tokens "
                 f"({eng.metrics.get('last_error')})")
    out_tok = sum(len(st) for st in streams)
    ttft = [q.first_token_s for q in reqs]
    row = dict(model=label, card=card, storage="bf16",
               layers=cfg.num_layers, heads=cfg.num_heads,
               head_dim=cfg.head_dim, v_head_dim=cfg.v_dim,
               requests=len(reqs),
               prompt_tokens=sum(len(q.prompt_ids) for q in reqs),
               output_tokens=out_tok, wall_s=wall,
               output_tok_s=out_tok / wall,
               ttft_mean_s=float(np.mean(ttft)),
               ttft_max_s=float(np.max(ttft)),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               weight_bytes=eng.weight_stats()["weight_bytes"],
               kv_page_bytes=eng.page_bytes, launches=launches,
               b1_by_route=dict(b1.COUNTS.by_route),
               b1_by_head_dim=dict(b1.COUNTS.by_head_dim),
               b2e_by_instance=dict(b2e.COUNTS.by_instance),
               ticks=eng.metrics["steps"])
    print(f"{tag} serve " + json.dumps(row), flush=True)
    del eng
    torch.cuda.empty_cache()
    return row


def generate_run(kernels: dict, card: str, fail, dev, tag: str, label: str,
                 cfg, hf: dict, params, lengths, new: int = 32) -> dict:
    """``generate()`` of the model class over left-padded prompts of
    ``lengths`` ids, ``new`` greedy tokens each: B2, B3 and B4 launch at
    the config's K width, no plain version runs; returns the run's row
    (tok/s, first cost, peak memory, launches)."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    model = TPUModelForCausalLM(cfg, params, hf, "sym_int4")
    rng = np.random.default_rng(13)
    width = max(lengths)
    ids = np.zeros((len(lengths), width), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, width - n:] = rng.integers(3, cfg.vocab_size, n)
        mask[i, width - n:] = 1
    reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask),
                         max_new_tokens=new, eos_token_id=())
    wall = time.perf_counter() - t0
    launches = launch_gate(kernels, fail, tag, f"{label} generate",
                           (b2, b3, b4), cfg.head_dim)
    got = model.last_result
    if tuple(out.shape) != (len(lengths), width + new) or list(
            got.num_new_tokens) != [new] * len(lengths) or int(
            out[:, -new:].max()) >= cfg.vocab_size:
        fail(f"{tag} {label} generate: sequences {tuple(out.shape)}, new "
             f"tokens {list(got.num_new_tokens)}")
    row = dict(model=label, card=card, rows=len(lengths),
               layers=cfg.num_layers, prompt_tokens=sum(lengths),
               new_tokens=new, wall_s=wall,
               output_tok_s=len(lengths) * new / wall,
               first_cost_s=model.first_cost,
               rest_cost_mean_s=model.rest_cost_mean,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               b3_by_head_dim=dict(b3.COUNTS.by_head_dim),
               b4_by_head_dim=dict(b4.COUNTS.by_head_dim))
    print(f"{tag} generate " + json.dumps(row), flush=True)
    del model
    return row


def random_weights(label: str, cfg, seed: int, dev):
    """Random sym_int4 params of ``cfg`` drawn and packed on the card."""
    import torch

    from ipex_llm_tpu_torch.models import random_init as ri

    t0 = time.perf_counter()
    params = ri.random_params(cfg, "sym_int4", seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"{label}-width random sym_int4 weights ({cfg.num_layers} "
          f"layers): {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card",
          flush=True)
    return params


def gpt_families_phase(kernels: dict, card: str, fail, device, graph_ms,
                       steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import torch

    import ipex_llm_tpu_torch.models.decoder as decoder_mod
    from ipex_llm_tpu_torch.models import random_init as ri
    from torch_families_smoke import small_check

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b2e = kernels["qmatmul_experts"]
    dev = device
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    # the attention kernels and the run helpers (module level, shared with
    # the offload and minicpm phases)
    reset = functools.partial(reset_counts, kernels)
    gate = functools.partial(launch_gate, kernels, fail, "gpt_families")
    if "kernels" in steps:
        res["kernels"] = attention_cases(
            kernels, fail, dev, graph_ms, tag="gpt_families", model="Phi-2",
            d=D, hq=HEADS, hkv=HEADS, seed=19)

    # -- 2. 2-layer decoders at the published widths, card against CPU -----
    def replaying_route():
        """The decoder's router wrapped: a call on the CPU records its
        selection and weights, the same call on the card (the next one in
        the card's order) returns the CPU's; returns (counts, original)."""
        orig = decoder_mod.route
        rec, seen = [], {"cuda_calls": 0, "differ": 0, "positions": 0}

        def route(cfg, logits, bias=None):
            w, idx = orig(cfg, logits, bias)
            if not logits.is_cuda:
                rec.append((w, idx))
                return w, idx
            w_c, idx_c = rec[seen["cuda_calls"]]
            seen["cuda_calls"] += 1
            seen["positions"] += idx_c[..., 0].numel()
            seen["differ"] += int((idx.sort(-1).values.cpu()
                                   != idx_c.sort(-1).values).any(-1).sum())
            return w_c.to(w.device), idx_c.to(idx.device)
        decoder_mod.route = route
        return seen, orig

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.to("cpu") if hasattr(tree, "to") else tree

    published = {"Phi-2": ri.phi2_config, "phixtral-4x2_8":
                 ri.phixtral_4x2_config, "Pythia-6.9B":
                 ri.pythia_6_9b_config, "GPT-J-6B": ri.gptj_6b_config}
    res["step_s"] = {"kernels": time.perf_counter() - t_phase}
    if "small" in steps:
        t0 = time.perf_counter()
        reset()
        res["small"] = {}
        for seed, (label, make) in enumerate(published.items()):
            cfg = make(num_layers=2, vocab_size=SMALL_VOCAB)
            params = to_cpu(ri.random_params(cfg, "sym_int4", seed=40 + seed,
                                             device=dev))
            seen, orig = replaying_route()
            try:
                res["small"][label] = small_check(
                    cfg, 40 + seed, dev, fail, label, forms=("paged",),
                    params=params, paged_decode_steps=1)
            finally:
                decoder_mod.route = orig
            if cfg.num_experts:
                res["small"][label]["router"] = dict(seen)
        res["small_launches"] = {n: m.COUNTS.launches
                                 for n, m in kernels.items()}
        if not all(m.COUNTS.launches for m in (b1, b2, b2e)) or \
                b1.COUNTS.by_head_dim[D] == 0:
            fail(f"gpt_families small: launches {res['small_launches']}")
        print("gpt_families small decoders card vs CPU, worst logit diff "
              "over the range (bound 0.025): " + json.dumps(res["small"]),
              flush=True)
        res["step_s"]["small"] = time.perf_counter() - t0

    # -- 3. full width through the engine; Phi-2's generate() ---------------
    if "serve" in steps:
        t0 = time.perf_counter()
        res["serve"], res["generate"] = [], []
        for seed, (label, make) in enumerate(published.items()):
            cfg = make() if label == "Phi-2" else make(
                num_layers=SERVE_LAYERS)
            params = random_weights(label, cfg, 50 + seed, dev)
            need = (b1, b2, b2e) if cfg.num_experts else (b1, b2)
            res["serve"].append(serve_run(
                kernels, card, fail, dev, "gpt_families", label, cfg, params,
                8, 60 + seed, need))
            if label == "Phi-2":
                res["generate"].append(generate_run(
                    kernels, card, fail, dev, "gpt_families", label, cfg,
                    ri.PHI2_HF, params, GENERATE_LENGTHS))
            del params
            torch.cuda.empty_cache()
        res["step_s"]["serve"] = time.perf_counter() - t0

    # -- 4. a Phi-2-width checkpoint through the model API -------------------
    if "load" in steps:
        t0 = time.perf_counter()
        res["load"] = load_step(kernels, card, fail, dev, gate)
        res["step_s"]["load"] = time.perf_counter() - t0
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def load_step(kernels: dict, card: str, fail, dev, gate) -> dict:
    """Step 4 of the module docstring; ``gate(what, need, head_dim)``
    checks a run's launches."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models.build import param_bytes, quantize_weight
    from ipex_llm_tpu_torch.models.loader import (CheckpointReader,
                                                  save_safetensors)
    from ipex_llm_tpu_torch.models.random_init import PHI2_HF
    from ipex_llm_tpu_torch.quantize.core import QTensor
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM

    hf = dict(PHI2_HF, num_hidden_layers=LOAD_LAYERS,
              architectures=["PhiForCausalLM"], torch_dtype="bfloat16")
    shapes = phi_hf_shapes(hf)
    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    res: dict = {"card": card, "layers": LOAD_LAYERS}
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_phi_load_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(21)
        tensors = {}
        for name, shape in sorted(shapes.items()):
            w = torch.randn(shape, generator=gen, device=dev)
            if name.endswith("layernorm.weight"):
                w = 1.0 + 0.05 * w
            elif name.endswith("bias"):
                w = 0.02 * w
            else:
                w = w * (1.2 / shape[-1] ** 0.5)
            tensors[name] = w.to(torch.bfloat16).cpu()
        total = sum(t.numel() * 2 for t in tensors.values())
        save_safetensors(tensors, f"{root}/model.safetensors",
                         metadata={"format": "pt"})
        del tensors
        with open(f"{root}/config.json", "w") as f:
            json.dump(hf, f)
        res.update(checkpoint_bytes=total, write_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.from_pretrained(
            root, load_in_low_bit="sym_int4", device=dev)
        torch.cuda.synchronize()
        res.update(load_s=time.perf_counter() - t0,
                   weight_bytes=param_bytes(model.params)[0])
        reader = CheckpointReader(root)
        p = "model.layers.0."
        for key, names in (("qkv", [p + "self_attn.q_proj.weight",
                                    p + "self_attn.k_proj.weight",
                                    p + "self_attn.v_proj.weight"]),
                           ("up", [p + "mlp.fc1.weight"])):
            want = quantize_weight(torch.cat([reader.get(n)
                                              for n in names]), "sym_int4")
            got = model.params["layers"][key].planes(lambda t: t[0].cpu())
            if not (torch.equal(got.data, want.data)
                    and torch.equal(got.scales, want.scales)):
                fail(f"gpt_families load: {key} planes differ from the "
                     "CPU codec's")
        t0 = time.perf_counter()
        model.save_low_bit(f"{root}/low_bit")
        again = AutoModelForCausalLM.load_low_bit(f"{root}/low_bit",
                                                  device=dev)
        res["save_load_s"] = time.perf_counter() - t0

        def leaves(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from leaves(v, f"{path}{k}.")
                elif isinstance(v, QTensor):
                    for plane in ("data", "scales", "zeros"):
                        yield f"{path}{k}.{plane}", getattr(v, plane)
                else:
                    yield f"{path}{k}", v
        a, b = dict(leaves(model.params)), dict(leaves(again.params))
        if sorted(a) != sorted(b) or any(
                (x is None) != (b[k] is None) or (
                    x is not None and not (
                        torch.equal(x, b[k]) if torch.is_tensor(x)
                        else x == b[k]))
                for k, x in a.items()):
            fail("gpt_families load: save_low_bit/load_low_bit is not "
                 "bitwise")
        if not {"lm_head_bias", "final_norm_bias"} <= set(again.params):
            fail(f"gpt_families load: leaves {sorted(again.params)}")
        res["low_bit_bitwise"] = True
        del model
        for mod in kernels.values():
            mod.COUNTS.reset()
        ids = torch.from_numpy(np.random.default_rng(23).integers(
            3, hf["vocab_size"], (2, 300)))
        t0 = time.perf_counter()
        out = again.generate(ids, max_new_tokens=16, eos_token_id=())
        res["generate_s"] = time.perf_counter() - t0
        if tuple(out.shape) != (2, 316):
            fail(f"gpt_families load generate: {tuple(out.shape)}")
        res["generate_launches"] = gate("load generate", (b2, b3, b4), 80)
        print("gpt_families load " + json.dumps(res), flush=True)
        del again
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_gpt_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_gpt_families_smoke: steps are {STEPS}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_gpt_families_smoke: FAILED: {msg}", file=sys.stderr,
              flush=True)
        sys.exit(1)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = kernel_modules()
    print(f"kernel build: "
          f"{_build.build(_build.sources(kernels.values())):.1f} s",
          flush=True)
    res = gpt_families_phase(kernels, card, fail, torch.device("cuda", 0),
                             graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
