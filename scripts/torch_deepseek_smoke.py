#!/usr/bin/env python3
"""DeepSeek on one card: B1, B3 and B4 at K width 192 and V width 128
against their plain versions, tiny DeepSeek-V2 and V3 decoders card
against CPU, DeepSeek-V2-Lite at full width through ``ServingEngine`` and
``generate()``, DeepSeek-V3 at full width (its depth cut) through the
engine, and a V2-Lite-width checkpoint through ``from_pretrained`` and
``build_server``, from random sym_int4 weights drawn on the card from a
seed.

``chip_smoke.py`` runs this as its ``deepseek`` phase; alone, from the
root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_deepseek_smoke.py [kernels] [small] [v2] [v3]
        [load]

(no step named: all five).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: B1's (192, 128) instances at V2-Lite's heads (16 over 16)
   and V3's (128 over 128), C = 1 and 4 (the key split) and C = 128 (query
   tiles: chunk, decode and idle rows), over bf16 and e5m2 pools of
   16-slot pages, ragged ``kv_len``; B3's at V2-Lite's heads, B = 4 and 8
   rows of a 4096-slot dense layer (bf16, and e5m2 at B = 8); B4's at
   V2-Lite's heads, 8 rows of T = 128 at their own slots of a 4096-slot
   layer and 2 rows of T = 2048 from slot 0: every query row within
   ``ATTN_TOL_REL`` of its largest plain output, then each timed as device
   time from CUDA-graph replays beside its bound (bytes over 3.35 TB/s,
   operations over 989 TFLOP/s) and ``scaled_dot_product_attention``
   (which takes a V narrower than K) on the same inputs and mask;
2. ``small``: tiny V2 (full-rank q, group-limited softmax routing) and V3
   (low-rank q, sigmoid routing with the score bias) decoders of
   ``random_init``, widened to hidden 512 and MLA's head widths (K 192, V
   128), 3 layers (1 dense, 2 MoE), paged and dense, on the card
   against the same decoder on the CPU's plain versions: logits within
   2.5% of their range, the card following the CPU's expert selections
   (a flip at a near-tie cannot move the logits), and its own selections
   equal wherever the CPU's selection is clear (``selection_sure``);
3. ``v2``: DeepSeek-V2-Lite at full width, ``SERVE_LAYERS`` of its 27
   layers (1 dense, 7 MoE), through ``ServingEngine`` with ``SERVE_EC``:
   eight requests of 64-1000 ids over a bf16 pool, two over e5m2; B1 at
   (192, 128), B2 and B2e launch, no plain version runs; tok/s, TTFT and
   peak memory; one decode tick under ``torch.profiler`` (idle share, B2e's
   share); ``generate()`` on four prompts of 1990, 1327, 611 and 203 ids,
   32 new tokens: B2, B2e, B3 and B4 at (192, 128) launch;
4. ``v3``: DeepSeek-V3 at full width, its 3 dense prefix layers and 1 MoE
   layer (``random_init.deepseek_v3_config``), through the engine: eight
   requests over a bf16 pool (B1 at 128 heads a row); the first tick's
   router logits read back, and ``route`` on the CPU over them (its plain
   sigmoid, score bias and group selection) selects the experts the card
   selected wherever the selection is clear (``selection_sure``);
5. ``load``: a 2-layer V2-Lite-width checkpoint (1 dense, 1 MoE layer)
   written with numpy to ``TMPDIR``, through ``from_pretrained`` (its MLA
   planes against the CPU codec of the same tensors) and ``build_server``
   (one completion), then removed.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the weight bytes.  Each model is freed
before the next.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "v2", "v3", "load")
# the attention kernels against their float64 plain versions: within 2^-7
# of the row's largest output (chip_smoke.py's ATTN_TOL_REL)
ATTN_TOL_REL = 2.0 ** -7
D, DV = 192, 128            # MLA's K and V head widths
SERVE_EC = dict(max_rows=8, max_seq_len=2048, page_size=128,
                prefill_bucket=128, decode_horizon=4)
SERVE_LAYERS = 8            # of V2-Lite's 27 (as families and moe keep 8)
GENERATE_LENGTHS = (1990, 1327, 611, 203)
# a selection is compared card against CPU where it is clear: the last
# kept group leads the next, and the k-th selected expert the next
# eligible one, by more than SEL_MARGIN of the token's logit span in the
# logits (softmax scores: the same order; the moe phase's MARGIN), or by
# more than SEL_MARGIN_SIGMOID in the sigmoid scores plus the score bias
SEL_MARGIN = 0.01
SEL_MARGIN_SIGMOID = 0.02
# route on the card and on the CPU over the same fp32 logits: they differ
# only by the last bits of a sigmoid or softmax, so a lead of this many
# score units (or of logits under softmax) is clear
ROUTE_MARGIN = 1e-5


def selection_sure(cfg, logits, bias, same_logits: bool = False):
    """[...] bool: the token's selection by ``models.decoder.route``'s
    rule over fp32 ``logits`` is clear (the margins above; ROUTE_MARGIN
    where both sides route the ``same_logits``)."""
    import torch

    from ipex_llm_tpu_torch.models.decoder import route

    if cfg.moe_score_func == "sigmoid":
        key = torch.sigmoid(logits)
        if bias is not None:
            key = key + bias
        floor, masked = SEL_MARGIN_SIGMOID, 0.0     # the reference's mask
    else:                       # softmax: the logits order the scores
        span = logits.amax(-1) - logits.amin(-1)
        key, floor, masked = logits, SEL_MARGIN * span, float("-inf")
    if same_logits:
        floor = ROUTE_MARGIN
    lead = torch.full(key.shape[:-1], float("inf"), device=key.device)
    if cfg.moe_n_group > 1:
        g = key.reshape(*key.shape[:-1], cfg.moe_n_group, -1)
        top = torch.sort(g, dim=-1, descending=True).values
        gs = (top[..., 0] + top[..., 1] if cfg.moe_group_score == "top2sum"
              else top[..., 0])
        gsrt = torch.sort(gs, dim=-1, descending=True)
        k_g = cfg.moe_topk_group
        lead = gsrt.values[..., k_g - 1] - gsrt.values[..., k_g]
        keep = torch.zeros_like(gs, dtype=torch.bool).scatter_(
            -1, gsrt.indices[..., :k_g], True)
        key = torch.where(keep[..., None], g, torch.full_like(g, masked)
                          ).reshape(key.shape)
    _, idx = route(cfg, logits, bias)
    rest = key.scatter(-1, idx, float("-inf"))
    lead = torch.minimum(lead, torch.gather(key, -1, idx).min(-1).values
                         - rest.max(-1).values)
    return lead > floor


def deepseek_phase(kernels: dict, card: str, fail, device, graph_ms,
                   steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ipex_llm_tpu_torch.models.decoder as decoder_mod
    from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
    from ipex_llm_tpu_torch.models import random_init as ri
    from ipex_llm_tpu_torch.models.families import config_from_hf
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM
    from torch_moe_smoke import bound    # the H100's least time for work

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    b2e = kernels["qmatmul_experts"]
    dev = device
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(18)
    scale = D ** -0.5

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
        if tuple(o.shape) != tuple(r.shape) or o.shape[-1] != DV:
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
                   bound_by=by, head_dim=D, v_head_dim=DV, **extra)
        print("deepseek kernel " + json.dumps(row), flush=True)
        return row

    # -- 1. the (192, 128) instances -----------------------------------------
    def b1_case(pool_dtype, c, h, r=8, ps=16, maxp=150):
        """Rows over 16-slot pages in random order, -1 past each row's last
        page.  C = 1 and 4: every row decodes or verifies at staggered
        lengths up to the capacity; C = 128: full and part chunks, decode
        rows, a chunk at the row's first slots and an idle row (kv_len the
        sentinel at the capacity)."""
        cap = maxp * ps
        kp = torch.randn(1 + r * maxp, h, ps, D, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(1 + r * maxp, h, ps, DV, generator=gen,
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
        q = torch.randn(r, c, h, D, generator=gen, device=dev).to(
            torch.bfloat16)
        return (q, kp, vp, tables,
                torch.tensor(kv_len, dtype=torch.int32, device=dev),
                torch.tensor(chunk, dtype=torch.int32, device=dev))

    def b1_work(q, kp, kv_len, chunk):
        """Bytes: q, out and each row's live K and V slots; operations:
        2 D for Q.K and 2 Dv for P.V at each visible (query, key) pair and
        head."""
        r, c, h, _ = q.shape
        item = kp.element_size()
        nbytes = r * c * h * (D + DV) * 2
        pairs = 0
        for n_kv, n_q in zip(kv_len.tolist(), chunk.tolist()):
            if n_q:
                nbytes += n_kv * h * (D + DV) * item
                pairs += sum(n_kv - n_q + j + 1 for j in range(n_q))
        return bound(nbytes, 2.0 * (D + DV) * h * pairs)

    def b1_library(q, kp, vp, tables, kv_len, chunk):
        """SDPA over the gathered pages (the gather outside the timing)."""
        r, c, h, _ = q.shape
        maxp, ps = tables.shape[1], kp.shape[2]
        idx = tables.long().clamp(0, kp.shape[0] - 1)

        def gather(pool):
            g = pool[idx].to(torch.bfloat16)         # [R, maxP, H, ps, d]
            return g.permute(0, 2, 1, 3, 4).reshape(r, h, maxp * ps, -1)
        kg, vg = gather(kp), gather(vp)
        kpos = torch.arange(maxp * ps, device=dev)
        qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kv_len[:, None, None])
        mask[..., 0] = True          # idle rows: keep the softmax defined
        qt = q.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask[:, None], scale=scale)

    def dense_case(b, t, h, s, kv_len, kv_dtype):
        """Query rows at each row's last ``t`` slots below ``kv_len`` of a
        head-major [B, H, S, D] K and [B, H, S, Dv] V layer."""
        q = torch.randn(b, t, h, D, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(b, h, s, D, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(b, h, s, DV, generator=gen, device=dev).to(kv_dtype)
        kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        qpos = (kvl.long() - t)[:, None] + torch.arange(t, device=dev)
        kpos = torch.arange(s, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kvl[:, None, None])
        return q, k, v, kvl, qpos, mask

    def dense_work(q, k, mask):
        """Bytes: q, out and the K/V slots some query sees; operations:
        2 (D + Dv) for each visible (query, key) pair and head."""
        b, t, h, _ = q.shape
        seen = mask.any(dim=1).sum().item()          # slots any query sees
        nbytes = b * t * h * (D + DV) * 2 + seen * h * (D + DV) \
            * k.element_size()
        return bound(nbytes, 2.0 * (D + DV) * h * mask.sum().item())

    if "kernels" in steps:
        rows = []
        for model, h, maxp in (("V2-Lite", 16, 150), ("V3", 128, 40)):
            for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                          ("e5m2", torch.float8_e5m2)):
                for c in (1, 4, 128):
                    args = b1_case(pool_dtype, c, h, maxp=maxp)
                    before = dict(b1.COUNTS.by_route)
                    n192 = b1.COUNTS.by_head_dim[D]
                    out = b1.ragged_paged_sdpa(*args, scale=scale)
                    route = [r for r, v in b1.COUNTS.by_route.items()
                             if v > before[r]]
                    want = "split" if c <= 16 else "tiles"
                    if route != [want] or b1.COUNTS.by_head_dim[D] == n192:
                        fail(f"B1 (192, 128) {model} C={c}: ran {route}, "
                             f"want {want} at K width 192")
                    ref = b1.ragged_paged_sdpa_plain(*args, scale=scale)
                    label = f"(192, 128) {model} Hq=Hkv={h} C={c}"
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
                        b1_library(*args), b1_work(args[0], args[1],
                                                   args[4], args[5]),
                        err, dict(pool=pool_name, route=want, heads=h,
                                  capacity=maxp * 16)))
                    del args, out, ref
        h, s = 16, 4096
        kv_len8 = [64, 700, 1500, 2047, 2048, 2600, 3500, 4096]
        for b, kv_name, kv_dtype in ((4, "bf16", torch.bfloat16),
                                     (8, "bf16", torch.bfloat16),
                                     (8, "e5m2", torch.float8_e5m2)):
            kvl_list = kv_len8[::2] if b == 4 else kv_len8
            q, k, v, kvl, qpos, mask = dense_case(b, 1, h, s, kvl_list,
                                                  kv_dtype)
            n192 = b3.COUNTS.by_head_dim[D]
            out = b3.decode_sdpa(q, k, v, kv_len=kvl, scale=scale)
            if b3.COUNTS.by_head_dim[D] != n192 + 2:
                fail("B3 (192, 128): not the K-width-192 instance")

            def plain(q=q, k=k, v=v, kvl=kvl):
                return b3.decode_sdpa_plain(
                    q, k, v, scale=scale, kv_len=kvl,
                    kv_start=torch.zeros_like(kvl), won=torch.ones_like(kvl),
                    window=None, softcap=None)
            label = f"(192, 128) V2-Lite B={b} Hq=Hkv={h} S={s}"
            err = check_rows(out, plain(), [(i, 1) for i in range(b)],
                             f"B3 {label} {kv_name}")
            kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
            rows.append(timed_row(
                "decode_attention", label,
                lambda q=q, k=k, v=v, kvl=kvl: b3.decode_sdpa(
                    q, k, v, kv_len=kvl, scale=scale), plain,
                lambda q=q, kb=kb, vb=vb, m=mask:
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), kb, vb, attn_mask=m[:, None],
                        scale=scale),
                dense_work(q, k, mask), err, dict(pool=kv_name, rows=b)))
            del q, k, v, kb, vb, out
        for b, t, s_, what in ((8, 128, 4096, "chunks"),
                               (2, 2048, 2048, "prefill")):
            kvl_list = ([max(n, t) for n in kv_len8] if b == 8
                        else [s_] * b)
            q, k, v, kvl, qpos, mask = dense_case(b, t, h, s_, kvl_list,
                                                  torch.bfloat16)
            kd, vd = k.transpose(1, 2), v.transpose(1, 2)
            kw = dict(q_positions=qpos, kv_len=kvl, scale=scale)
            n192 = b4.COUNTS.by_head_dim[D]
            out = b4.flash_sdpa(q, kd, vd, **kw)
            if b4.COUNTS.by_head_dim[D] != n192 + 1:
                fail("B4 (192, 128): not the K-width-192 instance")

            def plain(q=q, kd=kd, vd=vd, kw=kw):
                return b4.flash_sdpa_plain(
                    q, kd, vd, scale=scale, causal=True,
                    q_positions=kw["q_positions"], kv_len=kw["kv_len"],
                    kv_start=torch.zeros_like(kw["kv_len"]),
                    won=torch.ones_like(kw["kv_len"]), window=None,
                    softcap=None)
            label = f"(192, 128) V2-Lite T={t} x {b} {what} S={s_}"
            err = check_rows(out, plain(), [(i, t) for i in range(b)],
                             f"B4 {label}")
            rows.append(timed_row(
                "flash_attention", label,
                lambda q=q, kd=kd, vd=vd, kw=kw: b4.flash_sdpa(q, kd, vd,
                                                               **kw),
                plain,
                lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=m[:, None],
                    scale=scale),
                dense_work(q, k, mask), err, dict(t=t, rows=b)))
            del q, k, v, kd, vd, out
        torch.cuda.empty_cache()
        res["kernels"] = rows

    # -- 2. small decoders, card against CPU ---------------------------------
    def recording_route(replay=None):
        """Wrap the decoder's router so that each call's fp32 logits, score
        bias and selection are kept (in call order); with ``replay``
        (another run's records) each call returns that run's selection and
        weights for the same call instead of its own."""
        rec = []
        orig = decoder_mod.route

        def route(cfg, logits, bias=None):
            w, idx = orig(cfg, logits, bias)
            rec.append((logits.float().cpu(),
                        None if bias is None else bias.cpu(), idx.cpu(),
                        w.cpu()))
            if replay is not None:
                _, _, idx_r, w_r = replay[len(rec) - 1]
                return w_r.to(w.device), idx_r.to(idx.device)
            return w, idx
        decoder_mod.route = route
        return rec, orig

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev) if hasattr(tree, "to") else tree

    def small_check(label, cfg, seed) -> dict:
        p_cpu = ri.random_params(cfg, "sym_int4", seed=seed, device="cpu",
                                 router_scale=3.0)
        p_dev = to_dev(p_cpu)
        rng = np.random.default_rng(seed)
        r, t, ps, maxp = 3, 40, 128, 2
        lengths = np.array([40, 17, 29], np.int32)
        toks = rng.integers(0, cfg.vocab_size, (r, t)).astype(np.int32)
        decode = [rng.integers(0, cfg.vocab_size, (r, 1)).astype(np.int32)
                  for _ in range(3)]
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        valid = {"paged": [np.arange(t)[None] < lengths[:, None]]
                 + [np.ones((r, 1), bool)] * 3,
                 "dense": [np.arange(t)[None] >= (t - lengths)[:, None]]
                 + [np.ones((r, 1), bool)] * 3}
        worst = {}
        sel = {"checked": 0, "positions": 0, "flips": 0}
        for form in ("paged", "dense"):
            outs, routes = {}, {}
            for name, where, params in (("cpu", "cpu", p_cpu),
                                        ("cuda", dev, p_dev)):
                def to(x):
                    return torch.from_numpy(np.ascontiguousarray(x)).to(
                        where)
                rec, orig = recording_route(routes.get("cpu"))
                logits = []
                try:
                    if form == "paged":
                        c = PagedKVCache.init(
                            cfg.num_layers, 1 + r * maxp, r, maxp,
                            cfg.num_kv_heads, ps, cfg.head_dim,
                            device=where, v_head_dim=cfg.v_dim)
                        c.tables.copy_(1 + torch.arange(
                            r * maxp, dtype=torch.int32).reshape(r, maxp))
                        lg, _ = decoder_mod.decoder_forward(
                            cfg, params, to(toks), c,
                            to(np.arange(t)[None].repeat(r, 0)),
                            slot_offsets=to(np.zeros(r, np.int32)),
                            chunk_lens=to(lengths),
                            gather_positions=to(lengths - 1))
                        logits.append(lg)
                        lens = lengths.copy()
                        for tk in decode:
                            lg, _ = decoder_mod.decoder_forward(
                                cfg, params, to(tk), c, to(lens[:, None]),
                                slot_offsets=to(lens), last_token_only=True)
                            logits.append(lg)
                            lens = lens + 1
                    else:
                        padded = np.zeros_like(toks)
                        for i, n in enumerate(lengths):
                            padded[i, t - n:] = toks[i, :n]
                        kv_start = (t - lengths).astype(np.int32)
                        pos = np.maximum(
                            np.arange(t)[None] - kv_start[:, None], 0)
                        c = make_cache("normal", cfg.num_layers, r, t + 16,
                                       cfg.num_kv_heads, cfg.head_dim,
                                       v_head_dim=cfg.v_dim, device=where)
                        for tk, pp in [(padded, pos)] + [
                                (tk, (lengths + i)[:, None])
                                for i, tk in enumerate(decode)]:
                            lg, _ = decoder_mod.decoder_forward(
                                cfg, params, to(tk), c, to(pp),
                                to(kv_start), last_token_only=True)
                            logits.append(lg)
                finally:
                    decoder_mod.route = orig
                outs[name] = [lg.float().cpu().numpy() for lg in logits]
                routes[name] = rec
            for j, real in enumerate(valid[form]):
                live = torch.from_numpy(real)
                for (lc, bc, ic, _), (_, _, ig, _) in zip(
                        routes["cpu"][j * n_moe:(j + 1) * n_moe],
                        routes["cuda"][j * n_moe:(j + 1) * n_moe]):
                    sure = selection_sure(cfg, lc, bc) & live
                    sel["positions"] += int(live.sum())
                    sel["checked"] += int(sure.sum())
                    differ = (ic.sort(-1).values != ig.sort(-1).values
                              ).any(-1) & live
                    if bool((differ & sure).any()):
                        fail(f"deepseek small {label} {form}: the card "
                             "selected other experts than the CPU where "
                             "the selection is clear")
                    sel["flips"] += int(differ.sum())
            w = 0.0
            for a, b in zip(outs["cuda"], outs["cpu"]):
                diff = float(np.abs(a - b).max() / (b.max() - b.min()))
                if not np.isfinite(a).all() or diff > 0.025:
                    fail(f"deepseek small {label} {form}: card vs CPU "
                         f"logits differ by {diff:.4f} of the range "
                         "(bound 0.025)")
                w = max(w, diff)
            worst[form] = w
        if sel["checked"] < 0.3 * sel["positions"]:
            fail(f"deepseek small {label}: only {sel['checked']} of "
                 f"{sel['positions']} router positions were checked")
        worst["selections_equal"] = sel
        return worst

    if "small" in steps:
        reset()
        # the tiny configs at MLA's head widths (K 128 + 64, V 128, which
        # the kernels take) and hidden 512
        wide = dict(hidden_size=512, intermediate_size=1024,
                    moe_intermediate_size=256, vocab_size=512,
                    qk_nope_head_dim=128, qk_rope_head_dim=64,
                    v_head_dim=DV, kv_lora_rank=128)
        res["small"] = {
            label: small_check(label, config_from_hf({**hf, **wide, **q}),
                               seed)
            for label, hf, q, seed in (
                ("v2", ri.TINY_DEEPSEEK_V2_HF, {}, 3),
                ("v3", ri.TINY_DEEPSEEK_V3_HF, {"q_lora_rank": 96}, 4))}
        res["small_launches"] = {n: m.COUNTS.launches
                                 for n, m in kernels.items()}
        if not all(m.COUNTS.launches for m in (b1, b2, b2e, b3, b4)) or any(
                m.COUNTS.launches != m.COUNTS.by_head_dim[D]
                for m in (b1, b3, b4)):
            fail(f"deepseek small: launches {res['small_launches']}")
        print("deepseek small decoders card vs CPU, worst logit diff over "
              "the range (bound 0.025): " + json.dumps(res["small"]),
              flush=True)

    # -- 3, 4. full width through the engine; generate() ---------------------
    def requests(cfg, n_req, seed):
        rng = np.random.default_rng(seed)
        lens = rng.integers(64, 1001, n_req)
        news = rng.integers(32, 65, n_req)
        return [Request(prompt_ids=[int(v) for v in rng.integers(
                    1, cfg.vocab_size, int(n))], max_new_tokens=int(m),
                        temperature=0.8 if i % 2 else 0.0,
                        top_p=0.9 if i % 2 else 1.0,
                        seed=5000 + i if i % 2 else None)
                for i, (n, m) in enumerate(zip(lens, news))]

    def gate(what, need):
        """Every kernel of ``need`` launched, no plain version run; the
        attention kernels at K width 192 only; returns the launches."""
        out = {}
        for name, mod in kernels.items():
            n, plain = mod.COUNTS.launches, mod.COUNTS.plain_calls
            if plain or (mod in need and n == 0):
                fail(f"deepseek {what}: {name} launched {n} times, plain "
                     f"version called {plain} times")
            out[name] = n
        for mod in (b1, b3, b4):
            if mod.COUNTS.launches != mod.COUNTS.by_head_dim[D]:
                fail(f"deepseek {what}: {mod.NAME} launched at head "
                     f"widths {dict(mod.COUNTS.by_head_dim)}")
        return out

    def serve(label, cfg, params, storage, n_req, seed, need,
              first_tick=None):
        eng = ServingEngine(cfg, params, EngineConfig(
            kv_storage=storage, **SERVE_EC), device=dev)
        reqs = requests(cfg, n_req, seed)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if first_tick is not None:
            for q in reqs:
                eng.submit(q)
            first_tick(eng)
        eng.start()
        t0 = time.perf_counter()
        if first_tick is None:
            for q in reqs:
                eng.submit(q)
        streams = [list(stream_tokens(q, timeout=900)) for q in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.stop()
        launches = gate(f"{label} serve {storage}", need)
        for q, st in zip(reqs, streams):
            if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                    or st != q.output_ids or not all(
                        0 <= v < cfg.vocab_size for v in st):
                fail(f"deepseek {label} {storage}: a request finished "
                     f"{q.finish_reason} with {len(st)} of "
                     f"{q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
        out_tok = sum(len(st) for st in streams)
        ttft = [q.first_token_s for q in reqs]
        row = dict(model=label, card=card, storage=storage,
                   layers=cfg.num_layers, heads=cfg.num_heads,
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
                   b2e_by_instance=dict(b2e.COUNTS.by_instance),
                   ticks=eng.metrics["steps"])
        print("deepseek serve " + json.dumps(row), flush=True)
        del eng
        torch.cuda.empty_cache()
        return row

    def tick_profile(label, cfg, params) -> dict:
        """One decode tick of eight rows (horizon 4) under
        ``torch.profiler``: B2e's device time over the tick's, and the
        device's idle share of the tick's wall time."""
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        total = experts = attn = 0.0
        spans = []
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                total += ev.device_time_total
                if "qmm_experts" in ev.name:
                    experts += ev.device_time_total
                if "ragged" in ev.name:
                    attn += ev.device_time_total
                spans.append((ev.time_range.start, ev.time_range.end))
        busy, last = 0.0, None
        for s, e in sorted(spans):          # union of the kernels' spans
            if last is None or s > last:
                busy += e - s
                last = e
            elif e > last:
                busy += e - last
                last = e
        if not total:
            fail(f"deepseek {label} tick: the profile shows no device time")
        row = dict(model=label, card=card, rows=len(reqs),
                   horizon=eng.ec.decode_horizon, tick_wall_ms=wall * 1e3,
                   tick_device_ms=total / 1e3, b2e_device_ms=experts / 1e3,
                   b2e_share=experts / total, b1_device_ms=attn / 1e3,
                   b1_share=attn / total, device_busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / 1e3 / (wall * 1e3))
        print("deepseek tick " + json.dumps(row), flush=True)
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
        launches = gate(f"{label} generate", (b2, b2e, b3, b4))
        got = model.last_result
        if tuple(out.shape) != (len(GENERATE_LENGTHS), width + new) or list(
                got.num_new_tokens) != [new] * len(GENERATE_LENGTHS) or int(
                out[:, -new:].max()) >= cfg.vocab_size:
            fail(f"deepseek {label} generate: sequences "
                 f"{tuple(out.shape)}, new tokens {list(got.num_new_tokens)}")
        row = dict(model=label, card=card, rows=len(GENERATE_LENGTHS),
                   prompt_tokens=sum(GENERATE_LENGTHS), new_tokens=new,
                   wall_s=wall, output_tok_s=len(GENERATE_LENGTHS) * new
                   / wall, first_cost_s=model.first_cost,
                   rest_cost_mean_s=model.rest_cost_mean,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches,
                   b2e_by_instance=dict(b2e.COUNTS.by_instance))
        print("deepseek generate " + json.dumps(row), flush=True)
        del model
        return row

    def weights(label, cfg, seed):
        t0 = time.perf_counter()
        params = ri.random_params(cfg, "sym_int4", seed=seed, device=dev)
        torch.cuda.synchronize()
        print(f"{label}-width random sym_int4 weights ({cfg.num_layers} "
              f"layers): {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)
        return params

    res["serve"], res["tick"], res["generate"] = [], [], []
    if "v2" in steps:
        cfg = ri.deepseek_v2_lite_config(num_layers=SERVE_LAYERS)
        params = weights("DeepSeek-V2-Lite", cfg, 30)
        need = (b1, b2, b2e)
        res["serve"].append(serve("DeepSeek-V2-Lite", cfg, params, "bf16", 8,
                                  40, need))
        res["serve"].append(serve("DeepSeek-V2-Lite", cfg, params, "fp8", 2,
                                  41, need))
        res["tick"].append(tick_profile("DeepSeek-V2-Lite", cfg, params))
        res["generate"].append(generate("DeepSeek-V2-Lite", cfg,
                                        ri.DEEPSEEK_V2_LITE_HF, params))
        del params
        torch.cuda.empty_cache()

    if "v3" in steps:
        cfg = ri.deepseek_v3_config()
        params = weights("DeepSeek-V3", cfg, 31)
        first = {}

        def first_tick(eng):
            """The first tick run by hand with the router recorded: its
            card selections against ``route`` on the CPU over the same
            logits and score bias, where the margin is clear."""
            rec, orig = recording_route()
            try:
                eng._tick()
            finally:
                decoder_mod.route = orig
            torch.cuda.synchronize()
            checked = positions = 0
            for lg, bias, idx, w in rec:
                _, idx_c = decoder_mod.route(cfg, lg, bias)
                sure = selection_sure(cfg, lg, bias, same_logits=True)
                positions += sure.numel()
                checked += int(sure.sum())
                if bool(((idx_c.sort(-1).values != idx.sort(-1).values
                          ).any(-1) & sure).any()):
                    fail("deepseek V3: the card selected other experts "
                         "than route on the CPU where the margin is clear")
            if not rec or checked < 0.5 * positions:
                fail(f"deepseek V3: {checked} of {positions} first-tick "
                     "selections checked")
            first.update(router_calls=len(rec), positions=positions,
                         checked=checked)
        res["serve"].append(serve("DeepSeek-V3", cfg, params, "bf16", 8, 42,
                                  (b1, b2, b2e), first_tick))
        res["v3_first_tick_selections"] = first
        print("deepseek V3 first tick selections " + json.dumps(first),
              flush=True)
        del params
        torch.cuda.empty_cache()

    # -- 5. from_pretrained and build_server of a V2-Lite-width checkpoint ---
    if "load" in steps:
        res["load"] = load_step(kernels, card, fail, dev)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def load_step(kernels: dict, card: str, fail, dev) -> dict:
    """Step 5 of the module docstring."""
    import asyncio

    import torch

    from ipex_llm_tpu_torch.models.build import param_bytes, quantize_weight
    from ipex_llm_tpu_torch.models.loader import (CheckpointReader,
                                                  save_safetensors)
    from ipex_llm_tpu_torch.models.random_init import (DEEPSEEK_V2_LITE_HF,
                                                       deepseek_hf_shapes)
    from ipex_llm_tpu_torch.serving.api_server import build_server
    from ipex_llm_tpu_torch.serving.engine import EngineConfig
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
    from torch_http_client import IdTokenizer

    hf = dict(DEEPSEEK_V2_LITE_HF, num_hidden_layers=2,
              architectures=["DeepseekV2ForCausalLM"], torch_dtype="bfloat16")
    shapes = deepseek_hf_shapes(hf)
    res: dict = {"card": card, "layers": 2}
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_deepseek_load_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(19)
        total, files, names = 0, [], sorted(shapes)
        per_file = 80
        for j in range(0, len(names), per_file):
            tensors = {}
            for name in names[j:j + per_file]:
                w = torch.randn(shapes[name], generator=gen, device=dev)
                w = (w * 0.02 + 1.0) if len(shapes[name]) == 1 else w * 0.02
                tensors[name] = w.to(torch.bfloat16).cpu()
                total += tensors[name].numel() * 2
            file = f"model-{len(files) + 1:05d}.safetensors"
            save_safetensors(tensors, f"{root}/{file}",
                             metadata={"format": "pt"})
            files.append((file, list(tensors)))
            del tensors
        with open(f"{root}/model.safetensors.index.json", "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": {n: fl for fl, ns in files
                                      for n in ns}}, f)
        with open(f"{root}/config.json", "w") as f:
            json.dump(hf, f)
        res.update(checkpoint_bytes=total, write_s=time.perf_counter() - t0)
        print(f"deepseek load: wrote {total / 1e9:.2f} GB (2 layers) in "
              f"{res['write_s']:.1f} s", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.from_pretrained(
            root, load_in_low_bit="sym_int4", device=dev)
        torch.cuda.synchronize()
        res.update(load_s=time.perf_counter() - t0,
                   weight_bytes=param_bytes(model.params)[0])
        # MLA's kv_b and an expert's planes against the CPU codec
        reader = CheckpointReader(root)
        e = hf["n_routed_experts"] - 1
        x = f"model.layers.1.mlp.experts.{e}."
        for key, names_, at in (
                ("kv_b", ["model.layers.1.self_attn.kv_b_proj.weight"],
                 lambda t: t[0].cpu()),
                ("moe_gate_up", [x + "gate_proj.weight",
                                 x + "up_proj.weight"],
                 lambda t: t[0, e].cpu())):
            want = quantize_weight(torch.cat([reader.get(n)
                                              for n in names_]), "sym_int4")
            got = model.params["layers"][key].planes(at)
            if not (torch.equal(got.data, want.data)
                    and torch.equal(got.scales, want.scales)):
                fail(f"deepseek load: {key} planes differ from the CPU "
                     "codec's")
        if set(model.params) < {"layers", "layers_dense"}:
            fail(f"deepseek load: stacks {sorted(model.params)}")
        res["planes_equal"] = True
        del model
        torch.cuda.empty_cache()
        for mod in kernels.values():
            mod.COUNTS.reset()
        srv = build_server(root, tokenizer=IdTokenizer(hf["vocab_size"]),
                           engine_config=EngineConfig(**SERVE_EC),
                           device=dev)
        try:
            out = asyncio.run(srv.call("POST", "/v1/completions", {
                "prompt": " ".join(str(3 + i) for i in range(200)),
                "max_tokens": 16}))
        finally:
            srv.engine.stop()
        if out.status != 200 or out.body["usage"]["completion_tokens"] != 16:
            fail(f"deepseek load: build_server answered {out.status} "
                 f"{str(out.body)[:200]}")
        launches = {n: m.COUNTS.launches for n, m in kernels.items()}
        plain = {n: m.COUNTS.plain_calls for n, m in kernels.items()}
        if any(plain.values()) or not (
                launches["qmatmul_experts"]
                and launches["ragged_paged_attention"]):
            fail(f"deepseek load server: launches {launches}, plain {plain}")
        res["server"] = dict(status=out.status, launches=launches)
        print("deepseek load " + json.dumps(res), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_deepseek_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_deepseek_smoke: steps are {STEPS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_deepseek_smoke: FAILED: {msg}", file=sys.stderr,
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
    res = deepseek_phase(kernels, card, fail, torch.device("cuda", 0),
                         graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
