#!/usr/bin/env python3
"""Training on one card: the two backward kernels against their plain
versions, a small QLoRA step card against CPU, Llama-2-7B sym_int4 QLoRA
at full width and depth, and full-parameter and LISA steps.

``chip_smoke.py`` runs this as its ``train`` phase; alone, from the root
of a checkout on a machine with one CUDA card:

    python3 scripts/torch_train_smoke.py [kernels] [small] [qlora] [full]

(no step named: all four).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: B4's LSE instance (out and lse against the plain
   versions); B4's backward against its plain version (autograd of the
   forward's plain version in float64), causal, T = 1, 63, 1024 and 2048,
   G = 1 and 4, ``kv_start`` > 0 on one row of two: dQ held per query row
   and dK, dV per key row within ``BWD_TOL_REL`` of the row's largest
   value, and a second call bitwise the first; at the QLoRA step's shape
   (B=2, T=1024, 32 heads of 128) timed as device time from CUDA-graph
   replays beside its bound (10 D operations per visible pair over 989
   TFLOP/s, or its bytes over 3.35 TB/s) and PyTorch's flash attention
   backward on the same inputs, also from graph replays; B2^T,
   ``dy @ dequant(W)^T``, in all ten formats at Llama-2-7B's five weight shapes, M = 2048 (the step's B x
   T), each dx row within one bf16 ulp of its largest plain value
   (``B2_TOL_REL``), timed beside its bound and ``torch.matmul(dy,
   W_bf16.T)``;
2. ``small``: a 2-layer decoder at Llama-2-7B width, sym_int4, r = 8:
   one QLoRA loss and its adapter gradients on the card against the CPU's
   plain path on the same weights, adapters and tokens;
3. ``qlora``: Llama-2-7B sym_int4 at full width and depth (random weights
   from a seed), r = 8, alpha = 16, the four target slots, Adam, B = 2, T
   = 1024, one batch repeated for ``QLORA_STEPS`` steps: the loss finite
   at every step and lower at the last than at the first, the base
   planes bitwise unchanged, launches per step of B2, B2^T, B4 and B4's
   backward with no plain call; step time, tokens/s and peak memory; one
   step under ``torch.profiler`` (device time by kernel, idle share, the
   new kernels' events held against their counters, B4's backward's
   events over the step's layers its launches a call); then
   ``merge_and_unload`` and one greedy ``generate()`` of the merged model;
4. ``full``: full-parameter training at full width and 2 layers, bf16
   weights and Adam: one step with a finite loss that moves every layer,
   then a LISA step with one of the two layers active that moves only it.

Printed beside the card's name and power limit; ``train_phase`` returns
the report (``chip_smoke.py`` puts its kernel rows in the ``kernels``
line).
"""

from __future__ import annotations

import functools
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "qlora", "full")
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12    # H100 SXM dense bf16
B2_TOL_REL = 2.0 ** -7       # chip_smoke.py's B2 bound: one bf16 ulp
# B4's backward rounds P and dS to bf16 as operands (2^-9 of each term,
# errors of random sign), reads the forward's bf16-rounded output in
# Delta, and rounds each gradient once: each row within 2^-6 of its
# largest plain value (the forward's bound is 2^-7; the backward has two
# more rounded operands in its products)
BWD_TOL_REL = 2.0 ** -6
# a row whose exact gradient cancels to 0 (a query that sees one key:
# P = 1, dP - Delta = 0, so dQ and dK are 0; at T = 1 every row) keeps
# the fp32 residue of that cancellation, so each row's bound is taken
# against at least 2^-10 of the largest value of the three gradients
BWD_FLOOR = 2.0 ** -10
# card against CPU through two layers of bf16 activations: the decoder
# checks' 2.5% of the logit range; the loss within 1%, each adapter
# gradient within 5% of its norm
LOSS_TOL_REL = 1e-2
GRAD_TOL_REL = 5e-2
QLORA_STEPS = 6
QLORA_LR = 2e-4
BATCH, SEQ = 2, 1024
# the training path's kernels: B2, B2^T, B4 (its LSE instance) and B4's
# backward, each launched in every step
TRAIN_KERNELS = ("qmatmul", "qmatmul_dx", "flash_attention",
                 "flash_attention_bwd")
# each new kernel's ``__global__`` functions, by the substring of its name
# that the profiler's kernel events carry
KERNEL_EVENTS = {"flash_attention_bwd": ("flash_bwd_dq_kernel",
                                         "flash_bwd_dkdv_kernel"),
                 "qmatmul_dx": ("qmm_dx_kernel",)}
LLAMA2_7B_SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096),
                    "gate_up": (4096, 22016), "down": (11008, 4096),
                    "lm_head": (4096, 32000)}


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_events(prof, names) -> int:
    """Device kernel events in ``prof`` whose name holds one of
    ``names``."""
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type.name == "CUDA"
               and any(n in ev.key for n in names))


def kernel_modules():
    """The training path's wrapper modules, by ``NAME``."""
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import flash_attention_bwd as b4b
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t
    return {m.NAME: m for m in (b2, b2t, b4, b4b)}


def train_phase(kernels: dict, card: str, fail, dev, graph_ms,
                steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` times calls from CUDA-graph replays."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import flash_attention_bwd as b4b
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t
    from ipex_llm_tpu_torch.quantize.core import dequantize_padded, quantize

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)
    report: dict = {"card": card}

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

    def rows_close(got, want, dims, tol, what, floor=0.0) -> float:
        """Each row (over ``dims``) within ``tol`` of its largest |want|,
        or of ``floor`` where that is larger (with no floor a row whose
        plain value is all 0 must be 0).  Returns the worst ratio of a
        row's error to its bound's scale."""
        g, w = got.float(), want.float()
        if not torch.isfinite(g).all():
            fail(f"{what}: not finite")
        err = (g - w).abs().amax(dim=dims)
        top = w.abs().amax(dim=dims)
        top = top.clamp_min(floor)
        bad = err > tol * top
        if bool(bad.any()):
            i = int(bad.flatten().nonzero()[0])
            fail(f"{what}: row {i} max abs err {err.flatten()[i].item()} > "
                 f"{tol} * {top.flatten()[i].item()}")
        return float((err / top.clamp_min(1e-30)).max())

    # -- 1. the kernels ------------------------------------------------------
    def b4_inputs(b, t, hq, hkv, kv_start):
        q, k, v, do = (torch.randn(b, t, h, 128, generator=gen, device=dev)
                       .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
        ks = torch.tensor(kv_start, dtype=torch.int32, device=dev)
        kl = torch.full((b,), t, dtype=torch.int32, device=dev)
        qp = torch.arange(t, device=dev)[None].expand(b, t)
        return q, k, v, do, dict(scale=128 ** -0.5, causal=True,
                                 q_positions=qp, kv_len=kl, kv_start=ks)

    def b4_bwd_case(b, t, hq, hkv, kv_start, timed=False):
        q, k, v, do, kw = b4_inputs(b, t, hq, hkv, kv_start)
        out, lse = b4.flash_sdpa_lse(q, k, v, **kw)
        lse_ref = b4.lse_plain(q, k, **{**kw, "q_positions":
                                        kw["q_positions"].long()})
        out_ref = b4.flash_sdpa_plain(
            q, k, v, scale=kw["scale"], causal=True,
            q_positions=kw["q_positions"].long(), kv_len=kw["kv_len"],
            kv_start=kw["kv_start"], won=torch.zeros_like(kw["kv_len"]),
            window=None, softcap=None)
        lse_err = float(torch.where(torch.isinf(lse_ref), 0.0,
                                    (lse - lse_ref).abs()).max())
        if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)) \
                or lse_err > 1e-3:
            fail(f"B4 lse T={t}: max err {lse_err}")
        rows_close(out, out_ref, (2, 3), 2.0 ** -7, f"B4 LSE out T={t}")
        grads = b4b.flash_sdpa_bwd(q, k, v, do, lse, **kw)
        again = b4b.flash_sdpa_bwd(q, k, v, do, lse, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"B4 backward T={t}: a second call differs")
        ref = b4b.flash_sdpa_bwd_plain(q, k, v, do, **kw)
        floor = BWD_FLOOR * max(float(r.abs().max()) for r in ref)
        worst = {name: rows_close(g, r, (2, 3), BWD_TOL_REL,
                                  f"B4 backward {name} T={t} G={hq // hkv}",
                                  floor)
                 for name, g, r in zip(("dq", "dk", "dv"), grads, ref)}
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(grads, ref))
        row = dict(case=f"B={b} T={t} Hq={hq} Hkv={hkv} kv_start="
                        f"{list(kv_start)}", max_abs_err=err,
                   worst_row_ratio=worst, lse_max_err=lse_err)
        del ref
        if timed:
            row["ms"] = graph_ms(torch, [lambda: b4b.flash_sdpa_bwd(
                q, k, v, do, lse, **kw)] * 5)
            row["fwd_lse_ms"] = graph_ms(torch, [lambda: b4.flash_sdpa_lse(
                q, k, v, **kw)] * 5)
            row["plain_ms"] = time_ms(lambda: b4b.flash_sdpa_bwd_plain(
                q, k, v, do, **kw), 1)
            row["library_ms"], row["library_call"] = library_bwd_ms(
                q, k, v, do, kw["scale"])
            lo = kw["kv_start"].long()[:, None]
            pairs = int((torch.arange(t, device=dev)[None] + 1 - lo)
                        .clamp(min=0).sum()) * hq
            nbytes = 2 * (4 * b * t * hq * 128 + 4 * b * t * hkv * 128) \
                + 4 * b * hq * t
            row["pairs"] = pairs
            row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                     10 * 128 * pairs)
        print("B4 backward " + json.dumps(row), flush=True)
        return row

    def library_bwd_ms(q, k, v, do, scale):
        """PyTorch's flash attention backward on the same inputs (head
        major, as it takes them), given its own forward's output and
        log-sum-exp, timed as the kernel is, from CUDA-graph replays."""
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False, scale=scale)
        o, lse_l, cq, ck, mq, mk, seed, off = fwd[:8]
        bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        return graph_ms(torch, [lambda: bwd(
            dot, qt, kt, vt, o, lse_l, cq, ck, mq, mk, 0.0, True, seed, off,
            scale=scale)] * 5), \
            "aten._scaled_dot_product_flash_attention_backward, " \
            "CUDA-graph replays"

    def b2t_case(qtype, name, m, timed):
        k, n = LLAMA2_7B_SHAPES[name]
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        qt = quantize(w, qtype)
        dy = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        dx = b2t.qmatmul_dx(dy, qt)
        again = b2t.qmatmul_dx(dy, qt)
        ref = b2t.qmatmul_dx_plain(dy, qt)
        torch.cuda.synchronize()
        if not torch.equal(dx, again):
            fail(f"B2^T {qtype} {name}: a second call differs")
        worst = rows_close(dx, ref, (1,), B2_TOL_REL, f"B2^T {qtype} {name}")
        row = dict(qtype=qtype, weight=name, m=m, k=k, n=n,
                   max_abs_err=float((dx.float() - ref.float()).abs().max()),
                   worst_row_ratio=worst)
        if timed:
            wb = dequantize_padded(qt).to(torch.bfloat16)
            row["ms"] = graph_ms(torch, [lambda: b2t.qmatmul_dx(dy, qt)] * 3)
            row["plain_ms"] = time_ms(lambda: b2t.qmatmul_dx_plain(dy, qt),
                                      1)
            row["library_ms"] = graph_ms(torch, [
                lambda: torch.matmul(dy, wb.t())] * 3)
            nbytes = qt.nbytes + 2 * m * n + 2 * m * k
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2 * m * n * k)
        print("B2^T " + json.dumps(row), flush=True)
        return row

    if "kernels" in steps:
        b4_rows = [b4_bwd_case(2, 1024, 32, 32, (0, 0), timed=True)]
        for t in (1, 63, 1024, 2048):
            for hq, hkv in ((32, 32), (32, 8)):
                b4_rows.append(b4_bwd_case(2, t, hq, hkv,
                                           (0, min(t - 1, 37))))
        report["b4_bwd"] = b4_rows
        b2t_rows = []
        for qtype in b2.FORMATS:
            for name in LLAMA2_7B_SHAPES:
                b2t_rows.append(b2t_case(
                    qtype, name, BATCH * SEQ,
                    timed=qtype == "sym_int4" or name == "gate_up"))
        report["b2t"] = b2t_rows
        torch.cuda.empty_cache()

    # -- the models -----------------------------------------------------------
    from ipex_llm_tpu_torch.models.random_init import (llama2_7b_config,
                                                       random_params)
    from ipex_llm_tpu_torch.training import (LoraConfig, attach_lora,
                                             causal_lm_loss, get_peft_model,
                                             init_lora, init_optimizer,
                                             make_lisa_train_step,
                                             make_train_step)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    def reset():
        for mod in kernels.values():
            mod.COUNTS.reset()

    def counts() -> dict:
        return {name: dict(launches=mod.COUNTS.launches,
                           plain=mod.COUNTS.plain_calls)
                for name, mod in kernels.items()}

    def to_dev(tree, device):
        if isinstance(tree, dict):
            return {k: to_dev(v, device) for k, v in tree.items()}
        return tree.to(device) if hasattr(tree, "to") else tree

    def tokens_for(cfg, b, t, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randint(3, cfg.vocab_size, (b, t), generator=g)

    if "small" in steps:
        cfg = llama2_7b_config(num_layers=2)
        lc = LoraConfig(r=8, lora_alpha=16)
        params = random_params(cfg, "sym_int4", seed=3, device=dev)
        tok = tokens_for(cfg, 1, 128, 4)
        res = {}
        for where in ("card", "cpu"):
            p = params if where == "card" else to_dev(params, "cpu")
            d = dev if where == "card" else torch.device("cpu")
            ad = init_lora(torch.Generator(device="cpu").manual_seed(5),
                           cfg, to_dev(p, "cpu"), lc)
            for ab in ad.values():     # a live B, so A gets a gradient
                ab["b"] += 0.01 * torch.randn(
                    ab["b"].shape, generator=torch.Generator().manual_seed(6))
            ad = to_dev(ad, d)
            for ab in ad.values():
                for t in ab.values():
                    t.requires_grad_(True)
            reset()
            loss = causal_lm_loss(cfg, attach_lora(p, ad, lc), tok.to(d))
            loss.backward()
            res[where] = (loss.item(), {s: {k: t.grad.float().cpu()
                                            for k, t in ab.items()}
                                        for s, ab in ad.items()}, counts())
        (lc_card, g_card, n_card), (lc_cpu, g_cpu, _) = res["card"], \
            res["cpu"]
        if abs(lc_card - lc_cpu) > LOSS_TOL_REL * abs(lc_cpu):
            fail(f"small QLoRA: loss {lc_card} on the card, {lc_cpu} on "
                 "the CPU")
        grad_err = {}
        for s in g_cpu:
            for k in ("a", "b"):
                e = float((g_card[s][k] - g_cpu[s][k]).norm()
                          / g_cpu[s][k].norm().clamp_min(1e-30))
                grad_err[f"{s}.{k}"] = e
                if e > GRAD_TOL_REL:
                    fail(f"small QLoRA: {s}.{k} gradient {e} of its norm "
                         "from the CPU's")
        if any(c["plain"] for c in n_card.values()) or any(
                n_card[k]["launches"] == 0 for k in TRAIN_KERNELS):
            fail(f"small QLoRA: launches {n_card}")
        report["small"] = dict(loss_card=lc_card, loss_cpu=lc_cpu,
                               grad_rel_err=grad_err, launches=n_card)
        print("small QLoRA " + json.dumps(report["small"]), flush=True)
        del params, res
        torch.cuda.empty_cache()

    if "qlora" in steps:
        cfg = llama2_7b_config()
        t0 = time.perf_counter()
        params = random_params(cfg, "sym_int4", seed=7, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        # no eos: generate() runs its full length
        model = TPUModelForCausalLM(cfg, params, {"model_type": "llama"},
                                    "sym_int4")
        watch = {(s, i): params["layers"][s].data[i].clone()
                 for s in ("qkv", "o", "gate_up", "down")
                 for i in (0, cfg.num_layers - 1)}
        peft = get_peft_model(model, LoraConfig(r=8, lora_alpha=16), seed=1)
        peft.compile(functools.partial(torch.optim.Adam, lr=QLORA_LR))
        tok = tokens_for(cfg, BATCH, SEQ, 8).to(dev)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, per_step = [], [], []
        for _ in range(QLORA_STEPS):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(peft.train_step(tok))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append(counts())
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"QLoRA: losses {losses}, step seconds {step_s}")
        for (s, i), before in watch.items():
            if not torch.equal(params["layers"][s].data[i], before):
                fail(f"QLoRA: the base planes of {s} layer {i} moved")
        last = per_step[-1]
        for name in TRAIN_KERNELS:
            if last[name]["launches"] == 0 or any(
                    c[name]["plain"] for c in per_step):
                fail(f"QLoRA: {name} per step {last[name]}")
        # one step under the profiler: device time by kernel, idle share
        from torch.profiler import ProfilerActivity, profile

        reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            peft.train_step(tok)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        profiled = counts()
        # the new kernels' launches a step as the profiler saw them, held
        # against the counters of the same step
        events = {name: kernel_events(prof, ev)
                  for name, ev in KERNEL_EVENTS.items()}
        for name, n in events.items():
            if n != profiled[name]["launches"]:
                fail(f"QLoRA: {n} {name} kernel events in the profiled "
                     f"step, the counter says {profiled[name]['launches']}")
        # one attention backward a layer
        bwd_per_call = events["flash_attention_bwd"] / cfg.num_layers
        by_kernel = {}
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None)
            if dt is None:
                dt = getattr(ev, "cuda_time_total", 0)
            if dt and ev.device_type.name == "CUDA":
                by_kernel[ev.key] = dt / 1e3
        busy_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        steady = step_s[1:]
        res = dict(model="Llama-2-7B", qtype="sym_int4", r=8, alpha=16,
                   batch=BATCH, seq=SEQ, lr=QLORA_LR, losses=losses,
                   step_s=step_s, step_s_median=float(np.median(steady)),
                   tokens_per_s=BATCH * SEQ / float(np.median(steady)),
                   peak_gb=peak / 1e9, build_s=build_s,
                   launches_per_step={k: v["launches"]
                                      for k, v in last.items()},
                   plain_calls=sum(c[k]["plain"] for c in per_step
                                   for k in c),
                   kernel_events_per_step=events,
                   bwd_launches_per_call=bwd_per_call,
                   profile=dict(wall_ms=prof_wall * 1e3,
                                device_busy_ms=busy_ms,
                                idle_share=max(0.0, 1 - busy_ms
                                               / (prof_wall * 1e3)),
                                top_kernels_ms=top))
        # merge the adapters in, then generate with the merged model
        t0 = time.perf_counter()
        merged = peft.merge_and_unload()
        torch.cuda.synchronize()
        res["merge_s"] = time.perf_counter() - t0
        reset()
        prompt = tokens_for(cfg, 1, 64, 9).numpy()
        out = np.asarray(merged.generate(prompt, max_new_tokens=8))
        gen_counts = counts()
        if out.shape != (1, 72) or gen_counts["flash_attention_bwd"][
                "launches"] or gen_counts["qmatmul_dx"]["launches"]:
            fail(f"merged generate: {out.shape}, launches {gen_counts}")
        res["generate"] = dict(tokens=out[0, 64:].tolist(),
                               launches={k: v["launches"]
                                         for k, v in gen_counts.items()})
        report["qlora"] = res
        print("QLoRA " + json.dumps(res), flush=True)
        del params, model, peft, merged, watch
        torch.cuda.empty_cache()

    if "full" in steps:
        cfg = llama2_7b_config(num_layers=2)
        params = random_params(cfg, "bf16", seed=11, device=dev)
        tok = tokens_for(cfg, 1, 512, 12).to(dev)
        out = {}

        def layer_moved(before):
            return [not torch.equal(params["layers"]["qkv"].data[i],
                                    before[i]) for i in range(2)]
        before = params["layers"]["qkv"].data.detach().clone()
        opt = init_optimizer(functools.partial(torch.optim.Adam, lr=1e-4),
                             params)
        reset()
        _, _, loss = make_train_step(cfg, None)(params, opt, tok)
        out["full"] = dict(loss=float(loss), moved=layer_moved(before),
                           launches={k: v["launches"]
                                     for k, v in counts().items()})
        if not math.isfinite(float(loss)) or not all(out["full"]["moved"]):
            fail(f"full-parameter step: {out['full']}")
        before = params["layers"]["qkv"].data.detach().clone()
        opt = init_optimizer(functools.partial(torch.optim.Adam, lr=1e-4),
                             params)
        mask = torch.tensor([True, False])
        _, _, loss = make_lisa_train_step(cfg, None)(params, opt, tok, mask)
        out["lisa"] = dict(loss=float(loss), moved=layer_moved(before))
        if not math.isfinite(float(loss)) or out["lisa"]["moved"] != [
                True, False]:
            fail(f"LISA step: {out['lisa']}")
        report["full"] = out
        print("full/LISA " + json.dumps(out), flush=True)
        del params, opt
        torch.cuda.empty_cache()

    report["phase_s"] = time.perf_counter() - t_phase
    return report


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_train_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_train_smoke: steps are {STEPS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_train_smoke: FAILED: {msg}", file=sys.stderr,
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
    for name in ("flash_attention_bwd", "qmatmul_dx"):
        log = _build.BUILD_DIR / f"{name}.log"
        print(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    res = train_phase(kernels, card, fail, torch.device("cuda", 0), graph_ms,
                      steps)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_smoke.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items()
                      if k in ("small", "full", "phase_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
