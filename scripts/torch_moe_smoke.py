#!/usr/bin/env python3
"""Mixture-of-experts serving on one card: the expert-grouped
dequant-matmul B2e against its plain version, small MoE and qwen3
decoders against the CPU, Mixtral-8x7B and Qwen3-30B-A3B at full width
(``SERVE_LAYERS`` layers) through ``ServingEngine`` (and ``generate()``
for Mixtral), and
``from_pretrained`` of a Mixtral-width checkpoint.

``chip_smoke.py`` runs this as its ``moe`` phase; alone, from the root of
a checkout on a machine with one CUDA card:

    python3 scripts/torch_moe_smoke.py [b2e] [small] [mixtral] [qwen3] [load]

(no step named: all five).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``b2e``: each instance of B2e against its plain version on the card,
   every output row within ``B2_TOL_REL`` of its largest value, and a
   second call bitwise the first: every format at K = 200 (padded to each
   format's block) and N = 384 and 200 (16- and 4-byte copies), over 6
   experts, both output dtypes, at the splits of ``B2E_CASES`` (the gemv
   instance under a bound of 8 rows with empty experts, 1-row segments, a
   9-row segment and one expert holding every row; the wgmma instance with
   ragged segment tails and one expert holding every row; the tiled
   instance's 16- and 64-row tiles); sym_int4 at Mixtral-8x7B's expert
   shapes (gate_up 4096 -> 28672, down 14336 -> 4096) and Qwen3-30B-A3B's
   (2048 -> 1536, 768 -> 2048) at the forwards of ``B2E_TICKS`` (a decode
   tick, a verify forward, a mixed tick's prefill at the engine's default
   budget and at ``WIDE_BUDGET``), routed by top-k of random logits drawn
   from their own seed (as ``scripts/torch_experts_ab.py`` draws them),
   with the token count as the bound (the engine's): the instance that
   picks checked as above, then timed from CUDA-graph replays, beside its
   bound (the touched experts' planes, x and the output over 3.35 TB/s,
   or 2 P K N over 989 TFLOP/s), the plain version's time, one PyTorch
   call on the bf16 expert weights (``torch._grouped_mm`` over the same
   segments, else ``torch.bmm`` over the pairs' gathered weights at decode
   sizes) and, where the bound picks the gemv instance, the tiled
   instance on the same inputs (no bound), checked and timed likewise;
2. ``small``: Mixtral-, Qwen1.5-MoE- (60 experts, top 4, a shared expert
   and its gate, a qkv bias), Qwen3-MoE- (128 experts, top 8, q/k norms)
   and Qwen3-shaped decoders (2 layers, hidden 512, vocab 512) on the card
   against the same models on the CPU's plain versions, paged (prefill
   chunks of 40, 17 and 29 ids: the ragged route; three decode steps: the
   gather route) and dense (a left-padded prefill, four decode steps):
   the card's logits within 2.5% of the CPU's range, the card following
   the CPU's expert selections (a flip at a near-tie would send a token to
   other experts, and its row's later logits with it), and the card's own
   selections, as sets, equal to the CPU's at every real token (not a
   chunk's or a left-padded prompt's pads) where the CPU's k-th router
   logit leads the (k+1)-th by more than ``MARGIN`` of the token's logit
   span: at least 40% of the real tokens (the router weights are drawn
   wide); flips at near-ties are counted;
3. ``mixtral``: Mixtral-8x7B at its published widths, cut to
   ``SERVE_LAYERS`` of its 32 layers (random sym_int4 weights drawn on the
   card from a seed), through
   ``ServingEngine`` with ``SERVE_EC`` (the engine's default prefill
   budget: mixed ticks of up to 128 prompt tokens) over a bf16 pool:
   eight requests of 64-1000 ids, 32-64 new tokens, half greedy; the same
   eight with mixed ticks of up to ``WIDE_BUDGET`` prompt tokens; then
   two over an e5m2 pool: every request finishes with its tokens, B1, B2
   and B2e launch (B2e in both of its output types: the gather route at
   decode, the ragged route at prefill; its gemv instance at decode in
   both bf16 runs, its tiled instance at prefill at the default budget,
   its wgmma instance at prefill at the wide one), no plain version
   runs; one decode tick under
   ``torch.profiler`` gives B2e's share of the tick's device time and the
   device's idle share, with no host sync inside ``moe_ffn`` (torch's
   sync debug mode raises there, and the profile counts none); then
   ``generate()`` on four prompts of 1990, 1327, 611 and 203 ids, 32 new
   tokens: B2, B3, B4 and B2e (both its gemv and wgmma instances)
   launch;
4. ``qwen3``: Qwen3-30B-A3B likewise (serving and its profile): the ragged
   route even at decode (64 pairs), B1 at a GQA group of 8;
5. ``load``: a 2-layer Mixtral-width checkpoint of bf16 weights written
   with the port's numpy safetensors writer (about 6 GB, in a temporary
   directory removed at the end), ``from_pretrained(load_in_low_bit=
   "sym_int4")`` onto the card (seconds and peak device memory), one
   expert's planes bitwise the CPU codec's, one completion through
   ``build_server``.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the launches of each kernel.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("b2e", "small", "mixtral", "qwen3", "load")
# the engine's default prefill budget: a mixed tick prefills up to
# prefill_bucket = 128 prompt tokens
SERVE_EC = dict(max_rows=8, max_seq_len=2048, page_size=128,
                prefill_bucket=128, decode_horizon=4)
# a wider budget served beside it: a mixed tick prefills up to 8 x 128
# prompt tokens (a chunk of 128 for each of eight rows), the prefill
# forward B2e's wgmma instance is for
WIDE_BUDGET = 1024
# the layers each full-width model keeps (of Mixtral-8x7B's 32 and
# Qwen3-30B-A3B's 48): the depth is cut so that chip_smoke.py keeps within
# its time; every layer runs the same kernels
SERVE_LAYERS = 8
# the forwards B2e is timed at, by their token counts: a decode tick of 8
# rows, a verify forward of 8 rows x 4, a mixed tick's prefill at the
# default budget and at WIDE_BUDGET
B2E_TICKS = (("decode", 8), ("verify", 32), ("chunk", 128),
             ("prefill", WIDE_BUDGET))
GENERATE_LENGTHS = (1990, 1327, 611, 203)
B2_TOL_REL = 2.0 ** -7       # chip_smoke.py's B2 bound: one bf16 ulp
PEAK_BYTES_S = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOP_S = 989e12    # H100 SXM dense bf16
# a router-logit lead, as a share of the token's logit span, past the
# card-vs-CPU rounding of the logits (at most 0.2% of the span in the
# small decoders' first layer, 0.5% in the second): a selection must
# agree there
MARGIN = 0.01
# host-side events that wait for the card or read a device value
SYNC_EVENTS = ("aten::item", "aten::_local_scalar_dense",
               "cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cudaMemcpy")
LOAD_LAYERS = 2
# B2e's checks: (the instance that must launch, rows of each of 6 experts,
# the bound on an expert's rows handed to the wrapper); the gemv bound of
# 8 holds for none of the first two splits, and the kernel must be right
# all the same
B2E_CASES = (("gemv", (0, 1, 7, 8, 9, 0), 8), ("gemv", (0, 0, 24, 0, 0, 0), 8),
             ("gemv", (1, 1, 1, 1, 1, 1), 8),
             ("wgmma", (0, 1, 130, 9, 300, 200), None),
             ("wgmma", (0, 0, 640, 0, 0, 0), None),
             ("tiled16", (4, 0, 9, 3, 0, 20), None),
             ("tiled64", (0, 1, 7, 8, 9, 130), None))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixtral_hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """HF names and shapes of a Mixtral checkpoint."""
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = h // hf["num_attention_heads"]
    q, kv = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, h)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "post_attention_layernorm.weight": (h,),
            p + "block_sparse_moe.gate.weight": (hf["num_local_experts"],
                                                 h)})
        for e in range(hf["num_local_experts"]):
            x = p + f"block_sparse_moe.experts.{e}."
            shapes.update({x + "w1.weight": (f, h), x + "w3.weight": (f, h),
                           x + "w2.weight": (h, f)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (v, h)})
    return shapes


def moe_phase(kernels: dict, card: str, fail, device, graph_ms,
              steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` times calls from CUDA-graph replays."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import ipex_llm_tpu_torch.models.decoder as decoder_mod
    import ipex_llm_tpu_torch.ops.moe as moe_mod
    from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
    from ipex_llm_tpu_torch.models.random_init import (
        MIXTRAL_8X7B_HF, mixtral_8x7b_config, qwen3_8b_config,
        qwen3_30b_a3b_config, qwen15_moe_a27b_config, random_params)
    from ipex_llm_tpu_torch.ops.cuda.qmatmul import data_row_factor
    from ipex_llm_tpu_torch.quantize.core import (QTensor,
                                                  dequantize_padded,
                                                  quantize)
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    b2e = kernels["qmatmul_experts"]
    dev = device
    res: dict = {"card": card}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)

    def reset():
        for mod in kernels.values():
            mod.COUNTS.reset()

    def gate(what, need, absent=(), b2e_need=()):
        """Every kernel of ``need`` launched, none of ``absent``, each B2e
        instance of ``b2e_need`` (``gemv``, ``wgmma``, ``tiled``: either
        row tile) at least once, no
        plain version run; returns the launches by kernel."""
        out = {}
        for name, mod in kernels.items():
            n, plain = mod.COUNTS.launches, mod.COUNTS.plain_calls
            if plain or (mod in need and n == 0) or (mod in absent and n):
                fail(f"moe {what}: {name} launched {n} times, plain "
                     f"version called {plain} times")
            out[name] = n
        for inst in b2e_need:
            if not sum(v for k, v in b2e.COUNTS.by_instance.items()
                       if k.split("/")[0].rstrip("0123456789") == inst):
                fail(f"moe {what}: B2e's {inst} instance never launched "
                     f"({b2e.COUNTS.by_instance})")
        return out

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

    # -- 1. B2e against its plain version -----------------------------------
    def stack(n_e, k, n, qtype):
        """n_e experts' [k, n] weights quantized on the card, stacked."""
        qts = [quantize(torch.randn(k, n, generator=gen, device=dev)
                        * (1.2 / math.sqrt(k)), qtype) for _ in range(n_e)]

        def st(key):
            planes = [getattr(q, key) for q in qts]
            return None if planes[0] is None else torch.stack(planes)
        return QTensor(st("data"), st("scales"), st("zeros"), qtype,
                       (k, n), qts[0].block_size)

    def padded_x(p, k, qt):
        num, den = data_row_factor(qt.qtype)
        x = torch.randn(p, k, generator=gen, device=dev).to(torch.bfloat16)
        return torch.nn.functional.pad(
            x, (0, qt.data.shape[-2] * num // den - k)).contiguous()

    def seg_of(counts):
        seg = torch.zeros(len(counts) + 1, dtype=torch.int32)
        seg[1:] = torch.cumsum(torch.tensor(counts), 0)
        return seg.to(dev)

    def check(x, seg, qt, keep_f32, what, instance, max_rows):
        """One call launches ``instance`` once; the output holds against
        the plain version, and a second call gives the same bits."""
        key = f"{instance}/{'f32' if keep_f32 else 'bf16'}"
        before = b2e.COUNTS.launches, b2e.COUNTS.by_instance[key]
        y = b2e.qmatmul_experts(x, seg, qt, keep_f32=keep_f32,
                                max_rows=max_rows)
        if (b2e.COUNTS.launches, b2e.COUNTS.by_instance[key]) != (
                before[0] + 1, before[1] + 1):
            fail(f"B2e {what}: one call did not launch {key} once")
        again = b2e.qmatmul_experts(x, seg, qt, keep_f32=keep_f32,
                                    max_rows=max_rows)
        ref = b2e.qmatmul_experts_plain(x, seg, qt, keep_f32=keep_f32)
        torch.cuda.synchronize()
        if not torch.equal(y, again):
            fail(f"B2e {what}: a second call gave other bits")
        want = torch.float32 if keep_f32 else torch.bfloat16
        if y.dtype != want or y.shape != ref.shape:
            fail(f"B2e {what}: {y.dtype} {tuple(y.shape)}")
        err = (y.float() - ref.float()).abs().amax(dim=1)
        top = ref.float().abs().amax(dim=1)
        bad = err > B2_TOL_REL * top
        if bool(bad.any()) or not bool(torch.isfinite(y).all()):
            i = int(bad.nonzero()[0]) if bool(bad.any()) else -1
            fail(f"B2e {what}: row {i} max abs err {err[i].item()} > "
                 f"{B2_TOL_REL} * {top[i].item()} (or not finite)")
        return err.max().item(), (err / top.clamp_min(1e-30)).max().item()

    def library_call(x, seg, qt, counts, keep_f32):
        """One PyTorch call on the bf16 expert weights computing the same
        grouped product, and its name; (None, reason) where none runs."""
        w = torch.stack([dequantize_padded(qt.planes(lambda t, e=e: t[e]))
                         .to(torch.bfloat16) for e in range(len(counts))])
        offs = seg[1:].contiguous()
        gmm = getattr(torch, "_grouped_mm", None)
        why = "torch._grouped_mm missing"
        if gmm is not None:
            # mat_b column-major in its last two dims, as the op wants;
            # where it refuses an fp32 output, its bf16 one
            wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
            for out_dtype in dict.fromkeys(
                    (torch.float32 if keep_f32 else torch.bfloat16,
                     torch.bfloat16)):
                try:
                    gmm(x, wt, offs=offs, out_dtype=out_dtype)
                    torch.cuda.synchronize()
                    return (lambda d=out_dtype: gmm(
                        x, wt, offs=offs, out_dtype=d)), \
                        f"torch._grouped_mm ({str(out_dtype)[6:]} out)"
                except (RuntimeError, TypeError) as exc:
                    why = f"torch._grouped_mm refused: {exc}"[:200]
        if x.shape[0] <= 64:
            ids = torch.repeat_interleave(
                torch.arange(len(counts), device=dev),
                torch.tensor(counts, device=dev))
            wg = w[ids]                             # [P, K, N]
            return (lambda: torch.bmm(x[:, None], wg)[:, 0]), "torch.bmm"
        return None, why

    def routed_counts(tokens, n_e, k):
        """Rows per expert of ``tokens`` routed by top-k of random logits
        from their own seed, as ``scripts/torch_experts_ab.py`` routes
        them: the same experts are touched there and here, whatever ran
        before."""
        rng = np.random.default_rng(tokens + n_e)
        idx = np.argsort(-rng.standard_normal((tokens, n_e)), axis=1)[:, :k]
        return np.bincount(idx.ravel(), minlength=n_e).tolist()

    def b2e_step() -> dict:
        from ipex_llm_tpu_torch.ops.cuda.qmatmul import FORMATS
        rows = []
        for qtype in FORMATS:
            for n in (384, 200):
                qt = stack(6, 200, n, qtype)
                for instance, counts, max_rows in B2E_CASES:
                    x = padded_x(sum(counts), 200, qt)
                    seg = seg_of(counts)
                    for keep_f32 in (False, True):
                        err, rel = check(x, seg, qt, keep_f32,
                                         f"{qtype} N={n} {counts}", instance,
                                         max_rows)
                        rows.append(dict(qtype=qtype, n=n, k=200,
                                         segments=list(counts),
                                         instance=instance,
                                         out="f32" if keep_f32 else "bf16",
                                         max_abs_err=err, max_rel_err=rel))
        res["b2e_formats"] = rows
        worst = {i: max(r["max_rel_err"] for r in rows
                        if r["instance"] == i) for i, _, _ in B2E_CASES}
        print(f"B2e: {len(rows)} format cases within {B2_TOL_REL} of each "
              "row's largest output and bitwise on a second call, worst "
              f"relative error by instance {json.dumps(worst)}", flush=True)
        timed = []
        shapes = (("Mixtral-8x7B", 8, 2, (("gate_up", 4096, 28672),
                                          ("down", 14336, 4096))),
                  ("Qwen3-30B-A3B", 128, 8, (("gate_up", 2048, 1536),
                                             ("down", 768, 2048))))
        for model, n_e, k, projs in shapes:
            for name, kk, n in projs:
                qt = stack(n_e, kk, n, "sym_int4")
                for tick, tokens in B2E_TICKS:
                    p = tokens * k
                    # the engine's routes: the gather route (bf16 out) at
                    # 32 pairs or fewer, else the ragged route (fp32 out)
                    keep_f32 = p > 32
                    counts = routed_counts(tokens, n_e, k)
                    x, seg = padded_x(p, kk, qt), seg_of(counts)
                    pl = b2e.plan(p, n_e, n, kk, qt.block_size, tokens)
                    instance = (pl.instance if pl.instance != "tiled"
                                else f"tiled{pl.tile}")
                    err, rel = check(x, seg, qt, keep_f32,
                                     f"{model} {name} {tick}", instance,
                                     tokens)
                    ms = graph_ms(torch, [lambda: b2e.qmatmul_experts(
                        x, seg, qt, keep_f32=keep_f32, max_rows=tokens)])
                    # the tiled instance on the same inputs (no bound),
                    # where the bound picks the gemv one: checked, then
                    # timed
                    free = b2e.plan(p, n_e, n, kk, qt.block_size)
                    tiled_err = tiled_ms = None
                    if pl.instance == "gemv" and free.instance == "tiled":
                        tiled_err, _ = check(
                            x, seg, qt, keep_f32,
                            f"{model} {name} {tick} tiled{free.tile}",
                            f"tiled{free.tile}", None)
                        tiled_ms = graph_ms(torch, [
                            lambda: b2e.qmatmul_experts(
                                x, seg, qt, keep_f32=keep_f32)])
                    plain_ms = time_ms(lambda: b2e.qmatmul_experts_plain(
                        x, seg, qt, keep_f32=keep_f32), 2)
                    touched = sum(1 for c in counts if c)
                    per_expert = qt.nbytes // n_e
                    nbytes = (touched * per_expert + x.numel() * 2
                              + p * n * (4 if keep_f32 else 2))
                    bms, by = bound(nbytes, 2.0 * p * kk * n)
                    lib, lib_name = library_call(x, seg, qt, counts,
                                                 keep_f32)
                    lib_ms = graph_ms(torch, [lib]) if lib else None
                    row = dict(model=model, weight=name, tick=tick,
                               pairs=p, k=kk, n=n, experts=n_e,
                               touched=touched, instance=instance,
                               out="f32" if keep_f32 else "bf16",
                               max_abs_err=err, max_rel_err=rel, ms=ms,
                               tiled_ms=tiled_ms,
                               tiled_max_abs_err=tiled_err,
                               plain_ms=plain_ms, bound_ms=bms,
                               bound_by=by, library_ms=lib_ms,
                               library=lib_name, card=card)
                    timed.append(row)
                    print("B2e " + json.dumps(row), flush=True)
                    del lib
                del qt
                torch.cuda.empty_cache()
        return timed

    if "b2e" in steps:
        reset()
        res["b2e"] = b2e_step()
        res["b2e_check_launches"] = b2e.COUNTS.launches

    # -- 2. small decoders, card against CPU ---------------------------------
    def recording_route(replay=None):
        """Wrap the decoder's router so that each call's fp32 logits, its
        selected experts and their weights are kept (in call order); with
        ``replay`` (another run's records) each call returns that run's
        selection and weights for the same call instead of its own."""
        rec = []
        orig = decoder_mod.route

        def route(cfg, logits, bias=None):
            w, idx = orig(cfg, logits, bias)
            rec.append((logits.float().cpu(), idx.cpu(), w.cpu()))
            if replay is not None:
                _, idx_r, w_r = replay[len(rec) - 1]
                return w_r.to(w.device), idx_r.to(idx.device)
            return w, idx
        decoder_mod.route = route
        return rec, orig

    def small_check(label, cfg, seed, **init) -> dict:
        """The worst card-vs-CPU logit gap of each form over the logits'
        range, and the router selections compared where they are sure."""
        p_cpu = random_params(cfg, "sym_int4", seed=seed, device="cpu",
                              **init)

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
        sel = {"checked": 0, "positions": 0, "flips": 0}
        # the tokens each forward's router sees that are real (a chunk's
        # pads and a left-padded prompt's pads carry no token), per form:
        # the prefill's, then one a decode step
        valid = {"paged": [np.arange(t)[None] < lengths[:, None]]
                 + [np.ones((r, 1), bool)] * 3,
                 "dense": [np.arange(t)[None] >= (t - lengths)[:, None]]
                 + [np.ones((r, 1), bool)] * 4}
        for form in ("paged", "dense"):
            outs, routes = {}, {}
            for name, where, params in (("cpu", "cpu", p_cpu),
                                        ("cuda", dev, p_dev)):
                def to(x):
                    return torch.from_numpy(np.ascontiguousarray(x)).to(
                        where)
                # the card follows the CPU's selections, so that a flip
                # at a near-tie cannot move what the logits compare; its
                # own selections are compared below
                rec, orig = recording_route(routes.get("cpu"))
                logits = []
                try:
                    if form == "paged":
                        c = PagedKVCache.init(cfg.num_layers, 1 + r * maxp,
                                              r, maxp, cfg.num_kv_heads, ps,
                                              cfg.head_dim, device=where)
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
                        for tk in decode[:3]:
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
                                       device=where)
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
            # a flip where the CPU's router is sure fails; one at a
            # near-tie is counted
            k, n_l = cfg.num_experts_per_tok, cfg.num_layers
            for j, real in enumerate(valid[form]):
                live = torch.from_numpy(real)
                for (lc, ic, _), (_, ig, _) in zip(
                        routes["cpu"][j * n_l:(j + 1) * n_l],
                        routes["cuda"][j * n_l:(j + 1) * n_l]):
                    srt = lc.sort(dim=-1, descending=True).values
                    span = srt[..., 0] - srt[..., -1]
                    sure = ((srt[..., k - 1] - srt[..., k])
                            > MARGIN * span) & live
                    sel["positions"] += int(live.sum())
                    sel["checked"] += int(sure.sum())
                    # the sets (the order inside the top k only moves a
                    # bf16 sum's rounding)
                    differ = (ic.sort(-1).values != ig.sort(-1).values
                              ).any(-1) & live
                    if bool((differ & sure).any()):
                        fail(f"moe small {label} {form}: the card selected "
                             "other experts than the CPU where the router "
                             f"margin exceeds {MARGIN} of the logits' span")
                    sel["flips"] += int(differ.sum())
            w = 0.0
            for a, b in zip(outs["cuda"], outs["cpu"]):
                diff = float(np.abs(a - b).max() / (b.max() - b.min()))
                if not np.isfinite(a).all() or diff > 0.025:
                    fail(f"moe small {label} {form}: card vs CPU logits "
                         f"differ by {diff:.4f} of the range (bound 0.025)")
                w = max(w, diff)
            worst[form] = w
        if cfg.num_experts:
            if sel["checked"] < 0.4 * sel["positions"]:
                fail(f"moe small {label}: only {sel['checked']} of "
                     f"{sel['positions']} router positions were checked")
            worst["selections_equal"] = sel
        return worst

    if "small" in steps:
        reset()
        small = dict(hidden_size=512, num_layers=2, vocab_size=512)
        res["small"] = {
            "mixtral": small_check("mixtral", mixtral_8x7b_config(
                intermediate_size=1024, moe_intermediate_size=1024,
                num_heads=4, num_kv_heads=1, **small), 3, router_scale=3.0),
            "qwen2_moe": small_check("qwen2_moe", qwen15_moe_a27b_config(
                intermediate_size=1408, moe_intermediate_size=352,
                num_heads=4, num_kv_heads=4, **small), 4,
                shared_intermediate=1408, router_scale=3.0),
            "qwen3_moe": small_check("qwen3_moe", qwen3_30b_a3b_config(
                intermediate_size=1024, moe_intermediate_size=192,
                num_heads=8, num_kv_heads=1, **small), 5, router_scale=3.0),
            "qwen3": small_check("qwen3", qwen3_8b_config(
                intermediate_size=1024, num_heads=8, num_kv_heads=2,
                **small), 6)}
        # the CPU's side runs the plain versions, so only the card's
        # launches are gated here
        res["small_launches"] = {n: m.COUNTS.launches
                                 for n, m in kernels.items()}
        if not all(m.COUNTS.launches for m in (b1, b2, b2e, b3, b4)):
            fail(f"moe small: launches {res['small_launches']}")
        res["small_b2e_by_instance"] = dict(b2e.COUNTS.by_instance)
        print("moe small decoders card vs CPU, worst logit diff over the "
              "range (bound 0.025): " + json.dumps(res["small"]), flush=True)

    # -- 3, 4. full width through the engine; generate() ---------------------
    def requests(cfg, n_req, seed):
        rng = np.random.default_rng(seed)
        lens = rng.integers(64, 1001, n_req)
        news = rng.integers(32, 65, n_req)
        return [Request(prompt_ids=[int(v) for v in rng.integers(
                    1, cfg.vocab_size, int(n))], max_new_tokens=int(m),
                        temperature=0.8 if i % 2 else 0.0,
                        top_p=0.9 if i % 2 else 1.0,
                        seed=4000 + i if i % 2 else None)
                for i, (n, m) in enumerate(zip(lens, news))]

    def serve(label, cfg, params, storage, n_req, seed, need,
              b2e_need=(), budget=None):
        """``n_req`` requests through the engine of ``SERVE_EC`` with a
        mixed tick's prefill budget ``budget`` (None: the engine's
        default)."""
        eng = ServingEngine(cfg, params, EngineConfig(
            kv_storage=storage, step_token_budget=budget, **SERVE_EC),
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
        launches = gate(f"{label} serve {storage} budget "
                        f"{eng._step_budget}", need, b2e_need=b2e_need)
        for q, st in zip(reqs, streams):
            if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                    or st != q.output_ids or not all(
                        0 <= v < cfg.vocab_size for v in st):
                fail(f"moe {label} {storage}: a request finished "
                     f"{q.finish_reason} with {len(st)} of "
                     f"{q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
        out_tok = sum(len(st) for st in streams)
        ttft = [q.first_token_s for q in reqs]
        row = dict(model=label, card=card, storage=storage,
                   layers=cfg.num_layers,
                   step_token_budget=eng._step_budget, requests=len(reqs),
                   prompt_tokens=sum(len(q.prompt_ids) for q in reqs),
                   output_tokens=out_tok, wall_s=wall,
                   output_tok_s=out_tok / wall,
                   ttft_mean_s=float(np.mean(ttft)),
                   ttft_max_s=float(np.max(ttft)),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   weight_bytes=eng.weight_stats()["weight_bytes"],
                   launches=launches,
                   b2e_by_instance=dict(b2e.COUNTS.by_instance),
                   b1_by_route=dict(b1.COUNTS.by_route),
                   ticks=eng.metrics["steps"])
        print("moe serve " + json.dumps(row), flush=True)
        del eng
        torch.cuda.empty_cache()
        return row

    @contextlib.contextmanager
    def sync_raises():
        """torch's sync debug mode at "error": a host read of a device
        value raises inside the block."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def marked_ffn(ffn):
        """``moe_ffn`` under :func:`sync_raises`, each call a profiler
        range named ``moe_ffn``."""
        def wrapped(*args, **kw):
            with record_function("moe_ffn"), sync_raises():
                return ffn(*args, **kw)
        return wrapped

    def host_syncs_in_ffn(prof) -> int:
        """Host reads and stream waits inside the ``moe_ffn`` ranges."""
        spans = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events() if ev.name == "moe_ffn"
                 and ev.device_type == DeviceType.CPU]
        return sum(
            1 for ev in prof.events()
            if ev.device_type == DeviceType.CPU and ev.name in SYNC_EVENTS
            and any(lo <= ev.time_range.start <= hi for lo, hi in spans))

    def tick_profile(label, cfg, params) -> dict:
        """One decode tick (eight rows of 64-1000 ids, horizon 4) under
        ``torch.profiler``: B2e's device time over the tick's, and the
        device's idle share of the tick's wall time.  Every ``moe_ffn``
        call of the tick, and one of layer 0 at a decode and a prefill
        shape before it, runs with a host read raising, and the profile
        must show none inside the dispatch: no host read finds B2e's
        work."""
        lp = decoder_mod.layer_params(params["layers"], 0)
        for b, t in ((8, 1), (1, 128)):
            h = torch.randn(b, t, cfg.hidden_size, generator=gen,
                            device=dev).to(torch.bfloat16)
            w, idx = decoder_mod.route(cfg, decoder_mod._f32_product(
                h, lp["router"]))
            torch.cuda.synchronize()
            with sync_raises():
                moe_mod.moe_ffn(h, w, idx, lp["moe_gate_up"],
                                lp["moe_down"], cfg.act, cfg.num_experts)
        torch.cuda.synchronize()
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
        ffn = moe_mod.moe_ffn
        moe_mod.moe_ffn = marked_ffn(ffn)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng._tick()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            moe_mod.moe_ffn = ffn
        syncs = host_syncs_in_ffn(prof)
        if syncs or not any(ev.name == "moe_ffn" for ev in prof.events()):
            fail(f"moe {label} tick: {syncs} host syncs inside moe_ffn")
        total = experts = 0.0
        spans = []
        for ev in prof.events():
            # the device copies of the moe_ffn ranges are spans, not work
            if ev.device_type == DeviceType.CUDA and ev.name != "moe_ffn":
                total += ev.device_time_total
                if "qmm_experts" in ev.name:
                    experts += ev.device_time_total
                spans.append((ev.time_range.start, ev.time_range.end))
        busy, last = 0.0, None
        for s, e in sorted(spans):          # union of the kernels' spans
            if last is None or s > last:
                busy += e - s
                last = e
            elif e > last:
                busy += e - last
                last = e
        row = dict(model=label, card=card, rows=len(reqs),
                   horizon=eng.ec.decode_horizon, tick_wall_ms=wall * 1e3,
                   tick_device_ms=total / 1e3, b2e_device_ms=experts / 1e3,
                   b2e_share=experts / total if total else None,
                   device_busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / 1e3 / (wall * 1e3),
                   moe_ffn_host_syncs=syncs)
        print("moe tick " + json.dumps(row), flush=True)
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
        launches = gate(f"{label} generate", (b2, b3, b4, b2e),
                        b2e_need=("gemv", "wgmma"))
        got = model.last_result
        if tuple(out.shape) != (len(GENERATE_LENGTHS), width + new) or list(
                got.num_new_tokens) != [new] * len(GENERATE_LENGTHS) or int(
                out[:, -new:].max()) >= cfg.vocab_size:
            fail(f"moe {label} generate: sequences {tuple(out.shape)}, "
                 f"new tokens {list(got.num_new_tokens)}")
        row = dict(model=label, card=card, rows=len(GENERATE_LENGTHS),
                   prompt_tokens=sum(GENERATE_LENGTHS), new_tokens=new,
                   wall_s=wall, output_tok_s=len(GENERATE_LENGTHS) * new
                   / wall, first_cost_s=model.first_cost,
                   rest_cost_mean_s=model.rest_cost_mean,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches,
                   b2e_by_instance=dict(b2e.COUNTS.by_instance))
        print("moe generate " + json.dumps(row), flush=True)
        del model
        return row

    res["serve"], res["tick"], res["generate"] = [], [], []
    for step, label, cfg, seed in (
            ("mixtral", "Mixtral-8x7B",
             mixtral_8x7b_config(num_layers=SERVE_LAYERS), 20),
            ("qwen3", "Qwen3-30B-A3B",
             qwen3_30b_a3b_config(num_layers=SERVE_LAYERS), 21)):
        if step not in steps:
            continue
        t0 = time.perf_counter()
        params = random_params(cfg, "sym_int4", seed=seed, device=dev)
        torch.cuda.synchronize()
        print(f"{label}-width random sym_int4 weights: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)
        need = (b1, b2, b2e)
        # eight requests: decode ticks (gemv) and, at the default budget,
        # prefill chunks of up to 128 tokens (tiled); at the wide budget,
        # up to 8 x 128 (wgmma)
        res["serve"].append(serve(label, cfg, params, "bf16", 8, seed + 10,
                                  need, ("gemv", "tiled")))
        res["serve"].append(serve(label, cfg, params, "bf16", 8, seed + 10,
                                  need, ("gemv", "wgmma"), WIDE_BUDGET))
        res["serve"].append(serve(label, cfg, params, "fp8", 2, seed + 20,
                                  need))
        res["tick"].append(tick_profile(label, cfg, params))
        if step == "mixtral":
            res["generate"].append(generate(label, cfg, MIXTRAL_8X7B_HF,
                                            params))
        del params
        torch.cuda.empty_cache()

    # -- 5. from_pretrained of a Mixtral-width checkpoint --------------------
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
    from ipex_llm_tpu_torch.models.random_init import MIXTRAL_8X7B_HF
    from ipex_llm_tpu_torch.serving.api_server import build_server
    from ipex_llm_tpu_torch.serving.engine import EngineConfig
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
    from torch_http_client import IdTokenizer

    hf = dict(MIXTRAL_8X7B_HF, num_hidden_layers=LOAD_LAYERS,
              architectures=["MixtralForCausalLM"], torch_dtype="bfloat16")
    shapes = mixtral_hf_shapes(hf)
    res: dict = {"card": card, "layers": LOAD_LAYERS}
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_moe_load_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(17)
        total, files, names = 0, [], sorted(shapes)
        per_file = 40
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
        print(f"moe load: wrote {total / 1e9:.2f} GB ({LOAD_LAYERS} layers)"
              f" in {res['write_s']:.1f} s", flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.from_pretrained(
            root, load_in_low_bit="sym_int4", device=dev)
        torch.cuda.synchronize()
        res.update(load_s=time.perf_counter() - t0,
                   peak_over_base_bytes=torch.cuda.max_memory_allocated()
                   - base,
                   weight_bytes=param_bytes(model.params)[0])
        # one expert's planes against the CPU codec of the same tensors
        reader = CheckpointReader(root)
        e = hf["num_local_experts"] - 1
        x = f"model.layers.1.block_sparse_moe.experts.{e}."
        want = quantize_weight(torch.cat([reader.get(x + "w1.weight"),
                                          reader.get(x + "w3.weight")]),
                               "sym_int4")
        got = model.params["layers"]["moe_gate_up"].planes(
            lambda t: t[1, e].cpu())
        if not (torch.equal(got.data, want.data)
                and torch.equal(got.scales, want.scales)):
            fail("moe load: expert planes differ from the CPU codec's")
        res["expert_planes_equal"] = True
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
            fail(f"moe load: build_server answered {out.status} "
                 f"{str(out.body)[:200]}")
        launches = {n: m.COUNTS.launches for n, m in kernels.items()}
        plain = {n: m.COUNTS.plain_calls for n, m in kernels.items()}
        if any(plain.values()) or not launches["qmatmul_experts"]:
            fail(f"moe load server: launches {launches}, plain {plain}")
        res["server"] = dict(status=out.status, launches=launches)
        print("moe load " + json.dumps(res), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def b2e_build_report(b2e) -> dict:
    """For each of B2e's sources, built: ptxas's register, spill and
    warning lines, and the tensor-core instructions in its kernel's SASS
    (HMMA from mma.sync in the tiled and gemv instances, HGMMA from wgmma
    in the wgmma instance's); ``problems`` lists a spill or an instance
    without them."""
    from ipex_llm_tpu_torch.ops.cuda import _build

    out = {"problems": []}
    for inst, kernel, opcode in (("tiled", "qmm_experts_kernel", "HMMA"),
                                 ("gemv", "qmm_experts_gemv_kernel", "HMMA"),
                                 ("wgmma", "qmm_experts_wgmma_kernel",
                                  "HGMMA")):
        src = b2e.SOURCES[inst]
        log = (_build.BUILD_DIR / f"{src}.log").read_text().splitlines()
        lines = [ln.strip() for ln in log if "registers" in ln
                 or "spill" in ln or "arning" in ln]
        spills = [ln for ln in lines if "spill" in ln
                  and " 0 bytes spill stores" not in ln]
        counts = [n for fn, n in _build.sass_counts(src, opcode).items()
                  if kernel in fn]
        if spills or not counts or min(counts) == 0:
            out["problems"].append(f"B2e {inst}: spills {spills}, {opcode} "
                                   f"counts {counts}")
        out[inst] = dict(source=src, opcode=opcode, kernels=len(counts),
                         count_min=min(counts, default=0),
                         count_max=max(counts, default=0), ptxas=lines[:8])
    return out


def kernel_modules():
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
    return {m.NAME: m for m in (b2, b1, b3, b4, b5, b2e)}


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_moe_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_moe_smoke: steps are {STEPS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_moe_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
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
    built = b2e_build_report(kernels["qmatmul_experts"])
    print("B2e build: " + json.dumps(built), flush=True)
    res = moe_phase(kernels, card, fail, torch.device("cuda", 0), graph_ms,
                    steps)
    print(json.dumps(res), flush=True)
    if built["problems"]:
        fail("; ".join(built["problems"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
