#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ipex_llm_tpu_torch``) on one NVIDIA GPU
and check it.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (there is no fallback):

1. device: the card's name and power limit, the torch and CUDA versions,
   and the build of every CUDA kernel of the serving path (one ``nvcc``
   per source, all started together);
2. B2, the sym_int4 dequant-matmul, against its plain PyTorch version at
   the five Llama-2-7B weight shapes and M = 1, 8 (decode) and 128 (the
   prefill tokens of a mixed tick at ``prefill_bucket`` 128), plus M = 512,
   off the serving path, as a larger prefill (3, 13 and 100 checked only),
   with the kernel's, the plain version's and
   ``torch.matmul`` on the dequantized weight's times, and the card's
   least time for the work;
3. B1, ragged paged attention, against its plain version on decode, chunk
   (width 128 and 16) and idle rows at 32 heads, head_dim 128, page 128,
   over bf16 and e5m2 pools, with ``scaled_dot_product_attention`` over
   the gathered pages as the library yardstick;
4. a small GQA decoder on the card against the same decoder on the CPU's
   plain versions (prefill plus decode steps, logits within tolerance);
5. serving at Llama-2-7B widths (random sym_int4 weights from a seed):
   eight requests through ``ServingEngine`` over a bf16 pool, then two
   over an e5m2 pool; every kernel of the path must have launched in each
   run and no plain version may have run.

The second-to-last line of output is the ``{"kernels": [...]}`` summary,
the last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet (dense): HBM3 rate and the bf16
# tensor-core rate.  The least time a kernel could take is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
L2_BYTES = 50 * 2 ** 20

# bf16 outputs: one ulp is 2^-8 of a value's binade, and both sides round
# once at the end, so kernel and plain version may differ by one ulp of
# the largest output (plus far smaller fp32 accumulation error)
B2_TOL_REL = 2.0 ** -7
# the kernel and the plain version (float64) see the same widened inputs
# and differ, apart from fp32 rounding far below it, by the final bf16
# rounding: at most one ulp of an output, so within 2^-7 of the largest
# output of its row.  Held per row, as rows over few keys have outputs
# far larger than rows over thousands.
B1_TOL_REL = 2.0 ** -7

LLAMA2_7B_SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096),
                    "gate_up": (4096, 22016), "down": (11008, 4096),
                    "lm_head": (4096, 32000)}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not (ROOT / "ipex_llm_tpu_torch" / "csrc").is_dir():
        fail(f"no ipex_llm_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report: dict = {}

    def time_ms(fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    kernels = {"qmatmul_int4": b2, "ragged_paged_attention": b1}
    t_build = _build.build(list(kernels))
    print(f"kernel build: {t_build:.1f} s for {len(kernels)} sources",
          flush=True)
    report.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=t_build)
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 2. B2 ---------------------------------------------------------------
    from ipex_llm_tpu_torch.quantize.core import dequantize, quantize

    b2_rows = []
    for wname, (k, n) in LLAMA2_7B_SHAPES.items():
        wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                      * (1.2 / math.sqrt(k)), "sym_int4")
        wbytes = wq.data.numel() + wq.scales.numel() * 2
        # rotate over enough copies that each launch finds its weight
        # out of L2, as a layer's weight is on the serving path
        copies = [wq] + [quantize(torch.randn(k, n, generator=gen,
                                              device=dev), "sym_int4")
                         for _ in range(math.ceil(2 * L2_BYTES / wbytes))]
        w_bf16 = dequantize(wq, torch.bfloat16)
        for m in (1, 8, 128, 512):
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            y = b2.qmatmul_int4(x, wq.data, wq.scales)
            y_plain = b2.qmatmul_int4_plain(x, wq.data, wq.scales)
            torch.cuda.synchronize()
            err = (y.float() - y_plain.float()).abs().max().item()
            top = y_plain.float().abs().max().item()
            if not (err <= B2_TOL_REL * top) or not torch.isfinite(y).all():
                fail(f"B2 {wname} M={m}: max abs err {err} > "
                     f"{B2_TOL_REL} * {top}")
            it = [0]

            def run_kernel():
                q = copies[it[0] % len(copies)]
                it[0] += 1
                b2.qmatmul_int4(x, q.data, q.scales)

            ms = time_ms(run_kernel, 30)
            plain_ms = time_ms(
                lambda: b2.qmatmul_int4_plain(x, wq.data, wq.scales), 3)
            lib_ms = time_ms(lambda: torch.matmul(x, w_bf16), 30)
            bms, by = bound(m * k * 2 + wbytes + m * n * 2, 2.0 * m * n * k)
            row = dict(weight=wname, m=m, k=k, n=n, on_path=m != 512,
                       max_abs_err=err,
                       max_rel_err=err / top, tol=B2_TOL_REL * top,
                       ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            b2_rows.append(row)
            print("B2 " + json.dumps(row), flush=True)
        del copies, w_bf16
        if wname == "qkv":
            # row counts of mixed ticks (P rows x a power-of-two width) and
            # of part-full row tiles: checked, not timed
            for m in (3, 13, 100):
                x = torch.randn(m, k, generator=gen, device=dev).to(
                    torch.bfloat16)
                y = b2.qmatmul_int4(x, wq.data, wq.scales)
                y_plain = b2.qmatmul_int4_plain(x, wq.data, wq.scales)
                err = (y.float() - y_plain.float()).abs().max().item()
                top = y_plain.float().abs().max().item()
                if not err <= B2_TOL_REL * top:
                    fail(f"B2 {wname} M={m}: max abs err {err}")
    report["b2"] = b2_rows

    # -- 3. B1 ---------------------------------------------------------------
    import torch.nn.functional as F

    def ragged_case(pool_dtype, r=8, c=128, hq=32, hkv=32, d=128, ps=128,
                    maxp=16):
        """benchmark/microbench.py::bench_ragged_attn's mix: even rows
        decode at full history, odd rows take a ragged chunk; the last two
        rows are idle (chunk 0, kv_len the sentinel past the table)."""
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)
                  ).to(torch.int32).reshape(r, maxp)
        chunk = np.where(np.arange(r) % 2 == 0, 1,
                         1 + (37 * np.arange(r)) % c).astype(np.int32)
        kv_len = np.where(chunk == 1, maxp * ps,
                          maxp * ps - c + chunk).astype(np.int32)
        chunk[-2:] = 0
        kv_len[-2:] = maxp * ps
        tables[-2:] = -1
        q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        return (q, kp, vp, tables, torch.from_numpy(kv_len).to(dev),
                torch.from_numpy(chunk).to(dev))

    def b1_work(q, kp, kv_len, chunk):
        r, c, hq, d = q.shape
        hkv = kp.shape[1]
        item = kp.element_size()
        live = chunk.cpu().numpy() > 0
        kvl = kv_len.cpu().numpy()
        ch = chunk.cpu().numpy()
        nbytes = 2 * r * c * hq * d * 2          # q in, out
        pairs = 0
        for i in np.flatnonzero(live):
            nbytes += 2 * int(kvl[i]) * hkv * d * item
            q0 = int(kvl[i]) - int(ch[i])
            pairs += sum(q0 + j + 1 for j in range(int(ch[i])))
        return nbytes, 4.0 * d * hq * pairs

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
            qt, kg, vg, attn_mask=mask[:, None])

    b1_rows = []
    for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
        for label, kw in (("row mix R=8 C=128", {}),
                          ("row mix R=8 C=16", dict(c=16)),
                          ("decode R=8 C=1", dict(c=1))):
            q, kp, vp, tables, kv_len, chunk = ragged_case(pool_dtype, **kw)
            if kw.get("c") == 1:      # decode rows at staggered lengths
                chunk = torch.ones_like(chunk)
                kv_len = torch.tensor([130, 300, 511, 700, 900, 1064, 1500,
                                       2048], dtype=torch.int32, device=dev)
                tables = (1 + torch.arange(tables.numel(), device=dev)
                          ).to(torch.int32).reshape(tables.shape)
            args = (q, kp, vp, tables, kv_len, chunk)
            out = b1.ragged_paged_sdpa(*args)
            ref = b1.ragged_paged_sdpa_plain(*args, scale=128 ** -0.5)
            torch.cuda.synchronize()
            err = worst = 0.0
            for i, n_q in enumerate(chunk.tolist()):
                if n_q == 0:
                    if out[i].abs().max().item() != 0.0:
                        fail(f"B1 {pool_name}: idle row {i} is not zero")
                    continue
                e = (out[i, :n_q].float() - ref[i, :n_q].float()
                     ).abs().max().item()
                top = ref[i, :n_q].float().abs().max().item()
                if not e <= B1_TOL_REL * top:
                    fail(f"B1 {pool_name} {label} row {i}: max abs err {e} "
                         f"> {B1_TOL_REL} * {top}")
                err, worst = max(err, e), max(worst, e / top)
            if not torch.isfinite(out).all():
                fail(f"B1 {pool_name} {label}: output not finite")
            ms = time_ms(lambda: b1.ragged_paged_sdpa(*args), 30)
            plain_ms = time_ms(lambda: b1.ragged_paged_sdpa_plain(
                *args, scale=128 ** -0.5), 3)
            lib_ms = time_ms(b1_library(*args), 30)
            bms, by = bound(*b1_work(q, kp, kv_len, chunk))
            row = dict(pool=pool_name, case=label, max_abs_err=err,
                       max_rel_err=worst, tol_rel=B1_TOL_REL, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            b1_rows.append(row)
            print("B1 " + json.dumps(row), flush=True)
            del q, kp, vp, out, ref
    report["b1"] = b1_rows

    # -- 4. a small decoder: card against CPU --------------------------------
    from ipex_llm_tpu_torch.kv import PagedKVCache
    from ipex_llm_tpu_torch.models.decoder import decoder_forward
    from ipex_llm_tpu_torch.models.random_init import (llama2_7b_config,
                                                       llama_config,
                                                       random_params)

    # GQA (4 query heads over 2 kv heads) at the kernel's head_dim 128
    small = llama_config(hidden_size=512, intermediate_size=1024,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=128, vocab_size=512)
    p_cpu = random_params(small, "sym_int4", seed=1, device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev) if hasattr(tree, "to") else tree
    p_dev = to_dev(p_cpu)
    rng = np.random.default_rng(3)
    r, t, ps, maxp = 3, 40, 128, 2
    chunk = np.array([40, 17, 29], np.int32)
    toks = rng.integers(0, 512, (r, t)).astype(np.int32)
    worst = 0.0
    caches = {}
    for name, device, params in (("cpu", "cpu", p_cpu), ("cuda", dev,
                                                          p_dev)):
        c = PagedKVCache.init(2, 1 + r * maxp, r, maxp, 2, ps, 128,
                              device=device)
        c.tables.copy_(1 + torch.arange(r * maxp, dtype=torch.int32
                                        ).reshape(r, maxp))
        caches[name] = (c, params, device)
    lens = np.zeros(r, np.int32)
    steps = [(toks, np.zeros(r, np.int32), chunk)]
    for _ in range(3):
        steps.append((rng.integers(0, 512, (r, 1)).astype(np.int32), None,
                      None))
    for tk, base, ch in steps:
        outs = {}
        for name, (c, params, device) in caches.items():
            kw = {}
            if ch is not None:
                pos = base[:, None] + np.arange(tk.shape[1])[None, :]
                kw = dict(slot_offsets=torch.from_numpy(base).to(device),
                          chunk_lens=torch.from_numpy(ch).to(device),
                          gather_positions=torch.from_numpy(ch - 1).to(
                              device))
            else:
                pos = lens[:, None]
                kw = dict(slot_offsets=torch.from_numpy(lens).to(device),
                          last_token_only=True)
            lg, _ = decoder_forward(small, params,
                                    torch.from_numpy(tk).to(device), c,
                                    torch.from_numpy(
                                        np.ascontiguousarray(pos)).to(device),
                                    **kw)
            outs[name] = lg.float().cpu().numpy()
        lens = lens + (chunk if ch is not None else 1)
        span = outs["cpu"].max() - outs["cpu"].min()
        diff = np.abs(outs["cuda"] - outs["cpu"]).max() / span
        worst = max(worst, float(diff))
        if not np.isfinite(outs["cuda"]).all() or diff > 0.025:
            fail(f"small decoder: card vs CPU logits differ by {diff:.4f} "
                 "of the logit range (bound 0.025)")
    print(f"small decoder card vs CPU: worst logit diff {worst:.5f} of the "
          "range (bound 0.025)", flush=True)
    report["small_decoder_worst_rel"] = worst
    del caches, p_dev

    # -- 5. serving at Llama-2-7B widths -----------------------------------
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)

    cfg = llama2_7b_config()
    t0 = time.perf_counter()
    params = random_params(cfg, "sym_int4", seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"Llama-2-7B-width random sym_int4 weights: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card",
          flush=True)

    def serve(storage: str, n_req: int, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        lens = rng.integers(64, 1001, n_req)
        news = rng.integers(32, 65, n_req)
        reqs = [Request(prompt_ids=[int(v) for v in
                                    rng.integers(1, cfg.vocab_size, n)],
                        max_new_tokens=int(m),
                        temperature=0.8 if i % 2 else 0.0,
                        top_p=0.9 if i % 2 else 1.0,
                        seed=1000 + i if i % 2 else None)
                for i, (n, m) in enumerate(zip(lens, news))]
        eng = ServingEngine(cfg, params, EngineConfig(
            max_rows=8, max_seq_len=2048, page_size=128, prefill_bucket=128,
            decode_horizon=4, kv_storage=storage), device=dev)
        for mod in kernels.values():
            mod.COUNTS.reset()
        eng.start()
        t_start = time.perf_counter()
        for q in reqs:
            eng.submit(q)
        streams = [list(stream_tokens(q, timeout=600)) for q in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts = {name: (mod.COUNTS.launches, mod.COUNTS.plain_calls)
                  for name, mod in kernels.items()}
        eng.stop()
        if eng._thread.is_alive():
            fail("engine thread did not stop")
        for q, s in zip(reqs, streams):
            if q.finish_reason != "length" or len(s) != q.max_new_tokens \
                    or s != q.output_ids:
                fail(f"{storage} pool: request finished {q.finish_reason} "
                     f"with {len(s)} of {q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
            if not all(0 <= v < cfg.vocab_size for v in s) or not all(
                    math.isfinite(lp) and lp <= 0 for lp in q.logprobs):
                fail(f"{storage} pool: token or logprob out of range")
        for name, (launches, plain) in counts.items():
            if launches == 0 or plain != 0:
                fail(f"{storage} pool: {name} launched {launches} times, "
                     f"plain version called {plain} times")
        out_tok = sum(len(s) for s in streams)
        ttft = [q.first_token_s for q in reqs]
        res = dict(storage=storage, requests=n_req,
                   prompt_tokens=int(lens.sum()), output_tokens=out_tok,
                   wall_s=wall, output_tok_s=out_tok / wall,
                   ttft_mean_s=float(np.mean(ttft)),
                   ttft_max_s=float(np.max(ttft)),
                   launches={k: v[0] for k, v in counts.items()},
                   metrics={k: eng.metrics[k] for k in (
                       "mixed_steps", "steps", "host_syncs", "epoch_syncs",
                       "decode_horizon_effective")})
        print("serve " + json.dumps(res), flush=True)
        del eng
        torch.cuda.empty_cache()
        return res

    report["serve"] = [serve("bf16", 8, 7), serve("fp8", 2, 8)]
    main_launches = report["serve"][0]["launches"]

    # -- summary -------------------------------------------------------------
    rep_b2 = next(r for r in b2_rows if r["weight"] == "gate_up"
                  and r["m"] == 8)
    rep_b1 = next(r for r in b1_rows if r["pool"] == "bf16"
                  and r["case"].startswith("row mix"))
    src = "ipex_llm_tpu_torch/csrc/"
    line = {"kernels": [
        {"name": "qmatmul_int4", "route": "cuda",
         "source": src + "qmatmul_int4.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "shape": "M=8 K=4096 N=22016 (gate_up, decode)",
         "launches": main_launches["qmatmul_int4"],
         "max_abs_err": max(r["max_abs_err"] for r in b2_rows),
         **{k: rep_b2[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}},
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=128 Hq=Hkv=32 D=128 page 128, bf16 pool, "
                  "decode+chunk+idle rows",
         "launches": main_launches["ragged_paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in b1_rows),
         **{k: rep_b1[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}},
    ]}
    out_dir = ROOT / "chiprun_out"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps({**report, **line}, indent=1))
    except OSError as exc:
        print(f"could not write {out_dir}: {exc}", flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
