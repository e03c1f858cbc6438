#!/usr/bin/env python3
"""Time the port's attention kernels B1 (ragged paged), B3 (dense decode),
B4 (flash) and B5 (split paged) from one source tree, so that two trees can be compared on
one card.

    python3 scripts/torch_attention_ab.py TREE build   # build TREE's kernels
    python3 scripts/torch_attention_ab.py TREE time    # one JSON line of times
    python3 scripts/torch_attention_ab.py turns PARENT CHANGE [ROUNDS]

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  ``turns`` builds both trees, then
times them in alternating order (parent, change, change, parent, ...; one
process per timing, ROUNDS of each, 3 by default) in one run on
one card, and prints each case's times, its medians, the ratio of the
parent's median to the change's and each side's spread.

It times B1 at Llama-2-7B's attention widths (32 query and 32 kv heads of
128, page 128, 8 rows of up to 16 pages) with CUDA events over 50
launches, over bf16 and e5m2 pools, in four cases: the row mix of a mixed
tick at C=128 and at C=16 (even rows decode at 2,048 slots, odd rows take
a ragged chunk, the last two idle), the verify chunks of speculation (C=4)
and decode (C=1), both at staggered lengths of 130 to 2,048 slots.

B5 runs on ``chip_smoke.py``'s ``b5`` shapes: the same widths, rows of 1,
100, 130, 511, 900, 1300, 2047 and 2048 slots, pages in random order with
-1 past each row's last page, at C = 1 (decode), 4 (the verify chunks of
spec_k 3) and 128, over bf16 and e5m2 pools, as device time from CUDA-graph
replays (below).

B3 and B4 run at Mistral-7B's widths (32 query heads over 8 kv heads of
128) on the shapes of ``chip_smoke.py``'s generate runs: B4 on run (a)'s
prefill (B=4, the 2048 bucket, rows of 1990, 1327, 611 and 203 ids,
capacity 2304) and run (d)'s (one 4500-id prompt in the 4608 bucket, the
4096 window cutting); B3 on run (a)'s decode (capacity 2304, kv_start 0,
211, 1003, 37, kv_len 2100, 1500, 1990, 777, window off) and run (d)'s
last step (capacity 4864, kv_start 108, kv_len 4639, window 4096), over
bf16 and e5m2 caches.  Their calls are captured in a CUDA graph and
replayed, so the time is the kernels' device time per call, not the pace
at which Python can launch them; B3 rotates over copies of the cache
layer, so each call finds it out of L2, as each layer's is in decode.

The other head widths, as device time from CUDA-graph replays
(:func:`width_cases`): B1 at 128 (32 heads over 32, C = 1, 4 and 128),
256 (Gemma-7B's 16 heads over 16, C = 1 and 128) and 80 (Phi-2's 32 over
32, C = 1 and 128), 128-slot pages, 8 rows of up to 2048 slots, bf16
pool, B3 at 256 (Gemma-2-9B's 16 over 8), 96 (Phi-3-mini's 32 over 32),
80 (Phi-2's 32 over 32) and 128 at GLM-4-9B's GQA group of 16 (32 over
2) over 8 rows of a 4096-slot bf16 layer, B4 at the first three widths on
8 rows of T = 128 at their own slots of that layer.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_qmatmul_ab import graph_ms, turns  # noqa: E402  (shared)

LENS = [130, 300, 511, 700, 900, 1064, 1500, 2048]


def cases(torch, dev, gen, pool_dtype):
    """(label, args) of the four cases over one pool dtype."""
    r, hq, hkv, d, ps, maxp = 8, 32, 32, 128, 128, 16
    n_pages = 1 + r * maxp
    kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device=dev).to(
        pool_dtype)
    vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device=dev).to(
        pool_dtype)
    tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)).to(
        torch.int32).reshape(r, maxp)
    out = []
    for c in (128, 16):
        chunk = [1 if i % 2 == 0 else 1 + (37 * i) % c for i in range(r)]
        kv_len = [maxp * ps if n == 1 else maxp * ps - c + n for n in chunk]
        chunk[-2:] = [0, 0]
        kv_len[-2:] = [maxp * ps] * 2
        t = tables.clone()
        t[-2:] = -1
        out.append((f"row mix C={c}", c, t, kv_len, chunk))
    for c, label in ((4, "verify C=4"), (1, "decode C=1")):
        out.append((label, c, tables, LENS, [c] * r))
    res = []
    for label, c, t, kv_len, chunk in out:
        q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        res.append((label, (q, kp, vp, t,
                            torch.tensor(kv_len, dtype=torch.int32,
                                         device=dev),
                            torch.tensor(chunk, dtype=torch.int32,
                                         device=dev))))
    return res


def dense_cases(torch, dev, gen, b3, b4) -> dict:
    """B3 and B4 on the generate runs' shapes: label -> list of calls."""
    hq, hkv, d = 32, 8, 128
    out = {}
    for label, t, cap, lengths in (("b4 run (a) T=2048", 2048, 2304,
                                    [1990, 1327, 611, 203]),
                                   ("b4 run (d) T=4608", 4608, 4864,
                                    [4500])):
        b = len(lengths)
        q = torch.randn(b, t, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
            torch.bfloat16)
        kw = dict(q_positions=torch.arange(t, device=dev)[None].expand(b, t),
                  kv_start=torch.tensor([t - n for n in lengths],
                                        dtype=torch.int32, device=dev),
                  kv_len=torch.full((b,), t, dtype=torch.int32, device=dev),
                  window=4096)
        out[label] = [lambda q=q, k=k, v=v, kw=kw: b4.flash_sdpa(
            q, k.transpose(1, 2), v.transpose(1, 2), **kw)] * 3
    l2_bytes = 50 * 2 ** 20
    for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                              ("e5m2", torch.float8_e5m2)):
        for label, cap, kv_len, kv_start, window in (
                ("run (a)", 2304, [2100, 1500, 1990, 777], [0, 211, 1003, 37],
                 None),
                ("run (d)", 4864, [4639], [108], 4096)):
            b = len(kv_len)
            q = torch.randn(b, 1, hq, d, generator=gen, device=dev).to(
                torch.bfloat16)
            k = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
                kv_dtype)
            v = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
                kv_dtype)
            lay = 2 * k.numel() * k.element_size()
            copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(
                -(-2 * l2_bytes // lay))]
            kw = dict(kv_len=torch.tensor(kv_len, dtype=torch.int32,
                                          device=dev),
                      kv_start=torch.tensor(kv_start, dtype=torch.int32,
                                            device=dev), window=window)
            out[f"b3 {kv_name} {label}"] = [
                lambda q=q, kc=kc, vc=vc, kw=kw: b3.decode_sdpa(
                    q, kc, vc, **kw)
                for kc, vc in copies * max(1, 24 // len(copies))]
    return out


def width_cases(torch, dev, gen, b1, b3, b4) -> dict:
    """B1 at head_dim 128, 256 and 80, B3 and B4 at 256, 96 and 80
    (module docstring): label -> list of calls."""
    out = {}
    r, ps, maxp = 8, 128, 16
    tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)).to(
        torch.int32).reshape(r, maxp)
    kv_len = torch.tensor(LENS, dtype=torch.int32, device=dev)
    for d, h, cs in ((128, 32, (1, 4, 128)), (256, 16, (1, 128)),
                     (80, 32, (1, 128))):
        kp = torch.randn(1 + r * maxp, h, ps, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        vp = torch.randn(1 + r * maxp, h, ps, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        for c in cs:
            q = torch.randn(r, c, h, d, generator=gen, device=dev).to(
                torch.bfloat16)
            chunk = torch.full((r,), c, dtype=torch.int32, device=dev)
            kvl = kv_len.clamp(min=c)
            out[f"b1 D={d} C={c} (graph)"] = [
                lambda q=q, kp=kp, vp=vp, kvl=kvl, chunk=chunk:
                    b1.ragged_paged_sdpa(q, kp, vp, tables, kvl, chunk)] * 10
    s, lens = 4096, [64, 700, 1500, 2047, 2048, 2600, 3500, 4096]
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    for d, hq, hkv in ((256, 16, 8), (96, 32, 32), (80, 32, 32),
                       (128, 32, 2)):
        k = torch.randn(r, hkv, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn(r, hkv, s, d, generator=gen, device=dev).to(
            torch.bfloat16)
        q1 = torch.randn(r, 1, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        if hq // hkv == 16:
            out[f"b3 D={d} G=16"] = [lambda q=q1, k=k, v=v: b3.decode_sdpa(
                q, k, v, kv_len=kvl)] * 10
            continue
        out[f"b3 D={d}"] = [lambda q=q1, k=k, v=v: b3.decode_sdpa(
            q, k, v, kv_len=kvl)] * 10
        qt = torch.randn(r, 128, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        kvl128 = kvl.clamp(min=128)
        qpos = (kvl128.long() - 128)[:, None] + torch.arange(128, device=dev)
        out[f"b4 D={d} T=128 x 8"] = [
            lambda q=qt, k=k, v=v, qpos=qpos, kvl=kvl128: b4.flash_sdpa(
                q, k.transpose(1, 2), v.transpose(1, 2), q_positions=qpos,
                kv_len=kvl)] * 10
    return out


B5_LENS = [1, 100, 130, 511, 900, 1300, 2047, 2048]


def b5_cases(torch, dev, gen, b5) -> dict:
    """B5 at chip_smoke.py's b5 shapes: label -> list of calls."""
    r, hq, hkv, d, ps, maxp = 8, 32, 32, 128, 128, 16
    out = {}
    for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device=dev).to(
            pool_dtype)
        vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device=dev).to(
            pool_dtype)
        tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)
                  ).to(torch.int32).reshape(r, maxp)
        for i, n in enumerate(B5_LENS):
            tables[i, -(-n // ps):] = -1
        kv_len = torch.tensor(B5_LENS, dtype=torch.int32, device=dev)
        for c in (1, 4, 128):
            q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
                torch.bfloat16)
            fn = b5.paged_decode_sdpa if c == 1 else b5.paged_prefill_sdpa
            out[f"b5 {pool_name} C={c}"] = [
                lambda fn=fn, q=q, kp=kp, vp=vp: fn(q, kp, vp, tables,
                                                    kv_len)] * 10
    return out


def time_tree(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
        for label, args in cases(torch, dev, gen, pool_dtype):
            b1.ragged_paged_sdpa(*args)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(50):
                b1.ragged_paged_sdpa(*args)
            e.record()
            e.synchronize()
            out[f"{pool_name} {label}"] = s.elapsed_time(e) / 50
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4

    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5

    for label, calls in {**dense_cases(torch, dev, gen, b3, b4),
                         **b5_cases(torch, dev, gen, b5),
                         **width_cases(torch, dev, gen, b1, b3,
                                       b4)}.items():
        out[label] = graph_ms(torch, calls)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1] == "turns":
        rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 3
        return turns(__file__, sys.argv[2], sys.argv[3], rounds)
    root = pathlib.Path(sys.argv[1]).resolve()
    if sys.argv[2] == "build":
        sys.path.insert(0, str(root))
        from ipex_llm_tpu_torch.ops.cuda import _build

        print(root.name, "build", _build.build(
            ["ragged_paged_attention", "decode_attention", "flash_attention",
             "paged_attention"]))
        return 0
    print(json.dumps({"tree": str(root), **time_tree(root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
