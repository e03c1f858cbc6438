#!/usr/bin/env python3
"""Time the port's dequant-matmul (B2) from one source tree, so that two
trees can be compared on one card.

    python3 scripts/torch_qmatmul_ab.py TREE build   # build TREE's kernel
    python3 scripts/torch_qmatmul_ab.py TREE time    # time it, one JSON line
    python3 scripts/torch_qmatmul_ab.py turns PARENT CHANGE [ROUNDS]

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  ``turns`` builds both trees, then
times them in alternating order (parent, change, change, parent, ...; one
process per timing, ROUNDS of each, 3 by default) in one run on
one card, and prints each case's times, its medians and the ratio of the
parent's median to the change's.

It times sym_int4 at Llama-2-7B's qkv, gate_up and down at M = 1, 8
(decode), 32 (the verify forward of spec_k 3 over 8 rows) and 128 (a
mixed tick's prefill rows), Mistral-7B's gate_up at M = 4 (generate's
decode) and 8192 (generate's prefill), every other format at Llama-2-7B's
gate_up at M = 1, 4 and 8 (the GEMV instance), and fp8_e5m2 there at M =
32 and 128 too.  Each case is the device time per call of calls captured
in a CUDA graph and replayed (:func:`graph_ms`), rotating over five
weights so that each call finds its weight out of L2 (three calls at
M=8192).  It takes the wrapper of either API: ``qmatmul(x, qt)`` or, on
trees from before the ten-format kernel, ``qmatmul_int4(x, data,
scales)`` (sym_int4 only).
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys

LLAMA = {"qkv": (4096, 12288), "gate_up": (4096, 22016),
         "down": (11008, 4096)}
FORMATS = ("sym_int4", "asym_int4", "nf4", "fp4", "sym_int5", "asym_int5",
           "sym_int8", "fp6", "fp8_e4m3", "fp8_e5m2")
CASES = ([("sym_int4", w, k, n, (1, 4, 8, 32, 128) if w == "gate_up"
           else (1, 8, 32, 128)) for w, (k, n) in LLAMA.items()]
         + [("sym_int4", "mistral gate_up", 4096, 28672, (4, 8192))]
         + [(q, "gate_up", 4096, 22016,
             (1, 4, 8, 32, 128) if q == "fp8_e5m2" else (1, 4, 8))
            for q in FORMATS[1:]])


def graph_ms(torch, calls, replays: int = 5) -> float:
    """Device ms per call of ``calls`` (a list of closures), captured once
    into a CUDA graph and replayed ``replays`` times: the kernels' time
    without the host's pace of launching them (``chip_smoke.py`` and
    ``torch_attention_ab.py`` time with it too)."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in calls:                   # warm the allocator on the stream
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        graph.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / (replays * len(calls))


def time_tree(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.quantize.core import quantize

    new = hasattr(b2, "FORMATS")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for qtype, name, k, n, ms in CASES:
        if qtype != "sym_int4" and not new:
            continue
        copies = [quantize(torch.randn(k, n, generator=g, device=dev)
                           * (1.2 / math.sqrt(k)), qtype) for _ in range(5)]
        for m in ms:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)

            def call(q, x=x):
                if new:
                    return b2.qmatmul(x, q)
                return b2.qmatmul_int4(x, q.data, q.scales)

            calls = [lambda q=q: call(q) for q in copies]
            out[f"{qtype} {name} M={m}"] = graph_ms(
                torch, calls[:3] if m == 8192 else calls * 4)
            torch.cuda.empty_cache()
        del copies
    return out


def spread(xs: list) -> float:
    return (max(xs) - min(xs)) / statistics.median(xs)


def turns(script: str, parent: str, change: str, rounds: int) -> int:
    """Build both trees, time them in alternating order, print medians."""
    for tree in (parent, change):
        subprocess.run([sys.executable, script, tree, "build"], check=True)
    runs: dict[str, list] = {parent: [], change: []}
    for i in range(2 * rounds):
        tree = (parent, change)[(i + i // 2) % 2]   # P C C P P C ...
        line = subprocess.run([sys.executable, script, tree, "time"],
                              check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[tree].append(json.loads(line))
    keys = [k for k in runs[change][0] if k != "tree"
            and k in runs[parent][0]]
    summary = {}
    for k in keys:
        mp = statistics.median(r[k] for r in runs[parent])
        mc = statistics.median(r[k] for r in runs[change])
        summary[k] = {"parent_ms": mp, "change_ms": mc,
                      "parent_over_change": mp / mc,
                      # each side's runs: (max - min) / median
                      "parent_spread": spread([r[k] for r in runs[parent]]),
                      "change_spread": spread([r[k] for r in runs[change]])}
    print(json.dumps({"medians": summary, "rounds": rounds}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1] == "turns":
        rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 3
        return turns(__file__, sys.argv[2], sys.argv[3], rounds)
    root = pathlib.Path(sys.argv[1]).resolve()
    if sys.argv[2] == "build":
        sys.path.insert(0, str(root))
        from ipex_llm_tpu_torch.ops.cuda import _build
        from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2

        print(root.name, "build", _build.build([b2.NAME]))
        return 0
    print(json.dumps({"tree": str(root), **time_tree(root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
