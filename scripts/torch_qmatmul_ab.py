#!/usr/bin/env python3
"""Time the port's sym_int4 dequant-matmul (B2) from one source tree, so
that two trees can be compared on one card.

    python3 scripts/torch_qmatmul_ab.py TREE build   # build TREE's kernel
    python3 scripts/torch_qmatmul_ab.py TREE time    # time it, one JSON line

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  Build both trees first, then time
them in alternating order (parent, change, change, parent, ...) within
one session on one card, and compare medians.  It times qkv, gate_up and
down at Llama-2-7B widths and M = 1, 8, 128 and 8192 with CUDA events
(100 launches, 3 at M=8192), rotating over five weights so that each
launch finds its weight out of L2.  It takes the wrapper of either API:
``qmatmul(x, qt)`` or, on trees from before the ten-format kernel,
``qmatmul_int4(x, data, scales)``.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.quantize.core import quantize

    if sys.argv[2] == "build":
        from ipex_llm_tpu_torch.ops.cuda import _build

        print(root.name, "build", _build.build([b2.NAME]))
        return 0
    new = hasattr(b2, "FORMATS")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (k, n) in {"qkv": (4096, 12288), "gate_up": (4096, 22016),
                         "down": (11008, 4096)}.items():
        wq = quantize(torch.randn(k, n, generator=g, device=dev)
                      * (1.2 / math.sqrt(k)), "sym_int4")
        copies = [wq] + [quantize(torch.randn(k, n, generator=g, device=dev),
                                  "sym_int4") for _ in range(4)]
        for m in (1, 8, 128, 8192):
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            it = [0]

            def run():
                q = copies[it[0] % len(copies)]
                it[0] += 1
                if new:
                    b2.qmatmul(x, q)
                else:
                    b2.qmatmul_int4(x, q.data, q.scales)

            run()
            torch.cuda.synchronize()
            n_it = 3 if m == 8192 else 100
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(n_it):
                run()
            e.record()
            e.synchronize()
            out[f"{name} M={m}"] = s.elapsed_time(e) / n_it
    print(json.dumps({"tree": str(root), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
