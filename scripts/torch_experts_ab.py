#!/usr/bin/env python3
"""Time the port's expert-grouped dequant-matmul (B2e) from one source
tree, so that two trees can be compared on one card.

    python3 scripts/torch_experts_ab.py TREE build   # build TREE's kernel
    python3 scripts/torch_experts_ab.py TREE time    # time it, one JSON line
    python3 scripts/torch_experts_ab.py turns PARENT CHANGE [ROUNDS]

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  ``turns`` builds both trees, then
times them in alternating order (parent, change, change, parent, ...; one
process per timing, ROUNDS of each, 3 by default) on one card and prints
each case's medians, the ratio of the parent's median to the change's and
each side's spread (``scripts/torch_qmatmul_ab.py`` runs the same turns
for B2).

It times sym_int4 at the decode and prefill shapes of
``scripts/torch_moe_smoke.py``'s ``b2e`` step, routed as it routes them:
the experts of Mixtral-8x7B (gate_up 4096 -> 28672, down
14336 -> 4096; 8 experts, top 2) and Qwen3-30B-A3B (2048 -> 1536, 768 ->
2048; 128 experts, top 8) for a decode tick (8 tokens) and a prefill chunk
(8 x 128 tokens), each token routed to the top experts of random logits
from a fixed seed, in the engine's output dtype (bf16 at 32 pairs or
fewer, else fp32) and, on trees whose wrapper takes it, with the token
count as the bound on an expert's rows (``max_rows``, which picks the
instance).  Each case is the device time per call of a call captured in a
CUDA graph and replayed (``graph_ms``); every stack is far larger than
L2, so each call reads its experts' planes from device memory.
"""

from __future__ import annotations

import inspect
import json
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_qmatmul_ab import graph_ms, turns  # noqa: E402

# model: (experts, experts a token takes, ((weight, K, N), ...))
MODELS = {"Mixtral-8x7B": (8, 2, (("gate_up", 4096, 28672),
                                  ("down", 14336, 4096))),
          "Qwen3-30B-A3B": (128, 8, (("gate_up", 2048, 1536),
                                     ("down", 768, 2048)))}
TICKS = (("decode", 8), ("prefill", 8 * 128))


def time_tree(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
    from ipex_llm_tpu_torch.quantize.core import QTensor, quantize

    bounded = "max_rows" in inspect.signature(b2e.qmatmul_experts).parameters
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for model, (n_e, top, weights) in MODELS.items():
        for name, k, n in weights:
            qts = [quantize(torch.randn(k, n, generator=g, device=dev)
                            * (1.2 / math.sqrt(k)), "sym_int4")
                   for _ in range(n_e)]
            qt = QTensor(torch.stack([q.data for q in qts]),
                         torch.stack([q.scales for q in qts]), None,
                         "sym_int4", (k, n), qts[0].block_size)
            del qts
            for tick, tokens in TICKS:
                rng = np.random.default_rng(tokens + n_e)
                idx = np.argsort(-rng.standard_normal((tokens, n_e)),
                                 axis=1)[:, :top]
                counts = np.bincount(idx.ravel(), minlength=n_e)
                seg = torch.from_numpy(np.concatenate(
                    [[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
                p = tokens * top
                x = torch.randn(p, k, generator=g, device=dev).to(
                    torch.bfloat16)
                kw = dict(keep_f32=p > 32)
                if bounded:
                    kw["max_rows"] = tokens
                out[f"{model} {name} {tick}"] = graph_ms(
                    torch, [lambda x=x, seg=seg, kw=kw:
                            b2e.qmatmul_experts(x, seg, qt, **kw)])
            del qt
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
        from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e

        sources = list(getattr(b2e, "SOURCES", {b2e.NAME: b2e.NAME})
                       .values())
        print(root.name, "build", _build.build(sources))
        return 0
    print(json.dumps({"tree": str(root), **time_tree(root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
