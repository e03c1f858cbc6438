#!/usr/bin/env python3
"""Time the port's ragged paged attention (B1) from one source tree, so that
two trees can be compared on one card.

    python3 scripts/torch_attention_ab.py TREE build   # build TREE's kernel
    python3 scripts/torch_attention_ab.py TREE time    # time it, one JSON line
    python3 scripts/torch_attention_ab.py turns PARENT CHANGE [ROUNDS]

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  ``turns`` builds both trees, then
times them in alternating order (parent, change, change, parent, ...; one
process per timing, ROUNDS of each, 3 by default) in one run on
one card, and prints each case's times, its medians and the ratio of the
parent's median to the change's.

It times B1 at Llama-2-7B's attention widths (32 query and 32 kv heads of
128, page 128, 8 rows of up to 16 pages) with CUDA events over 50
launches, over bf16 and e5m2 pools, in four cases: the row mix of a mixed
tick at C=128 and at C=16 (even rows decode at 2,048 slots, odd rows take
a ragged chunk, the last two idle), the verify chunks of speculation (C=4)
and decode (C=1), both at staggered lengths of 130 to 2,048 slots.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from torch_qmatmul_ab import turns  # noqa: E402  (the shared alternation)

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
    return out


def main() -> int:
    if sys.argv[1] == "turns":
        rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 3
        return turns(__file__, sys.argv[2], sys.argv[3], rounds)
    root = pathlib.Path(sys.argv[1]).resolve()
    if sys.argv[2] == "build":
        sys.path.insert(0, str(root))
        from ipex_llm_tpu_torch.ops.cuda import _build

        print(root.name, "build", _build.build(["ragged_paged_attention"]))
        return 0
    print(json.dumps({"tree": str(root), **time_tree(root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
