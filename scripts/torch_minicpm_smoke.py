#!/usr/bin/env python3
"""The MiniCPM families on one card: B1, B3 and B4 at MiniCPM's widths
against their plain versions, 2-layer MiniCPM-2B and MiniCPM3-4B decoders
card against CPU, and both at full width through ``ServingEngine`` and
``generate()``, from random sym_int4 weights drawn on the card from a
seed.

``chip_smoke.py`` runs this as its ``minicpm`` phase; alone, from the root
of a checkout on a machine with one CUDA card:

    python3 scripts/torch_minicpm_smoke.py [kernels] [small] [serve]

(no step named: all three).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: the cases of ``torch_gpt_families_smoke.attention_cases``
   (B1 at C = 1 and 4, the key split, and C = 128, the query tiles, over
   bf16 and e5m2 pools of 128-slot pages; B3 at B = 8 rows of a 2048-slot
   dense layer, bf16 and e5m2; B4 at 8 rows of T = 128 and 2 rows of T =
   2048), every query row within ``ATTN_TOL_REL`` of its largest plain
   output, each timed as device time from CUDA-graph replays beside its
   bound and ``scaled_dot_product_attention``: B1, B3 and B4 at (64, 64)
   at MiniCPM-2B's 36 heads (G = 1) and Llama-3.2-1B's 32 over 8 (G = 4),
   at (96, 64) at MiniCPM3-4B's 40 MLA heads, and B1 at (96, 96) at
   Phi-3-mini's 32 heads (a paged model at 96 with no window);
2. ``small``: MiniCPM-2B's and MiniCPM3-4B's published widths at 2 layers
   and a vocabulary cut to ``SMALL_VOCAB``, the sym_int4 weights drawn and
   packed on the card and copied to the CPU, paged (prefill chunks of 40,
   17 and 29 ids, one decode step), on the card against the CPU: logits
   within 2.5% of their range (``torch_families_smoke.small_check``);
3. ``serve``: MiniCPM-2B at full width and depth (40 layers) and
   MiniCPM3-4B at full width and ``SERVE_LAYERS`` of its 62 layers (every
   layer runs the same kernels), each through ``ServingEngine`` with
   ``torch_gpt_families_smoke.SERVE_EC`` over a bf16 pool (eight requests
   of 64-1000 ids, 32-64 new tokens, half greedy and half seeded; B1 and
   B2 launch, no plain version runs) and ``generate()`` on four prompts of
   1990, 1327, 611 and 203 ids, 32 new tokens (B2, B3 and B4 launch).

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the weight bytes.  Each model is freed
before the next.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "serve")
SERVE_LAYERS = 8            # MiniCPM3-4B's (MiniCPM-2B: all 40)
SMALL_VOCAB = 4096
GENERATE_LENGTHS = (1990, 1327, 611, 203)
# (model, K width, V width, query heads, kv heads, kernels)
KERNEL_CASES = (
    ("MiniCPM-2B", 64, 64, 36, 36, ("b1", "b3", "b4")),
    ("Llama-3.2-1B", 64, 64, 32, 8, ("b1", "b3", "b4")),
    ("MiniCPM3-4B", 96, 64, 40, 40, ("b1", "b3", "b4")),
    ("Phi-3-mini", 96, 96, 32, 32, ("b1",)),
)


def minicpm_phase(kernels: dict, card: str, fail, device, graph_ms,
                  steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import torch

    from ipex_llm_tpu_torch.models import random_init as ri
    from torch_families_smoke import small_check
    from torch_gpt_families_smoke import (attention_cases, generate_run,
                                          random_weights, reset_counts,
                                          serve_run)

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    dev = device
    res: dict = {"card": card, "step_s": {}}
    t_phase = time.perf_counter()
    published = {"MiniCPM-2B": (ri.minicpm_2b_config, ri.MINICPM_2B_HF),
                 "MiniCPM3-4B": (ri.minicpm3_4b_config, ri.MINICPM3_4B_HF)}

    if "kernels" in steps:
        res["kernels"] = []
        for i, (model, d, dv, hq, hkv, cases) in enumerate(KERNEL_CASES):
            res["kernels"] += attention_cases(
                kernels, fail, dev, graph_ms, tag="minicpm", model=model,
                d=d, dv=dv, hq=hq, hkv=hkv, seed=20 + i, cases=cases)
        res["step_s"]["kernels"] = time.perf_counter() - t_phase

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.to("cpu") if hasattr(tree, "to") else tree

    if "small" in steps:
        t0 = time.perf_counter()
        reset_counts(kernels)
        res["small"] = {}
        for seed, (label, (make, _)) in enumerate(published.items()):
            cfg = make(num_layers=2, vocab_size=SMALL_VOCAB)
            params = ri.random_params(cfg, "sym_int4", seed=40 + seed,
                                      device=dev)
            res["small"][label] = small_check(
                cfg, 40 + seed, dev, fail, label, forms=("paged",),
                params=to_cpu(params), paged_decode_steps=1)
            del params
        res["small_launches"] = {
            "ragged_paged_attention": dict(b1.COUNTS.by_head_dim)}
        if not (b1.COUNTS.by_head_dim[64] and b1.COUNTS.by_head_dim[96]
                and b2.COUNTS.launches):
            fail(f"minicpm small: launches {res['small_launches']}")
        print("minicpm small decoders card vs CPU, worst logit diff over "
              "the range (bound 0.025): " + json.dumps(res["small"]),
              flush=True)
        res["step_s"]["small"] = time.perf_counter() - t0

    if "serve" in steps:
        t0 = time.perf_counter()
        res["serve"], res["generate"] = [], []
        for seed, (label, (make, hf)) in enumerate(published.items()):
            cfg = make() if label == "MiniCPM-2B" else make(
                num_layers=SERVE_LAYERS)
            params = random_weights(label, cfg, 70 + seed, dev)
            res["serve"].append(serve_run(
                kernels, card, fail, dev, "minicpm", label, cfg, params, 8,
                80 + seed, (b1, b2)))
            res["generate"].append(generate_run(
                kernels, card, fail, dev, "minicpm", label, cfg, hf, params,
                GENERATE_LENGTHS))
            del params
            torch.cuda.empty_cache()
        res["step_s"]["serve"] = time.perf_counter() - t0
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_minicpm_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_minicpm_smoke: steps are {STEPS}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_minicpm_smoke: FAILED: {msg}", file=sys.stderr,
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
    res = minicpm_phase(kernels, card, fail, torch.device("cuda", 0),
                        graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
