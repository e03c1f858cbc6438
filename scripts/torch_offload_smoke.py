#!/usr/bin/env python3
"""Expert offload on one card: Mixtral-8x7B-v0.1 at full width, 8 of its
32 layers, sym_int4 weights drawn on the card from a seed, its 64 expert
entries (about 99 MB each) in pinned host memory, through
``offload.OffloadedMoE.generate``.

``chip_smoke.py`` runs this as its ``offload`` phase; alone, from the root
of a checkout on a machine with one CUDA card:

    python3 scripts/torch_offload_smoke.py

What it does (each check fails the run; nothing retries on the CPU):

1. the resident model's ``generate()`` (``TPUModelForCausalLM``, B2e for
   the experts) on a 512-id prompt, 32 greedy tokens;
2. the same params split (``OffloadedMoE``: the expert stacks copied to
   pinned host memory, the device copies freed) and driven twice on the
   same prompt: at a budget of ``SMALL_BUDGET_MB`` (about 15 of the 64
   entries, so every step misses and evicts) and at ``FULL_BUDGET_MB``
   (every entry stays), twice (cold: the prefill copies every entry;
   warm: every read a hit): the runs' tokens and every step's fp32
   logits bitwise equal; B2, B3 and B4 launch, B1 and B2e do not, no
   plain version runs;
3. the offloaded tokens against the resident ones: equal, or, from the
   first step where they fork, the resident token within ``FORK_ULPS``
   bf16 ulps of the offloaded top logit (the resident MoE route sums its
   experts in another order: ROADMAP queue 3).

Printed, beside the card's name and power limit: hits, misses, evictions,
the bytes copied and the copy stream's rate, tok/s at each budget and
the resident one, and the card's peak memory in each run.
"""

from __future__ import annotations

import copy
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

LAYERS = 8                  # of Mixtral-8x7B's 32
PROMPT_LEN = 512
NEW_TOKENS = 32
SMALL_BUDGET_MB = 1536.0    # about 15 entries of 99 MB
FULL_BUDGET_MB = 8192.0     # every one of the 64
# a fork between the resident and offloaded streams is a near-tie when the
# resident token's offloaded logit is within this many bf16 ulps of the
# top one (chip_smoke.py's SPEC_ULPS)
FORK_ULPS = 8


def offload_phase(kernels: dict, card: str, fail, device) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models import random_init as ri
    from ipex_llm_tpu_torch.offload import ExpertStore, OffloadedMoE
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM
    from torch_gpt_families_smoke import launch_gate, reset_counts

    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    dev = device
    res: dict = {"card": card, "layers": LAYERS}
    t_phase = time.perf_counter()
    cfg = ri.mixtral_8x7b_config(num_layers=LAYERS)
    params = ri.random_params(cfg, "sym_int4", seed=91, device=dev,
                              router_scale=3.0)
    torch.cuda.synchronize()
    res["weights_s"] = time.perf_counter() - t_phase
    prompt = np.random.default_rng(17).integers(
        3, cfg.vocab_size, PROMPT_LEN).astype(np.int64)

    # 1. the resident model
    model = TPUModelForCausalLM(cfg, params, ri.MIXTRAL_8X7B_HF, "sym_int4")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = model.generate(torch.from_numpy(prompt[None]),
                         max_new_tokens=NEW_TOKENS, eos_token_id=(),
                         do_sample=False)
    wall = time.perf_counter() - t0
    resident = np.asarray(out.cpu())[0, PROMPT_LEN:]
    res["resident"] = dict(wall_s=wall, output_tok_s=NEW_TOKENS / wall,
                           peak_memory_bytes=torch.cuda.max_memory_allocated())
    del model, out

    # 2. the offloaded drive at two budgets over one split
    t0 = time.perf_counter()
    small = OffloadedMoE(cfg, params, hbm_budget_mb=SMALL_BUDGET_MB,
                         device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["split_s"] = time.perf_counter() - t0
    host = small.store.host
    entry_bytes = sum(qt.nbytes for qt in host.values()) // (
        LAYERS * cfg.num_experts)
    res.update(entry_bytes=entry_bytes,
               host_bytes=sum(qt.nbytes for qt in host.values()),
               host_pinned=all(qt.data.is_pinned() for qt in host.values()))
    full = copy.copy(small)
    full.store = ExpertStore(host, int(FULL_BUDGET_MB * 2 ** 20), dev)
    runs = {}
    for label, off, mb in (("small", small, SMALL_BUDGET_MB),
                           ("full", full, FULL_BUDGET_MB),
                           ("full, warm", full, FULL_BUDGET_MB)):
        st = off.store
        before = (st.hits, st.misses, st.evictions, st.bytes_copied)
        reset_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = off.generate(prompt, max_new_tokens=NEW_TOKENS)[
            0, PROMPT_LEN:]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_gate(kernels, fail, "offload", f"{label} budget",
                               (b2, b3, b4), cfg.head_dim)
        for name in ("ragged_paged_attention", "qmatmul_experts"):
            if launches[name]:
                fail(f"offload {label}: {name} launched {launches[name]} "
                     "times")
        hits, misses, evictions, copied = (
            a - b for a, b in zip((st.hits, st.misses, st.evictions,
                                   st.bytes_copied), before))
        # the copy stream's time over this run's copies (a warm run has
        # none: every entry is already on the card)
        copy_s = st.copy_seconds() if copied else 0.0
        runs[label] = (toks, off.last_logits)
        row = dict(budget_mb=mb, budget_entries=mb * 2 ** 20 / entry_bytes,
                   hits=hits, misses=misses, evictions=evictions,
                   bytes_copied=copied, copy_stream_s=copy_s,
                   copy_gb_s=copied / copy_s / 1e9 if copy_s else None,
                   wall_s=wall, output_tok_s=NEW_TOKENS / wall,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches,
                   b2_by_route=dict(b2.COUNTS.by_route),
                   b3_by_head_dim=dict(b3.COUNTS.by_head_dim),
                   b4_by_head_dim=dict(b4.COUNTS.by_head_dim))
        res[label] = row
        print("offload run " + json.dumps(row), flush=True)
    (ts, ls), (tf, lf) = runs["small"], runs["full"]
    if not all(np.array_equal(ts, t) and torch.equal(ls, lg)
               for t, lg in runs.values()):
        fail("offload: the budgets' tokens or logits differ")
    warm = res["full, warm"]
    if res["small"]["evictions"] == 0 or res["full"]["evictions"] != 0 or \
            not 0 < res["full"]["misses"] <= LAYERS * cfg.num_experts or \
            warm["misses"] or warm["bytes_copied"]:
        fail(f"offload: counts {res['small']} / {res['full']} / {warm}")
    if not torch.isfinite(lf).all():
        fail("offload: logits not finite")
    res["budgets_bitwise"] = True

    # 3. against the resident stream
    fork = next((i for i in range(NEW_TOKENS) if ts[i] != resident[i]),
                None)
    res["fork_step"] = fork
    if fork is not None:
        step = lf[fork].float()
        top = float(step.max())
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        gap = (top - float(step[int(resident[fork])])) / ulp
        res["fork_gap_ulps"] = gap
        if gap > FORK_ULPS:
            fail(f"offload: step {fork} forks from the resident stream "
                 f"{gap:.1f} bf16 ulps below the top logit")
    res["tokens_equal_resident"] = fork is None
    res["phase_s"] = time.perf_counter() - t_phase
    print("offload " + json.dumps({k: v for k, v in res.items()
                                   if k not in runs}), flush=True)
    del small, full, runs
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_offload_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_offload_smoke: FAILED: {msg}", file=sys.stderr,
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
    res = offload_phase(kernels, card, fail, torch.device("cuda", 0))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
