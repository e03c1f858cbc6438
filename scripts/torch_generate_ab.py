#!/usr/bin/env python3
"""Time the port's ``generate()`` decode from one source tree, so that two
trees can be compared on one card.

    python3 scripts/torch_generate_ab.py TREE build   # build TREE's kernels
    python3 scripts/torch_generate_ab.py TREE time    # time it, one JSON line
    python3 scripts/torch_generate_ab.py turns PARENT CHANGE [ROUNDS]

``TREE`` is the root of a checkout (this repository, or a ``git archive``
of another commit unpacked beside it).  ``turns`` builds both trees, then
times them in alternating order (parent, change, change, parent, ...; one
process per timing, ROUNDS of each, 3 by default) and prints each
number's medians and the ratio of the parent's median to the change's
(``torch_qmatmul_ab.turns``).

Each timing builds Llama-2-7B sym_int4 at full width and depth (random
weights from a seed, no eos, so every row runs its full length), warms
``generate()`` once, then runs ``REPEATS`` greedy ``generate()`` calls of
4 prompts of 128 tokens with 64 new tokens each.  It reports, in ms, the
medians of the model's ``rest_cost_mean`` (``decode_step``: host wall
time per decode step, the first token excluded) and ``first_cost``
(``prefill``: the prefill with its first sample).  Decode is host-bound
at this shape (the device idles most of a step), so the decode step's
wall time is the host's cost of issuing it.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys

REPEATS = 5
ROWS, PROMPT, NEW = 4, 128, 64


def time_tree(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models.random_init import (llama2_7b_config,
                                                       random_params)
    from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

    cfg = llama2_7b_config()
    params = random_params(cfg, "sym_int4", seed=7,
                           device=torch.device("cuda", 0))
    model = TPUModelForCausalLM(cfg, params, {"model_type": "llama"},
                                "sym_int4")
    prompt = np.random.default_rng(9).integers(3, cfg.vocab_size,
                                               (ROWS, PROMPT))
    model.generate(prompt, max_new_tokens=8)
    rest, first = [], []
    for _ in range(REPEATS):
        out = model.generate(prompt, max_new_tokens=NEW)
        assert np.asarray(out).shape == (ROWS, PROMPT + NEW)
        rest.append(model.rest_cost_mean)
        first.append(model.first_cost)
    return {"decode_step": 1e3 * statistics.median(rest),
            "prefill": 1e3 * statistics.median(first)}


def main() -> int:
    root_dir = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root_dir))
    from torch_qmatmul_ab import turns

    if sys.argv[1] == "turns":
        rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 3
        return turns(__file__, sys.argv[2], sys.argv[3], rounds)
    root = pathlib.Path(sys.argv[1]).resolve()
    if sys.argv[2] == "build":
        sys.path.insert(0, str(root))
        from ipex_llm_tpu_torch.ops.cuda import _build
        from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
        from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
        from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2

        print(root.name, "build", _build.build(_build.sources((b2, b3, b4))))
        return 0
    print(json.dumps({"tree": str(root), **time_tree(root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
