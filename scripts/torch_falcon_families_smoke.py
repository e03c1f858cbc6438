#!/usr/bin/env python3
"""The falcon, starcoder2, stablelm, cohere and olmo2 families on one card:
B3 past a GQA group of 16 (Falcon-7B's 71 query heads over one kv head,
and 17 and 32), B1, B4 and B2 at Falcon-7B's shapes, against their plain
versions; 2-layer decoders card against CPU; Falcon-7B at full width and
depth through ``ServingEngine`` and ``generate()``; four more models at
full width through the engine; a Falcon-7B-width checkpoint through
``from_pretrained``, from random sym_int4 weights drawn on the card from
a seed.

``chip_smoke.py`` runs this as its ``falcon_families`` phase; alone, from
the root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_falcon_families_smoke.py [kernels] [small]
        [serve] [load]

(no step named: all four).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: the cases of ``torch_gpt_families_smoke.attention_cases``
   at head_dim 64 and Falcon-7B's 71 query heads over one kv head: B1 at
   C = 1, the verify chunk C = 4 and C = 128 (every C on the query tiles:
   71 rows a decode row, two 64-row tiles), over bf16 and e5m2 pools of
   128-slot pages; B3 at B = 8 rows of a 2048-slot dense layer (five
   16-row tiles a kv head), bf16 and e5m2, without a window and with one
   of 1000 slots; B4 at 8 rows of T = 128 and 2 rows of T = 2048; then B3
   at head_dim 128 and GQA groups of 32 and 17 over 2 kv heads (two tiles,
   the second full or of one row); every query row within
   ``ATTN_TOL_REL`` of its largest plain output, each timed as device
   time from CUDA-graph replays beside its bound and
   ``scaled_dot_product_attention``.  B2 at Falcon-7B's five linears (qkv
   4544 -> 4672, o, the MLP's up 4544 -> 18176 and down 18176 -> 4544,
   the tied head 4544 -> 65024; K = 4544 is 142 blocks of 32, not a
   multiple of 128) at M = 8 (the GEMV) and 128 (the tiled instance),
   each output row within one bf16 ulp of its largest plain output,
   timed beside its bound and ``torch.matmul`` on the bf16 weight;
2. ``small``: the six published configs of ``random_init`` (Falcon-7B and
   -40B, StarCoder2-7B with its window cut to 24 so that it binds on the
   40-id prompts, StableLM-2-1.6B, Command-R-v01, OLMo-2-7B) at 2 layers
   and a vocabulary cut to ``SMALL_VOCAB``, the sym_int4 weights drawn
   and packed on the card and copied to the CPU, paged (prefill chunks of
   40, 17 and 29 ids, one decode step), on the card against the CPU:
   logits within 2.5% of their range
   (``torch_families_smoke.small_check``);
3. ``serve``: Falcon-7B at full width and depth (32 layers) through
   ``ServingEngine`` with ``torch_gpt_families_smoke.SERVE_EC`` over a
   bf16 pool (eight requests of 64-1000 ids, 32-64 new tokens, half greedy
   and half seeded; B1 on its query tiles and B2 launch, no plain version
   runs) and ``generate()`` on four prompts of 1990, 1327, 611 and 203
   ids, 32 new tokens, within its 2048 positions (B2, B3's G = 71
   instance and B4 launch); then StarCoder2-7B (the gathered route: B3
   and B4), Command-R-v01 and OLMo-2-7B at full width and
   ``SERVE_LAYERS`` layers and StableLM-2-1.6B at its full 24, eight
   requests each through the engine; and one StarCoder2-7B request of
   ``LONG_PROMPT`` ids, past its 4096-slot window, so that the window
   binds on the card;
4. ``load``: a ``LOAD_LAYERS``-layer checkpoint at Falcon-7B's widths
   under its published names (``transformer.h.{i}.input_layernorm``,
   ``self_attention.query_key_value``; bf16 weights drawn on the card,
   written by the port's safetensors writer to ``TMPDIR``), through
   ``from_pretrained(load_in_low_bit="sym_int4")`` (layer 0's fused qkv
   and ``dense_h_to_4h`` planes against the CPU codec of the same
   tensors, the LayerNorm's bias as stored), then one ``generate()`` call
   (B2, B3 and B4 at 64), then removed.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the weight bytes.  Each model is freed
before the next.
"""

from __future__ import annotations

import functools
import json
import math
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "serve", "load")
SERVE_LAYERS = 8            # StarCoder2's, Command-R's and OLMo-2's
SMALL_VOCAB = 4096
GENERATE_LENGTHS = (1990, 1327, 611, 203)   # + 32 new: within 2048
LONG_PROMPT = 4300          # past StarCoder2-7B's 4096-slot window
LOAD_LAYERS = 2
D, HEADS, KV_HEADS = 64, 71, 1      # Falcon-7B's attention: G = 71
B1_CHUNKS = (1, 4, 128)
B3_WINDOW = 1000
# bf16 outputs: kernel and plain version may differ by one ulp of a row's
# largest output (chip_smoke.py's B2_TOL_REL)
B2_TOL_REL = 2.0 ** -7
L2_BYTES = 50 * 2 ** 20


def falcon_hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """Falcon's published names and ``[out, in]`` shapes (the old
    architecture over one kv head: one LayerNorm a block, the fused
    ``query_key_value`` of 71 + 2 heads, a tied head)."""
    h, v = hf["hidden_size"], hf["vocab_size"]
    hd = h // hf["num_attention_heads"]
    qkv = (hf["num_attention_heads"] + 2) * hd
    out = {"transformer.word_embeddings.weight": (v, h),
           "transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,)}
    for i in range(hf["num_hidden_layers"]):
        p = f"transformer.h.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "input_layernorm.bias": (h,),
            p + "self_attention.query_key_value.weight": (qkv, h),
            p + "self_attention.dense.weight": (h, h),
            p + "mlp.dense_h_to_4h.weight": (4 * h, h),
            p + "mlp.dense_4h_to_h.weight": (h, 4 * h)})
    return out


def b2_cases(b2, fail, dev, graph_ms, tag: str, shapes: dict,
             ms=(8, 128)) -> list[dict]:
    """B2 (sym_int4) at ``shapes`` (name -> (K, N)) and the row counts
    ``ms``: every output row within ``B2_TOL_REL`` of its largest plain
    output, then timed as device time from CUDA-graph replays (each call
    finds its weight out of L2) beside its bound and ``torch.matmul`` on
    the bf16 weight."""
    import torch

    from ipex_llm_tpu_torch.quantize.core import dequantize, quantize
    from torch_gpt_families_smoke import time_ms
    from torch_moe_smoke import bound

    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for wname, (k, n) in shapes.items():
        wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                      * (1.2 / math.sqrt(k)), "sym_int4")
        copies = [wq] + [wq.planes(torch.clone) for _ in
                         range(math.ceil(2 * L2_BYTES / wq.nbytes))]
        w_bf16 = dequantize(wq, torch.bfloat16)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            before = dict(b2.COUNTS.by_route)
            y = b2.qmatmul(x, wq)
            route = [r for r, c in b2.COUNTS.by_route.items()
                     if c > before[r]]
            y_plain = b2.qmatmul_plain(x, wq)
            err = (y.float() - y_plain.float()).abs().amax(dim=1)
            top = y_plain.float().abs().amax(dim=1)
            if bool((err > B2_TOL_REL * top).any()) or \
                    not torch.isfinite(y).all():
                fail(f"{tag} B2 {wname} M={m}: max abs err "
                     f"{err.max().item()} over {B2_TOL_REL} of its row")
            bms, by = bound(m * k * 2 + wq.nbytes + m * n * 2,
                            2.0 * m * n * k)
            row = dict(
                kernel="qmatmul", weight=wname, m=m, k=k, n=n, route=route,
                weight_bytes=wq.nbytes, max_abs_err=err.max().item(),
                max_rel_err=(err / top.clamp_min(1e-30)).max().item(),
                tol_rel=B2_TOL_REL,
                ms=graph_ms(torch, [lambda q=q: b2.qmatmul(x, q)
                                    for q in copies]
                            * max(1, 24 // len(copies))),
                plain_ms=time_ms(lambda: b2.qmatmul_plain(x, wq), 1),
                library_ms=graph_ms(torch, [lambda: torch.matmul(
                    x, w_bf16)] * 20),
                bound_ms=bms, bound_by=by)
            print(f"{tag} kernel " + json.dumps(row), flush=True)
            rows.append(row)
        del copies, w_bf16
        torch.cuda.empty_cache()
    return rows


def falcon_families_phase(kernels: dict, card: str, fail, device, graph_ms,
                          steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import torch

    from ipex_llm_tpu_torch.models import random_init as ri
    from torch_families_smoke import small_check
    from torch_gpt_families_smoke import (attention_cases, generate_run,
                                          launch_gate, random_weights,
                                          reset_counts, serve_run)

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    b3, b4 = kernels["decode_attention"], kernels["flash_attention"]
    dev = device
    res: dict = {"card": card, "step_s": {}}
    t_phase = time.perf_counter()
    tag = "falcon_families"
    published = {
        "Falcon-7B": (ri.falcon_7b_config, ri.FALCON_7B_HF),
        "Falcon-40B": (ri.falcon_40b_config, ri.FALCON_40B_HF),
        "StarCoder2-7B": (ri.starcoder2_7b_config, ri.STARCODER2_7B_HF),
        "StableLM-2-1.6B": (ri.stablelm2_1_6b_config, ri.STABLELM2_1_6B_HF),
        "Command-R-v01": (ri.command_r_v01_config, ri.COMMAND_R_V01_HF),
        "OLMo-2-7B": (ri.olmo2_7b_config, ri.OLMO2_7B_HF)}

    if "kernels" in steps:
        res["kernels"] = attention_cases(
            kernels, fail, dev, graph_ms, tag=tag, model="Falcon-7B", d=D,
            hq=HEADS, hkv=KV_HEADS, seed=22, b1_chunks=B1_CHUNKS,
            b3_windows=(None, B3_WINDOW))
        for g in (32, 17):
            res["kernels"] += attention_cases(
                kernels, fail, dev, graph_ms, tag=tag, model=f"G={g}",
                d=128, hq=2 * g, hkv=2, seed=g, cases=("b3",))
        h = ri.FALCON_7B_HF["hidden_size"]
        res["b2"] = b2_cases(b2, fail, dev, graph_ms, tag, {
            "qkv": (h, h + 2 * D), "o": (h, h), "up": (h, 4 * h),
            "down": (4 * h, h), "lm_head": (h, ri.FALCON_7B_HF["vocab_size"])})
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
            over = dict(num_layers=2, vocab_size=SMALL_VOCAB)
            if label == "StarCoder2-7B":
                over["sliding_window"] = 24
            cfg = make(**over)
            params = ri.random_params(cfg, "sym_int4", seed=40 + seed,
                                      device=dev)
            res["small"][label] = small_check(
                cfg, 40 + seed, dev, fail, label, forms=("paged",),
                params=to_cpu(params), paged_decode_steps=1)
            del params
            torch.cuda.empty_cache()
        res["small_launches"] = {n: m.COUNTS.launches
                                 for n, m in kernels.items()}
        if not all(m.COUNTS.launches for m in (b1, b2, b3, b4)):
            fail(f"{tag} small: launches {res['small_launches']}")
        print(f"{tag} small decoders card vs CPU, worst logit diff over the "
              "range (bound 0.025): " + json.dumps(res["small"]), flush=True)
        res["step_s"]["small"] = time.perf_counter() - t0

    if "serve" in steps:
        t0 = time.perf_counter()
        res["serve"], res["generate"] = [], []
        for seed, label in enumerate(("Falcon-7B", "StarCoder2-7B",
                                      "Command-R-v01", "OLMo-2-7B",
                                      "StableLM-2-1.6B")):
            make, hf = published[label]
            full = label in ("Falcon-7B", "StableLM-2-1.6B")
            cfg = make() if full else make(num_layers=SERVE_LAYERS)
            params = random_weights(label, cfg, 70 + seed, dev)
            need = (b2, b3, b4) if cfg.sliding_window else (b1, b2)
            row = serve_run(kernels, card, fail, dev, tag, label, cfg,
                            params, 8, 80 + seed, need)
            if label == "Falcon-7B" and (
                    row["b1_by_route"]["split"]
                    or not row["b1_by_route"]["tiles"]):
                fail(f"{tag} {label}: B1 by route {row['b1_by_route']}")
            res["serve"].append(row)
            if label == "Falcon-7B":
                res["generate"].append(generate_run(
                    kernels, card, fail, dev, tag, label, cfg, hf, params,
                    GENERATE_LENGTHS))
            if label == "StarCoder2-7B":
                res["long"] = long_request(kernels, card, fail, dev, cfg,
                                           params)
            del params
            torch.cuda.empty_cache()
        res["step_s"]["serve"] = time.perf_counter() - t0

    if "load" in steps:
        t0 = time.perf_counter()
        res["load"] = load_step(kernels, card, fail, dev, functools.partial(
            launch_gate, kernels, fail, tag))
        res["step_s"]["load"] = time.perf_counter() - t0
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def long_request(kernels: dict, card: str, fail, dev, cfg, params) -> dict:
    """One greedy request of ``LONG_PROMPT`` ids and 16 new tokens through
    an engine whose rows hold 4608 slots: past the 4096-slot window, so
    the gathered route's B3 and B4 mask the row's first slots on the
    card."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from torch_gpt_families_smoke import launch_gate, reset_counts

    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    if not LONG_PROMPT + 16 > cfg.sliding_window:
        fail("falcon_families long: the request does not pass the window")
    # a pool that holds the row's 36 pages (the default holds half the
    # worst case) and page 0, the scratch page
    eng = ServingEngine(cfg, params, EngineConfig(
        max_rows=1, max_seq_len=4608, page_size=128, pool_pages=37,
        prefill_bucket=512), device=dev)
    ids = np.random.default_rng(17).integers(1, cfg.vocab_size, LONG_PROMPT)
    req = Request(prompt_ids=[int(v) for v in ids], max_new_tokens=16)
    reset_counts(kernels)
    torch.cuda.synchronize()
    eng.start()
    t0 = time.perf_counter()
    eng.submit(req)
    toks = list(stream_tokens(req, timeout=900))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.stop()
    launches = launch_gate(kernels, fail, "falcon_families", "long request",
                           (b2, b3, b4), cfg.head_dim)
    if req.finish_reason != "length" or len(toks) != 16 or not all(
            0 <= v < cfg.vocab_size for v in toks):
        fail(f"falcon_families long: finished {req.finish_reason} with "
             f"{len(toks)} tokens")
    row = dict(model="StarCoder2-7B", card=card, layers=cfg.num_layers,
               prompt_tokens=LONG_PROMPT, new_tokens=len(toks),
               window=cfg.sliding_window, wall_s=wall,
               ttft_s=req.first_token_s, launches=launches)
    print("falcon_families long " + json.dumps(row), flush=True)
    del eng
    return row


def load_step(kernels: dict, card: str, fail, dev, gate) -> dict:
    """Step 4 of the module docstring; ``gate(what, need, head_dim)``
    checks a run's launches."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models.build import param_bytes, quantize_weight
    from ipex_llm_tpu_torch.models.loader import (CheckpointReader,
                                                  save_safetensors)
    from ipex_llm_tpu_torch.models.random_init import FALCON_7B_HF
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM

    hf = dict(FALCON_7B_HF, num_hidden_layers=LOAD_LAYERS,
              architectures=["FalconForCausalLM"], torch_dtype="bfloat16")
    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    res: dict = {"card": card, "layers": LOAD_LAYERS}
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_falcon_load_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(22)
        tensors = {}
        for name, shape in sorted(falcon_hf_shapes(hf).items()):
            w = torch.randn(shape, generator=gen, device=dev)
            if "layernorm" in name or "ln_f" in name:
                w = 1.0 + 0.05 * w if name.endswith("weight") else 0.05 * w
            else:
                w = w * (1.2 / shape[-1] ** 0.5)
            tensors[name] = w.to(torch.bfloat16).cpu()
        total = sum(t.numel() * 2 for t in tensors.values())
        save_safetensors(tensors, f"{root}/model.safetensors",
                         metadata={"format": "pt"})
        del tensors
        with open(f"{root}/config.json", "w") as f:
            json.dump(hf, f)
        res.update(checkpoint_bytes=total, write_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.from_pretrained(
            root, load_in_low_bit="sym_int4", device=dev)
        torch.cuda.synchronize()
        res.update(load_s=time.perf_counter() - t0,
                   weight_bytes=param_bytes(model.params)[0])
        cfg = model.config
        if (cfg.model_type, cfg.num_heads, cfg.num_kv_heads,
                cfg.parallel_blocks) != ("falcon", HEADS, KV_HEADS, True):
            fail(f"falcon_families load: config {cfg}")
        reader = CheckpointReader(root)
        p = "transformer.h.0."
        layers = model.params["layers"]
        for key, name in (("qkv", "self_attention.query_key_value.weight"),
                          ("up", "mlp.dense_h_to_4h.weight")):
            want = quantize_weight(reader.get(p + name), "sym_int4")
            got = layers[key].planes(lambda t: t[0].cpu())
            if not (torch.equal(got.data, want.data)
                    and torch.equal(got.scales, want.scales)):
                fail(f"falcon_families load: {key} planes differ from the "
                     "CPU codec's")
        for key in ("attn_norm_bias", "mlp_norm_bias"):
            if not torch.equal(layers[key][0].cpu(), reader.get(
                    p + "input_layernorm.bias").float()):
                fail(f"falcon_families load: {key} is not the stored "
                     "input_layernorm.bias")
        for mod in kernels.values():
            mod.COUNTS.reset()
        ids = torch.from_numpy(np.random.default_rng(23).integers(
            3, cfg.vocab_size, (2, 300)))
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=16, eos_token_id=())
        res["generate_s"] = time.perf_counter() - t0
        if tuple(out.shape) != (2, 316) or int(out.max()) >= cfg.vocab_size:
            fail(f"falcon_families load generate: {tuple(out.shape)}")
        res["generate_launches"] = gate("load generate", (b2, b3, b4), D)
        print("falcon_families load " + json.dumps(res), flush=True)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_falcon_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_falcon_families_smoke: steps are {STEPS}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_falcon_families_smoke: FAILED: {msg}", file=sys.stderr,
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
    res = falcon_families_phase(kernels, card, fail, torch.device("cuda", 0),
                                graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
