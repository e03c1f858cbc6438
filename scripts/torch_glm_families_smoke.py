#!/usr/bin/env python3
"""The GLM and llama-layout families on one card: B1, B3 and B4 at
GLM-4-9B's GQA group of 16 (32 query heads over 2 kv heads, head_dim 128)
against their plain versions, 2-layer decoders card against CPU,
GLM-4-9B at full width and depth through ``ServingEngine`` and
``generate()``, four more families at full width through the engine, and
a chatglm-layout checkpoint through ``from_pretrained``, from random
sym_int4 weights drawn on the card from a seed.

``chip_smoke.py`` runs this as its ``glm_families`` phase; alone, from the
root of a checkout on a machine with one CUDA card:

    python3 scripts/torch_glm_families_smoke.py [kernels] [small] [serve]
        [load]

(no step named: all four).  Steps (each fails the run on a miss; nothing
retries on the CPU):

1. ``kernels``: the cases of ``torch_gpt_families_smoke.attention_cases``
   at head_dim 128 and GLM-4-9B's 32 query heads over 2 kv heads: B1 at C
   = 1 (the key split, its 16 rows the 16 query heads of one kv head), C =
   2 and the verify chunk C = 4 (query tiles of 32 and 64 rows) and C =
   128, over bf16 and e5m2 pools of 128-slot pages; B3 at B = 8 rows of a
   2048-slot dense layer (its whole 16-row tile live), bf16 and e5m2; B4
   at 8 rows of T = 128 and 2 rows of T = 2048: every query row within
   ``ATTN_TOL_REL`` of its largest plain output, each timed as device
   time from CUDA-graph replays beside its bound and
   ``scaled_dot_product_attention``;
2. ``small``: GLM-4-9B-0414's (glm4), glm-4-9b-chat's (chatglm) and
   internlm2-chat-7b's published widths at 2 layers and a vocabulary cut
   to ``SMALL_VOCAB``, the sym_int4 weights drawn and packed on the card
   and copied to the CPU, paged (prefill chunks of 40, 17 and 29 ids, one
   decode step), on the card against the CPU: logits within 2.5% of their
   range (``torch_families_smoke.small_check``);
3. ``serve``: glm-4-9b-chat (the chatglm layout) at full width and depth
   (40 layers) through ``ServingEngine`` with
   ``torch_gpt_families_smoke.SERVE_EC`` over a bf16 pool (eight requests
   of 64-1000 ids, 32-64 new tokens, half greedy and half seeded; B1, by
   both instances, and B2 launch, no plain version runs) and
   ``generate()`` on four prompts of 1990, 1327, 611 and 203 ids, 32 new
   tokens (B2, B3 and B4 launch); then GLM-4-9B-0414 (glm4, the post
   norms), internlm2-chat-7b, Qwen-7B-Chat (its ``c_attn`` bias) and
   Baichuan2-7B-Chat at full width and ``SERVE_LAYERS`` layers, eight
   requests each through the engine;
4. ``load``: a ``LOAD_LAYERS``-layer checkpoint at glm-4-9b-chat's widths
   under the THUDM names (bf16 weights drawn on the card, written by the
   port's safetensors writer to ``TMPDIR``), through
   ``from_pretrained(load_in_low_bit="sym_int4")`` (layer 0's fused qkv
   and ``dense_h_to_4h`` planes against the CPU codec of the same
   tensors, the qkv bias as stored), then one ``generate()`` call (B2, B3
   and B4 at 128), then removed.

Printed, beside the card's name and power limit: output tok/s, TTFT mean
and max, peak device memory and the weight bytes.  Each model is freed
before the next.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("kernels", "small", "serve", "load")
SERVE_LAYERS = 8            # the four other families' (GLM-4-9B: all 40)
SMALL_VOCAB = 4096
GENERATE_LENGTHS = (1990, 1327, 611, 203)
LOAD_LAYERS = 2
D, HEADS, KV_HEADS = 128, 32, 2     # GLM-4-9B's attention: G = 16
B1_CHUNKS = (1, 2, 4, 128)


def chatglm_hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """THUDM names and ``[out, in]`` shapes of a chatglm-layout
    checkpoint (glm-4-9b-chat's ``transformer.encoder`` tree)."""
    h, f, v = hf["hidden_size"], hf["ffn_hidden_size"], \
        hf["padded_vocab_size"]
    hd, nh = hf["kv_channels"], hf["num_attention_heads"]
    qkv = (nh + 2 * hf["multi_query_group_num"]) * hd
    out = {"transformer.embedding.word_embeddings.weight": (v, h),
           "transformer.encoder.final_layernorm.weight": (h,),
           "transformer.output_layer.weight": (v, h)}
    for i in range(hf["num_layers"]):
        p = f"transformer.encoder.layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attention.query_key_value.weight": (qkv, h),
            p + "self_attention.query_key_value.bias": (qkv,),
            p + "self_attention.dense.weight": (h, nh * hd),
            p + "mlp.dense_h_to_4h.weight": (2 * f, h),
            p + "mlp.dense_4h_to_h.weight": (h, f)})
    return out


def glm_families_phase(kernels: dict, card: str, fail, device, graph_ms,
                       steps=STEPS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run,
    ``graph_ms(torch, calls)`` is device ms a call from CUDA-graph
    replays."""
    import functools

    import torch

    from ipex_llm_tpu_torch.models import random_init as ri
    from torch_families_smoke import small_check
    from torch_gpt_families_smoke import (attention_cases, generate_run,
                                          launch_gate, random_weights,
                                          reset_counts, serve_run)

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]
    dev = device
    res: dict = {"card": card, "step_s": {}}
    t_phase = time.perf_counter()
    published = {
        "glm-4-9b-chat": (ri.glm4_9b_chat_config, ri.GLM4_9B_CHAT_HF),
        "GLM-4-9B-0414": (ri.glm4_9b_0414_config, ri.GLM4_9B_0414_HF),
        "internlm2-chat-7b": (ri.internlm2_7b_config, ri.INTERNLM2_7B_HF),
        "Qwen-7B-Chat": (ri.qwen_7b_config, ri.QWEN_7B_HF),
        "Baichuan2-7B-Chat": (ri.baichuan2_7b_config, ri.BAICHUAN2_7B_HF)}

    if "kernels" in steps:
        res["kernels"] = attention_cases(
            kernels, fail, dev, graph_ms, tag="glm_families",
            model="GLM-4-9B", d=D, hq=HEADS, hkv=KV_HEADS, seed=21,
            b1_chunks=B1_CHUNKS)
        res["step_s"]["kernels"] = time.perf_counter() - t_phase

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.to("cpu") if hasattr(tree, "to") else tree

    if "small" in steps:
        t0 = time.perf_counter()
        reset_counts(kernels)
        res["small"] = {}
        for seed, label in enumerate(("GLM-4-9B-0414", "glm-4-9b-chat",
                                      "internlm2-chat-7b")):
            cfg = published[label][0](num_layers=2, vocab_size=SMALL_VOCAB)
            params = ri.random_params(cfg, "sym_int4", seed=40 + seed,
                                      device=dev)
            res["small"][label] = small_check(
                cfg, 40 + seed, dev, fail, label, forms=("paged",),
                params=to_cpu(params), paged_decode_steps=1)
            del params
        res["small_launches"] = {n: m.COUNTS.launches
                                 for n, m in kernels.items()}
        if not (b1.COUNTS.by_head_dim[D] and b2.COUNTS.launches):
            fail(f"glm_families small: launches {res['small_launches']}")
        print("glm_families small decoders card vs CPU, worst logit diff "
              "over the range (bound 0.025): " + json.dumps(res["small"]),
              flush=True)
        res["step_s"]["small"] = time.perf_counter() - t0

    if "serve" in steps:
        t0 = time.perf_counter()
        res["serve"], res["generate"] = [], []
        for seed, (label, (make, hf)) in enumerate(published.items()):
            full = label == "glm-4-9b-chat"
            cfg = make() if full else make(num_layers=SERVE_LAYERS)
            params = random_weights(label, cfg, 70 + seed, dev)
            row = serve_run(kernels, card, fail, dev, "glm_families", label,
                            cfg, params, 8, 80 + seed, (b1, b2))
            if full and not all(row["b1_by_route"].values()):
                fail(f"glm_families {label}: B1 by route "
                     f"{row['b1_by_route']}")
            res["serve"].append(row)
            if full:
                res["generate"].append(generate_run(
                    kernels, card, fail, dev, "glm_families", label, cfg,
                    hf, params, GENERATE_LENGTHS))
            del params
            torch.cuda.empty_cache()
        res["step_s"]["serve"] = time.perf_counter() - t0

    if "load" in steps:
        t0 = time.perf_counter()
        res["load"] = load_step(kernels, card, fail, dev, functools.partial(
            launch_gate, kernels, fail, "glm_families"))
        res["step_s"]["load"] = time.perf_counter() - t0
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def load_step(kernels: dict, card: str, fail, dev, gate) -> dict:
    """Step 4 of the module docstring; ``gate(what, need, head_dim)``
    checks a run's launches."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models.build import param_bytes, quantize_weight
    from ipex_llm_tpu_torch.models.loader import (CheckpointReader,
                                                  save_safetensors)
    from ipex_llm_tpu_torch.models.random_init import GLM4_9B_CHAT_HF
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM

    hf = dict(GLM4_9B_CHAT_HF, num_layers=LOAD_LAYERS,
              architectures=["ChatGLMModel"], torch_dtype="bfloat16")
    b2, b3, b4 = (kernels[n] for n in ("qmatmul", "decode_attention",
                                       "flash_attention"))
    res: dict = {"card": card, "layers": LOAD_LAYERS}
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_chatglm_load_")
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(22)
        tensors = {}
        for name, shape in sorted(chatglm_hf_shapes(hf).items()):
            w = torch.randn(shape, generator=gen, device=dev)
            if name.endswith("layernorm.weight"):
                w = 1.0 + 0.05 * w
            elif name.endswith("bias"):
                w = 0.1 * w
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
        if (cfg.model_type, cfg.num_kv_heads, cfg.rope.rotary_dim) != (
                "chatglm", 2, 64):
            fail(f"glm_families load: config {cfg}")
        reader = CheckpointReader(root)
        p = "transformer.encoder.layers.0."
        layers = model.params["layers"]
        for key, name in (("qkv", "self_attention.query_key_value.weight"),
                          ("gate_up", "mlp.dense_h_to_4h.weight")):
            want = quantize_weight(reader.get(p + name), "sym_int4")
            got = layers[key].planes(lambda t: t[0].cpu())
            if not (torch.equal(got.data, want.data)
                    and torch.equal(got.scales, want.scales)):
                fail(f"glm_families load: {key} planes differ from the CPU "
                     "codec's")
        bias = reader.get(p + "self_attention.query_key_value.bias").float()
        if not torch.equal(layers["qkv_bias"][0].cpu(), bias):
            fail("glm_families load: the qkv bias is not the stored one")
        for mod in kernels.values():
            mod.COUNTS.reset()
        ids = torch.from_numpy(np.random.default_rng(23).integers(
            3, cfg.vocab_size, (2, 300)))
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=16, eos_token_id=())
        res["generate_s"] = time.perf_counter() - t0
        if tuple(out.shape) != (2, 316) or int(out.max()) >= cfg.vocab_size:
            fail(f"glm_families load generate: {tuple(out.shape)}")
        res["generate_launches"] = gate("load generate", (b2, b3, b4), D)
        print("glm_families load " + json.dumps(res), flush=True)
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def main(argv) -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_glm_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    steps = tuple(argv) or STEPS
    if set(steps) - set(STEPS):
        print(f"torch_glm_families_smoke: steps are {STEPS}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_moe_smoke import kernel_modules
    from torch_qmatmul_ab import graph_ms

    from ipex_llm_tpu_torch.ops.cuda import _build

    def fail(msg):
        print(f"torch_glm_families_smoke: FAILED: {msg}", file=sys.stderr,
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
    res = glm_families_phase(kernels, card, fail, torch.device("cuda", 0),
                             graph_ms, steps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
