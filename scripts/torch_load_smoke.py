#!/usr/bin/env python3
"""The port's model API on one card at Llama-2-7B widths: write an HF
checkpoint, load it with ``from_pretrained(load_in_low_bit="sym_int4")``,
round-trip it through ``save_low_bit``/``load_low_bit``, generate from it
and serve it through ``build_server``.

``chip_smoke.py`` runs this as its ``load`` phase; alone, from the root of
a checkout on a machine with one CUDA card:

    python3 scripts/torch_load_smoke.py

Steps (each fails the run on a miss; nothing retries on the CPU):

1. write a Llama-2-7B-width checkpoint (hidden 4096, ffn 11008,
   ``N_LAYERS`` layers, 32/32 heads of 128, vocab 32000, untied head) of
   bf16 weights drawn on the card from a seeded ``torch.Generator`` (std
   0.02, norms 1 + 0.02 N), as HF-named safetensors shards of at most
   5 GB with ``model.safetensors.index.json`` and ``config.json``, with the
   port's numpy writer, into a temporary directory removed at the end;
2. ``from_pretrained`` onto the card: the peak of
   ``torch.cuda.max_memory_allocated`` over the load stays under the
   packed tree's bytes + ``PEAK_MARGIN_BYTES`` above what was allocated
   before (the margin: one layer's bf16 weights, 0.405 GB, the bf16
   embedding and head, 0.524 GB, and headroom; a loader that built the
   bf16 model on the card would need 13.5 GB); layer 0's, the last
   layer's and the head's planes are bitwise the CPU ``quantize_weight``
   of the same tensors;
3. ``save_low_bit`` then ``load_low_bit``: every tensor bitwise; four
   prompts of 64-1000 ids, 32 new tokens, greedy, through both models'
   ``generate``: the same tokens, with B2, B3 and B4 launched and no
   plain version run;
4. ``build_server(dir, tokenizer=IdTokenizer(vocab))`` with
   ``chip_smoke.py``'s serving configuration: eight ``/v1/completions``
   over 127.0.0.1 (prompts of 64-1000 ids, 32-64 new tokens, half
   greedy, half seeded) whose texts
   equal the same requests sent straight to an engine over the loaded
   tree (both engines hold their first tick until all eight wait, so both
   run the same ticks), B1 and B2 (GEMV and tiled) launched and no plain
   version run; then ``build_server`` on the ``save_low_bit`` directory
   with ``low_bit="nf4"`` reports the recorded sym_int4 in ``/health``.

Printed: write, load, save and reload seconds, load GB/s, the peak device
memory, the weight bytes, and the tok/s of ``generate`` and of the server,
beside the card's name and power limit.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# huggingface.co/meta-llama/Llama-2-7b-hf, config.json (the fields the port
# reads); N_LAYERS of its 32 layers are written
LLAMA2_7B_HF = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "pad_token_id": 0, "torch_dtype": "bfloat16"}
N_LAYERS = 32
SHARD_BYTES = 5 * 10 ** 9
PEAK_MARGIN_BYTES = 1.5e9
SERVE_EC = dict(max_rows=8, max_seq_len=2048, page_size=128,
                prefill_bucket=128, decode_horizon=4, kv_storage="bf16")
MERGES = {"qkv": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
          "o": ("self_attn.o_proj",), "gate_up": ("mlp.gate_proj",
                                                  "mlp.up_proj"),
          "down": ("mlp.down_proj",)}


def hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = h // hf["num_attention_heads"]
    q, kv = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, h)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "post_attention_layernorm.weight": (h,),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f)})
    shapes.update({"model.norm.weight": (h,), "lm_head.weight": (v, h)})
    return shapes


def write_random_checkpoint(path: str, hf: dict, seed: int, device) -> int:
    """HF-named bf16 shards drawn on ``device``; returns the bytes of the
    tensors written."""
    import torch

    from ipex_llm_tpu_torch.models.loader import save_safetensors

    shapes = hf_shapes(hf)
    groups, size = [[]], 0
    for name, shape in shapes.items():
        n = 2 * int(torch.tensor(shape).prod())
        if groups[-1] and size + n > SHARD_BYTES:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    files = [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
             for i in range(len(groups))]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = 0
    for group, file in zip(groups, files):
        tensors = {}
        for name in group:
            w = torch.randn(shapes[name], generator=gen, device=device) * 0.02
            if len(shapes[name]) == 1:
                w += 1.0
            tensors[name] = w.to(torch.bfloat16).cpu()
            total += tensors[name].numel() * 2
            del w
        save_safetensors(tensors, f"{path}/{file}", metadata={"format": "pt"})
        del tensors
    with open(f"{path}/model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": {n: fl for g, fl in zip(groups, files)
                                  for n in g}}, f)
    with open(f"{path}/config.json", "w") as f:
        json.dump(hf, f)
    return total


def _planes_equal(a, b) -> bool:
    import torch

    from ipex_llm_tpu_torch.quantize.core import QTensor
    if isinstance(b, dict):
        return set(a) == set(b) and all(_planes_equal(a[k], b[k]) for k in b)
    if isinstance(b, QTensor):
        return ((a.qtype, a.shape, a.block_size) == (b.qtype, b.shape,
                                                     b.block_size)
                and all((x is None and y is None) or (
                    x is not None and y is not None and x.dtype == y.dtype
                    and torch.equal(x, y))
                    for x, y in ((a.data, b.data), (a.scales, b.scales),
                                 (a.zeros, b.zeros))))
    if isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.device == b.device and torch.equal(
            a, b)
    return a == b


def load_phase(kernels: dict, card: str, fail, device,
               n_layers: int = N_LAYERS) -> dict:
    """The steps of the module docstring; ``kernels`` maps each kernel's
    name to its wrapper module (``COUNTS``), ``fail(msg)`` ends the run."""
    import numpy as np
    import torch

    from ipex_llm_tpu_torch.models.build import (_cat_columns, param_bytes,
                                                 quantize_weight)
    from ipex_llm_tpu_torch.models.loader import CheckpointReader
    from ipex_llm_tpu_torch.serving.api_server import build_server
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)
    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
    from torch_http_client import (Client, IdTokenizer, hold_first_tick,
                                   http_transport)

    b1, b2 = kernels["ragged_paged_attention"], kernels["qmatmul"]

    def reset():
        for mod in kernels.values():
            mod.COUNTS.reset()

    def counts() -> dict:
        return {n: (m.COUNTS.launches, m.COUNTS.plain_calls)
                for n, m in kernels.items()}

    def expect_launches(what, cs, need):
        for name, (launches, plain) in cs.items():
            if plain != 0 or (name in need and launches == 0):
                fail(f"load {what}: {name} launched {launches} times, "
                     f"plain version called {plain} times")

    hf = dict(LLAMA2_7B_HF, num_hidden_layers=n_layers)
    vocab = hf["vocab_size"]
    res: dict = {"card": card, "layers": n_layers,
                 "layers_published": LLAMA2_7B_HF["num_hidden_layers"]}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ipex_llm_tpu_torch_load_")
    ckpt, lowbit = f"{root}/hf", f"{root}/low_bit"
    try:
        pathlib.Path(ckpt).mkdir()
        free = shutil.disk_usage(root).free
        t0 = time.perf_counter()
        nbytes = write_random_checkpoint(ckpt, hf, seed=11, device=device)
        res.update(checkpoint_bytes=nbytes, disk_free_before=free,
                   write_s=time.perf_counter() - t0)
        print(f"load: wrote {nbytes / 1e9:.2f} GB ({n_layers} layers) in "
              f"{res['write_s']:.1f} s to {root} ({free / 1e9:.0f} GB "
              "free before)", flush=True)

        # -- from_pretrained onto the card ----------------------------------
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.from_pretrained(
            ckpt, load_in_low_bit="sym_int4")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        packed, dense = param_bytes(model.params)
        res.update(load_s=load_s, load_gb_s=nbytes / load_s / 1e9,
                   allocated_before=base, peak_allocated=peak,
                   peak_above_before=peak - base, packed_bytes=packed,
                   dense_bytes=dense, peak_bound=packed + PEAK_MARGIN_BYTES)
        print(f"load: from_pretrained sym_int4 {load_s:.2f} s, "
              f"{res['load_gb_s']:.2f} GB/s; weights {packed} bytes packed "
              f"({dense} at bf16); peak device memory {peak - base} bytes "
              f"above the {base} before (bound {packed} + "
              f"{PEAK_MARGIN_BYTES:.0f}); {card}", flush=True)
        if model.device.type != "cuda":
            fail(f"load: from_pretrained put the tree on {model.device}")
        if peak - base > packed + PEAK_MARGIN_BYTES:
            fail(f"load: peak device memory {peak - base} bytes above the "
                 f"start exceeds the packed tree {packed} + "
                 f"{PEAK_MARGIN_BYTES:.0f}")

        # -- the planes against the CPU codec -------------------------------
        t0 = time.perf_counter()
        reader = CheckpointReader(ckpt)
        checked = []
        for i in (0, n_layers - 1):
            for key, parts in MERGES.items():
                want = _cat_columns([quantize_weight(reader.get(
                    f"model.layers.{i}.{p}.weight"), "sym_int4")
                    for p in parts])
                got = model.params["layers"][key].planes(lambda t: t[i].cpu())
                if not _planes_equal(got, want):
                    fail(f"load: layer {i} {key} planes differ from the CPU "
                         "quantize_weight")
                checked.append(f"{i}.{key}")
        if not _planes_equal(model.params["lm_head"].to("cpu"),
                             quantize_weight(reader.get("lm_head.weight"),
                                             "sym_int4")):
            fail("load: lm_head planes differ from the CPU quantize_weight")
        res.update(planes_checked=checked + ["lm_head"],
                   cpu_check_s=time.perf_counter() - t0)

        # -- save_low_bit / load_low_bit ------------------------------------
        t0 = time.perf_counter()
        model.save_low_bit(lowbit)
        res["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = AutoModelForCausalLM.load_low_bit(lowbit)
        torch.cuda.synchronize()
        res["reload_s"] = time.perf_counter() - t0
        if not _planes_equal(again.params, model.params):
            fail("load: the load_low_bit tree differs from the saved one")
        print(f"load: save_low_bit {res['save_s']:.2f} s, load_low_bit "
              f"{res['reload_s']:.2f} s, trees bitwise equal", flush=True)

        # -- generate from both ---------------------------------------------
        rng = np.random.default_rng(61)
        lens = rng.integers(64, 1001, 4)
        ids = np.zeros((4, int(lens.max())), np.int64)
        mask = np.zeros_like(ids)
        for r, n in enumerate(lens):
            ids[r, ids.shape[1] - n:] = rng.integers(3, vocab, n)
            mask[r, ids.shape[1] - n:] = 1
        gen = {}
        for label, m in (("loaded", model), ("reloaded", again)):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = m.generate(ids, attention_mask=mask, max_new_tokens=32,
                             eos_token_id=())
            wall = time.perf_counter() - t0
            cs = counts()
            expect_launches(f"generate ({label})", cs, (
                "qmatmul", "decode_attention", "flash_attention"))
            new = int(m.last_result.num_new_tokens.sum())
            if new != 4 * 32:
                fail(f"load generate ({label}): {new} new tokens of 128")
            gen[label] = dict(out=out, wall_s=wall, tok_s=new / wall,
                              ttft_s=m.first_cost,
                              launches={k: v[0] for k, v in cs.items()})
        if not np.array_equal(gen["loaded"]["out"], gen["reloaded"]["out"]):
            fail("load: generate of the reloaded model differs from the "
                 "loaded model's")
        res["generate"] = {k: {kk: vv for kk, vv in v.items() if kk != "out"}
                           for k, v in gen.items()}
        res["generate"]["prompt_lens"] = [int(n) for n in lens]
        print("load: generate " + json.dumps(res["generate"]), flush=True)
        del again
        torch.cuda.empty_cache()

        # -- build_server over the checkpoint --------------------------------
        lens = rng.integers(64, 1001, 8)
        news = rng.integers(32, 65, 8)
        prompts = [[int(v) for v in rng.integers(1, vocab, n)] for n in lens]
        bodies = []
        for i, (p, m_new) in enumerate(zip(prompts, news)):
            b = {"prompt": " ".join(map(str, p)), "max_tokens": int(m_new)}
            b.update(dict(temperature=0.8, top_p=0.9, seed=4000 + i)
                     if i % 2 else dict(temperature=0.0))
            bodies.append(b)
        t0 = time.perf_counter()
        srv = build_server(ckpt, tokenizer=IdTokenizer(vocab),
                           engine_config=EngineConfig(**SERVE_EC))
        res["build_server_s"] = time.perf_counter() - t0
        if not _planes_equal(srv.engine.params, model.params):
            fail("load: build_server's tree differs from from_pretrained's")
        hold_first_tick(srv.engine, len(bodies))
        # the order the server queued the wave in, which the direct run
        # repeats (admission order decides each tick's chunks)
        arrivals, submit = [], srv.engine.submit

        def recording_submit(req):
            arrivals.append(prompts.index(list(req.prompt_ids)))
            return submit(req)
        srv.engine.submit = recording_submit
        client = Client(srv, http_transport(),
                        lambda msg: fail(f"load serve: {msg}"))
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=8)
        reset()
        t0 = time.perf_counter()
        wave = [(st_, body) for st_, _, body in pool.map(
            lambda b: client.request("POST", "/v1/completions", b), bodies)]
        wall = time.perf_counter() - t0
        cs = counts()
        routes = dict(b2.COUNTS.by_route)
        b1_routes = dict(b1.COUNTS.by_route)
        st, _, health = client.request("GET", "/health")
        client.close()
        pool.shutdown()
        expect_launches("serve", cs, ("qmatmul", "ragged_paged_attention"))
        if routes.get("gemv", 0) == 0 or routes.get("tiled", 0) == 0:
            fail(f"load serve: an instance of B2 never launched ({routes})")
        for i, (status, body) in enumerate(wave):
            if status != 200:
                fail(f"load serve: completion {i}: {status} {body}")
        if st != 200 or health["weights"]["qtype"] != "sym_int4":
            fail(f"load serve: /health {st} {health.get('weights')}")
        out_tok = sum(b["usage"]["completion_tokens"] for _, b in wave)
        res["server"] = dict(
            transport=client.transport, requests=len(wave),
            output_tokens=out_tok, wall_s=wall, output_tok_s=out_tok / wall,
            launches={k: v[0] for k, v in cs.items()},
            b2_routes=routes, b1_routes=b1_routes,
            weights=health["weights"])
        del srv, client
        torch.cuda.empty_cache()

        eng = hold_first_tick(ServingEngine(
            model.config, model.params, EngineConfig(**SERVE_EC),
            default_eos=model.generation_config.eos_token_id), len(bodies))
        eng.start()
        reqs = [Request(prompt_ids=p, max_new_tokens=b["max_tokens"],
                        temperature=b["temperature"],
                        top_p=b.get("top_p", 1.0), seed=b.get("seed"))
                for p, b in zip(prompts, bodies)]
        t0 = time.perf_counter()
        for i in arrivals:
            eng.submit(reqs[i])
        streams = [list(stream_tokens(q, timeout=600)) for q in reqs]
        wall = time.perf_counter() - t0
        res["direct"] = dict(wall_s=wall,
                             output_tok_s=sum(map(len, streams)) / wall)
        eng.stop()
        eos = set(eng.default_eos)
        for i, ((_, body), st_) in enumerate(zip(wave, streams)):
            if st_ and st_[-1] in eos:
                st_ = st_[:-1]      # the server's text leaves the EOS out
            if body["choices"][0]["text"] != " ".join(map(str, st_)):
                fail(f"load serve: completion {i} "
                     f"({'seeded' if i % 2 else 'greedy'}) differs from the "
                     "engine's stream")
        res["server_equals_engine"] = True
        res["arrival_order"] = arrivals
        print("load: serve " + json.dumps(
            {k: res[k] for k in ("server", "direct", "build_server_s")})
            + f"; {card}", flush=True)
        del eng
        torch.cuda.empty_cache()

        # -- build_server over the save_low_bit directory --------------------
        srv = build_server(lowbit, low_bit="nf4", tokenizer=IdTokenizer(vocab),
                           engine_config=EngineConfig(**SERVE_EC))
        try:
            import asyncio
            out = asyncio.run(srv.call("GET", "/health"))
        finally:
            srv.engine.stop()
        w = out.body["weights"]
        if out.status != 200 or w["qtype"] != "sym_int4" or w[
                "requested_qtype"] != "sym_int4":
            fail(f"load: build_server on the save_low_bit directory reports "
                 f"{out.status} {w}")
        res["low_bit_dir_weights"] = w
        del srv, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_load_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    def fail(msg):
        print(f"torch_load_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kernels = {m.NAME: m for m in (b2, b1, b3, b4, b5)}
    print(f"kernel build: {_build.build(list(kernels)):.1f} s", flush=True)
    res = load_phase(kernels, card, fail, torch.device("cuda", 0))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
