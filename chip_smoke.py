#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ipex_llm_tpu_torch``) on one NVIDIA GPU
and check it.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (there is no fallback):

1. device: the card's name and power limit, the torch and CUDA versions,
   the build of every CUDA kernel (one ``nvcc`` per source, all started
   together), no register spills in B2's, B2e's, B3's, B4's and B5's
   sources, and
   the tensor-core instructions in the SASS of B2's GEMV and tiled
   instances, of B2e's gemv and tiled instances, of B1's, of B3's and of
   B5's split pass (``HMMA``, from ``mma.sync``) and of B4's and B2e's
   wgmma instance (``HGMMA``, from ``wgmma``): each instance must have
   some;
2. ``b2``: the dequant-matmul in each of its ten block formats against
   its plain PyTorch version at the five Llama-2-7B weight shapes and M =
   1, 2, 4, 8 (decode) and 128 (the prefill tokens of a mixed tick at
   ``prefill_bucket`` 128), plus in sym_int4 M = 32 (the verify forward of
   ``spec_k`` 3 over 8 rows) and, off the serving path, M = 512 as a
   larger prefill (3, 13 and 100 checked only), each output row
   to one bf16 ulp of its largest value, with the instance that ran
   (``route``: the GEMV for M <= 8, one launch a call, the tiled
   tensor-core product above), the kernel's and ``torch.matmul`` on the
   dequantized weight's device times (from CUDA-graph replays), the plain
   version's time, and the card's least time for the work; a profile of
   one GEMV call shows no reduce kernel; in every format, the tiled
   instance at small K and ragged M (9 to 100; N of 200 and 384; bf16 and
   fp32 out), checked only; then ``codec``: one 4096x4096
   weight quantized in the nine other formats on the card and on the CPU,
   every plane byte-equal;
3. ``b1``: ragged paged attention against its plain version on decode,
   chunk (width 128 and 16) and idle rows, and on the verify chunks of
   ``spec_k`` 3 (C=4), at 32 heads, head_dim 128 (its head_dim-256
   instances in ``rope_families``), page 128, and at GQA
   (32 query heads over 8 kv heads: decode and C=128) and at Qwen2-7B's
   group of 7 (28 query heads over 4 kv heads: decode, C=4 and C=128),
   over bf16 and e5m2 pools, with the instance that ran (``route``: query
   tiles, or the key split and its merge for G*C <= 16) and
   ``scaled_dot_product_attention``
   over the gathered pages as the library yardstick; then ``b5``: split
   paged attention against its plain version at the same widths, rows of
   1 to 2048 slots with -1 table tails, in decode (C=1), at the verify
   width of ``spec_k`` 3 (C=4) and at C=128, over bf16 and e5m2 pools,
   and B1 against B5 on the same inputs (B5 is B1's oracle; it is off the
   serving path), B5, B1 and SDPA timed as device time from CUDA-graph
   replays; then ``spec_verify``: one B1 launch over [R, 4] verify
   chunks against the four B5 decode launches the same tokens cost
   without speculation;
4. ``decoder``: a small GQA decoder on the card against the same decoder on
   the CPU's plain versions, paged form (prefill plus decode steps), in
   each of the ten formats;
5. ``serve``: serving at Llama-2-7B widths (random sym_int4 weights from a
   seed): eight requests through ``ServingEngine`` over a bf16 pool, then
   two over an e5m2 pool; then ``serve_spec``: prompt-lookup speculative
   decoding (``spec_k`` 3, horizon 4) on eight requests of 48 new tokens,
   four prompts repeating a 16-id pattern, four not, against the same
   engine with ``spec_k`` 0 and the sequential engine's host walk (its
   oracle): until the first fork each token's logprobs agree within
   ``SPEC_ULPS`` bf16 ulps of the top logit, and a greedy stream forks only
   where both tokens lie within as many ulps of it; then two over an e5m2
   pool;
   then ``serve_formats``: one random bf16 tree
   that the engine repacks (``EngineConfig(weight_qtype=F)``) into each of
   the nine other formats, and a tree with a sym_int8 lm head over a
   sym_int4 body ("mixed"), two requests each (prompts of 300 and 700 ids,
   24 new tokens, greedy and seeded sampling).  In each run every kernel
   of the path must have launched (B2 in the run's formats) and no plain
   version may have run;
   then ``serve_http``: the OpenAI/TGI front end (``OpenAIServer``) over
   the same weights and the serving configuration, over 127.0.0.1 when
   aiohttp imports and else through its route coroutines in process
   (``"transport"``): eight ``/v1/completions`` at once (prompts of
   64-1000 ids, 32-64 new tokens, half greedy, half seeded), whose texts
   must equal token for token the same requests sent straight to an
   engine of the same configuration; two SSE chat streams in flight, a
   stop string, a TGI ``/generate_stream`` and its ``/trace/{id}``; a
   1000-id prompt with a 0.05 s deadline (408, and an SSE error event);
   ``/metrics`` in both forms, ``/debug/flight``, ``/v1/models``,
   ``/health``; then an engine of one row and a queue of one: 429, a
   drain, ``/health`` "draining", 503.  B1 and B2 (GEMV and tiled) must
   launch and no plain version run; output tok/s and TTFT p50/p95 of the
   server and of the engine alone are printed with the card;
   then ``serve_faults``: the transactional tick on five requests (64-1000
   ids, 24 new tokens; greedy, seeded and engine-seeded sampling), all
   waiting before the first tick so that every run runs the same ticks:
   clean; a ``TransientFault`` at the second hit of page-alloc,
   mixed-step, decode-dispatch and sample; a real ``torch.OutOfMemoryError``
   (from a ``torch.empty`` larger than the card) at decode-dispatch; a
   ``DeterministicFault`` bound to a decoding request.  Each retry (one a
   run) and the isolation's survivors must equal the clean run bitwise in
   tokens and logprobs, the culprit alone finish "error" with its pages
   back; each run prints its wall time, committed ticks, bisection probes
   and B1's and B2's launches;
   then ``load`` (``scripts/torch_load_smoke.py``): the model API over a
   Llama-2-7B-width HF checkpoint written with random bf16 weights (all
   32 layers, sharded safetensors): ``from_pretrained(load_in_low_bit=
   "sym_int4")`` onto the card under a peak of the packed tree + 1.5 GB,
   layer 0's, the last layer's and the head's planes bitwise the CPU
   codec's, ``save_low_bit``/``load_low_bit`` bitwise, both models'
   greedy ``generate`` equal (B2, B3, B4), ``build_server`` over the
   checkpoint answering eight completions equal to an engine's over the
   loaded tree (B1, B2), and over the low-bit directory reporting its
   recorded width; write, load, save and reload seconds, load GB/s, peak
   memory and tok/s printed with the card;
   then ``sticky_fault``: ``scripts/torch_sticky_fault.py`` in a child
   process raises a real device-side assert inside a tick; the engine
   must classify it not transient and end in ``_fail_all`` (``errors``
   1, every request "error"), its thread must end, ``/health`` answer
   503 "dead" and a later request fail at once;
6. ``b3``: dense decode attention against its plain version at
   Mistral-7B widths (32 query heads over 8 kv heads of 128), B=4,
   capacity 2304, ragged ``kv_start``/``kv_len``, over bf16 and e5m2
   caches: window off, a 1024 window that cuts, and softcap 50; then at
   run (d)'s decode shape (B=1, capacity 4864, the 4096 window cutting);
   each timed as device time per call from a CUDA graph of many calls (a
   call's host work, not the card, would pace eager launches), as is
   ``scaled_dot_product_attention`` beside it; then, checked only, G = 1,
   2, 4 and 8 over bf16 and e5m2 at a capacity of 700 (not a multiple of
   the 64-key tile), ragged kv_len, left padding, a row that sees no key
   and a per-row window enable, with the window and with softcap 50; then
   the head_dim-256 instance at Gemma-2-9B's heads (16 over 8 kv heads),
   B=4 and 8 over the engine's gathered capacity of 6144, bf16 and e5m2,
   the 4096 window cutting, alone (SDPA beside it) and with softcap 50;
7. ``b4``: flash attention against its plain version: B=4, T=2048 left
   padded (the bucket of the generate phase); B=1, T=4608 with the 4096
   window, which cuts; softcap and non-causal cases at a small T; then,
   checked only, T = 200 and 1000 (not multiples of the 64-query tile) at
   G = 1 and 4: left padding with a window that cuts, softcap 50, and
   non-causal with kv_len < S; then the head_dim-256 instance at
   Gemma-2-9B's heads over a 6144-slot layer with per-row query slots and
   the 4096 window: T=128 chunks (8 rows), the T=4 verify width (8 rows)
   and a T=2048 prompt (2 rows), each alone (SDPA beside it) and with
   softcap 50 (every B4 row timed from CUDA-graph replays);
8. ``b2m``: B2 at Mistral-7B's weight shapes, M=4 (decode) and M=8192
   (the largest prefill, 4 rows x 2048); then ``b2f``: sym_int4 at
   Qwen2-7B's and Gemma-2-9B's weight shapes, M = 1, 8 and 128, timed,
   and the nine other formats checked at K = 18944 and 14336;
9. ``mistral``: a small windowed GQA mistral on the card against the same
   model on the CPU's plain versions, dense form (left-padded prefill and
   decode steps, the window cutting);
10. ``generate``: ``model.generate`` at Mistral-7B-v0.1 widths (random
    sym_int4 weights from a seed) through the model class: (a) four
    prompts left padded to 2048, 64 new tokens, greedy, bf16 cache; (b)
    the same sampled; (c) (a) over an e5m2 cache; (d) one prompt of 4500
    ids, 32 new tokens, so that the window masks keys in B4 and in B3.
    Every row must produce its tokens, and B2, B3 and B4 must launch with
    no plain call.  Then run (a)'s prefill and decode loop by stage, once
    for the host wall clock and once under ``torch.profiler`` for the
    kernels' device time: each stage's device idle share, launches per
    step and largest kernels;
11. ``families`` (``scripts/torch_families_smoke.py``): small qwen2 (B1
    at G = 7) and gemma2 (B3 and B4 at head_dim 256) decoders card
    against CPU, paged and dense; Mistral-7B-v0.1, Qwen2-7B and
    Gemma-2-9B at full width, 8 layers each, through ``ServingEngine`` (eight
    requests of 64-5000 ids over a bf16 pool, two over e5m2; the windowed
    ones on the gathered route, B1 never launched), the gather's share of
    one decode tick's device time, and ``generate()`` for Qwen2-7B and
    Gemma-2-9B (a 4500-id prompt among four), with tok/s, TTFT and peak
    device memory;
12. ``rope_families`` (``scripts/torch_rope_families_smoke.py``): every
    rope kind's table, mscale and cos/sin card against CPU; B1's
    head_dim-256 instances (Gemma-7B's and Gemma-3-4B's heads, C = 1, 4
    and 128, bf16 and e5m2 pools) and B3's and B4's head_dim-96 instances
    (Phi-3-mini's heads, the 2047 window cutting; B4 at the gathered
    route's 8 x 128 chunks and at T = 4) against their plain versions,
    timed from CUDA-graph replays beside their bounds and SDPA; small
    phi3, gemma and gemma3 decoders and 2-layer Llama-3.1-8B (llama3)
    and Phi-3.5-mini (longrope over a partial rotary of 0.75) decoders
    card against CPU; Phi-3-mini-4k, Gemma-7B and Gemma-3-4B at full width
    and depth through ``ServingEngine`` (eight requests of 64 ids to near
    the model's limit, two over e5m2) with the attention kernels following
    the layers (Gemma-7B B1 only, Gemma-3-4B B1 on its full layers and
    B3/B4 on its sliding ones, Phi-3-mini B3/B4 at 96 only), and a
    Gemma-3-4B ``generate()``;
13. ``moe`` (``scripts/torch_moe_smoke.py``): B2e, the expert-grouped
    dequant-matmul, each of its instances (gemv, wgmma, tiled) against its
    plain version in every format (segments of 0 to 640 rows, both output
    types, a second call bitwise the first) and at Mixtral-8x7B's and
    Qwen3-30B-A3B's expert shapes for a decode tick, a verify forward and
    a mixed tick's prefill at two budgets, checked again there and timed
    beside its bound and ``torch._grouped_mm``; small Mixtral-,
    Qwen1.5-MoE-, Qwen3-MoE- and Qwen3-shaped decoders card against CPU
    (both dispatch routes, equal expert selections where the router is
    sure); Mixtral-8x7B and Qwen3-30B-A3B at full width, 8 layers each, through
    ``ServingEngine`` at the engine's default prefill budget (B1, B2,
    B2e's gemv and tiled instances) and at a budget of 1024 tokens (gemv
    and wgmma; B1 at G = 8 for Qwen3), one decode tick of each profiled (B2e's share, the idle
    share), Mixtral ``generate()`` (B2, B3, B4, B2e's gemv and wgmma); a
    2-layer Mixtral-width checkpoint through ``from_pretrained`` and
    ``build_server``.
14. ``deepseek`` (``scripts/torch_deepseek_smoke.py``): B1, B3 and B4 at
    DeepSeek's MLA widths (K 192, V 128) against their plain versions (B1
    at V2-Lite's 16 heads and V3's 128, C = 1, 4 and 128, bf16 and e5m2
    pools; B3 at B = 4 and 8; B4 at T = 128 x 8 and 2048 x 2), timed
    beside their bounds and SDPA; tiny DeepSeek-V2 and V3 decoders card
    against CPU (equal expert selections where the selection is clear);
    DeepSeek-V2-Lite at full width, 8 layers (1 dense, 7 MoE), through
    ``ServingEngine`` (eight requests over a bf16 pool, two over e5m2; B1,
    B2 and B2e), one decode tick profiled, and its ``generate()`` (B2,
    B2e, B3, B4); DeepSeek-V3 at full width, its 3 dense prefix layers and
    1 MoE layer, through the engine (B1 at 128 heads; the first tick's
    expert selections against the CPU's ``route`` where clear); a 2-layer
    V2-Lite-width checkpoint through ``from_pretrained`` and
    ``build_server``.
15. ``gpt_families`` (``scripts/torch_gpt_families_smoke.py``): B1, B3
    and B4 at head_dim 80 against their plain versions (B1 at Phi-2's 32
    heads, C = 1, 4 and 128, bf16 and e5m2 pools; B3 at B = 8 over bf16
    and e5m2; B4 at T = 128 x 8 and 2048 x 2), timed beside their bounds
    and SDPA; 2-layer Phi-2, phixtral, Pythia-6.9B and GPT-J-6B decoders
    at their published widths (the vocabulary cut) card against CPU
    (phixtral's card forward on the CPU's expert selections); Phi-2 at
    full width and depth and phixtral, Pythia-6.9B and GPT-J-6B at full
    width, 8 layers, through ``ServingEngine`` (eight requests over a bf16
    pool; B1 at 80, 128 and 256, B2, B2e for phixtral), Phi-2's
    ``generate()`` (B3 and B4 at 80); a 4-layer Phi-2-width checkpoint
    through ``from_pretrained``, ``save_low_bit``/``load_low_bit``
    (bitwise) and ``generate()``.
16. ``offload`` (``scripts/torch_offload_smoke.py``): expert offload.
    Mixtral-8x7B-v0.1 at full width, 8 of its 32 layers, sym_int4: the
    resident ``generate()`` on a 512-id prompt, 32 greedy tokens, then
    the same params split by ``OffloadedMoE`` (the 64 expert entries of
    about 99 MB in pinned host memory, each miss a ``non_blocking`` copy
    on a copy stream) at a 1,536 MB budget (about 15 entries: every step
    misses and evicts) and at one that holds every entry, cold and warm:
    every run's tokens and logits bitwise equal, B2, B3 and B4 launched,
    no plain version; the tokens the resident ones, or a fork at a
    near-tie; hits, misses, evictions, bytes copied, the copy stream's
    rate, tok/s and peak memory in each run.
17. ``minicpm`` (``scripts/torch_minicpm_smoke.py``): B1, B3 and B4 at
    (64, 64) (MiniCPM-2B's 36 heads and Llama-3.2-1B's 32 over 8) and at
    (96, 64) (MiniCPM3-4B's 40 MLA heads), and B1 at (96, 96) (Phi-3-mini's
    32 heads, off this slice's serving path), against their plain versions
    and timed beside their bounds and SDPA (the cases of
    ``torch_gpt_families_smoke.attention_cases``); 2-layer MiniCPM-2B and
    MiniCPM3-4B decoders at their published widths (the vocabulary cut)
    card against CPU; MiniCPM-2B at full width and depth (40 layers) and
    MiniCPM3-4B at full width, 8 of its 62 layers, through
    ``ServingEngine`` (eight requests over a bf16 pool: B1, B2) and
    ``generate()`` (B2, B3, B4).
18. ``train`` (``scripts/torch_train_smoke.py``): the training path's
    kernels, B4's LSE instance and backward (causal, T = 1, 63, 1024 and
    2048, G = 1 and 4, ``kv_start`` > 0 on a row; dQ, dK, dV per row
    within 2^-6 of the row's largest plain value, bitwise on a second
    call) and B2^T (``dy @ dequant(W)^T`` in all ten formats at
    Llama-2-7B's shapes, M = 2048, within one bf16 ulp), each timed at
    the step's shapes beside its bound and SDPA's autograd backward or
    ``torch.matmul``; a 2-layer Llama-2-7B-width QLoRA loss and adapter
    gradients card against CPU; six Llama-2-7B sym_int4 QLoRA steps at
    full width and depth (B = 2, T = 1024, r = 8, Adam) with a falling
    loss, the base planes unchanged, B2, B2^T, B4 and B4's backward
    launched every step and no plain call, step time, tokens/s, peak
    memory and one step's profile; ``merge_and_unload`` and a
    ``generate()`` of the merged model; a full-parameter and a LISA step
    at full width, 2 layers.
19. ``serve_tp`` (``scripts/torch_tp_smoke.py``, run as a child process
    that spawns its ranks; the kernels already built): tensor-parallel
    serving, two gloo ranks on this one card (each prints its backend).
    The five sharded wrappers at their shard shapes against the unsharded
    kernels on the same global inputs (B1s 16/16 heads a rank over bf16
    and e5m2 pools at decode, C = 4 and 128; B2s col and row at
    Llama-2-7B's shard shapes, M = 1, 8, 128; B3s, B4s, B5s prefill and
    decode at Mistral-7B's 16/4), bitwise where reported and else within
    one bf16 ulp of each row's largest value, and timed; the GQA repeat
    (8 query heads over 2 kv heads, four ranks) for B1s and B5s;
    Llama-2-7B widths at 8 layers serving the ``serve`` phase's eight
    requests over a bf16 pool and two over e5m2, Mistral-7B-v0.1 widths
    at 8 layers over the gathered route (B3s, B4s), and the e5m2 and int8
    all-reduce families, each held against a tp = 1 engine (tokens, or
    near-tie greedy forks within 8 bf16 ulps of the top logit; logprobs
    before a fork within 0.05 nats on average; the families' perplexity
    within 1.25 of the exact family's), with no plain call and every
    kernel of the path launched on each rank.
20. ``glm_families`` (``scripts/torch_glm_families_smoke.py``): B1, B3 and
    B4 at GLM-4-9B's GQA group of 16 (32 query heads over 2 kv heads,
    head_dim 128) against their plain versions (B1 at C = 1, the key
    split's 16 rows one kv head's query heads, C = 2 and 4 and 128 on the
    query tiles, bf16 and e5m2 pools; B3 at B = 8 over bf16 and e5m2; B4
    at T = 128 x 8 and 2048 x 2), timed beside their bounds and SDPA;
    2-layer GLM-4-9B-0414, glm-4-9b-chat and internlm2-chat-7b decoders at
    their published widths (the vocabulary cut) card against CPU;
    glm-4-9b-chat at full width and depth (40 layers) through
    ``ServingEngine`` (eight requests over a bf16 pool: B1 by both
    instances, B2) and ``generate()`` (B2, B3, B4), and GLM-4-9B-0414,
    internlm2-chat-7b, Qwen-7B-Chat and Baichuan2-7B-Chat at full width, 8
    layers, through the engine; a 2-layer glm-4-9b-chat-width checkpoint
    under the THUDM names through ``from_pretrained`` and ``generate()``.
21. ``falcon_families`` (``scripts/torch_falcon_families_smoke.py``): B3
    past a GQA group of 16 (Falcon-7B's 71 query heads over one kv head,
    head_dim 64, five 16-row tiles a kv head; bf16 and e5m2, with and
    without a window; and 32 and 17 at head_dim 128), B1 at G = 71 (C =
    1, 4 and 128, all on the query tiles) and B4 at G = 71 against their
    plain versions, timed beside their bounds and SDPA; B2 at Falcon-7B's
    five linears (K = 4544, 142 blocks of 32) at M = 8 and 128 beside
    ``torch.matmul``; 2-layer Falcon-7B, Falcon-40B, StarCoder2-7B (its
    window cut to bind), StableLM-2-1.6B, Command-R-v01 and OLMo-2-7B
    decoders card against CPU; Falcon-7B at full width and depth (32
    layers) through ``ServingEngine`` (eight requests: B1, B2) and
    ``generate()`` (B2, B3's G = 71 instance, B4), StarCoder2-7B (the
    gathered route), Command-R-v01 and OLMo-2-7B at 8 layers and
    StableLM-2-1.6B at its 24 through the engine, one StarCoder2-7B
    request past its 4096-slot window; a 2-layer Falcon-7B checkpoint
    under its published names through ``from_pretrained`` and
    ``generate()``.

Kernel times come from CUDA events over many launches after a warm-up
(B2's up to M = 512, B3's, B4's and B5's, and their yardsticks, as
device time from CUDA-graph replays); the plain version's from a few
calls; ``library_ms`` times one PyTorch call computing the same function
(never called by the port).  Each
kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over 989 TFLOP/s (H100 SXM data sheet).

The second-to-last line of output is the ``{"kernels": [...]}`` summary,
the last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet (dense): HBM3 rate and the bf16
# tensor-core rate.  The least time a kernel could take is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
L2_BYTES = 50 * 2 ** 20

# bf16 outputs: one ulp is 2^-8 of a value's binade, and both sides round
# once at the end, so kernel and plain version may differ by one ulp of
# the largest output (plus far smaller fp32 accumulation error)
B2_TOL_REL = 2.0 ** -7
# the attention kernels and their plain versions (float64) see the same
# widened inputs and differ by the kernel's bf16 rounding of p before P.V
# (2^-9 of each term, errors of random sign) and the final bf16 rounding:
# within 2^-7 of the largest output of the query row.  Held per row
# (batch row and query, over heads and dims), as rows over few keys have
# outputs far larger than rows over thousands.
ATTN_TOL_REL = 2.0 ** -7
# the softcap cases scale q so that scores (N(0, 1) from randn q and k at
# scale d^-0.5) spread as N(0, 24^2) and pass the cap of 50 on many keys;
# each then requires the capped plain output to differ from the uncapped
# one by CAP_GAP_TOLS * ATTN_TOL_REL on some row, so a kernel that left
# the softcap out would fail
CAP_Q_SCALE = 24.0
CAP_GAP_TOLS = 10
# two serving paths over one model (fused spec tick, spec off, the host
# walk) run B2 at different M, and its split plan follows M, so their fp32
# sums round to bf16 differently at every layer and the logits differ by a
# few ulps.  A greedy fork is a near-tie only when both forked tokens lie
# within this many bf16 ulps of the top logit, and logprobs of the same
# token must agree within it; a mis-walked chain or a shifted position
# lands far outside.
SPEC_ULPS = 8

LLAMA2_7B_SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096),
                    "gate_up": (4096, 22016), "down": (11008, 4096),
                    "lm_head": (4096, 32000)}
MISTRAL_7B_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096),
                     "gate_up": (4096, 28672), "down": (14336, 4096),
                     "lm_head": (4096, 32000)}
# (K, N) of each linear of Qwen2-7B and Gemma-2-9B (whose head is the bf16
# embedding table, a plain product outside B2)
QWEN2_7B_SHAPES = {"qkv": (3584, 4608), "o": (3584, 3584),
                   "gate_up": (3584, 37888), "down": (18944, 3584),
                   "lm_head": (3584, 152064)}
GEMMA2_9B_SHAPES = {"qkv": (3584, 8192), "o": (4096, 3584),
                    "gate_up": (3584, 28672), "down": (14336, 3584)}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not (ROOT / "ipex_llm_tpu_torch" / "csrc").is_dir():
        fail(f"no ipex_llm_tpu_torch package beside {__file__}: run from a "
             "checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_attention_ab import graph_ms  # device time of captured calls

    from ipex_llm_tpu_torch.ops.cuda import _build
    from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
    from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
    from ipex_llm_tpu_torch.ops.cuda import flash_attention_bwd as b4b
    from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
    from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
    from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t
    from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
    from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report: dict = {}

    def time_ms(fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev) if hasattr(tree, "to") else tree

    def sdpa_gqa(q, k, v, mask):
        """The library yardstick: q [B, Hq, T, D], k/v [B, Hkv, S, D]."""
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])

    def check_rows(out, ref, what: str):
        """Per query row (batch row and query, over heads and dims): the
        worst |out - ref| within ATTN_TOL_REL of the row's largest |ref|
        (a row that sees no key must be exactly 0 on both sides)."""
        o, r = out.float(), ref.float()
        if not torch.isfinite(o).all():
            fail(f"{what}: output not finite")
        err = (o - r).abs().amax(dim=(2, 3))
        top = r.abs().amax(dim=(2, 3))
        bad = err > ATTN_TOL_REL * top
        if bad.any():
            i = int(bad.flatten().nonzero()[0])
            fail(f"{what}: row {divmod(i, err.shape[1])} max abs err "
                 f"{err.flatten()[i].item()} > {ATTN_TOL_REL} * "
                 f"{top.flatten()[i].item()}")
        return (err.max().item(),
                (err / top.clamp_min(1e-30)).max().item())

    def cap_binds(ref, uncapped, what: str) -> float:
        """The largest per-row gap between the capped and the uncapped
        plain output, relative to the row's largest |ref|; fails under
        CAP_GAP_TOLS * ATTN_TOL_REL."""
        r, u = ref.float(), uncapped.float()
        gap = ((r - u).abs().amax(dim=(2, 3)) / r.abs().amax(
            dim=(2, 3)).clamp_min(1e-30)).max().item()
        if gap < CAP_GAP_TOLS * ATTN_TOL_REL:
            fail(f"{what}: the softcap moves no row by more than {gap} "
                 f"(need {CAP_GAP_TOLS} * {ATTN_TOL_REL})")
        return gap

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    kernels = {"qmatmul": b2, "ragged_paged_attention": b1,
               "decode_attention": b3, "flash_attention": b4,
               "paged_attention": b5, "qmatmul_experts": b2e,
               "qmatmul_dx": b2t, "flash_attention_bwd": b4b}
    sources = _build.sources(kernels.values())
    t_build = _build.build(sources)
    print(f"kernel build: {t_build:.1f} s for {len(sources)} sources",
          flush=True)
    report.update(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=t_build)
    for name in sources:
        log = _build.BUILD_DIR / f"{name}.log"
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log.exists() \
            else []
        report.setdefault("ptxas", {})[name] = regs
    # the redesigned instances must run on the tensor cores: mma.sync is
    # HMMA in the SASS, B4's and B2e's wgmma HGMMA; and none may spill
    # (B2's, B2e's, B3's, B4's and B5's sources; B1's merge kernel keeps a
    # 4-byte spill)
    spills = {name: [ln for ln in report["ptxas"][name] if "spill" in ln
                     and " 0 bytes spill stores" not in ln]
              for name in (b2.NAME, *b2e.SOURCES.values(), b3.NAME, b4.NAME,
                           b5.NAME, b2t.NAME, b4b.NAME)}
    if any(spills.values()):
        fail(f"ptxas reports spills: {spills}")
    hmma = {}
    for src, kernel, opcode in (
            (b2.NAME, "qmm_kernel", "HMMA"),
            (b2.NAME, "qmm_tc_kernel", "HMMA"),
            (b2e.SOURCES["tiled"], "qmm_experts_kernel", "HMMA"),
            (b2e.SOURCES["gemv"], "qmm_experts_gemv_kernel", "HMMA"),
            (b2e.SOURCES["wgmma"], "qmm_experts_wgmma_kernel", "HGMMA"),
            (b1.NAME, "ragged_attn_kernel", "HMMA"),
            (b3.NAME, "decode_split_kernel", "HMMA"),
            (b4.NAME, "flash_attn_kernel", "HGMMA"),
            (b5.NAME, "paged_split_kernel", "HMMA"),
            (b2t.NAME, "qmm_dx_kernel", "HMMA"),
            (b4b.NAME, "flash_bwd_dq_kernel", "HMMA"),
            (b4b.NAME, "flash_bwd_dkdv_kernel", "HMMA")):
        counts = {fn: n for fn, n in
                  _build.sass_counts(src, opcode).items()
                  if kernel in fn}
        if not counts or min(counts.values()) == 0:
            fail(f"{kernel}: an instance has no {opcode} instruction "
                 f"({counts})")
        hmma[kernel] = dict(opcode=opcode, instances=len(counts),
                            count_min=min(counts.values()),
                            count_max=max(counts.values()))
    report["sass_hmma"] = hmma
    print("SASS tensor-core instructions " + json.dumps(hmma), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    from ipex_llm_tpu_torch.quantize.core import dequantize, quantize
    from ipex_llm_tpu_torch.quantize.qtypes import resolve

    def check_b2(y, y_plain, what: str) -> tuple[float, float]:
        """Each output row within one bf16 ulp of the row's largest plain
        output (B2_TOL_REL x max|row|); returns the worst abs error and
        the worst ratio of a row's error to its largest output."""
        err = (y.float() - y_plain.float()).abs().amax(dim=1)
        top = y_plain.float().abs().amax(dim=1)
        bad = err > B2_TOL_REL * top
        if bool(bad.any()) or not torch.isfinite(y).all():
            i = int(bad.nonzero()[0]) if bool(bad.any()) else -1
            fail(f"B2 {what}: row {i} max abs err {err[i].item()} > "
                 f"{B2_TOL_REL} * {top[i].item()} (or not finite)")
        return (err.max().item(),
                (err / top.clamp_min(1e-30)).max().item())

    def b2_route(call) -> str:
        """The B2 instance one call launched (its ``by_route`` count); a
        GEMV call must be one launch (its K split meets in shared memory,
        no reduce kernel)."""
        before = dict(b2.COUNTS.by_route)
        launches = b2.COUNTS.launches
        call()
        ran = [r for r, v in b2.COUNTS.by_route.items() if v > before[r]]
        if len(ran) != 1:
            fail(f"B2: one call launched the instances {ran}")
        if ran[0] == "gemv" and b2.COUNTS.launches - launches != 1:
            fail(f"B2: a GEMV call made {b2.COUNTS.launches - launches} "
                 "launches, want 1")
        return ran[0]

    def b2_ragged(qtype: str) -> list:
        """The tiled instance at small K and ragged M, each row checked;
        K 224 (a half 64-row step) where the block size allows, N 200 (a
        part-full column tile, 4-byte copies) and 384."""
        bs = resolve(qtype).block_size
        done = []
        for k, n in ((256, 384), (224, 200)):
            if k % bs:
                continue
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          / math.sqrt(k), qtype)
            for m in (9, 13, 17, 33, 100):
                x = torch.randn(m, k, generator=gen, device=dev).to(
                    torch.bfloat16)
                for f32 in (False, True):
                    y = []
                    if b2_route(lambda: y.append(
                            b2.qmatmul(x, wq, keep_f32=f32))) != "tiled":
                        fail(f"B2 {qtype} M={m}: not the tiled instance")
                    check_b2(y[0], b2.qmatmul_plain(x, wq, keep_f32=f32),
                             f"{qtype} ragged K={k} N={n} M={m} f32={f32}")
                    done.append([k, n, m, f32])
        return done

    def b2_rows(shapes: dict, ms: tuple, on_path, tag: str, qtype: str,
                iters=lambda m: 30):
        rows = []
        for wname, (k, n) in shapes.items():
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * (1.2 / math.sqrt(k)), qtype)
            wbytes = wq.nbytes
            # rotate over enough copies that each launch finds its weight
            # out of L2, as a layer's weight is on the serving path
            copies = [wq] + [wq.planes(torch.clone) for _ in
                             range(math.ceil(2 * L2_BYTES / wbytes))]
            w_bf16 = dequantize(wq, torch.bfloat16)
            # row counts of mixed ticks (P rows x a power-of-two width) and
            # of part-full row tiles: checked, not timed
            extra = (3, 13, 100) if wname == "qkv" and tag == "llama2-7b" \
                else ()
            for m in ms + extra:
                x = torch.randn(m, k, generator=gen, device=dev).to(
                    torch.bfloat16)
                rt = b2_route(lambda: b2.qmatmul(x, wq))
                err, worst = check_b2(b2.qmatmul(x, wq),
                                      b2.qmatmul_plain(x, wq),
                                      f"{qtype} {tag} {wname} M={m}")
                if m in extra:
                    continue
                it = [0]

                def run_kernel():
                    q = copies[it[0] % len(copies)]
                    it[0] += 1
                    b2.qmatmul(x, q)

                # device time of calls captured in a CUDA graph (eager
                # launches of the small GEMVs would time the host's pace)
                if m <= 512:
                    ms_k = graph_ms(torch, [
                        lambda q=q: b2.qmatmul(x, q) for q in copies] *
                        max(1, 24 // len(copies)))
                    lib_ms = graph_ms(torch, [
                        lambda: torch.matmul(x, w_bf16)] * 20)
                else:
                    ms_k = time_ms(run_kernel, iters(m))
                    lib_ms = time_ms(lambda: torch.matmul(x, w_bf16),
                                     iters(m))
                plain_ms = time_ms(lambda: b2.qmatmul_plain(x, wq), 1)
                bms, by = bound(m * k * 2 + wbytes + m * n * 2,
                                2.0 * m * n * k)
                row = dict(model=tag, qtype=qtype, weight=wname, m=m, k=k,
                           n=n, route=rt, on_path=on_path(wname, m),
                           weight_bytes=wbytes, max_abs_err=err,
                           max_rel_err=worst, tol_rel=B2_TOL_REL,
                           ms=ms_k, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by)
                rows.append(row)
                print("B2 " + json.dumps(row), flush=True)
            del copies, w_bf16
        return rows

    # -- 2. B2 at Llama-2-7B's shapes, in every format -----------------------
    report["b2"] = []
    report["b2_ragged_tiled"] = {}
    for qtype in b2.FORMATS:
        # M=32: the verify forward of spec_k 3 over 8 rows
        ms = ((1, 2, 4, 8, 32, 128, 512) if qtype == "sym_int4"
              else (1, 2, 4, 8, 128))
        report["b2"] += b2_rows(LLAMA2_7B_SHAPES, ms,
                                lambda w, m: m != 512, "llama2-7b", qtype)
        report["b2_ragged_tiled"][qtype] = b2_ragged(qtype)
    print("B2 tiled instance at ragged M, every format: " + json.dumps(
        {q: len(v) for q, v in report["b2_ragged_tiled"].items()}) +
        " shapes within tolerance", flush=True)
    # the GEMV route launches its kernel alone: no qmm_reduce_kernel (and
    # one launch a call, b2_route)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wq = quantize(torch.randn(4096, 22016, generator=gen, device=dev)
                  / 64, "sym_int4")
    x8 = torch.randn(8, 4096, generator=gen, device=dev).to(torch.bfloat16)
    b2.qmatmul(x8, wq)
    torch.cuda.synchronize()
    launches = b2.COUNTS.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        b2.qmatmul(x8, wq)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    if any("qmm_reduce_kernel" in n for n in names) or not any(
            "qmm_kernel" in n for n in names):
        fail(f"B2 GEMV route at gate_up M=8 ran {names}")
    report["b2_gemv_launches_per_call"] = b2.COUNTS.launches - launches
    print(f"B2 GEMV at gate_up M=8: {report['b2_gemv_launches_per_call']} "
          f"launch a call, kernels {names}", flush=True)
    del wq, x8
    torch.cuda.empty_cache()

    # -- 2b. the codec on the card against the CPU ---------------------------
    w = torch.randn(4096, 4096, generator=gen, device=dev) * (1.2 / 64)
    codec = []
    for qtype in b2.FORMATS[1:]:
        on_card = quantize(w, qtype)
        on_cpu = quantize(w.cpu(), qtype)
        for key in ("data", "scales", "zeros"):
            a_, b_ = getattr(on_card, key), getattr(on_cpu, key)
            if (a_ is None) != (b_ is None) or (a_ is not None and not (
                    a_.cpu().view(torch.uint8) == b_.view(torch.uint8)
            ).all()):
                fail(f"codec {qtype}: the card's {key} plane differs from "
                     "the CPU's")
        codec.append(dict(qtype=qtype, shape=[4096, 4096],
                          bytes=on_card.nbytes, equal=True))
        print("codec " + json.dumps(codec[-1]), flush=True)
    report["codec"] = codec
    del w, on_card, on_cpu

    # -- 3. B1 ---------------------------------------------------------------
    def ragged_case(pool_dtype, r=8, c=128, hq=32, hkv=32, d=128, ps=128,
                    maxp=16):
        """benchmark/microbench.py::bench_ragged_attn's mix: even rows
        decode at full history, odd rows take a ragged chunk; the last two
        rows are idle (chunk 0, kv_len the sentinel past the table)."""
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)
                  ).to(torch.int32).reshape(r, maxp)
        chunk = np.where(np.arange(r) % 2 == 0, 1,
                         1 + (37 * np.arange(r)) % c).astype(np.int32)
        kv_len = np.where(chunk == 1, maxp * ps,
                          maxp * ps - c + chunk).astype(np.int32)
        chunk[-2:] = 0
        kv_len[-2:] = maxp * ps
        tables[-2:] = -1
        q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        return (q, kp, vp, tables, torch.from_numpy(kv_len).to(dev),
                torch.from_numpy(chunk).to(dev))

    def b1_work(q, kp, kv_len, chunk):
        r, c, hq, d = q.shape
        hkv = kp.shape[1]
        item = kp.element_size()
        live = chunk.cpu().numpy() > 0
        kvl = kv_len.cpu().numpy()
        ch = chunk.cpu().numpy()
        nbytes = 2 * r * c * hq * d * 2          # q in, out
        pairs = 0
        for i in np.flatnonzero(live):
            nbytes += 2 * int(kvl[i]) * hkv * d * item
            q0 = int(kvl[i]) - int(ch[i])
            pairs += sum(q0 + j + 1 for j in range(int(ch[i])))
        return nbytes, 4.0 * d * hq * pairs

    def b1_library(q, kp, vp, tables, kv_len, chunk):
        """SDPA over the gathered pages (the gather outside the timing)."""
        r, c, hq, d = q.shape
        maxp, ps = tables.shape[1], kp.shape[2]
        idx = tables.long().clamp(0, kp.shape[0] - 1)

        def gather(pool):
            g = pool[idx].to(torch.bfloat16)         # [R, maxP, H, ps, D]
            return g.permute(0, 2, 1, 3, 4).reshape(r, -1, maxp * ps, d)
        kg, vg = gather(kp), gather(vp)
        kpos = torch.arange(maxp * ps, device=dev)
        qpos = (kv_len - chunk)[:, None] + torch.arange(c, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
            kpos[None, None, :] < kv_len[:, None, None])
        mask[..., 0] = True          # idle rows: keep the softmax defined
        qt = q.transpose(1, 2)
        return lambda: sdpa_gqa(qt, kg, vg, mask[:, None])

    def b1_route(args) -> str:
        """The B1 instance one call launched (its ``by_route`` count)."""
        before = dict(b1.COUNTS.by_route)
        b1.ragged_paged_sdpa(*args)
        ran = [r for r, v in b1.COUNTS.by_route.items() if v > before[r]]
        if len(ran) != 1:
            fail(f"B1: one call launched the instances {ran}")
        return ran[0]

    b1_rows = []
    gqa = dict(hkv=8)
    g7 = dict(hq=28, hkv=4)     # Qwen2-7B: a GQA group of 7
    g8 = dict(hq=32, hkv=4)     # Qwen3-30B-A3B: a GQA group of 8
    for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
        for label, kw in (("row mix R=8 C=128", {}),
                          ("row mix R=8 C=16", dict(c=16)),
                          ("verify R=8 C=4", dict(c=4)),
                          ("decode R=8 C=1", dict(c=1)),
                          ("GQA row mix R=8 C=128 Hkv=8", gqa),
                          ("GQA decode R=8 C=1 Hkv=8", dict(c=1, **gqa)),
                          ("G=7 decode R=8 C=1 Hq=28 Hkv=4",
                           dict(c=1, **g7)),
                          ("G=7 verify R=8 C=4 Hq=28 Hkv=4",
                           dict(c=4, **g7)),
                          ("G=7 row mix R=8 C=128 Hq=28 Hkv=4", g7),
                          ("G=8 decode R=8 C=1 Hq=32 Hkv=4",
                           dict(c=1, **g8)),
                          ("G=8 row mix R=8 C=128 Hq=32 Hkv=4", g8)):
            q, kp, vp, tables, kv_len, chunk = ragged_case(pool_dtype,
                                                           **kw)
            if kw.get("c") in (1, 4):   # decode or verify rows at
                chunk = torch.full_like(chunk, kw["c"])   # staggered lengths
                kv_len = torch.tensor(
                    [130, 300, 511, 700, 900, 1064, 1500, 2048],
                    dtype=torch.int32, device=dev)
                tables = (1 + torch.arange(tables.numel(), device=dev)
                          ).to(torch.int32).reshape(tables.shape)
            args = (q, kp, vp, tables, kv_len, chunk)
            route = b1_route(args)
            out = b1.ragged_paged_sdpa(*args)
            ref = b1.ragged_paged_sdpa_plain(*args, scale=128 ** -0.5)
            torch.cuda.synchronize()
            err = worst = 0.0
            for i, n_q in enumerate(chunk.tolist()):
                if n_q == 0:
                    if out[i].abs().max().item() != 0.0:
                        fail(f"B1 {pool_name}: idle row {i} is not zero")
                    continue
                e = (out[i, :n_q].float() - ref[i, :n_q].float()
                     ).abs().max().item()
                top = ref[i, :n_q].float().abs().max().item()
                if not e <= ATTN_TOL_REL * top:
                    fail(f"B1 {pool_name} {label} row {i}: max abs err "
                         f"{e} > {ATTN_TOL_REL} * {top}")
                err, worst = max(err, e), max(worst, e / top)
            if not torch.isfinite(out).all():
                fail(f"B1 {pool_name} {label}: output not finite")
            ms = time_ms(lambda: b1.ragged_paged_sdpa(*args), 30)
            plain_ms = time_ms(lambda: b1.ragged_paged_sdpa_plain(
                *args, scale=128 ** -0.5), 3)
            lib_ms = time_ms(b1_library(*args), 30)
            bms, by = bound(*b1_work(q, kp, kv_len, chunk))
            row = dict(pool=pool_name, case=label, route=route,
                       max_abs_err=err,
                       max_rel_err=worst, tol_rel=ATTN_TOL_REL, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bms, bound_by=by)
            b1_rows.append(row)
            print("B1 " + json.dumps(row), flush=True)
            del q, kp, vp, out, ref
    report["b1"] = b1_rows

    # -- 3b. B5, and B1 against it -------------------------------------------
    def b5_case(pool_dtype, c, r=8, hq=32, hkv=32, d=128, ps=128, maxp=16):
        """Rows of 1 to 2048 slots (one shorter than C=4, two shorter than
        C=128), pages in random order, -1 past each row's last page."""
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        kv_len = torch.tensor([1, 100, 130, 511, 900, 1300, 2047, 2048],
                              dtype=torch.int32, device=dev)[:r]
        tables = (1 + torch.randperm(r * maxp, generator=gen, device=dev)
                  ).to(torch.int32).reshape(r, maxp)
        for i in range(r):
            tables[i, -(-int(kv_len[i]) // ps):] = -1
        q = torch.randn(r, c, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        return q, kp, vp, tables, kv_len

    def b5_call(q, kp, vp, tables, kv_len):
        fn = b5.paged_decode_sdpa if q.shape[1] == 1 else b5.paged_prefill_sdpa
        return fn(q, kp, vp, tables, kv_len)

    b5.COUNTS.reset()
    b5_rows = []
    for pool_name, pool_dtype in (("bf16", torch.bfloat16),
                                  ("e5m2", torch.float8_e5m2)):
        for c in (1, 4, 128):
            args = b5_case(pool_dtype, c)
            q, kp, vp, tables, kv_len = args
            chunk = torch.full_like(kv_len, c)
            out = b5_call(*args)
            ref = b5.paged_sdpa_plain(*args, scale=128 ** -0.5)
            via_b1 = b1.ragged_paged_sdpa(q, kp, vp, tables, kv_len, chunk)
            torch.cuda.synchronize()
            label = f"B5 {pool_name} C={c}"
            err, worst = check_rows(out, ref, label)
            b1_err, b1_worst = check_rows(via_b1, out, f"B1 vs {label}")
            nq = (kv_len[:, None] - c + torch.arange(c, device=dev)) < 0
            if out[nq].any():
                fail(f"{label}: a query with no visible key is not zero")
            # device time of calls captured in a CUDA graph, for B5, B1
            # and SDPA alike (eager, the host's pace; kept as eager_ms)
            ms = graph_ms(torch, [lambda: b5_call(*args)] * 10)
            eager_ms = time_ms(lambda: b5_call(*args), 30)
            plain_ms = time_ms(lambda: b5.paged_sdpa_plain(
                *args, scale=128 ** -0.5), 3)
            lib_ms = graph_ms(torch, [b1_library(q, kp, vp, tables, kv_len,
                                                 chunk)] * 10)
            b1_ms = graph_ms(torch, [lambda: b1.ragged_paged_sdpa(
                q, kp, vp, tables, kv_len, chunk)] * 10)
            # B1's reckoning: q in and out once, each row's K/V slots once,
            # 4 D operations per visible (query head, key) pair
            kvl = kv_len.cpu().tolist()
            pairs = sum(max(0, n - c + j + 1) for n in kvl for j in range(c))
            bms, by = bound(2 * q.numel() * 2 + sum(
                2 * n * kp.shape[1] * 128 * kp.element_size() for n in kvl),
                4.0 * 128 * q.shape[2] * pairs)
            row = dict(pool=pool_name, case=f"C={c}", max_abs_err=err,
                       max_rel_err=worst, tol_rel=ATTN_TOL_REL, ms=ms,
                       eager_ms=eager_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms,
                       bound_by=by, b1_ms=b1_ms, b1_vs_b5_max_abs=b1_err,
                       b1_vs_b5_max_rel=b1_worst,
                       b1_equals_b5_bitwise=bool(torch.equal(via_b1, out)))
            b5_rows.append(row)
            print("B5 " + json.dumps(row), flush=True)
            del args, q, kp, vp, out, ref, via_b1
    report["b5"] = b5_rows

    # -- 3c. the verify shape: one wide B1 pass against k+1 B5 decodes -------
    def spec_verify(pool_name, pool_dtype, k_spec=3, r=8, hq=32, hkv=32,
                    d=128, ps=128, maxp=16):
        """benchmark/microbench.py::bench_spec_verify on the card: every
        row full (maxp pages), the [R, k+1] chunk through B1 once, against
        k+1 sequential B5 decode launches at kv_len = base+1 .. base+k+1."""
        k1 = k_spec + 1
        n_pages = 1 + r * maxp
        kp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        vp = torch.randn(n_pages, hkv, ps, d, generator=gen,
                         device=dev).to(pool_dtype)
        tables = (1 + torch.arange(r * maxp, device=dev)).to(
            torch.int32).reshape(r, maxp)
        q_wide = torch.randn(r, k1, hq, d, generator=gen, device=dev).to(
            torch.bfloat16)
        q_one = q_wide[:, :1].contiguous()
        base = maxp * ps - k1
        kv_full = torch.full((r,), maxp * ps, dtype=torch.int32, device=dev)
        chunk = torch.full((r,), k1, dtype=torch.int32, device=dev)
        lens = [torch.full((r,), base + j + 1, dtype=torch.int32, device=dev)
                for j in range(k1)]
        # bytes the sequential chain re-reads: k+1 sweeps of every row's pages
        nbytes = 2 * r * maxp * ps * hkv * d * kp.element_size() * k1

        def chain():
            for kl in lens:
                b5.paged_decode_sdpa(q_one, kp, vp, tables, kl)

        wide_ms = time_ms(lambda: b1.ragged_paged_sdpa(
            q_wide, kp, vp, tables, kv_full, chunk), 50)
        chain_ms = time_ms(chain, 50)
        row = dict(pool=pool_name, shape=f"R={r} Hq={hq} Hkv={hkv} "
                   f"S={maxp * ps} D={d} k={k_spec}",
                   wide_b1_ms=wide_ms, chain_b5_ms=chain_ms,
                   wide_eff_gb_s=nbytes / wide_ms / 1e6,
                   chain_gb_s=nbytes / chain_ms / 1e6,
                   chain_over_wide=chain_ms / wide_ms)
        print("spec_verify " + json.dumps(row), flush=True)
        return row

    report["spec_verify"] = [spec_verify("bf16", torch.bfloat16),
                             spec_verify("e5m2", torch.float8_e5m2)]
    b5_launches = b5.COUNTS.launches
    torch.cuda.empty_cache()

    # -- 4. a small decoder, paged form: card against CPU -------------------
    from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
    from ipex_llm_tpu_torch.models.decoder import decoder_forward
    from ipex_llm_tpu_torch.models.random_init import (MISTRAL_7B_V01_HF,
                                                       llama2_7b_config,
                                                       llama_config,
                                                       mistral_7b_config,
                                                       random_params)

    from ipex_llm_tpu_torch.models.build import requantize_params

    # GQA (4 query heads over 2 kv heads) at the kernel's head_dim 128
    small = llama_config(hidden_size=512, intermediate_size=1024,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=128, vocab_size=512)

    def decoder_check(p_cpu) -> float:
        """Prefill chunks of 40, 17 and 29 tokens and three decode steps
        through the paged decoder, on the card and on the CPU's plain
        versions; returns the worst logit difference over the range."""
        p_dev = to_dev(p_cpu)
        rng = np.random.default_rng(3)
        r, t, ps, maxp = 3, 40, 128, 2
        chunk = np.array([40, 17, 29], np.int32)
        toks = rng.integers(0, 512, (r, t)).astype(np.int32)
        worst = 0.0
        caches = {}
        for name, device, params in (("cpu", "cpu", p_cpu),
                                     ("cuda", dev, p_dev)):
            c = PagedKVCache.init(2, 1 + r * maxp, r, maxp, 2, ps, 128,
                                  device=device)
            c.tables.copy_(1 + torch.arange(r * maxp, dtype=torch.int32
                                            ).reshape(r, maxp))
            caches[name] = (c, params, device)
        lens = np.zeros(r, np.int32)
        steps = [(toks, np.zeros(r, np.int32), chunk)]
        for _ in range(3):
            steps.append((rng.integers(0, 512, (r, 1)).astype(np.int32),
                          None, None))
        for tk, base, ch in steps:
            outs = {}
            for name, (c, params, device) in caches.items():
                if ch is not None:
                    pos = base[:, None] + np.arange(tk.shape[1])[None, :]
                    kw = dict(slot_offsets=torch.from_numpy(base).to(device),
                              chunk_lens=torch.from_numpy(ch).to(device),
                              gather_positions=torch.from_numpy(ch - 1).to(
                                  device))
                else:
                    pos = lens[:, None]
                    kw = dict(slot_offsets=torch.from_numpy(lens).to(device),
                              last_token_only=True)
                lg, _ = decoder_forward(small, params,
                                        torch.from_numpy(tk).to(device), c,
                                        torch.from_numpy(np.ascontiguousarray(
                                            pos)).to(device), **kw)
                outs[name] = lg.float().cpu().numpy()
            lens = lens + (chunk if ch is not None else 1)
            span = outs["cpu"].max() - outs["cpu"].min()
            diff = np.abs(outs["cuda"] - outs["cpu"]).max() / span
            worst = max(worst, float(diff))
            if not np.isfinite(outs["cuda"]).all() or diff > 0.025:
                fail(f"small decoder: card vs CPU logits differ by "
                     f"{diff:.4f} of the logit range (bound 0.025)")
        return worst

    report["small_decoder_worst_rel"] = {
        "sym_int4": decoder_check(random_params(small, "sym_int4", seed=1,
                                                device="cpu"))}
    small_bf16 = random_params(small, "bf16", seed=1, device="cpu")
    for qtype in b2.FORMATS[1:]:
        report["small_decoder_worst_rel"][qtype] = decoder_check(
            requantize_params(small_bf16, qtype))
    print("small decoder card vs CPU, worst logit diff over the range "
          "(bound 0.025): " + json.dumps(report["small_decoder_worst_rel"]),
          flush=True)

    # -- 5. serving at Llama-2-7B widths -----------------------------------
    from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                                   ServingEngine,
                                                   stream_tokens)

    cfg = llama2_7b_config()
    serve_path = {"qmatmul": b2, "ragged_paged_attention": b1}

    def serve_run(label: str, eng, reqs, formats=()) -> dict:
        """Serve ``reqs`` through ``eng`` with every count set to 0 just
        before; every request must finish with its tokens, every kernel of
        the path (B2 in each of ``formats``) launch, and no plain version
        run."""
        for mod in kernels.values():
            mod.COUNTS.reset()
        eng.start()
        t_start = time.perf_counter()
        for q in reqs:
            eng.submit(q)
        streams = [list(stream_tokens(q, timeout=600)) for q in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts = {name: (mod.COUNTS.launches, mod.COUNTS.plain_calls)
                  for name, mod in kernels.items()}
        by_format = dict(b2.COUNTS.by_format)
        by_route = {"qmatmul": dict(b2.COUNTS.by_route),
                    "ragged_paged_attention": dict(b1.COUNTS.by_route)}
        eng.stop()
        if eng._thread.is_alive():
            fail(f"{label}: engine thread did not stop")
        for q, st in zip(reqs, streams):
            if q.finish_reason != "length" or len(st) != q.max_new_tokens \
                    or st != q.output_ids:
                fail(f"{label}: request finished {q.finish_reason} with "
                     f"{len(st)} of {q.max_new_tokens} tokens "
                     f"({eng.metrics.get('last_error')})")
            if not all(0 <= v < cfg.vocab_size for v in st) or not all(
                    math.isfinite(lp) and lp <= 0 for lp in q.logprobs):
                fail(f"{label}: token or logprob out of range")
        for name, (launches, plain) in counts.items():
            if plain != 0 or (name in serve_path and launches == 0):
                fail(f"{label}: {name} launched {launches} times, plain "
                     f"version called {plain} times")
        for qtype in formats:
            if by_format[qtype] == 0:
                fail(f"{label}: B2 never launched in {qtype}")
        out_tok = sum(len(st) for st in streams)
        ttft = [q.first_token_s for q in reqs]
        res = dict(run=label, requests=len(reqs),
                   prompt_tokens=sum(len(q.prompt_ids) for q in reqs),
                   output_tokens=out_tok, wall_s=wall,
                   output_tok_s=out_tok / wall,
                   ttft_mean_s=float(np.mean(ttft)),
                   ttft_max_s=float(np.max(ttft)),
                   launches={k: v[0] for k, v in counts.items()},
                   plain_calls={k: v[1] for k, v in counts.items()},
                   b2_launches_by_format={k: v for k, v in by_format.items()
                                          if v},
                   launches_by_route=by_route,
                   metrics={k: eng.metrics[k] for k in (
                       "mixed_steps", "steps", "host_syncs", "epoch_syncs",
                       "liveness_syncs", "decode_horizon_effective",
                       "host_sync_s")},
                   # one block read a tick plus the loop's liveness reads
                   host_syncs_per_tick=1 + eng.metrics["liveness_syncs"]
                   / eng.metrics["host_syncs"])
        if eng.ec.spec_k:
            m = eng.metrics
            if m["spec_steps"] == 0 or m["draft_proposed"] == 0:
                fail(f"{label}: the engine never speculated ({m})")
            res.update(spec_stats=eng.spec_stats(), verify_rounds=m[
                "spec_steps"], spec_ticks=m["spec_ticks"],
                spec_emitted=m["spec_emitted"],
                tokens_per_row_round=m["spec_emitted"] / m["spec_row_steps"])
        print("serve " + json.dumps(res), flush=True)
        return res

    def serve_phase():
        t0 = time.perf_counter()
        params = random_params(cfg, "sym_int4", seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"Llama-2-7B-width random sym_int4 weights: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)

        def serve(storage: str, n_req: int, seed: int) -> dict:
            rng = np.random.default_rng(seed)
            lens = rng.integers(64, 1001, n_req)
            news = rng.integers(32, 65, n_req)
            reqs = [Request(prompt_ids=[int(v) for v in
                                        rng.integers(1, cfg.vocab_size, n)],
                            max_new_tokens=int(m),
                            temperature=0.8 if i % 2 else 0.0,
                            top_p=0.9 if i % 2 else 1.0,
                            seed=1000 + i if i % 2 else None)
                    for i, (n, m) in enumerate(zip(lens, news))]
            eng = ServingEngine(cfg, params, EngineConfig(
                max_rows=8, max_seq_len=2048, page_size=128,
                prefill_bucket=128, decode_horizon=4, kv_storage=storage),
                device=dev)
            res = dict(storage=storage, **serve_run(
                f"{storage} pool", eng, reqs, ("sym_int4",)))
            del eng
            torch.cuda.empty_cache()
            return res

        rows = [serve("bf16", 8, 7), serve("fp8", 2, 8)]
        return (rows, serve_spec_phase(params), serve_http_phase(params),
                serve_faults_phase(params))

    def spec_requests(seed: int):
        """Eight requests of 48 new tokens: four prompts repeat a random
        16-id pattern to 256-1024 ids (the text prompt lookup serves:
        edits of given code, quotes of retrieved passages), four are random
        ids, 64-1000; in each group two greedy, two seeded t=0.8 top-p 0.9."""
        rng = np.random.default_rng(seed)
        reqs = []
        for i in range(8):
            if i < 4:
                n = int(rng.integers(256, 1025))
                ids = np.resize(rng.integers(1, cfg.vocab_size, 16), n)
            else:
                ids = rng.integers(1, cfg.vocab_size, int(rng.integers(64,
                                                                       1001)))
            reqs.append(dict(prompt_ids=[int(v) for v in ids],
                             max_new_tokens=48,
                             temperature=0.8 if i % 2 else 0.0,
                             top_p=0.9 if i % 2 else 1.0,
                             seed=2000 + i if i % 2 else None))
        return reqs

    def stream_logits(params, prompt, out) -> torch.Tensor:
        """[len(out), V] float32 logits that predict each token of ``out``
        after ``prompt``: one prefill over a fresh one-row pool, a numeric
        path of its own (B2 at M = the whole sequence)."""
        ids = list(prompt) + list(out[:-1])
        t = len(ids)
        maxp = -(-t // 128)
        cache = PagedKVCache.init(cfg.num_layers, 1 + maxp, 1, maxp,
                                  cfg.num_kv_heads, 128, cfg.head_dim,
                                  device=dev)
        cache.tables.copy_(1 + torch.arange(maxp, dtype=torch.int32))
        logits, _ = decoder_forward(
            cfg, params, torch.tensor([ids], dtype=torch.int32, device=dev),
            cache, torch.arange(t, device=dev)[None],
            slot_offsets=torch.zeros(1, dtype=torch.int32, device=dev))
        del cache
        return logits[0, len(prompt) - 1:].float()

    def below_top(ref, toks):
        """How far each token of ``toks`` lies below its position's top
        logit in ``ref`` [n, V], in bf16 ulps of that top logit, and the
        ulps."""
        top = ref.max(dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
        idx = torch.tensor(toks, device=ref.device)[:, None]
        low = (top - ref[:len(toks)].gather(1, idx)[:, 0]) / ulp[:len(toks)]
        return low.cpu().numpy(), ulp.cpu().numpy()

    def hold_streams(label, pairs, ref_logits) -> list:
        """Hold stream a (the fused spec tick's) against stream b of each
        request.  The two paths run B2 at different M, so their logits
        differ in the last bits.  Until the first fork, each token's two
        logprobs must agree within SPEC_ULPS bf16 ulps of that position's
        top logit (``ref_logits``: a third path, conditioned on stream a);
        at a greedy row's fork both tokens must lie within as many ulps of
        the top logit, or the fork is a fault and not a near-tie.  A
        seeded row's fork is a draw at t=0.8 that its Gumbel noise decides,
        so only its prefix is held."""
        forks = []
        for i, ((a, lp_a), (b, lp_b)) in enumerate(pairs):
            ref = ref_logits[i]
            j = next((j for j in range(len(a)) if a[j] != b[j]), None)
            n = len(a) if j is None else j
            _, ulp = below_top(ref, a)
            dlp = np.abs(np.asarray(lp_a[:n]) - np.asarray(lp_b[:n]))
            lp_ulps = float((dlp / ulp[:n]).max()) if n else 0.0
            greedy = i % 2 == 0
            fork = dict(request=i, greedy=greedy, repeating_prompt=i < 4,
                        first_fork=j, logprob_max_ulps=lp_ulps)
            if lp_ulps > SPEC_ULPS:
                fail(f"{label} request {i}: logprobs before the fork differ "
                     f"by {lp_ulps:.2f} ulps of the top logit (bound "
                     f"{SPEC_ULPS})")
            if j is not None:
                low = max(below_top(ref[j:j + 1], [a[j]])[0][0],
                          below_top(ref[j:j + 1], [b[j]])[0][0])
                top2 = torch.topk(ref[j], 2).values
                fork.update(a_token=a[j], b_token=b[j],
                            top2_gap=float(top2[0] - top2[1]),
                            fork_below_top_ulps=float(low))
                if greedy and low > SPEC_ULPS:
                    fail(f"{label} request {i}: greedy streams fork at "
                         f"token {j} to a token {low:.2f} ulps below the "
                         f"top logit (bound {SPEC_ULPS})")
            forks.append(fork)
        print(f"serve_spec forks {label} " + json.dumps(forks), flush=True)
        return forks

    def serve_spec_phase(params) -> dict:
        ec = dict(max_rows=8, max_seq_len=2048, page_size=128,
                  prefill_bucket=128, spec_ngram=3)
        runs, streams = {}, {}
        for label, k, storage, picks, extra in (
                ("spec_k=3", 3, "bf16", range(8), dict(decode_horizon=4)),
                ("spec_k=0", 0, "bf16", range(8), dict(decode_horizon=4)),
                # the sequential engine's host walk, the fused tick's oracle
                ("spec_k=3 host walk", 3, "bf16", range(8),
                 dict(decode_horizon=1, step_token_budget=0)),
                ("spec_k=3 e5m2", 3, "fp8", (0, 5), dict(decode_horizon=4))):
            kws = [spec_requests(31)[i] for i in picks]
            reqs = [Request(**kw) for kw in kws]
            eng = ServingEngine(cfg, params, EngineConfig(
                spec_k=k, kv_storage=storage, **extra, **ec), device=dev)
            runs[label] = dict(storage=storage, **serve_run(
                f"serve_spec {label}", eng, reqs, ("sym_int4",)))
            streams[label] = [(q.output_ids, q.logprobs) for q in reqs]
            del eng
            torch.cuda.empty_cache()
        prompts = [kw["prompt_ids"] for kw in spec_requests(31)]
        ref = [stream_logits(params, p, a) for p, (a, _) in
               zip(prompts, streams["spec_k=3"])]
        fused = streams["spec_k=3"]
        # every greedy token of the fused tick is the third path's argmax
        # but for a near-tie
        greedy_low = max(float(below_top(r, a)[0].max()) for r, (a, _)
                         in list(zip(ref, fused))[::2])
        print(f"serve_spec fused greedy tokens, worst {greedy_low:.2f} ulps "
              f"below the top logit (bound {SPEC_ULPS})", flush=True)
        if greedy_low > SPEC_ULPS:
            fail(f"serve_spec: a greedy token of the fused tick lies "
                 f"{greedy_low:.2f} ulps below the top logit")
        forks = hold_streams("fused vs spec_k=0",
                             list(zip(fused, streams["spec_k=0"])), ref)
        oracle = hold_streams("fused vs host walk",
                              list(zip(fused, streams["spec_k=3 host walk"])),
                              ref)
        return dict(runs=runs, forks=forks, forks_vs_host_walk=oracle,
                    greedy_worst_below_top_ulps=greedy_low,
                    tol_ulps=SPEC_ULPS)

    def serve_faults_phase(params) -> dict:
        """The transactional tick at Llama-2-7B widths: five requests
        (prompts of 64-1000 ids, 24 new tokens; two greedy, two seeded
        t=0.8 top-p 0.9, one sampled with a seed the engine draws) through
        the serving configuration, all waiting before the engine's first
        tick so that every run runs the same ticks: (1) clean; (2) a
        TransientFault at the second hit of each of page-alloc,
        mixed-step, decode-dispatch and sample; (3) the
        torch.OutOfMemoryError a ``torch.empty`` larger than the card
        raises, injected as that instance at decode-dispatch; (4) a
        DeterministicFault bound to a decoding request at decode-dispatch.
        (2) and (3) retry once and equal (1) bitwise in tokens and
        logprobs (the retried tick has the same shapes, and B1 and B2 sum
        in a fixed split order); (4) isolates the culprit alone and the
        survivors equal (1) bitwise (a decode tick runs every row of the
        pool, so dropping a row changes no kernel's shape).  B1 and B2
        must launch in every run and no plain version run."""
        from ipex_llm_tpu_torch.serving.faults import (DeterministicFault,
                                                       FaultInjector,
                                                       TransientFault,
                                                       is_transient)

        t_phase = time.perf_counter()
        ec = dict(max_rows=8, max_seq_len=2048, page_size=128,
                  prefill_bucket=128, decode_horizon=4, kv_storage="bf16")
        rng = np.random.default_rng(51)
        lens = [int(n) for n in rng.integers(64, 1001, 5)]
        prompts = [[int(v) for v in rng.integers(1, cfg.vocab_size, n)]
                   for n in lens]
        sampling = [{}, {}, dict(temperature=0.8, top_p=0.9, seed=3001),
                    dict(temperature=0.8, top_p=0.9, seed=3002),
                    dict(temperature=0.8, top_p=0.9)]     # engine-seeded

        def run(label: str, inj) -> tuple[dict, list]:
            reqs = [Request(prompt_ids=p, max_new_tokens=24,
                            request_id=f"f{i}", **kw)
                    for i, (p, kw) in enumerate(zip(prompts, sampling))]
            eng = ServingEngine(cfg, params, EngineConfig(**ec), device=dev,
                                fault_injector=inj)
            probes = [0]
            real_probe = eng._probe

            def probe(masked):
                probes[0] += 1
                return real_probe(masked)
            eng._probe = probe
            for q in reqs:
                eng.submit(q)
            for mod in kernels.values():
                mod.COUNTS.reset()
            t0 = time.perf_counter()
            eng.start()
            streams = [list(stream_tokens(q, timeout=600)) for q in reqs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {name: (mod.COUNTS.launches, mod.COUNTS.plain_calls)
                      for name, mod in kernels.items()}
            by_route = {name: dict(serve_path[name].COUNTS.by_route)
                        for name in serve_path}
            m = dict(eng.metrics)
            pages, cached = eng.alloc.pages_in_use, len(eng.alloc.prefix)
            ticks = eng.flight.recorded     # committed working ticks
            eng.stop()
            if eng._thread.is_alive():
                fail(f"serve_faults {label}: engine thread did not stop")
            for name, (launches, plain) in counts.items():
                if plain != 0 or (name in serve_path and launches == 0):
                    fail(f"serve_faults {label}: {name} launched "
                         f"{launches} times, plain version called {plain} "
                         "times")
            for q, st in zip(reqs, streams):
                if st != q.output_ids or not all(
                        0 <= v < cfg.vocab_size for v in st) or not all(
                        math.isfinite(lp) and lp <= 0 for lp in q.logprobs):
                    fail(f"serve_faults {label}: request {q.request_id} "
                         "streamed other tokens than it holds, or a token "
                         "or logprob is out of range")
            res = dict(run=label, wall_s=wall, ticks=ticks, probes=probes[0],
                       retries=m["retries"],
                       errors_isolated=m["errors_isolated"],
                       errors=m.get("errors", 0),
                       fired=inj.fired if inj is not None else 0,
                       site_hits=dict(inj.site_hits) if inj is not None
                       else {},
                       reasons=[q.finish_reason for q in reqs],
                       output_tokens=sum(len(st) for st in streams),
                       pages_in_use=pages, prefix_pages=cached,
                       launches={k: v[0] for k, v in counts.items()
                                 if k in serve_path},
                       launches_by_route=by_route)
            print("serve_faults " + json.dumps(res), flush=True)
            del eng
            torch.cuda.empty_cache()
            return res, [(q.output_ids, q.logprobs) for q in reqs]

        runs = []
        clean, want = run("clean", None)
        runs.append(clean)
        if clean["reasons"] != ["length"] * 5 or clean["output_tokens"] \
                != 5 * 24:
            fail(f"serve_faults clean: {clean['reasons']}")
        try:
            torch.empty(2 ** 50, dtype=torch.uint8, device=dev)
            fail("serve_faults: a 1 PiB torch.empty did not raise")
        except torch.OutOfMemoryError as exc:
            oom = exc
        if not is_transient(oom):
            fail(f"serve_faults: {type(oom).__name__} is not transient")
        scripts = [(f"transient {site}", site, TransientFault, 2, None)
                   for site in ("page-alloc", "mixed-step",
                                "decode-dispatch", "sample")]
        scripts += [("OutOfMemoryError decode-dispatch", "decode-dispatch",
                     oom, 2, None),
                    # the culprit's third decode dispatch: it is decoding
                    ("poisoned f0 decode-dispatch", "decode-dispatch",
                     DeterministicFault, 3, "f0")]
        for label, site, exc, nth, bound in scripts:
            inj = FaultInjector().inject(site, exc, nth=nth,
                                         times=None if bound else 1,
                                         request_id=bound)
            res, got = run(label, inj)
            runs.append(res)
            if bound is None:
                if (res["retries"], res["fired"], res["errors_isolated"],
                        res["errors"]) != (1, 1, 0, 0) or got != want:
                    fail(f"serve_faults {label}: retries {res['retries']}, "
                         f"fired {res['fired']}, isolated "
                         f"{res['errors_isolated']}, errors {res['errors']},"
                         f" bitwise equal to the clean run: {got == want}")
                continue
            culprit = int(bound[1:])
            n_ok = len(got[culprit][0])
            survivors = [g == w for i, (g, w) in enumerate(zip(got, want))
                         if i != culprit]
            if (res["reasons"][culprit] != "error"
                    or res["errors_isolated"] != 1 or res["errors"] != 0
                    or res["pages_in_use"] != res["prefix_pages"]
                    or got[culprit][0] != want[culprit][0][:n_ok]
                    or not all(survivors)
                    or any(r != "length" for i, r in enumerate(
                        res["reasons"]) if i != culprit)):
                fail(f"serve_faults {label}: {res}; survivors bitwise "
                     f"equal to the clean run: {survivors}")
        out = dict(runs=runs, phase_s=time.perf_counter() - t_phase,
                   launches={k: sum(r["launches"][k] for r in runs)
                             for k in serve_path})
        print(f"serve_faults: {len(runs)} runs, all gates held, "
              f"{out['phase_s']:.1f} s", flush=True)
        return out

    def serve_http_phase(params) -> dict:
        """The OpenAI/TGI front end (``serving/api_server.py``) over the
        engine at Llama-2-7B widths: over 127.0.0.1 when aiohttp imports,
        else through the route coroutines in process.  Eight completions
        whose greedy and seeded texts must equal, token for token, the
        same requests sent straight to an engine of the same
        configuration; two SSE chat streams, a stop string, a TGI stream
        and its trace; /metrics, /debug/flight, /v1/models and /health;
        then 429, 503 (drain) and 408 (deadline) as the clients see them."""
        from concurrent.futures import ThreadPoolExecutor

        from torch_http_client import (Client as HttpClient, IdTokenizer,
                                       hold_first_tick, http_transport)

        from ipex_llm_tpu_torch.serving.api_server import OpenAIServer
        from ipex_llm_tpu_torch.serving.observe import Histogram

        t_phase = time.perf_counter()
        transport = http_transport()

        def Tok():
            return IdTokenizer(cfg.vocab_size)

        def Client(srv):
            return HttpClient(srv, transport,
                              lambda msg: fail(f"serve_http: {msg}"))

        def expect(cond, what):
            if not cond:
                fail(f"serve_http: {what}")

        ec = dict(max_rows=8, max_seq_len=2048, page_size=128,
                  prefill_bucket=128, decode_horizon=4, kv_storage="bf16")

        def gated_engine(n_wave: int):
            """An engine whose thread holds its first tick until
            ``n_wave`` requests wait, so that the server's run and the
            direct run admit the same wave and run the same ticks."""
            return hold_first_tick(ServingEngine(cfg, params, EngineConfig(
                trace_requests=True, **ec), device=dev), n_wave)

        def hist_delta(after: Histogram, before: Histogram) -> Histogram:
            h = Histogram(after.bounds)
            h.counts = [a - b for a, b in zip(after.counts, before.counts)]
            h.count, h.sum = after.count - before.count, after.sum - before.sum
            return h

        rng = np.random.default_rng(41)
        lens, news = rng.integers(64, 1001, 8), rng.integers(32, 65, 8)
        prompts = [[int(v) for v in rng.integers(1, cfg.vocab_size, n)]
                   for n in lens]
        bodies = []
        for i, (ids, m) in enumerate(zip(prompts, news)):
            b = {"prompt": " ".join(map(str, ids)), "max_tokens": int(m)}
            b.update(dict(temperature=0.8, top_p=0.9, seed=3000 + i)
                     if i % 2 else dict(temperature=0.0))
            bodies.append(b)
        res = {"transport": transport, "card": card}

        # -- the server: eight completions at once, then the other routes
        eng = gated_engine(len(bodies))
        srv = OpenAIServer(eng, Tok(), "llama-2-7b-width")
        client = Client(srv)
        eng.start()
        pool = ThreadPoolExecutor(max_workers=16)
        for mod in kernels.values():
            mod.COUNTS.reset()
        h0 = {k: h.copy() for k, h in eng.histograms().items()}
        # a trace id each, whose first_token span carries the TTFT
        tids = [f"{0x5e7e000 + i:032x}" for i in range(len(bodies))]
        t0 = time.perf_counter()
        wave = list(pool.map(lambda bt: client.request(
            "POST", "/v1/completions", bt[0],
            {"traceparent": f"00-{bt[1]}-00f067aa0ba902b7-01"}),
            zip(bodies, tids)))
        wall = time.perf_counter() - t0
        hist = hist_delta(eng.histograms()["ttft_s"], h0["ttft_s"])
        for i, (status, _, body) in enumerate(wave):
            expect(status == 200, f"completion {i}: {status} {body}")
            ch = body["choices"][0]
            expect(ch["finish_reason"] == "length"
                   and body["usage"]["completion_tokens"]
                   == bodies[i]["max_tokens"]
                   and len(ch["text"].split()) == bodies[i]["max_tokens"],
                   f"completion {i}: {ch['finish_reason']}, {body['usage']}")
        out_tok = sum(b["usage"]["completion_tokens"] for _, _, b in wave)
        ttft = []
        for t in tids:
            st, _, trace = client.request("GET", f"/trace/{t}")
            ttft += [sp["attrs"]["ttft_s"] for sp in trace.get("spans", ())
                     if sp["name"] == "first_token"]
        expect(len(ttft) == len(bodies), f"{len(ttft)} first_token spans")
        res["server"] = dict(
            requests=len(wave), output_tokens=out_tok, wall_s=wall,
            output_tok_s=out_tok / wall, ttft_p50_s=hist.percentile(50),
            ttft_p95_s=hist.percentile(95), ttft_count=hist.count,
            ttft_exact_p50_s=float(np.percentile(ttft, 50)),
            ttft_exact_p95_s=float(np.percentile(ttft, 95)))

        tid = "5a1e3f2b9c8d7e6f0a1b2c3d4e5f6a7b"
        chat = [{"messages": [{"role": "user", "content": " ".join(
            map(str, prompts[i][:200]))}], "max_tokens": 32,
            "temperature": 0.0, "stream": True} for i in (0, 1)]
        jobs = [pool.submit(client.request, "POST", "/v1/chat/completions",
                            b) for b in chat]
        jobs.append(pool.submit(client.request, "POST", "/v1/completions", {
            "prompt": bodies[2]["prompt"], "max_tokens": 16,
            "temperature": 0.0, "stop": " "}))
        jobs.append(pool.submit(
            client.request, "POST", "/generate_stream",
            {"inputs": bodies[3]["prompt"],
             "parameters": {"max_new_tokens": 24}},
            {"traceparent": f"00-{tid}-00f067aa0ba902b7-01"}))
        (s1, _, ev1), (s2, _, ev2), (s3, _, stop_body), (s4, _, tgi) = [
            j.result() for j in jobs]
        for status, ev in ((s1, ev1), (s2, ev2)):
            expect(status == 200 and ev[-1] == "[DONE]", f"chat stream "
                   f"{status} {ev[-2:]}")
            pieces = [e["choices"][0]["delta"].get("content", "")
                      for e in ev[:-1]]
            expect(sum(1 for p in pieces if p) == 32 and ev[-2]["choices"][
                0]["finish_reason"] == "length", "a chat stream ended "
                f"with {len(pieces)} events")
        text = stop_body["choices"][0]["text"]
        expect(s3 == 200 and text.isdigit() and stop_body["choices"][0][
            "finish_reason"] == "stop", f"stop string: {stop_body}")
        toks = [e for e in tgi if e.get("token")]
        expect(s4 == 200 and len(toks) == 24 and tgi[-1]["details"][
            "finish_reason"] == "length" and tgi[-1]["generated_text"]
            == " ".join(str(e["token"]["id"]) for e in toks),
            f"TGI stream: {tgi[-1:]}")
        st, _, trace = client.request("GET", f"/trace/{tid}")
        names = {sp["name"] for sp in trace.get("spans", [])}
        expect(st == 200 and {"queue", "prefill_chunk", "first_token",
                              "decode_horizon", "finish"} <= names,
               f"trace: {st} {sorted(names)}")

        # deadlines: a 1000-id prompt cannot prefill within 0.05 s
        long_prompt = " ".join(map(str, rng.integers(1, cfg.vocab_size,
                                                     1000)))
        st408, _, body = client.request("POST", "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 32, "deadline_s": 0.05})
        expect(st408 == 408 and body["error"]["code"] == "timeout",
               f"deadline (whole): {st408} {body}")
        st, _, ev = client.request("POST", "/v1/completions", {
            "prompt": long_prompt, "max_tokens": 32, "deadline_s": 0.05,
            "stream": True})
        expect(st == 200 and any(isinstance(e, dict) and e.get(
            "error", {}).get("code") == "timeout" for e in ev),
            f"deadline (stream): {st} {ev[-2:]}")

        st, hdrs, metrics_text = client.request("GET", "/metrics")
        series = {ln.split("{")[0]: float(ln.rpartition(" ")[2])
                  for ln in metrics_text.splitlines()}
        expect(st == 200 and series.get("ipex_llm_tpu_ttft_s_count", 0)
               >= len(bodies) and series.get("ipex_llm_tpu_timeouts") == 2,
               f"/metrics: {st} {len(series)} series")
        st, _, mj = client.request("GET", "/metrics?format=json")
        expect(st == 200 and mj["metrics"]["tokens"] > 0
               and set(mj["histograms"]) == {"ttft_s", "token_latency_s",
                                             "tick_sync_s"},
               f"/metrics?format=json: {st}")
        st, _, flight = client.request("GET", "/debug/flight")
        expect(st == 200 and flight["recorded"] > 0 and flight["ring"],
               f"/debug/flight: {st}")
        st, _, models = client.request("GET", "/v1/models")
        expect(st == 200 and models["data"][0]["id"] == "llama-2-7b-width",
               f"/v1/models: {st} {models}")
        st, _, health = client.request("GET", "/health")
        expect(st == 200 and health["status"] == "ok"
               and health["weights"]["qtype"] == "sym_int4"
               and health["kv"]["spill_enabled"] is False
               and health["fault_domain"]["timeouts"] == 2,
               f"/health: {st} {health}")
        counts = {name: (mod.COUNTS.launches, mod.COUNTS.plain_calls)
                  for name, mod in kernels.items()}
        routes = {"qmatmul": dict(b2.COUNTS.by_route),
                  "ragged_paged_attention": dict(b1.COUNTS.by_route)}
        for name, (launches, plain) in counts.items():
            if plain != 0 or (name in serve_path and launches == 0):
                fail(f"serve_http: {name} launched {launches} times, plain "
                     f"version called {plain} times")
        if min(routes["qmatmul"].values()) == 0:
            fail(f"serve_http: an instance of B2 never launched ({routes})")
        m = dict(eng.metrics)
        res.update(launches={k: v[0] for k, v in counts.items()},
                   plain_calls={k: v[1] for k, v in counts.items()},
                   launches_by_route=routes,
                   host_syncs_per_tick=1 + m["liveness_syncs"]
                   / m["host_syncs"], host_sync_s=m["host_sync_s"],
                   tokens_per_sync=m["tokens_per_sync"],
                   flight_records=flight["recorded"],
                   metrics_series=len(series), health_decode=health[
                       "decode"])
        client.close()      # drains the engine and stops it
        del eng, srv, client
        torch.cuda.empty_cache()

        # -- admission under load: one row, a queue of one ---------------
        eng = ServingEngine(cfg, params, EngineConfig(
            max_queue=1, pool_pages=20, **dict(ec, max_rows=1)), device=dev)
        client = Client(OpenAIServer(eng, Tok(), "llama-2-7b-width"))
        eng.start()
        first = pool.submit(client.request, "POST", "/v1/completions", {
            "prompt": bodies[0]["prompt"], "max_tokens": 48,
            "temperature": 0.0})
        for _ in range(6000):
            if eng.metrics["requests"] >= 1:
                break
            time.sleep(0.005)
        queued = pool.submit(client.request, "POST", "/v1/completions", {
            "prompt": bodies[1]["prompt"], "max_tokens": 4})
        for _ in range(2000):
            if eng.queue_depth >= 1:
                break
            time.sleep(0.005)
        st429, hdrs, body = client.request("POST", "/v1/completions", {
            "prompt": "9", "max_tokens": 2})
        expect(st429 == 429 and body["error"]["code"] == "queue_full"
               and int(hdrs["Retry-After"]) >= 1,
               f"the third request: {st429} {body}")
        st, _, health = client.request("GET", "/health")
        expect(health["fault_domain"]["queue_depth"] == 1
               and health["fault_domain"]["rejected"] >= 1,
               f"/health under load: {health['fault_domain']}")
        t_drain = time.perf_counter()
        expect(eng.drain(timeout=120), "drain did not finish the work")
        res["drain_s"] = time.perf_counter() - t_drain
        for job, n in ((first, 48), (queued, 4)):
            st, _, body = job.result()
            expect(st == 200 and body["usage"]["completion_tokens"] == n,
                   f"a drained request: {st} {body}")
        st, _, health = client.request("GET", "/health")
        expect(health["status"] == "draining", f"/health: {health}")
        st503, hdrs, body = client.request("POST", "/v1/completions", {
            "prompt": "9", "max_tokens": 2})
        expect(st503 == 503 and body["error"]["code"] == "engine_draining",
               f"a request while draining: {st503} {body}")
        res["admission"] = dict(
            rejected=eng.metrics["rejected"], queue_full=st429,
            draining=st503, deadline=st408,
            retry_after_draining_s=int(hdrs["Retry-After"]))
        client.close()
        del eng, client
        torch.cuda.empty_cache()

        # -- the same eight requests straight to an engine of the same
        # configuration (the server's engine would serve these prompts
        # from its prefix cache and so run other ticks)
        eng = gated_engine(len(bodies)).start()
        reqs = [Request(prompt_ids=ids, max_new_tokens=b["max_tokens"],
                        temperature=b["temperature"],
                        top_p=b.get("top_p", 1.0), seed=b.get("seed"))
                for ids, b in zip(prompts, bodies)]
        h0 = {k: h.copy() for k, h in eng.histograms().items()}
        t0 = time.perf_counter()
        for q in reqs:
            eng.submit(q)
        streams = [list(stream_tokens(q, timeout=600)) for q in reqs]
        wall = time.perf_counter() - t0
        hist = hist_delta(eng.histograms()["ttft_s"], h0["ttft_s"])
        eng.stop()
        pool.shutdown()
        ttft = [q.first_token_s for q in reqs]
        res["direct"] = dict(
            requests=len(reqs), output_tokens=sum(map(len, streams)),
            wall_s=wall, output_tok_s=sum(map(len, streams)) / wall,
            ttft_p50_s=hist.percentile(50), ttft_p95_s=hist.percentile(95),
            ttft_exact_p50_s=float(np.percentile(ttft, 50)),
            ttft_exact_p95_s=float(np.percentile(ttft, 95)))
        same = []
        for i, ((_, _, body), st) in enumerate(zip(wave, streams)):
            text = body["choices"][0]["text"]
            same.append(text == " ".join(map(str, st)))
            if not same[-1]:
                a, b = text.split(), [str(t) for t in st]
                j = next((j for j in range(min(len(a), len(b)))
                          if a[j] != b[j]), min(len(a), len(b)))
                fail(f"serve_http: request {i} ("
                     f"{'seeded' if i % 2 else 'greedy'}) differs from the "
                     f"engine's stream at token {j} of {len(b)}")
        res["server_equals_engine"] = all(same)
        del eng
        torch.cuda.empty_cache()
        res["phase_s"] = time.perf_counter() - t_phase
        print("serve_http " + json.dumps(res), flush=True)
        return res

    (report["serve"], report["serve_spec"], report["serve_http"],
     report["serve_faults"]) = serve_phase()
    torch.cuda.empty_cache()

    # -- 5a. the model API over a Llama-2-7B-width checkpoint ----------------
    from torch_load_smoke import load_phase

    report["load"] = load_phase(kernels, card, fail, dev)
    print("load " + json.dumps(report["load"]), flush=True)
    torch.cuda.empty_cache()

    # -- 5b. a real sticky CUDA error inside a tick, in a child process ------
    def sticky_fault_phase() -> dict:
        """``scripts/torch_sticky_fault.py`` in a process of its own (the
        poisoned context dies with it): its report must show the
        device-side assert classified not transient, ``errors`` 1, every
        request finished "error", the engine thread ended, ``/health`` 503
        "dead" and a later request failed at once."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_sticky_fault.py")],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            fail(f"sticky_fault: the child printed no report (exit "
                 f"{proc.returncode}): {proc.stderr[-2000:]}")
        rep = json.loads(lines[-1])
        if (proc.returncode != 0 or rep.get("is_transient") is not False
                or rep.get("errors") != 1 or not rep.get("finish_reasons")
                or any(r != "error" for r in rep["finish_reasons"])
                or rep.get("thread_ended") is not True
                or rep.get("health") != [503, "dead"]
                or rep.get("late_request", [0])[0] is not None
                or rep["late_request"][1] != "error"):
            fail(f"sticky_fault: exit {proc.returncode}, report {rep}")
        rep["phase_s"] = time.perf_counter() - t0
        print("sticky_fault " + json.dumps(rep), flush=True)
        return rep

    report["sticky_fault"] = sticky_fault_phase()

    # -- 5c. serving a bf16 tree in each block format ------------------------
    def serve_formats_phase():
        """One random bf16 tree, repacked by the engine into each of the
        nine other formats (``EngineConfig.weight_qtype``), then a tree
        with a sym_int8 lm head over a sym_int4 body; two requests each."""
        t0 = time.perf_counter()
        params = random_params(cfg, "bf16", seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"Llama-2-7B-width random bf16 weights: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)
        ec = dict(max_rows=8, max_seq_len=2048, page_size=128,
                  prefill_bucket=128, decode_horizon=4)

        def reqs(seed: int):
            rng = np.random.default_rng(seed)
            return [Request(prompt_ids=[int(v) for v in rng.integers(
                        1, cfg.vocab_size, n)], max_new_tokens=24, **kw)
                    for n, kw in ((300, {}), (700, dict(
                        temperature=0.8, top_p=0.9, seed=77)))]

        rows = []
        for i, qtype in enumerate(b2.FORMATS[1:]):
            t0 = time.perf_counter()
            eng = ServingEngine(cfg, params, EngineConfig(
                weight_qtype=qtype, **ec), device=dev)
            torch.cuda.synchronize()
            repack_s = time.perf_counter() - t0
            ws = eng.weight_stats()
            if ws["qtype"] != qtype or ws["packed_qtypes"] != [qtype]:
                fail(f"serve_formats: weight_stats {ws} for {qtype}")
            rows.append(dict(qtype=qtype, repack_s=repack_s,
                             weight_bytes=ws["weight_bytes"],
                             dense_bytes=ws["dense_bytes"],
                             **serve_run(f"weight_qtype={qtype}", eng,
                                         reqs(20 + i), (qtype,))))
            del eng
            torch.cuda.empty_cache()
        body = requantize_params(params, "sym_int4")
        mixed = dict(body, lm_head=requantize_params(
            {"lm_head": params["lm_head"]}, "sym_int8")["lm_head"])
        del params, body
        eng = ServingEngine(cfg, mixed, EngineConfig(
            weight_qtype="sym_int4", **ec), device=dev)
        ws = eng.weight_stats()
        if ws["qtype"] != "mixed" or ws["packed_qtypes"] != ["sym_int4",
                                                              "sym_int8"]:
            fail(f"serve_formats: weight_stats {ws} for the mixed tree")
        rows.append(dict(qtype="mixed (sym_int8 lm head, sym_int4 body)",
                         weight_bytes=ws["weight_bytes"],
                         dense_bytes=ws["dense_bytes"],
                         **serve_run("mixed tree", eng, reqs(40),
                                     ("sym_int4", "sym_int8"))))
        del eng, mixed
        torch.cuda.empty_cache()
        return rows

    t_phase = time.perf_counter()
    report["serve_formats"] = serve_formats_phase()
    report["serve_formats_s"] = time.perf_counter() - t_phase

    # -- 6. B3 at Mistral-7B widths ------------------------------------------
    def b3_case(kv_dtype, window, softcap, s=2304,
                kv_len=(2100, 1500, 1990, 777), kv_start=(0, 211, 1003, 37),
                hq=32, hkv=8, d=128):
        """By default B=4 rows over a capacity of 2304 slots, ragged left
        padding and fill (a 1024 window cuts rows 0 and 1), at Mistral-7B's
        heads; q scaled by CAP_Q_SCALE where a softcap is set."""
        b = len(kv_len)
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        kv_start = torch.tensor(kv_start, dtype=torch.int32, device=dev)
        q = (torch.randn(b, 1, hq, d, generator=gen, device=dev)
             * (CAP_Q_SCALE if softcap else 1.0)).to(torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev).to(kv_dtype)
        return q, k, v, kv_len, kv_start, dict(window=window,
                                               softcap=softcap)

    def b3_run(name, q, k, v, kv_len, kv_start, window, softcap):
        b, _, hq, d = q.shape
        kwargs = dict(kv_len=kv_len, kv_start=kv_start, window=window,
                      window_on=True, softcap=softcap)
        out = b3.decode_sdpa(q, k, v, **kwargs)
        kl, ks, won = b3.row_vectors(b, k.shape[2], dev, kv_len, kv_start,
                                     True)
        plain = lambda: b3.decode_sdpa_plain(            # noqa: E731
            q, k, v, scale=d ** -0.5, kv_len=kl, kv_start=ks, won=won,
            window=window, softcap=softcap)
        ref = plain()
        torch.cuda.synchronize()
        err, worst = check_rows(out, ref, f"B3 {name}")
        gap = None if softcap is None else cap_binds(
            ref, b3.decode_sdpa_plain(q, k, v, scale=d ** -0.5, kv_len=kl,
                                      kv_start=ks, won=won, window=window,
                                      softcap=None), f"B3 {name}")
        # rotate over copies of the cache layer so each launch finds it out
        # of L2, as each layer's cache is on the decode path
        lay_bytes = 2 * k.numel() * k.element_size()
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(
            math.ceil(2 * L2_BYTES / lay_bytes))]
        calls = [lambda kc=kc, vc=vc: b3.decode_sdpa(q, kc, vc, **kwargs)
                 for kc, vc in copies * max(1, 24 // len(copies))]
        ms = graph_ms(torch, calls)
        eager_ms = time_ms(calls[0], 50)
        plain_ms = time_ms(plain, 3)
        lo = b3.first_visible(kl, ks, won, window)
        n_vis = (kl - lo).clamp(min=0)
        hkv = k.shape[1]
        nbytes = (int(n_vis.sum()) * hkv * d * k.element_size() * 2
                  + 2 * q.numel() * 2)
        bms, by = bound(nbytes, 4.0 * d * hq * int(n_vis.sum()))
        lib_ms = None
        if softcap is None:
            kpos = torch.arange(k.shape[2], device=dev)
            mask = ((kpos[None] >= lo[:, None]) & (kpos[None] < kl[:, None])
                    )[:, None, None, :]
            kw, vw = k.to(torch.bfloat16), v.to(torch.bfloat16)
            qt = q.transpose(1, 2)
            lib_ms = graph_ms(torch, [lambda: sdpa_gqa(qt, kw, vw, mask)] * 24)
            del kw, vw
        row = dict(case=name, shape=f"B={b} Hq={hq} Hkv={hkv} D={d} "
                   f"S={k.shape[2]}",
                   max_abs_err=err, max_rel_err=worst, tol_rel=ATTN_TOL_REL,
                   softcap_gap=gap,
                   ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=by,
                   splits=b3.split_plan(b, hkv, k.shape[2], d))
        print("B3 " + json.dumps(row), flush=True)
        return row

    rows = []
    for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                              ("e5m2", torch.float8_e5m2)):
        for label, window, softcap in (("window off", None, None),
                                       ("window 1024", 1024, None),
                                       ("softcap 50", None, 50.0)):
            q, k, v, kl, ks, kw = b3_case(kv_dtype, window, softcap)
            rows.append(b3_run(f"{kv_name} {label}", q, k, v, kl, ks,
                               **kw))
            del q, k, v
        # run (d)'s last decode step: a 4500-id prompt in the 4608 bucket
        # (kv_start 108), capacity 4608 + 256, 31 steps in; the window
        # starts at slot 543
        q, k, v, kl, ks, kw = b3_case(kv_dtype, 4096, None, s=4864,
                                      kv_len=(4639,), kv_start=(108,))
        rows.append(b3_run(f"{kv_name} run (d), window 4096", q, k, v, kl,
                           ks, **kw))
        del q, k, v
    # the window off on one row only (a per-row enable vector)
    q, k, v, kl, ks, _ = b3_case(torch.bfloat16, 1024, None)
    won = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    out = b3.decode_sdpa(q, k, v, kv_len=kl, kv_start=ks, window=1024,
                         window_on=won)
    ref = b3.decode_sdpa_plain(q, k, v, scale=128 ** -0.5, kv_len=kl,
                               kv_start=ks, won=won, window=1024,
                               softcap=None)
    check_rows(out, ref, "B3 per-row window enable")
    # checked only: every GQA group the kernel takes, at a capacity that is
    # not a multiple of the tile, with ragged rows, left padding, a row
    # that sees no key (row 3) and the window off on row 2
    b3_checks = 0
    for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                              ("e5m2", torch.float8_e5m2)):
        for g in (1, 2, 4, 8):
            for extra in ({}, dict(window=100), dict(softcap=50.0)):
                q, k, v, kl, ks, _ = b3_case(
                    kv_dtype, None, None, s=700,
                    kv_len=(700, 333, 65, 1, 150),
                    kv_start=(0, 37, 64, 1, 100))
                q = q[:, :, :2 * g].contiguous()
                if "softcap" in extra:
                    q = (q.float() * CAP_Q_SCALE).to(torch.bfloat16)
                k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
                won = torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32,
                                   device=dev)
                out = b3.decode_sdpa(q, k, v, kv_len=kl, kv_start=ks,
                                     window_on=won, **extra)
                ref = b3.decode_sdpa_plain(
                    q, k, v, scale=128 ** -0.5, kv_len=kl, kv_start=ks,
                    won=won, window=extra.get("window"),
                    softcap=extra.get("softcap"))
                check_rows(out, ref, f"B3 {kv_name} G={g} {extra}")
                if "softcap" in extra:
                    cap_binds(ref, b3.decode_sdpa_plain(
                        q, k, v, scale=128 ** -0.5, kv_len=kl, kv_start=ks,
                        won=won, window=None, softcap=None),
                        f"B3 {kv_name} G={g} {extra}")
                if out[3].any():
                    fail(f"B3 {kv_name} G={g}: a row with no key is not 0")
                b3_checks += 1
    print(f"B3: {b3_checks} small cases within tolerance", flush=True)
    report["b3"] = rows
    report["b3_small_checks"] = b3_checks
    torch.cuda.empty_cache()

    # -- 6b. B3 at head_dim 256: Gemma-2-9B's 16 query heads over 8 kv heads,
    # the engine's gathered layer (capacity 6144), the 4096 window cutting;
    # the window alone (SDPA beside it) and with softcap 50
    rows = []
    for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                              ("e5m2", torch.float8_e5m2)):
        for b in (4, 8):
            fills = (6100, 4500, 5050, 900, 6144, 4097, 2000, 64)[:b]
            for label, softcap in (("window 4096", None),
                                   ("window 4096 softcap 50", 50.0)):
                q, k, v, kl, ks, kw = b3_case(
                    kv_dtype, 4096, softcap, s=6144, kv_len=fills,
                    kv_start=(0,) * b, hq=16, hkv=8, d=256)
                rows.append(b3_run(f"D=256 {kv_name} B={b} {label}", q, k,
                                   v, kl, ks, **kw))
                del q, k, v
    report["b3_d256"] = rows
    torch.cuda.empty_cache()

    # -- 7. B4 ---------------------------------------------------------------
    def b4_case(b, t, cap, lengths, *, causal=True, window=None,
                softcap=None, hq=32, hkv=8, d=128, kv_len=None,
                offsets=None):
        """K/V as the dense cache holds them (head-major [B, Hkv, cap, D],
        read through the [B, cap, Hkv, D] view); causal rows left padded
        to ``t`` (kv_start = t - length), queries at slots 0..t-1; or, with
        per-row ``offsets``, each row's queries at slots offset..offset+t-1
        of the engine's gathered layer (kv_len = offset + t, kv_start 0);
        q scaled by CAP_Q_SCALE where a softcap is set."""
        q = (torch.randn(b, t, hq, d, generator=gen, device=dev)
             * (CAP_Q_SCALE if softcap else 1.0)).to(torch.bfloat16)
        k_hm = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
            torch.bfloat16)
        v_hm = torch.randn(b, hkv, cap, d, generator=gen, device=dev).to(
            torch.bfloat16)
        ks = torch.tensor([t - n for n in lengths], dtype=torch.int32,
                          device=dev)
        kl = torch.tensor(kv_len or [t] * b, dtype=torch.int32, device=dev)
        qpos = torch.arange(t, device=dev)[None].expand(b, t)
        if offsets is not None:
            off = torch.tensor(offsets, dtype=torch.int32, device=dev)
            ks = torch.zeros_like(off)
            kl = off + t
            qpos = off[:, None] + torch.arange(t, device=dev)[None]
        return dict(q=q, k_hm=k_hm, v_hm=v_hm, kv_start=ks, kv_len=kl,
                    q_positions=qpos, causal=causal, window=window,
                    softcap=softcap)

    def b4_run(name, c):
        """The kernel and SDPA timed as device time from CUDA-graph
        replays (a short call's eager time is the host's pace)."""
        q, k_hm, v_hm = c["q"], c["k_hm"], c["v_hm"]
        k, v = k_hm.transpose(1, 2), v_hm.transpose(1, 2)
        b, t, hq, d = q.shape
        kw = dict(causal=c["causal"], q_positions=c["q_positions"],
                  kv_len=c["kv_len"], kv_start=c["kv_start"],
                  window=c["window"], window_on=True, softcap=c["softcap"])
        out = b4.flash_sdpa(q, k, v, **kw)
        kl, ks, won = b3.row_vectors(b, k.shape[1], dev, c["kv_len"],
                                     c["kv_start"], True)
        plain = lambda: b4.flash_sdpa_plain(              # noqa: E731
            q, k, v, scale=d ** -0.5, causal=c["causal"],
            q_positions=c["q_positions"].long(), kv_len=kl, kv_start=ks,
            won=won, window=c["window"], softcap=c["softcap"])
        ref = plain()
        torch.cuda.synchronize()
        err, worst = check_rows(out, ref, f"B4 {name}")
        gap = None if c["softcap"] is None else cap_binds(
            ref, b4.flash_sdpa_plain(
                q, k, v, scale=d ** -0.5, causal=c["causal"],
                q_positions=c["q_positions"].long(), kv_len=kl, kv_start=ks,
                won=won, window=c["window"], softcap=None), f"B4 {name}")
        del out, ref
        ms = graph_ms(torch, [lambda: b4.flash_sdpa(q, k, v, **kw)] * 10)
        plain_ms = time_ms(plain, 1)
        # visible (query, key) pairs and the slots they read
        qp = c["q_positions"].long()
        lo = ks.long()[:, None].expand(b, t)
        hi = kl.long()[:, None].expand(b, t)
        if c["causal"]:
            hi = torch.minimum(hi, qp + 1)
            if c["window"] is not None:
                lo = torch.maximum(lo, qp - c["window"] + 1)
        pairs = int((hi - lo).clamp(min=0).sum())
        hkv = k.shape[2]
        # each row reads the union of its queries' visible keys once (the
        # ranges are contiguous and move with the query slot)
        seen = hi > lo
        row_lo = torch.where(seen, lo, torch.iinfo(lo.dtype).max).amin(1)
        row_hi = torch.where(seen, hi, 0).amax(1)
        slots = int((row_hi - row_lo).clamp(min=0).sum())
        nbytes = 2 * q.numel() * 2 + slots * hkv * d * 2 * 2
        bms, by = bound(nbytes, 4.0 * d * hq * pairs)
        lib_ms = None
        if c["softcap"] is None:
            kpos = torch.arange(k.shape[1], device=dev)
            mask = (kpos[None, None] >= lo[:, :, None]) & (
                kpos[None, None] < hi[:, :, None])
            qt = q.transpose(1, 2)

            lib_ms = graph_ms(torch, [lambda: sdpa_gqa(
                qt, k_hm, v_hm, mask[:, None])] * 10)
            del mask
        row = dict(case=name, shape=f"B={b} T={t} S={k.shape[1]} Hq={hq} "
                   f"Hkv={hkv} D={d}", max_abs_err=err, max_rel_err=worst,
                   tol_rel=ATTN_TOL_REL, softcap_gap=gap, ms=ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bms, bound_by=by,
                   visible_pairs=pairs)
        print("B4 " + json.dumps(row), flush=True)
        return row

    rows = [
        b4_run("generate bucket, left padded",
               b4_case(4, 2048, 2304, [1990, 1327, 611, 203],
                       window=4096)),
        b4_run("4500-id prompt, window 4096 cuts",
               b4_case(1, 4608, 4864, [4500], window=4096)),
        b4_run("softcap 50", b4_case(2, 256, 512, [256, 190],
                                     softcap=50.0, window=64)),
        b4_run("non-causal", b4_case(2, 200, 300, [200, 183],
                                     causal=False, kv_len=[300, 250])),
    ]
    # checked only: T not a multiple of the 64-query tile, G = 1 and 4
    b4_checks = 0
    for t in (200, 1000):
        for g in (1, 4):
            for kind in ("window cuts", "softcap", "non-causal"):
                c = b4_case(2, t, t + 64, [t, t - 77], hq=2 * g, hkv=2,
                            **({"window": 150} if kind == "window cuts" else
                               {"softcap": 50.0} if kind == "softcap" else
                               {"causal": False, "kv_len": [t + 64, t + 24]}))
                q, k, v = c["q"], c["k_hm"].transpose(1, 2), \
                    c["v_hm"].transpose(1, 2)
                kl, ks, won = b3.row_vectors(2, t + 64, dev, c["kv_len"],
                                             c["kv_start"], True)
                out = b4.flash_sdpa(
                    q, k, v, causal=c["causal"],
                    q_positions=c["q_positions"], kv_len=c["kv_len"],
                    kv_start=c["kv_start"], window=c["window"],
                    softcap=c["softcap"])
                ref = b4.flash_sdpa_plain(
                    q, k, v, scale=128 ** -0.5, causal=c["causal"],
                    q_positions=c["q_positions"].long(), kv_len=kl,
                    kv_start=ks, won=won, window=c["window"],
                    softcap=c["softcap"])
                check_rows(out, ref, f"B4 T={t} G={g} {kind}")
                if kind == "softcap":
                    cap_binds(ref, b4.flash_sdpa_plain(
                        q, k, v, scale=128 ** -0.5, causal=True,
                        q_positions=c["q_positions"].long(), kv_len=kl,
                        kv_start=ks, won=won, window=None, softcap=None),
                        f"B4 T={t} G={g} {kind}")
                b4_checks += 1
    print(f"B4: {b4_checks} small cases within tolerance", flush=True)
    report["b4"] = rows
    report["b4_small_checks"] = b4_checks
    torch.cuda.empty_cache()

    # -- 7b. B4 at head_dim 256: Gemma-2-9B's heads over the engine's
    # gathered layer (capacity 6144), per-row query slots, the 4096 window:
    # prefill chunks of 128, the verify width of spec_k 3 (T = 4) and a
    # 2048-query prompt, each with softcap 50 and, for the yardstick, the
    # window alone
    g2 = dict(hq=16, hkv=8, d=256, window=4096)
    rows = []
    for label, b, t, offsets in (
            ("T=128 chunks", 8, 128, [0, 500, 1000, 3000, 4200, 4800,
                                      5500, 6000]),
            ("T=4 verify", 8, 4, [40, 700, 1500, 3000, 4095, 4500, 5800,
                                  6140]),
            ("T=2048 prompt", 2, 2048, [0, 4000])):
        for softcap in (None, 50.0):
            rows.append(b4_run(
                f"D=256 {label}" + (" softcap 50" if softcap else ""),
                b4_case(b, t, 6144, [t] * b, offsets=offsets,
                        softcap=softcap, **g2)))
    report["b4_d256"] = rows
    torch.cuda.empty_cache()

    # -- 8. B2 at Mistral-7B's shapes ------------------------------------------
    # the lm head sees one token per row (last_token_only)
    report["b2m"] = b2_rows(MISTRAL_7B_SHAPES, (4, 8192),
                            lambda w, m: w != "lm_head" or m == 4,
                            "mistral-7b", "sym_int4",
                            iters=lambda m: 30 if m < 1024 else 3)
    torch.cuda.empty_cache()

    # -- 8b. B2 at Qwen2-7B's and Gemma-2-9B's shapes -------------------------
    report["b2f"] = []
    for tag, shapes in (("qwen2-7b", QWEN2_7B_SHAPES),
                        ("gemma2-9b", GEMMA2_9B_SHAPES)):
        report["b2f"] += b2_rows(shapes, (1, 8, 128),
                                 lambda w, m: w != "lm_head" or m <= 8,
                                 tag, "sym_int4")
    # the other nine formats, checked only, at the two new K
    b2f_checks = 0
    for qtype in b2.FORMATS[1:]:
        for k, n in ((18944, 3584), (14336, 3584)):
            wq = quantize(torch.randn(k, n, generator=gen, device=dev)
                          * (1.2 / math.sqrt(k)), qtype)
            for m in (1, 8, 128):
                x = torch.randn(m, k, generator=gen, device=dev).to(
                    torch.bfloat16)
                check_b2(b2.qmatmul(x, wq), b2.qmatmul_plain(x, wq),
                         f"{qtype} K={k} N={n} M={m}")
                b2f_checks += 1
            del wq
    report["b2f_format_checks"] = b2f_checks
    print(f"B2: {b2f_checks} checks of the nine other formats at K = 18944 "
          "and 14336 within tolerance", flush=True)
    torch.cuda.empty_cache()

    # -- 9. a small mistral, dense form: card against CPU -------------------
    small = mistral_7b_config(hidden_size=512, intermediate_size=1024,
                              num_layers=2, num_heads=4, num_kv_heads=2,
                              vocab_size=512, sliding_window=24)
    p_cpu = random_params(small, "sym_int4", seed=2, device="cpu")
    p_dev = to_dev(p_cpu)
    rng = np.random.default_rng(4)
    b, t = 3, 40
    lengths = np.array([40, 17, 29])
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    kv_start = (t - lengths).astype(np.int32)
    pos = np.maximum(np.arange(t)[None] - kv_start[:, None], 0)
    steps = [(toks, pos)]
    for i in range(4):
        steps.append((rng.integers(0, 512, (b, 1)).astype(np.int32),
                      (lengths + i)[:, None]))
    caches = {name: (make_cache("normal", 2, b, t + 16, 2, 128,
                                device=device), params, device)
              for name, device, params in (("cpu", "cpu", p_cpu),
                                           ("cuda", dev, p_dev))}
    worst = 0.0
    for tk, ps_ in steps:
        outs = {}
        for name, (c, params, device) in caches.items():
            lg, _ = decoder_forward(
                small, params, torch.from_numpy(tk).to(device), c,
                torch.from_numpy(np.ascontiguousarray(ps_)).to(device),
                torch.from_numpy(kv_start).to(device),
                last_token_only=True)
            outs[name] = lg.float().cpu().numpy()
        span = outs["cpu"].max() - outs["cpu"].min()
        diff = np.abs(outs["cuda"] - outs["cpu"]).max() / span
        worst = max(worst, float(diff))
        if not np.isfinite(outs["cuda"]).all() or diff > 0.025:
            fail(f"small mistral: card vs CPU logits differ by "
                 f"{diff:.4f} of the logit range (bound 0.025)")
    print(f"small mistral (window 24) card vs CPU: worst logit diff "
          f"{worst:.5f} of the range (bound 0.025)", flush=True)
    report["small_mistral_worst_rel"] = worst
    del caches, p_dev

    # -- 10. generate at Mistral-7B-v0.1 widths -----------------------------
    def generate_phase():
        from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM

        cfg = mistral_7b_config()
        t0 = time.perf_counter()
        params = random_params(cfg, "sym_int4", seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"Mistral-7B-width random sym_int4 weights: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              "card", flush=True)
        model = TPUModelForCausalLM(cfg, params, MISTRAL_7B_V01_HF,
                                    "sym_int4")
        path = {"qmatmul": b2, "decode_attention": b3,
                "flash_attention": b4}

        def prompts(lengths, seed):
            rng = np.random.default_rng(seed)
            width = max(lengths)
            ids = np.zeros((len(lengths), width), np.int64)
            mask = np.zeros((len(lengths), width), np.int64)
            for i, n in enumerate(lengths):
                ids[i, width - n:] = rng.integers(3, cfg.vocab_size, n)
                mask[i, width - n:] = 1
            return torch.from_numpy(ids), torch.from_numpy(mask)

        def run(label, lengths, new, fp8=False, **gen_kw):
            ids, mask = prompts(lengths, 11)
            for mod in kernels.values():
                mod.COUNTS.reset()
            if fp8:
                os.environ["IPEX_LLM_TPU_QUANTIZE_KV_CACHE"] = "1"
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            try:
                out = model.generate(ids, attention_mask=mask,
                                     max_new_tokens=new, eos_token_id=(),
                                     **gen_kw)
            finally:
                os.environ.pop("IPEX_LLM_TPU_QUANTIZE_KV_CACHE", None)
            wall = time.perf_counter() - t_start
            counts = {name: (mod.COUNTS.launches, mod.COUNTS.plain_calls)
                      for name, mod in kernels.items()}
            res = model.last_result
            if not isinstance(out, torch.Tensor) or out.dtype != torch.long:
                fail(f"generate {label}: returned {type(out)}")
            if tuple(out.shape) != (len(lengths), max(lengths) + new):
                fail(f"generate {label}: sequences of shape "
                     f"{tuple(out.shape)}")
            if list(res.num_new_tokens) != [new] * len(lengths):
                fail(f"generate {label}: new tokens per row "
                     f"{list(res.num_new_tokens)}, want {new}")
            new_ids = out[:, -new:]
            if int(new_ids.min()) < 0 or int(new_ids.max()) >= \
                    cfg.vocab_size:
                fail(f"generate {label}: token out of range")
            for name, (launches, plain) in counts.items():
                if plain != 0 or (name in path and launches == 0):
                    fail(f"generate {label}: {name} launched {launches} "
                         f"times, plain version called {plain} times")
            n_out = len(lengths) * new
            row = dict(case=label, rows=len(lengths),
                       prompt_tokens=int(sum(lengths)),
                       prompt_bucket=-(-max(lengths) // 128) * 128,
                       new_tokens=new, output_tokens=n_out, wall_s=wall,
                       output_tok_s=n_out / wall,
                       first_cost_s=model.first_cost,
                       rest_cost_mean_s=model.rest_cost_mean,
                       decode_tok_s=len(lengths) / model.rest_cost_mean,
                       host_syncs=res.host_syncs,
                       cache=res.cache_kind,
                       launches={k: v[0] for k, v in counts.items()},
                       distinct_new_tokens=int(torch.unique(new_ids).numel()))
            print("generate " + json.dumps(row), flush=True)
            return row

        four = [1990, 1327, 611, 203]
        rows = [run("(a) greedy, bf16 cache", four, 64),
                run("(b) sampled t=0.8 top_p=0.9", four, 64, do_sample=True,
                    temperature=0.8, top_p=0.9, seed=5),
                run("(c) greedy, e5m2 cache", four, 64, fp8=True),
                run("(d) 4500-id prompt, window 4096", [4500], 32)]
        stages = profile_stages(cfg, params, four, 64)
        del model, params
        torch.cuda.empty_cache()
        return rows, stages

    def profile_stages(cfg, params, lengths, new):
        """Run (a) by stage (prefill with its first sample, then the decode
        loop) over a fresh bf16 cache: once for the host wall clock, once
        under ``torch.profiler`` for the kernels' device time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from ipex_llm_tpu_torch import generation as g
        from ipex_llm_tpu_torch.ops.sampling import sample

        rng = np.random.default_rng(11)
        gcfg = g.GenerationConfig(max_new_tokens=new)
        tokens, lens, tpad = g.pad_batch(
            [rng.integers(3, cfg.vocab_size, n).tolist() for n in lengths], 0)
        tok_t = torch.from_numpy(tokens).to(dev)
        len_t = torch.from_numpy(lens).to(dev)
        kv_start = torch.from_numpy((tpad - lens).astype(np.int32)).to(dev)

        def stages():
            cache = make_cache("normal", cfg.num_layers, len(lengths),
                               tpad + g._round_up(new + 1, g.DECODE_BLOCK),
                               cfg.num_kv_heads, cfg.head_dim, device=dev)
            state = {}

            def prefill():
                logits, _ = g.prefill_step(cfg, params, cache, tok_t, len_t)
                state["first"] = sample(logits, None, gcfg.sampling())
                return 1

            def decode():
                ring = torch.from_numpy(g._init_prev_ring(tokens, lens)).to(
                    dev)
                _, steps, _ = g.decode_loop(cfg, params, cache,
                                            state["first"], len_t, kv_start,
                                            ring, None, gcfg, new)
                return steps - 1
            return prefill, decode

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0, n

        names = (f"prefill (B={len(lengths)}, bucket {tpad})",
                 f"decode (B={len(lengths)}, {new - 1} steps)")
        walls = {name: timed(fn) for name, fn in zip(names, stages())}
        rows = []
        for name, fn in zip(names, stages()):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_prof, _ = timed(fn)
            kern: dict = {}
            for ev in prof.events():
                if ev.device_type != DeviceType.CUDA:
                    continue
                k = kern.setdefault(ev.name, [0.0, 0])
                k[0] += ev.device_time_total / 1e6
                k[1] += 1
            if not kern:
                fail(f"profile {name}: the profiler saw no device time")
            wall, steps = walls[name]
            busy = sum(v[0] for v in kern.values())
            top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
            row = {"stage": name, "steps": steps, "wall_s": wall,
                   "wall_s_profiled": wall_prof, "device_s": busy,
                   "idle_share": 1.0 - busy / wall,
                   "launches_per_step": sum(v[1] for v in kern.values())
                   / max(steps, 1),
                   "top": [{"kernel": k[:80], "s": v[0], "launches": v[1]}
                           for k, v in top]}
            print("profile " + json.dumps(row), flush=True)
            rows.append(row)
        return rows

    report["generate"], report["generate_profile"] = generate_phase()

    # -- 11. the qwen2 and gemma2 families, and three paths at full width ----
    from torch_families_smoke import families_phase

    report["families"] = families_phase(kernels, card, fail, dev)
    print(f"families phase: {report['families']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 12. rope scaling and the phi3, gemma and gemma3 families ----------
    from torch_rope_families_smoke import rope_families_phase

    report["rope_families"] = rope_families_phase(kernels, card, fail, dev,
                                                  graph_ms)
    print(f"rope_families phase: {report['rope_families']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 13. mixture of experts: B2e, Mixtral-8x7B, Qwen3-30B-A3B -----------
    from torch_moe_smoke import moe_phase

    report["moe"] = moe_phase(kernels, card, fail, dev, graph_ms)
    print(f"moe phase: {report['moe']['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- 14. DeepSeek: MLA at K 192 / V 128, V2-Lite and V3 -----------------
    from torch_deepseek_smoke import deepseek_phase

    report["deepseek"] = deepseek_phase(kernels, card, fail, dev, graph_ms)
    print(f"deepseek phase: {report['deepseek']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 15. the GPT-style block: phi, phixtral, gpt_neox, gptj; D = 80 ----
    from torch_gpt_families_smoke import gpt_families_phase

    report["gpt_families"] = gpt_families_phase(kernels, card, fail, dev,
                                                graph_ms)
    print(f"gpt_families phase: {report['gpt_families']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 16. expert offload: Mixtral-8x7B with host-resident experts ------
    from torch_offload_smoke import offload_phase

    report["offload"] = offload_phase(kernels, card, fail, dev)
    print(f"offload phase: {report['offload']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 17. the MiniCPM families: B1, B3 and B4 at 64 and (96, 64) --------
    from torch_minicpm_smoke import minicpm_phase

    report["minicpm"] = minicpm_phase(kernels, card, fail, dev, graph_ms)
    print(f"minicpm phase: {report['minicpm']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 18. training: B4's backward, B2^T, Llama-2-7B QLoRA --------------
    from torch_train_smoke import train_phase

    report["train"] = train_phase(kernels, card, fail, dev, graph_ms)
    print(f"train phase: {report['train']['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- 19. tensor-parallel serving: two gloo ranks on this card ------------
    def serve_tp_phase() -> dict:
        """``scripts/torch_tp_smoke.py`` in a process of its own (its ranks
        are processes of theirs); its last line must say ok and carry a
        row for each sharded wrapper."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_tp_smoke.py")],
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        for ln in proc.stdout.splitlines():
            if ln.startswith("rank ") and "backend" in ln:
                print(ln, flush=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        rep = json.loads(lines[-1]) if lines else {}
        if proc.returncode != 0 or not rep.get("ok") or len(
                rep.get("kernels", ())) != 7:
            fail(f"serve_tp: exit {proc.returncode}, last line "
                 f"{lines[-1][:500] if lines else None}: "
                 f"{proc.stderr[-3000:]}")
        for ln in proc.stdout.splitlines():
            if ln.startswith("serve_tp gate"):
                print(ln, flush=True)
        rep["phase_s"] = time.perf_counter() - t0
        return rep

    report["serve_tp"] = serve_tp_phase()
    print(f"serve_tp phase: {report['serve_tp']['phase_s']:.1f} s",
          flush=True)

    # -- 20. the GLM and llama-layout families: B1, B3, B4 at G = 16 -------
    from torch_glm_families_smoke import glm_families_phase

    report["glm_families"] = glm_families_phase(kernels, card, fail, dev,
                                                graph_ms)
    print(f"glm_families phase: {report['glm_families']['phase_s']:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # -- 21. falcon, starcoder2, stablelm, cohere, olmo2; B3 at G = 71 -----
    from torch_falcon_families_smoke import falcon_families_phase

    report["falcon_families"] = falcon_families_phase(kernels, card, fail,
                                                      dev, graph_ms)
    print("falcon_families phase: "
          f"{report['falcon_families']['phase_s']:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- summary -------------------------------------------------------------
    serve_launches = report["serve"][0]["launches"]
    gen_launches = report["generate"][0]["launches"]
    rep_b1 = next(r for r in report["b1"] if r["pool"] == "bf16"
                  and r["case"].startswith("row mix"))
    rep_b3 = next(r for r in report["b3"] if r["case"] == "bf16 window off")
    rep_b4 = report["b4"][0]
    rep_b5 = next(r for r in report["b5"] if r["pool"] == "bf16"
                  and r["case"] == "C=4")
    rep_b5_wide = next(r for r in report["b5"] if r["pool"] == "bf16"
                       and r["case"] == "C=128")
    rep_b1_split = next(r for r in report["b1"] if r["pool"] == "bf16"
                        and r["case"] == "verify R=8 C=4")
    rep_b2_tiled = next(r for r in report["b2"] if r["qtype"] == "sym_int4"
                        and r["weight"] == "gate_up" and r["m"] == 128)
    fam = report["families"]
    fam_serve = {(r["model"], r["storage"]): r for r in fam["serve"]}
    fam_gen = {r["model"]: r for r in fam["generate"]}
    gemma_serve = fam_serve[("Gemma-2-9B", "bf16")]
    qwen_serve = fam_serve[("Qwen2-7B", "bf16")]
    rep_b3_256 = next(r for r in report["b3_d256"]
                      if r["case"] == "D=256 bf16 B=8 window 4096")
    rep_b4_256 = next(r for r in report["b4_d256"]
                      if r["case"] == "D=256 T=128 chunks")
    rep_b1_g7 = next(r for r in report["b1"] if r["pool"] == "bf16"
                     and r["case"].startswith("G=7 decode"))
    moe = report["moe"]
    # the bf16 serving runs at the engine's default prefill budget (128
    # tokens a mixed tick) and at the wide one (1024)
    moe_serve = {(r["model"], r["storage"], r["step_token_budget"]): r
                 for r in moe["serve"]}
    mix_serve = moe_serve[("Mixtral-8x7B", "bf16", 128)]
    mix_wide = moe_serve[("Mixtral-8x7B", "bf16", 1024)]
    q3_serve = moe_serve[("Qwen3-30B-A3B", "bf16", 128)]
    rep_b2e = {(r["model"], r["weight"], r["tick"]): r for r in moe["b2e"]}
    train = report["train"]
    # the training path's run: one Llama-2-7B sym_int4 QLoRA step (the
    # counts are set to 0 before each step and read after it)
    train_launches = train["qlora"]["launches_per_step"]
    rep_bwd = train["b4_bwd"][0]
    rep_dx = next(r for r in train["b2t"] if r["qtype"] == "sym_int4"
                  and r["weight"] == "gate_up")

    def b2e_launches(run: dict, instance: str) -> int:
        """B2e's launches of one instance (``gemv``, ``wgmma``, ``tiled``:
        every row tile and output type) in a run."""
        return sum(n for k, n in run["b2e_by_instance"].items()
                   if k.split("/")[0].rstrip("0123456789") == instance)
    rep_b1_g8 = next(r for r in report["b1"] if r["pool"] == "bf16"
                     and r["case"].startswith("G=8 decode"))
    # the head_dims of the rope_families phase: B1 at 256 (Gemma-7B's
    # heads), B3 and B4 at 96 (Phi-3-mini's); launches from those models'
    # bf16 serving runs (Gemma-3-4B's B1 launches beside Gemma-7B's)
    rf = report["rope_families"]
    rf_serve = {r["model"]: r for r in rf["serve"] if r["storage"] == "bf16"}
    rf_rows = rf["kernels"]

    def rf_row(kernel, case):
        return next(r for r in rf_rows if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def rf_err(kernel, head_dim):
        return max(r["max_abs_err"] for r in rf_rows
                   if r["kernel"] == kernel and r["head_dim"] == head_dim)
    rep_b1_256 = rf_row("ragged_paged_attention",
                        "D=256 Gemma-7B Hq=16 Hkv=16 C=128")
    rep_b1_256_split = rf_row("ragged_paged_attention",
                              "D=256 Gemma-7B Hq=16 Hkv=16 C=1")
    rep_b3_96 = rf_row("decode_attention",
                       "D=96 Phi-3-mini B=8 S=4096 window 2047")
    rep_b4_96 = rf_row("flash_attention",
                       "D=96 Phi-3-mini T=128 x 8 chunks S=4096 window 2047")
    gemma7 = rf_serve["Gemma-7B"]["attention"]
    gemma3 = rf_serve["Gemma-3-4B"]["attention"]
    phi3 = rf_serve["Phi-3-mini-4k"]["attention"]
    serve_routes = report["serve"][0]["launches_by_route"]
    for name, routes in serve_routes.items():
        if min(routes.values()) == 0:
            fail(f"serve: an instance of {name} never launched ({routes})")
    # the (192, 128) instances of the deepseek phase: launches from
    # V2-Lite's bf16 serving run (B1) and its generate() (B3, B4)
    ds = report["deepseek"]
    ds_serve = {(r["model"], r["storage"]): r for r in ds["serve"]}
    ds_v2 = ds_serve[("DeepSeek-V2-Lite", "bf16")]
    ds_v3 = ds_serve[("DeepSeek-V3", "bf16")]
    ds_gen = ds["generate"][0]

    def ds_row(kernel, case):
        return next(r for r in ds["kernels"] if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def ds_err(kernel):
        return max(r["max_abs_err"] for r in ds["kernels"]
                   if r["kernel"] == kernel)
    # the head_dim-80 instances of the gpt_families phase: launches from
    # Phi-2's serving run (B1) and its generate() (B3, B4)
    gf = report["gpt_families"]
    gf_serve = {r["model"]: r for r in gf["serve"]}
    gf_phi, gf_gen = gf_serve["Phi-2"], gf["generate"][0]

    def gf_row(kernel, case):
        return next(r for r in gf["kernels"] if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def gf_err(kernel):
        return max(r["max_abs_err"] for r in gf["kernels"]
                   if r["kernel"] == kernel)
    src = "ipex_llm_tpu_torch/csrc/"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the MiniCPM instances of the minicpm phase: launches from MiniCPM-2B's
    # and MiniCPM3-4B's serving runs (B1) and their generate() (B3, B4)
    mc = report["minicpm"]
    mc_serve = {r["model"]: r for r in mc["serve"]}
    mc_gen = {r["model"]: r for r in mc["generate"]}
    mc2, mc3 = mc_serve["MiniCPM-2B"], mc_serve["MiniCPM3-4B"]

    def mc_row(kernel, case):
        return next(r for r in mc["kernels"] if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def mc_err(kernel, d, dv):
        return max(r["max_abs_err"] for r in mc["kernels"]
                   if r["kernel"] == kernel and r["head_dim"] == d
                   and r["v_head_dim"] == dv)

    def mc_b1(width, model, heads, c, launches, run, extra=None):
        d, dv = width
        wd = f"D={d}" if d == dv else f"({d}, {dv})"
        split = c == 1
        return {
            "name": "ragged_paged_attention[D=%d%s%s]" % (
                d, "" if d == dv else f", Dv={dv}", ", split" if split
                else ""),
            "route": "cuda", "source": src + "ragged_paged_attention.cu",
            "replaces":
                "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
            "shape": f"R=8 C={c} {heads} D={d} Dv={dv} page 128, 2048 "
                     "slots, bf16 pool" + (" (key split and merge)" if split
                                           else ", chunk+decode+idle rows "
                                           "(query tiles)"),
            "launches": launches, "launches_run": run, **(extra or {}),
            "max_abs_err": mc_err("ragged_paged_attention", d, dv),
            **{k: mc_row("ragged_paged_attention",
                         f"{wd} {model} {heads} C={c}")[k] for k in keys}}

    def mc_dense(kernel, width, model, case, launches, run):
        d, dv = width
        wd = f"D={d}" if d == dv else f"({d}, {dv})"
        return {
            "name": f"{kernel}[D={d}" + ("" if d == dv else f", Dv={dv}")
                    + "]", "route": "cuda", "source": src + f"{kernel}.cu",
            "replaces": f"ipex_llm_tpu/ops/pallas/{kernel}.py:166",
            "shape": f"{model} {case}, bf16", "launches": launches,
            "launches_run": run, "max_abs_err": mc_err(kernel, d, dv),
            **{k: mc_row(kernel, f"{wd} {model} {case}")[k] for k in keys}}
    # the G = 16 cases of the glm_families phase: launches from
    # glm-4-9b-chat's serving run (40 layers) and its generate()
    gl = report["glm_families"]
    glm_serve = next(r for r in gl["serve"] if r["model"] == "glm-4-9b-chat")
    glm_gen = gl["generate"][0]
    glm_run = "glm-4-9b-chat serving, 40 layers, bf16 pool"

    def glm_row(kernel, case):
        return next(r for r in gl["kernels"] if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def glm_err(kernel):
        return max(r["max_abs_err"] for r in gl["kernels"]
                   if r["kernel"] == kernel)

    def glm_b1(c, launches):
        split = c == 1
        return {
            "name": "ragged_paged_attention[D=128, G=16%s]" % (
                ", split" if split else ""),
            "route": "cuda", "source": src + "ragged_paged_attention.cu",
            "replaces":
                "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
            "shape": f"R=8 C={c} Hq=32 Hkv=2 D=128 page 128, 2048 slots, "
                     "bf16 pool" + (" (key split and merge: 16 query heads "
                                    "a block)" if split else
                                    ", chunk+decode+idle rows (query "
                                    "tiles)"),
            "launches": launches, "launches_run": glm_run,
            "max_abs_err": glm_err("ragged_paged_attention"),
            **{k: glm_row("ragged_paged_attention",
                          f"D=128 GLM-4-9B Hq=32 Hkv=2 C={c}")[k]
               for k in keys}}

    def glm_dense(kernel, case):
        return {
            "name": f"{kernel}[D=128, G=16]", "route": "cuda",
            "source": src + f"{kernel}.cu",
            "replaces": f"ipex_llm_tpu/ops/pallas/{kernel}.py:166",
            "shape": f"GLM-4-9B {case}, bf16",
            "launches": glm_gen["launches"][kernel],
            "launches_run": "glm-4-9b-chat generate(), 40 layers",
            "launches_load_generate": gl["load"]["generate_launches"][kernel],
            "max_abs_err": glm_err(kernel),
            **{k: glm_row(kernel, f"D=128 GLM-4-9B {case}")[k]
               for k in keys}}
    # the G = 71 cases of the falcon_families phase: launches from
    # Falcon-7B's serving run (32 layers, B1 on its query tiles) and its
    # generate() (B3, B4)
    fc = report["falcon_families"]
    fc_serve = next(r for r in fc["serve"] if r["model"] == "Falcon-7B")
    fc_gen = fc["generate"][0]

    def fc_row(kernel, case):
        return next(r for r in fc["kernels"] if r["kernel"] == kernel
                    and r["case"] == case and r.get("pool", "bf16") == "bf16")

    def fc_err(kernel, head_dim=64):
        return max(r["max_abs_err"] for r in fc["kernels"]
                   if r["kernel"] == kernel and r["head_dim"] == head_dim)

    def fc_b1(c):
        return {
            "name": f"ragged_paged_attention[D=64, G=71, C={c}]",
            "route": "cuda", "source": src + "ragged_paged_attention.cu",
            "replaces":
                "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
            "shape": f"R=8 C={c} Hq=71 Hkv=1 D=64 page 128, 2048 slots, "
                     "bf16 pool (query tiles: two 64-row tiles a decode "
                     "row)" if c == 1 else f"R=8 C={c} Hq=71 Hkv=1 D=64 "
                     "page 128, 2048 slots, bf16 pool, chunk+decode+idle "
                     "rows (query tiles)",
            "launches": fc_serve["b1_by_route"]["tiles"],
            "launches_run": "Falcon-7B serving, 32 layers, bf16 pool",
            "max_abs_err": fc_err("ragged_paged_attention"),
            **{k: fc_row("ragged_paged_attention",
                         f"D=64 Falcon-7B Hq=71 Hkv=1 C={c}")[k]
               for k in keys}}

    def fc_dense(kernel, case, name=None):
        return {
            "name": name or f"{kernel}[D=64, G=71]", "route": "cuda",
            "source": src + f"{kernel}.cu",
            "replaces": f"ipex_llm_tpu/ops/pallas/{kernel}.py:166",
            "shape": f"Falcon-7B {case}, bf16",
            "launches": fc_gen["launches"][kernel],
            "launches_run": "Falcon-7B generate(), 32 layers",
            "launches_load_generate": fc["load"]["generate_launches"][kernel],
            "max_abs_err": fc_err(kernel),
            **{k: fc_row(kernel, f"D=64 Falcon-7B {case}")[k]
               for k in keys}}
    fc_b2 = next(r for r in fc["b2"] if r["weight"] == "qkv" and r["m"] == 8)
    # the offload phase's runs (the small budget's: every step streams)
    off_launches = report["offload"]["small"]["launches"]
    # B2's launches in each format on that format's main-path run: the
    # sym_int4 serving run, and each weight_qtype run of serve_formats
    b2_launches = {"sym_int4": serve_launches["qmatmul"]}
    for r in report["serve_formats"]:
        if r["qtype"] in b2.FORMATS:
            b2_launches[r["qtype"]] = r["b2_launches_by_format"][r["qtype"]]
    # the front end's run (serve_http) is a main path of its own: B2 and
    # B1's launches there ride beside each entry's
    http_launches = report["serve_http"]["launches"]
    # the transactional tick's runs (serve_faults), summed over its runs
    faults_launches = report["serve_faults"]["launches"]
    # the model API's runs (load): the loaded model's generate and the
    # server build_server started over the checkpoint
    load_gen = report["load"]["generate"]["loaded"]["launches"]
    load_srv = report["load"]["server"]["launches"]
    b2_entries = []
    for qtype in b2.FORMATS:
        rows = [r for r in report["b2"] if r["qtype"] == qtype]
        if qtype == "sym_int4":
            rows += report["b2m"]
        rep = next(r for r in rows if r["weight"] == "gate_up"
                   and r["m"] == 8)
        b2_entries.append({
            "name": f"qmatmul[{qtype}]", "route": "cuda",
            "source": src + "qmatmul.cu",
            "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
            "shape": "M=8 K=4096 N=22016 (gate_up, decode)",
            "launches": b2_launches[qtype],
            **({"launches_serve_http": http_launches["qmatmul"],
                "launches_offload": off_launches["qmatmul"],
                "launches_serve_faults": faults_launches["qmatmul"],
                "launches_load_generate": load_gen["qmatmul"],
                "launches_load_serve": load_srv["qmatmul"]}
               if qtype == "sym_int4" else {}),
            "launches_per_call": report["b2_gemv_launches_per_call"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: rep[k] for k in keys}})
    line = {"kernels": b2_entries + [
        # the tiled instance alone: its launches in the sym_int4 serving run
        {"name": "qmatmul[sym_int4, tiled]", "route": "cuda",
         "source": src + "qmatmul.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "shape": "M=128 K=4096 N=22016 (gate_up, a mixed tick's prefill "
                  "rows)",
         "launches": serve_routes["qmatmul"]["tiled"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b2"]
                            if r["route"] == "tiled"),
         **{k: rep_b2_tiled[k] for k in keys}},
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=128 Hq=Hkv=32 D=128 page 128, bf16 pool, "
                  "decode+chunk+idle rows (query tiles)",
         "launches": serve_launches["ragged_paged_attention"],
         "launches_by_route": serve_routes["ragged_paged_attention"],
         "launches_serve_http": http_launches["ragged_paged_attention"],
         "launches_serve_faults":
             faults_launches["ragged_paged_attention"],
         "launches_load_serve": load_srv["ragged_paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b1"]),
         **{k: rep_b1[k] for k in keys}},
        # the key-split instance alone (split pass and merge)
        {"name": "ragged_paged_attention[split]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=4 Hq=Hkv=32 D=128 page 128, bf16 pool, rows of "
                  "130-2048 slots (the verify chunks of spec_k 3)",
         "launches": serve_routes["ragged_paged_attention"]["split"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b1"]
                            if r["route"] == "split"),
         **{k: rep_b1_split[k] for k in keys}},
        {"name": "decode_attention", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/decode_attention.py:166",
         "shape": "B=4 Hq=32 Hkv=8 D=128 S=2304, bf16 cache, ragged "
                  "kv_start/kv_len, window off",
         "launches": gen_launches["decode_attention"],
         "launches_load_generate": load_gen["decode_attention"],
         "launches_offload": off_launches["decode_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b3"]),
         **{k: rep_b3[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "shape": "B=4 T=2048 S=2304 Hq=32 Hkv=8 D=128, causal, left "
                  "padded",
         "launches": gen_launches["flash_attention"],
         "launches_load_generate": load_gen["flash_attention"],
         "launches_offload": off_launches["flash_attention"],
         # the LSE instance's launches in one QLoRA step
         "launches_train_step": train_launches["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b4"]),
         **{k: rep_b4[k] for k in keys}},
        {"name": "paged_attention", "route": "cuda",
         "source": src + "paged_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/paged_attention.py:174",
         "shape": "R=8 C=4 Hq=Hkv=32 D=128 page 128, bf16 pool, rows of "
                  "1-2048 slots (the verify chunks of spec_k 3)",
         "on_serving_path": False,
         # the serve_spec run's count: the engine does not dispatch B5
         "launches": report["serve_spec"]["runs"]["spec_k=3"]["launches"][
             "paged_attention"],
         "check_launches": b5_launches,
         "check_launches_from": "the b5 and spec_verify phases (B1's "
                                "oracle)",
         "max_abs_err": max(r["max_abs_err"] for r in report["b5"]),
         # the 64-row tiles at C=128, beside B1 on the same inputs
         "c128": {k: rep_b5_wide[k] for k in keys + ("b1_ms",)},
         **{k: rep_b5[k] for k in keys}},
        # the head_dim-256 instances: their launches in the Gemma-2-9B
        # serving run (the gathered route) and its generate()
        {"name": "decode_attention[D=256]", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/decode_attention.py:166",
         "shape": "B=8 Hq=16 Hkv=8 D=256 S=6144, bf16 cache, window 4096",
         "launches": gemma_serve["launches_by_head_dim"][
             "decode_attention"][256],
         "launches_generate": fam_gen["Gemma-2-9B"]["launches_by_head_dim"][
             "decode_attention"][256],
         "max_abs_err": max(r["max_abs_err"] for r in report["b3_d256"]),
         **{k: rep_b3_256[k] for k in keys}},
        {"name": "flash_attention[D=256]", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "shape": "B=8 T=128 S=6144 Hq=16 Hkv=8 D=256, per-row query "
                  "slots, window 4096",
         "launches": gemma_serve["launches_by_head_dim"][
             "flash_attention"][256],
         "launches_generate": fam_gen["Gemma-2-9B"]["launches_by_head_dim"][
             "flash_attention"][256],
         "max_abs_err": max(r["max_abs_err"] for r in report["b4_d256"]),
         **{k: rep_b4_256[k] for k in keys}},
        # B1 at Qwen2-7B's GQA group of 7: its launches in that serving run
        {"name": "ragged_paged_attention[G=7]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=1 Hq=28 Hkv=4 D=128 page 128, bf16 pool (key "
                  "split)",
         "launches": qwen_serve["launches"]["ragged_paged_attention"],
         "launches_by_route": qwen_serve["b1_launches_by_route"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b1"]
                            if r["case"].startswith("G=7")),
         **{k: rep_b1_g7[k] for k in keys}},
        # B1 at Qwen3-30B-A3B's GQA group of 8: its launches in that serving
        {"name": "ragged_paged_attention[G=8]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=1 Hq=32 Hkv=4 D=128 page 128, bf16 pool (key "
                  "split)",
         "launches": q3_serve["launches"]["ragged_paged_attention"],
         "launches_by_route": q3_serve["b1_by_route"],
         "max_abs_err": max(r["max_abs_err"] for r in report["b1"]
                            if r["case"].startswith("G=8")),
         **{k: rep_b1_g8[k] for k in keys}},
        # B1's head_dim-256 instances (Gemma, Gemma-3's full layers): their
        # launches in the Gemma-7B bf16 serving run, every layer's
        {"name": "ragged_paged_attention[D=256]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=128 Hq=Hkv=16 D=256 page 16, 2400 slots, bf16 "
                  "pool, chunk+decode+idle rows (query tiles)",
         "launches": gemma7["b1_by_route"]["tiles"],
         "launches_run": "Gemma-7B serving, bf16 pool",
         "launches_gemma3_full_layers": gemma3["b1_by_route"]["tiles"],
         "max_abs_err": rf_err("ragged_paged_attention", 256),
         **{k: rep_b1_256[k] for k in keys}},
        {"name": "ragged_paged_attention[D=256, split]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=1 Hq=Hkv=16 D=256 page 16, rows of 130-2397 "
                  "slots, bf16 pool (key split and merge)",
         "launches": gemma7["b1_by_route"]["split"],
         "launches_run": "Gemma-7B serving, bf16 pool",
         "launches_gemma3_full_layers": gemma3["b1_by_route"]["split"],
         "max_abs_err": rf_err("ragged_paged_attention", 256),
         **{k: rep_b1_256_split[k] for k in keys}},
        # B3 and B4 at head_dim 96 (Phi-3-mini): their launches in its bf16
        # serving run (the gathered route on every layer)
        {"name": "decode_attention[D=96]", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/decode_attention.py:166",
         "shape": "B=8 Hq=Hkv=32 D=96 S=4096, bf16 cache, window 2047",
         "launches": phi3["b3_by_head_dim"][96],
         "launches_run": "Phi-3-mini-4k serving, bf16 pool",
         "max_abs_err": rf_err("decode_attention", 96),
         **{k: rep_b3_96[k] for k in keys}},
        {"name": "flash_attention[D=96]", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "shape": "B=8 T=128 S=4096 Hq=Hkv=32 D=96, per-row query slots, "
                  "window 2047",
         "launches": phi3["b4_by_head_dim"][96],
         "launches_run": "Phi-3-mini-4k serving, bf16 pool",
         "max_abs_err": rf_err("flash_attention", 96),
         **{k: rep_b4_96[k] for k in keys}},
        # B1, B3 and B4 at DeepSeek's MLA widths (K 192, V 128)
        {"name": "ragged_paged_attention[D=192, Dv=128]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=128 Hq=Hkv=16 D=192 Dv=128 page 16, 2400 slots, "
                  "bf16 pool, chunk+decode+idle rows (query tiles)",
         "launches": ds_v2["b1_by_route"]["tiles"],
         "launches_run": "DeepSeek-V2-Lite serving, 8 layers, bf16 pool",
         "launches_v3": ds_v3["b1_by_route"]["tiles"],
         "max_abs_err": ds_err("ragged_paged_attention"),
         **{k: ds_row("ragged_paged_attention",
                      "(192, 128) V2-Lite Hq=Hkv=16 C=128")[k]
            for k in keys}},
        {"name": "ragged_paged_attention[D=192, Dv=128, split]",
         "route": "cuda", "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=1 Hq=Hkv=16 D=192 Dv=128 page 16, rows of "
                  "120-2397 slots, bf16 pool (key split and merge)",
         "launches": ds_v2["b1_by_route"]["split"],
         "launches_run": "DeepSeek-V2-Lite serving, 8 layers, bf16 pool",
         "launches_v3": ds_v3["b1_by_route"]["split"],
         "max_abs_err": ds_err("ragged_paged_attention"),
         **{k: ds_row("ragged_paged_attention",
                      "(192, 128) V2-Lite Hq=Hkv=16 C=1")[k]
            for k in keys}},
        {"name": "decode_attention[D=192, Dv=128]", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/decode_attention.py:166",
         "shape": "B=8 Hq=Hkv=16 D=192 Dv=128 S=4096, bf16 cache",
         "launches": ds_gen["launches"]["decode_attention"],
         "launches_run": "DeepSeek-V2-Lite generate(), 8 layers",
         "max_abs_err": ds_err("decode_attention"),
         **{k: ds_row("decode_attention",
                      "(192, 128) V2-Lite B=8 Hq=Hkv=16 S=4096")[k]
            for k in keys}},
        {"name": "flash_attention[D=192, Dv=128]", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "shape": "B=2 T=2048 Hq=Hkv=16 D=192 Dv=128, causal",
         "launches": ds_gen["launches"]["flash_attention"],
         "launches_run": "DeepSeek-V2-Lite generate(), 8 layers",
         "max_abs_err": ds_err("flash_attention"),
         **{k: ds_row("flash_attention",
                      "(192, 128) V2-Lite T=2048 x 2 prefill S=2048")[k]
            for k in keys}},
        # B1, B3 and B4 at head_dim 80 (Phi-2, phixtral)
        {"name": "ragged_paged_attention[D=80]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=128 Hq=Hkv=32 D=80 page 128, 2048 slots, bf16 "
                  "pool, chunk+decode+idle rows (query tiles)",
         "launches": gf_phi["b1_by_route"]["tiles"],
         "launches_run": "Phi-2 serving, 32 layers, bf16 pool",
         "launches_phixtral": gf_serve["phixtral-4x2_8"]["b1_by_route"][
             "tiles"],
         "max_abs_err": gf_err("ragged_paged_attention"),
         **{k: gf_row("ragged_paged_attention",
                      "D=80 Phi-2 Hq=Hkv=32 C=128")[k] for k in keys}},
        {"name": "ragged_paged_attention[D=80, split]", "route": "cuda",
         "source": src + "ragged_paged_attention.cu",
         "replaces":
             "ipex_llm_tpu/ops/pallas/ragged_paged_attention.py:193",
         "shape": "R=8 C=1 Hq=Hkv=32 D=80 page 128, rows of 102-2045 "
                  "slots, bf16 pool (key split and merge)",
         "launches": gf_phi["b1_by_route"]["split"],
         "launches_run": "Phi-2 serving, 32 layers, bf16 pool",
         "launches_phixtral": gf_serve["phixtral-4x2_8"]["b1_by_route"][
             "split"],
         "max_abs_err": gf_err("ragged_paged_attention"),
         **{k: gf_row("ragged_paged_attention",
                      "D=80 Phi-2 Hq=Hkv=32 C=1")[k] for k in keys}},
        {"name": "decode_attention[D=80]", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/decode_attention.py:166",
         "shape": "B=8 Hq=Hkv=32 D=80 S=2048, bf16 cache",
         "launches": gf_gen["launches"]["decode_attention"],
         "launches_run": "Phi-2 generate(), 32 layers",
         "max_abs_err": gf_err("decode_attention"),
         **{k: gf_row("decode_attention", "D=80 Phi-2 B=8 Hq=Hkv=32 "
                      "S=2048")[k] for k in keys}},
        {"name": "flash_attention[D=80]", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "shape": "B=8 T=128 Hq=Hkv=32 D=80 S=2048, per-row query slots",
         "launches": gf_gen["launches"]["flash_attention"],
         "launches_run": "Phi-2 generate(), 32 layers",
         "max_abs_err": gf_err("flash_attention"),
         **{k: gf_row("flash_attention", "D=80 Phi-2 T=128 x 8 chunks "
                      "S=2048")[k] for k in keys}},
        # B1, B3 and B4 at MiniCPM's widths: (64, 64) (MiniCPM-2B, 40
        # layers) and (96, 64) (MiniCPM3-4B's MLA, 8 layers)
        mc_b1((64, 64), "MiniCPM-2B", "Hq=Hkv=36", 128,
              mc2["b1_by_route"]["tiles"], "MiniCPM-2B serving, 40 layers, "
              "bf16 pool"),
        mc_b1((64, 64), "MiniCPM-2B", "Hq=Hkv=36", 1,
              mc2["b1_by_route"]["split"], "MiniCPM-2B serving, 40 layers, "
              "bf16 pool"),
        mc_b1((96, 64), "MiniCPM3-4B", "Hq=Hkv=40", 128,
              mc3["b1_by_route"]["tiles"], "MiniCPM3-4B serving, 8 layers, "
              "bf16 pool"),
        mc_b1((96, 64), "MiniCPM3-4B", "Hq=Hkv=40", 1,
              mc3["b1_by_route"]["split"], "MiniCPM3-4B serving, 8 layers, "
              "bf16 pool"),
        # (96, 96): no model of this slice serves it (Phi-3-mini's layers
        # are windowed, the gathered route); its launches are the checks'
        mc_b1((96, 96), "Phi-3-mini", "Hq=Hkv=32", 128, 0,
              "none: no paged model at (96, 96) without a window is served",
              {"on_serving_path": False,
               "check_launches": sum(1 for r in mc["kernels"]
                                     if r["head_dim"] == 96
                                     and r["v_head_dim"] == 96)}),
        mc_dense("decode_attention", (64, 64), "MiniCPM-2B",
                 "B=8 Hq=Hkv=36 S=2048",
                 mc_gen["MiniCPM-2B"]["launches"]["decode_attention"],
                 "MiniCPM-2B generate(), 40 layers"),
        mc_dense("flash_attention", (64, 64), "MiniCPM-2B",
                 "T=128 x 8 chunks S=2048",
                 mc_gen["MiniCPM-2B"]["launches"]["flash_attention"],
                 "MiniCPM-2B generate(), 40 layers"),
        mc_dense("decode_attention", (96, 64), "MiniCPM3-4B",
                 "B=8 Hq=Hkv=40 S=2048",
                 mc_gen["MiniCPM3-4B"]["launches"]["decode_attention"],
                 "MiniCPM3-4B generate(), 8 layers"),
        mc_dense("flash_attention", (96, 64), "MiniCPM3-4B",
                 "T=128 x 8 chunks S=2048",
                 mc_gen["MiniCPM3-4B"]["launches"]["flash_attention"],
                 "MiniCPM3-4B generate(), 8 layers"),
        # B1, B3 and B4 at GLM-4-9B's group of 16 (32/2 heads, D = 128):
        # launches from glm-4-9b-chat's serving run at 40 layers (B1, by
        # instance) and its generate() (B3, B4)
        glm_b1(1, glm_serve["b1_by_route"]["split"]),
        glm_b1(128, glm_serve["b1_by_route"]["tiles"]),
        glm_dense("decode_attention", "B=8 Hq=32 Hkv=2 S=2048"),
        glm_dense("flash_attention", "T=128 x 8 chunks S=2048"),
        # B3 past one 16-row tile (its row tiles a block each), B1 and B4 at
        # Falcon-7B's 71 query heads over one kv head, B2 at its K = 4544:
        # launches from Falcon-7B's serving run at 32 layers (B1, B2) and
        # its generate() (B3, B4)
        fc_dense("decode_attention", "B=8 Hq=71 Hkv=1 S=2048",
                 "decode_attention[D=64, G=71, five 16-row tiles]"),
        fc_b1(1),
        fc_b1(128),
        fc_dense("flash_attention", "T=128 x 8 chunks S=2048"),
        {"name": "qmatmul[sym_int4, Falcon-7B qkv, gemv]", "route": "cuda",
         "source": src + "qmatmul.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "shape": "M=8 K=4544 N=4672 (142 quantization blocks of 32)",
         "launches": fc_serve["launches"]["qmatmul"],
         "launches_run": "Falcon-7B serving, 32 layers, bf16 pool",
         "max_abs_err": max(r["max_abs_err"] for r in fc["b2"]),
         **{k: fc_b2[k] for k in keys}},
        # B2e: B2 as the MoE dispatch reaches it under jax.vmap in the
        # reference; each entry's launches are its instance's in the
        # model's serving run at the engine's default prefill budget (the
        # wgmma entry's at the wide budget, which reaches it) and in
        # Mixtral's generate(), beside B2e's launches by instance there;
        # its error is its own shape's, against the plain version
        {"name": "qmatmul_experts[sym_int4, Mixtral-8x7B, gemv]",
         "route": "cuda", "source": src + "qmatmul_experts_gemv.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "reached_from": "ipex_llm_tpu/ops/moe.py:97",
         "shape": "16 pairs over 8 experts, gate_up 4096 -> 28672 (a "
                  "decode tick of 8 rows, the gather route, bf16 out)",
         "launches": b2e_launches(mix_serve, "gemv"),
         "launches_by_instance": mix_serve["b2e_by_instance"],
         "launches_wide_budget": b2e_launches(mix_wide, "gemv"),
         "launches_generate": b2e_launches(moe["generate"][0], "gemv"),
         **{k: rep_b2e[("Mixtral-8x7B", "gate_up", "decode")][k]
            for k in ("max_abs_err", *keys)}},
        {"name": "qmatmul_experts[sym_int4, Mixtral-8x7B, wgmma]",
         "route": "cuda", "source": src + "qmatmul_experts_wgmma.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "reached_from": "ipex_llm_tpu/ops/moe.py:97",
         "shape": "2048 pairs over 8 experts, gate_up 4096 -> 28672 (a "
                  "prefill chunk of 8 x 128 tokens, the ragged route, fp32 "
                  "out)",
         "launches": b2e_launches(mix_wide, "wgmma"),
         "launches_by_instance": mix_wide["b2e_by_instance"],
         "launches_run": "serving at step_token_budget 1024",
         "launches_generate": b2e_launches(moe["generate"][0], "wgmma"),
         **{k: rep_b2e[("Mixtral-8x7B", "gate_up", "prefill")][k]
            for k in ("max_abs_err", *keys)}},
        {"name": "qmatmul_experts[sym_int4, Qwen3-30B-A3B, gemv]",
         "route": "cuda", "source": src + "qmatmul_experts_gemv.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "reached_from": "ipex_llm_tpu/ops/moe.py:97",
         "shape": "64 pairs over 128 experts, gate_up 2048 -> 1536 (a "
                  "decode tick of 8 rows, the ragged route, fp32 out)",
         "launches": b2e_launches(q3_serve, "gemv"),
         "launches_by_instance": q3_serve["b2e_by_instance"],
         **{k: rep_b2e[("Qwen3-30B-A3B", "gate_up", "decode")][k]
            for k in ("max_abs_err", *keys)}},
        # the tiled instance, which takes the forwards between (more than 8
        # tokens, fewer than 64 rows an expert): a mixed tick's prefill at
        # the engine's default budget
        {"name": "qmatmul_experts[sym_int4, Qwen3-30B-A3B, tiled]",
         "route": "cuda", "source": src + "qmatmul_experts.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "reached_from": "ipex_llm_tpu/ops/moe.py:97",
         "shape": "1024 pairs over 128 experts, gate_up 2048 -> 1536 (a "
                  "mixed tick's prefill of 128 tokens, the ragged route, "
                  "fp32 out; the 16-row tile)",
         "launches": b2e_launches(q3_serve, "tiled"),
         "launches_by_instance": q3_serve["b2e_by_instance"],
         **{k: rep_b2e[("Qwen3-30B-A3B", "gate_up", "chunk")][k]
            for k in ("max_abs_err", *keys)}},
        # the training path's backward kernels (no TPU kernel: the
        # reference's gradient is XLA's autodiff of the forward's oracle)
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": src + "flash_attention_bwd.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/flash_attention.py:166",
         "replaces_note": "the gradient of this kernel, which the "
                          "reference takes by autodiff of "
                          "ops/attention.py::sdpa_reference",
         "shape": "B=2 T=1024 Hq=Hkv=32 D=128, causal (a Llama-2-7B "
                  "QLoRA step)",
         "launches": train_launches["flash_attention_bwd"],
         "launches_run": "one Llama-2-7B sym_int4 QLoRA step, B=2 T=1024",
         "launches_per_call": train["qlora"]["bwd_launches_per_call"],
         "launches_profiled_step": train["qlora"]["kernel_events_per_step"][
             "flash_attention_bwd"],
         "library_call": rep_bwd["library_call"],
         "max_abs_err": max(r["max_abs_err"] for r in train["b4_bwd"]),
         **{k: rep_bwd[k] for k in keys}},
        {"name": "qmatmul_dx[sym_int4]", "route": "cuda",
         "source": src + "qmatmul_dx.cu",
         "replaces": "ipex_llm_tpu/ops/pallas/qmatmul.py:236",
         "replaces_note": "the input gradient of this kernel, which the "
                          "reference takes by autodiff of "
                          "ops/linear.py::qmatmul_reference",
         "shape": "M=2048 K=4096 N=22016 (gate_up, a QLoRA step)",
         "launches": train_launches["qmatmul_dx"],
         "launches_run": "one Llama-2-7B sym_int4 QLoRA step, B=2 T=1024",
         "launches_profiled_step": train["qlora"]["kernel_events_per_step"][
             "qmatmul_dx"],
         "formats_checked": sorted({r["qtype"] for r in train["b2t"]}),
         "max_abs_err": max(r["max_abs_err"] for r in train["b2t"]),
         **{k: rep_dx[k] for k in keys}},
    ] + [dict(row, launches_run="rank 0 of tp = 2 (gloo, this card): "
              "Llama-2-7B and Mistral-7B-v0.1 widths, 8 layers, serving")
         for row in report["serve_tp"]["kernels"]]}
    out_dir = ROOT / "chiprun_out"
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(
            json.dumps({**report, **line}, indent=1))
    except OSError as exc:
        print(f"could not write {out_dir}: {exc}", flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
