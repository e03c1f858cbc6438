"""The shared decoder (port of ``ipex_llm_tpu/models/decoder.py``).

The reference scans one compiled layer body over stacked layer params; the
port keeps the params stacked (``[L, ...]`` leaves) and runs a Python loop
over the layer index.  Two forms, as in the reference:

- paged (the serving engine): every call carries per-row ``slot_offsets``,
  K/V are written into the pool in place through its block tables, and
  attention reads the pool through the ragged paged kernel, or, for a
  layer with a window or a softcap, gathers each row's pages first
  (``ops.attention.cached_sdpa``).  A layer the window does not cover
  passes no window down (the reference passes it with its flag off, which
  masks the same keys), so the full layers of a windowed model without a
  softcap (gemma3's) read the pool through the ragged kernel;
- dense (``generate()``): ``slot_offsets=None`` writes at the cache's
  ``length`` (one offset for every row), ``kv_start`` masks each row's left
  padding, and attention goes to the flash kernel (prefill) or the decode
  kernel (T=1), with the sliding window on where ``cfg.layer_is_sliding``;
- training (``cache=None``): the dense form over slots ``[0, T)`` without
  a cache: attention reads the layer's own k and v (``ops.attention.sdpa``,
  B4 and, under a gradient, its backward), which is what the reference's
  ``causal_lm_loss`` computes over a fresh dense cache of length T.  No
  tensor is written in place, so autograd can run through it.
  ``FROZEN_BUFFER_KEYS`` (the rope tables) are never trainable leaves
  (``training/step.py``), so they carry no gradient.

Rounding points follow the reference: activations are bf16, norms and rope
compute in fp32, linear layers accumulate in fp32 and round to bf16 (a
bias is added in bf16), the embedding multiplier is rounded to bf16 before
the multiply, the logits are the lm head's bf16 output widened to fp32, or
a tied head's bf16 x bf16 product summed and kept in fp32, then softcapped
in fp32.  The per-family switches (qkv bias, (1 + w) norms, post-block
norms, softcaps, attention scale, per-layer windows, per-head q/k norms,
partial rotary, gemma3's local rope table on its sliding layers) follow
the reference's order (``decoder.py:70-210``, ``:334-407``,
``:422-470``).  A layer that holds ``moe_gate_up`` runs the sparse MoE
block (:func:`_moe_block`, the reference's ``decoder.py:212-306``) in
place of the MLP.  DeepSeek's layers run MLA in place of q/k/v
(:func:`_mla_qkv`, the reference's ``decoder.py:81-127``), and a
model with a dense prefix holds two stacks, ``layers_dense`` for its first
``moe_layer_start`` layers and ``layers`` for the rest (the reference's
``decoder.py:585-590``).  The GPT-style block (phi, phixtral, gpt_neox,
gptj) norms with LayerNorm and its bias (``cfg.norm_kind``), adds the
biases of qkv, o, the ungated MLP's up and down and the head where the
tree holds them (each in bf16 after the product's rounding, the head's
to the bf16 logits before they widen), and with ``cfg.parallel_blocks``
adds the two branches first and then the sum to the block's input,
``x + (attn + ffn)``, as the reference rounds it (``decoder.py:501-505``);
minicpm's ``residual_multiplier`` scales each branch's output (the
parallel sum as one) before its add, and ``logit_scale`` the fp32 logits
(:func:`residual_add`, :func:`logits_tail`);
both branches norm the block's input, the attention with
``attn_norm``, the MLP with ``mlp_norm`` (one LayerNorm's weights for phi,
phixtral and gptj, two for gpt_neox).  With ``cfg.norm_after`` (olmo2) a
block's norm moves from its input to its output, ``x + norm(branch(x))``
(the reference's ``decoder.py:78``, ``:205``, ``:311`` and ``:327``), and
q/k norms as wide as the projections norm each over all its heads before
the reshape (``:139-147``).  An MoE layer's norm takes no bias,
as the reference's ``_moe_block`` takes none (phixtral's ``ln.bias`` is
loaded and left unread there: ROADMAP queue 3).

Tensor-parallel serving runs the paged form on every rank with ``tp``, the
rank's group (``parallel/manual.py``): ``cfg`` is then the rank-local
config (``local_cfg``: heads divided by tp) and ``params`` the rank's
slices (``shard_params_manual``).  qkv and gate_up are column-parallel,
o and down row-parallel (their partials summed over the group), attention
reads the rank's kv heads through the kernels' sharded wrappers, and a
column-parallel lm head's fp32 logits are gathered to full width (the
reference's ``decoder.py:438-445``); a tied head stays replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.ops import linear as linear_ops
from ipex_llm_tpu_torch.ops import mlp as mlp_ops
from ipex_llm_tpu_torch.ops import moe as moe_ops
from ipex_llm_tpu_torch.ops import rope as rope_ops
from ipex_llm_tpu_torch.ops.attention import cached_sdpa, sdpa
from ipex_llm_tpu_torch.ops.embedding import embed_lookup
from ipex_llm_tpu_torch.ops.norms import layer_norm, rms_norm
from ipex_llm_tpu_torch.quantize.core import QTensor

COMPUTE_DTYPE = torch.bfloat16
# the tree's non-trainable buffers (the reference's decoder.py:40)
FROZEN_BUFFER_KEYS = ("inv_freq", "inv_freq_local", "rope_mscale")


def layer_params(layers: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer ``i`` of the stacked layer tree (views, no copies)."""
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QTensor):
            out[name] = leaf.planes(lambda t: t[i])
        elif isinstance(leaf, torch.Tensor):
            out[name] = leaf[i]
        else:   # training.qlora.LoraWeight over a QTensor or a matrix
            base = leaf.base
            base = (base.planes(lambda t: t[i]) if isinstance(base, QTensor)
                    else base[i])
            out[name] = dataclasses.replace(leaf, base=base, a=leaf.a[i],
                                            b=leaf.b[i])
    return out


def _norm(cfg: ModelConfig, x, w, bias=None):
    """The config's norm: LayerNorm (with ``bias``) or RMSNorm."""
    if cfg.norm_kind == "layer":
        return layer_norm(x, w, bias, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps, cfg.norm_offset)


def _in_norm(cfg: ModelConfig, x, lp: dict, key: str):
    """A block's input norm ``key`` and its bias where the tree holds
    one."""
    return _norm(cfg, x, lp[key], lp.get(key + "_bias"))


def _attention_block(cfg: ModelConfig, lp: dict, x, kl, vl, cos, sin, slot0,
                     q_slots, kv_len, kv_start, sliding: bool, cache,
                     chunk_lens, tp=None):
    """One layer's attention; ``cos``/``sin`` are the table this layer
    rotates with (gemma3's local one on a sliding layer)."""
    b, t, _ = x.shape
    h = x if cfg.norm_after else _in_norm(cfg, x, lp, "attn_norm")
    kw = dict(causal=True, q_positions=q_slots, kv_len=kv_len,
              kv_start=kv_start,
              window=cfg.sliding_window if sliding else None,
              window_on=sliding, softcap=cfg.attn_softcap,
              scale=cfg.attn_scale)
    if cfg.is_mla:
        q, k, v = _mla_qkv(cfg, lp, h, cos, sin)
        # the reference passes MLA no window (its window_on stays)
        kw["window"] = None
        return _attend(cfg, lp, q, k, v, kl, vl, slot0, cache, chunk_lens,
                       kw, tp)
    qkv = linear_ops.linear(h, lp["qkv"], lp.get("qkv_bias"), tp=tp,
                            mode="col")
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    q, k = qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim]
    flat = cfg.qk_norm and lp["q_norm"].shape[-1] == q_dim
    if flat:            # olmo2: over the whole projection, before rope
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps, cfg.norm_offset)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps, cfg.norm_offset)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = qkv[..., q_dim + kv_dim:].reshape(b, t, cfg.num_kv_heads,
                                          cfg.head_dim)
    if cfg.qk_norm and not flat:    # per head, over head_dim, before rope
        q = _norm(cfg, q, lp["q_norm"])
        k = _norm(cfg, k, lp["k_norm"])
    rd = cfg.rope.rotary_dim
    q = rope_ops.apply_rope_partial(q, cos, sin, rd, cfg.rope_layout)
    k = rope_ops.apply_rope_partial(k, cos, sin, rd, cfg.rope_layout)
    return _attend(cfg, lp, q, k, v, kl, vl, slot0, cache, chunk_lens, kw,
                   tp)


def _attend(cfg: ModelConfig, lp: dict, q, k, v, kl, vl, slot0, cache,
            chunk_lens, kw: dict, tp):
    """Attention of q [B, T, Hq, D] over the cache layer after writing k
    [B, T, Hkv, D] and v [B, T, Hkv, Dv] there (or over k and v alone in
    the training form), then o and the post norm."""
    b, t = q.shape[:2]
    if cache is None:        # the training form: the layer's own K/V
        attn = sdpa(q, k, v.contiguous(), **kw)
    else:
        kl, vl = cache.update_layer(kl, vl, k, v, slot0)
        attn = cached_sdpa(q, kl, vl, cache, chunk_lens=chunk_lens, tp=tp,
                           **kw)
    attn = attn.reshape(b, t, cfg.num_heads * cfg.v_dim)
    out = linear_ops.linear(attn, lp["o"], lp.get("o_bias"), tp=tp,
                            mode="row")
    if cfg.norm_after:
        out = _in_norm(cfg, out, lp, "attn_norm")
    if cfg.post_attn_norm:
        out = _norm(cfg, out, lp["post_attn_norm"])
    return out


def _mla_qkv(cfg: ModelConfig, lp: dict, h, cos, sin):
    """DeepSeek's multi-head latent attention up to the cache write (the
    reference's ``decoder.py:81-116``): q from ``q`` or through the
    low-rank ``q_a`` -> RMSNorm -> ``q_b``; ``kv_a`` gives the
    ``kv_lora_rank`` latent (RMSNorm, then ``kv_b`` to each head's k_nope
    and v) and one rope slice ``k_pe`` that every head shares; rope in the
    "two" layout on q_pe and k_pe only.  Returns q, k [B, T, H,
    qk_nope + qk_rope] and v [B, T, H, v_dim]."""
    b, t, _ = h.shape
    nope, rank = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    if "q_a" in lp:
        q = linear_ops.linear(rms_norm(linear_ops.linear(h, lp["q_a"]),
                                       lp["q_a_norm"], cfg.norm_eps),
                              lp["q_b"])
    else:               # V2-Lite: the full-rank q_proj
        q = linear_ops.linear(h, lp["q"])
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    ckv = linear_ops.linear(h, lp["kv_a"])
    c = rms_norm(ckv[..., :rank], lp["kv_a_norm"], cfg.norm_eps)
    kv = linear_ops.linear(c, lp["kv_b"]).reshape(b, t, cfg.num_heads,
                                                  nope + cfg.v_dim)
    q_pe = rope_ops.apply_rope(q[..., nope:], cos, sin, "two")
    k_pe = rope_ops.apply_rope(ckv[..., rank:][:, :, None, :], cos, sin,
                               "two")
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, t, cfg.num_heads,
                                               cfg.qk_rope_head_dim)],
                  dim=-1)
    return q, k, kv[..., nope:]


def _mlp_block(cfg: ModelConfig, lp: dict, x, tp=None):
    """The MLP: gated (act(gate) * up), or ungated (``up`` is fc1, then
    the activation), then down, each with its bias where the tree holds
    one."""
    h = x if cfg.norm_after else _in_norm(cfg, x, lp, "mlp_norm")
    if "gate_up" in lp:
        gate, up = mlp_ops.split_gate_up(linear_ops.linear(
            h, lp["gate_up"], tp=tp, mode="col"))
        inner = mlp_ops.gated_act_mul(gate, up, cfg.act)
    else:
        inner = mlp_ops.act(linear_ops.linear(h, lp["up"], lp.get("up_bias"),
                                              tp=tp, mode="col"), cfg.act)
    out = linear_ops.linear(inner, lp["down"], lp.get("down_bias"), tp=tp,
                            mode="row")
    if cfg.norm_after:
        out = _in_norm(cfg, out, lp, "mlp_norm")
    if cfg.post_mlp_norm:
        out = _norm(cfg, out, lp["post_mlp_norm"])
    return out


def _f32_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [..., H] widened to fp32 against an fp32 [H, N] matrix (a router):
    a plain fp32 product outside any kernel on the card (the reference
    leaves it to XLA); the CPU sums in float64, so each logit is exactly
    rounded whatever the batch."""
    if h.is_cuda:
        return torch.matmul(h.to(torch.float32), w)
    return torch.matmul(h.to(torch.float64), w.to(torch.float64)).to(
        torch.float32)


def route(cfg: ModelConfig, logits: torch.Tensor,
          bias: torch.Tensor | None = None):
    """(weights fp32, expert ids) [..., k] from fp32 router logits [..., E]
    (the reference's ``decoder.py:212-258``): mixtral's top-k of the
    logits then a softmax over the k, or a softmax (sigmoid, DeepSeek-V3)
    over all experts then top-k of the scores plus ``bias`` (V3's score
    correction, for the selection only), limited to the ``moe_topk_group``
    best of ``moe_n_group`` groups where set (a group scores its max, or
    the sum of its top two; the other groups' experts select at 0, as the
    reference masks them), the weights the selected scores, renormalised
    with ``moe_norm_topk_prob``; then times ``moe_router_scale``.  Ties go
    to the lowest index, the reference's ``lax.top_k`` rule: a stable
    descending sort, then the first k (``torch.topk`` does not promise
    that order on the card)."""
    k = cfg.num_experts_per_tok

    def top_k(v, n):
        return torch.sort(v, dim=-1, descending=True, stable=True
                          ).indices[..., :n]
    if cfg.moe_softmax_before_topk:
        scores = (torch.sigmoid(logits) if cfg.moe_score_func == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        sel = scores if bias is None else scores + bias
        if cfg.moe_n_group > 1:
            g = sel.reshape(*sel.shape[:-1], cfg.moe_n_group, -1)
            if cfg.moe_group_score == "top2sum":
                top2 = torch.sort(g, dim=-1, descending=True).values
                gs = top2[..., 0] + top2[..., 1]
            else:
                gs = g.amax(-1)
            keep = torch.zeros_like(gs, dtype=torch.bool).scatter_(
                -1, top_k(gs, cfg.moe_topk_group), True)
            sel = torch.where(keep[..., None], g, torch.zeros_like(g)
                              ).reshape(sel.shape)
        idx = top_k(sel, k)
        w = torch.gather(scores, -1, idx)
        if cfg.moe_norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
    else:
        idx = top_k(logits, k)
        w = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    if cfg.moe_router_scale != 1.0:
        w = w * cfg.moe_router_scale
    return w, idx


def _moe_block(cfg: ModelConfig, lp: dict, x, experts):
    """The sparse MoE FFN: the norm, fp32 router logits, the top-k route,
    the experts through ``experts`` (``ops.moe.dispatch()``: ``moe_ffn``,
    or the dense all-experts scan under ``IPEX_LLM_TPU_DENSE_MOE=1``),
    then the shared expert (DeepSeek's, or qwen2_moe's gated by
    ``sigmoid(h . shared_router)``)."""
    h = _norm(cfg, x, lp["mlp_norm"])
    w, idx = route(cfg, _f32_product(h, lp["router"]), lp.get("router_bias"))
    out = experts(h, w, idx, lp["moe_gate_up"], lp["moe_down"], cfg.act,
                  cfg.num_experts, gated=cfg.mlp_gated,
                  up_bias=lp.get("moe_up_bias"),
                  down_bias=lp.get("moe_down_bias")).to(x.dtype)
    return with_shared_expert(cfg, lp, h, out)


def with_shared_expert(cfg: ModelConfig, lp: dict, h, out):
    """``out`` plus the layer's shared expert of the normed input ``h``
    where it has one (DeepSeek's, or qwen2_moe's gated by ``sigmoid(h .
    shared_router)``)."""
    if "shared_gate_up" in lp:
        gate, up = mlp_ops.split_gate_up(
            linear_ops.linear(h, lp["shared_gate_up"]))
        ys = linear_ops.linear(mlp_ops.gated_act_mul(gate, up, cfg.act),
                               lp["shared_down"])
        if "shared_router" in lp:
            g = torch.sigmoid(_f32_product(h, lp["shared_router"]))
            ys = ys * g.to(ys.dtype)
        out = out + ys
    return out


def bf16_scalar(v: float) -> float:
    """``v`` rounded to bf16, as a Python float (exact): a bf16 tensor
    times it rounds once, as the reference's bf16 product does, with no
    upload a forward."""
    return float(torch.tensor(v, dtype=COMPUTE_DTYPE))


def residual_add(cfg: ModelConfig, x, out):
    """``x + out``, with minicpm's depth scaling: ``x + rm * out``, the
    bf16 ``rm`` (``cfg.residual_multiplier``) times the branch's bf16
    output rounded once before the add (the reference's
    ``decoder.py:494-502``)."""
    if cfg.residual_multiplier != 1.0:
        out = out * bf16_scalar(cfg.residual_multiplier)
    return x + out


def embed_prelude(cfg: ModelConfig, params, tokens, rope_positions):
    """Token embeddings (times the embedding multiplier, rounded to bf16
    first as the reference rounds it) and the rope cos/sin tables:
    (x, cos, sin)."""
    x = embed_lookup(params["embed"], tokens, COMPUTE_DTYPE)
    if cfg.embedding_multiplier != 1.0:
        x = x * bf16_scalar(cfg.embedding_multiplier)
    cos, sin = rope_ops.cos_sin(rope_positions, params["inv_freq"],
                                params.get("rope_mscale", 1.0))
    return x, cos, sin


def local_rope_tables(params, rope_positions):
    """gemma3's sliding layers' (cos, sin), from ``inv_freq_local`` with no
    mscale (the reference's ``local_rope_tables``); (None, None) for a
    tree without that table."""
    if "inv_freq_local" not in params:
        return None, None
    return rope_ops.cos_sin(rope_positions, params["inv_freq_local"], 1.0)


def tied_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a head tied to the bf16 embedding table: x [..., H]
    bf16 against ``embed.T`` with fp32 sums, kept in fp32 (the reference's
    ``preferred_element_type``).  A plain product outside any kernel (the
    reference leaves it to XLA); the CPU sums in float64."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    if x2.is_cuda:
        y = torch.mm(x2, embed.t(), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.double(), embed.double().t()).float()
    return y.reshape(*lead, embed.shape[0])


def logits_tail(cfg: ModelConfig, params, x, tp=None):
    """Final norm and lm head (fp32 logits of an untied head's bf16 output
    plus its bias, or of the tied product), then the logit scale and the
    final-logit softcap in fp32.  With a ``tp`` group and a rank's column slice of the head,
    the slices' logits are gathered to full width (exact)."""
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    head = params.get("lm_head")
    if tp is not None and head is not None \
            and head.out_features != cfg.vocab_size:
        from ipex_llm_tpu_torch.ops.collectives import all_gather_last

        logits = all_gather_last(linear_ops.linear(
            x, head, tp=tp, mode="col").to(torch.float32), tp)
    elif head is not None:
        logits = linear_ops.linear(x, head, params.get("lm_head_bias")).to(
            torch.float32)
    else:
        logits = tied_logits(x, params["embed"])
    if cfg.logit_scale != 1.0:     # minicpm (and cohere): fp32, after the
        logits = logits * cfg.logit_scale   # gather, before the softcap
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def decoder_forward(cfg: ModelConfig, params: dict[str, Any],
                    tokens: torch.Tensor, cache,
                    rope_positions: torch.Tensor,
                    kv_start: torch.Tensor | None = None, *,
                    slot_offsets: torch.Tensor | None = None,
                    last_token_only: bool = False,
                    gather_positions: torch.Tensor | None = None,
                    chunk_lens: torch.Tensor | None = None, tp=None):
    """Run the decoder; returns (logits, cache) with the cache updated in
    place.

    tokens/rope_positions [B, T].  Paged form: ``slot_offsets`` [B] is each
    row's first write slot, ``chunk_lens`` [B] its real token count (None =
    T; 0 = an idle row, whose offset is a sentinel past the table width).
    Dense form (``slot_offsets=None``): every row writes at slots
    ``[cache.length, cache.length + T)``, ``kv_start`` [B] is each row's
    first valid slot (left padding), and ``cache.length`` advances by T.
    Training form (``cache=None``): the dense form from slot 0 over the
    tokens' own K/V; the returned cache is None.
    Logits are [B, V] for ``last_token_only`` or ``gather_positions`` (one
    index per row, gathered before the lm head) and [B, T, V] otherwise.
    ``tp``: the rank's group of tensor-parallel serving (module docstring).
    """
    b, t = tokens.shape
    dev = tokens.device
    x, cos, sin = embed_prelude(cfg, params, tokens, rope_positions)
    cos_l, sin_l = local_rope_tables(params, rope_positions)
    if slot_offsets is not None:
        slot0 = slot_offsets
        q_slots = slot0[:, None] + torch.arange(t, device=dev)[None, :]
        kv_len = slot0 + (chunk_lens if chunk_lens is not None else t)
    else:
        slot0 = 0 if cache is None else int(cache.length)
        q_slots = (slot0 + torch.arange(t, device=dev))[None].expand(b, t)
        kv_len = torch.full((b,), slot0 + t, dtype=torch.int32, device=dev)
    experts = moe_ops.dispatch() if cfg.num_experts else None
    n_dense = cfg.moe_layer_start if "layers_dense" in params else 0
    for i in range(cfg.num_layers):
        lp = (layer_params(params["layers_dense"], i) if i < n_dense
              else layer_params(params["layers"], i - n_dense))
        kl, vl = (None, None) if cache is None else (cache.k[i], cache.v[i])
        sliding = cfg.layer_is_sliding(i)
        c, s = (cos_l, sin_l) if sliding and cos_l is not None else (cos, sin)
        attn = _attention_block(cfg, lp, x, kl, vl, c, s, slot0, q_slots,
                                kv_len, kv_start, sliding, cache,
                                chunk_lens, tp)
        if "moe_gate_up" in lp and tp is not None:
            raise NotImplementedError(
                "MoE stacks not manual-sharded yet (ROADMAP item 15)")

        def ffn(x):
            return (_moe_block(cfg, lp, x, experts) if "moe_gate_up" in lp
                    else _mlp_block(cfg, lp, x, tp))
        if cfg.parallel_blocks:     # both branches from the block's input
            x = residual_add(cfg, x, attn + ffn(x))
        else:
            x = residual_add(cfg, x, attn)
            x = residual_add(cfg, x, ffn(x))
    if slot_offsets is None and cache is not None:
        cache.length = slot0 + t
    if last_token_only:
        x = x[:, -1:, :]
    elif gather_positions is not None:
        idx = gather_positions.long().clamp(0, t - 1)
        x = x[torch.arange(b, device=x.device), idx][:, None, :]
    logits = logits_tail(cfg, params, x, tp)
    if last_token_only or gather_positions is not None:
        logits = logits[:, 0]
    return logits, cache
