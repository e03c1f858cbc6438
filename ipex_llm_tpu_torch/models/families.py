"""Model families: an HF ``config.json`` dict to a ``ModelConfig`` and a
weight-naming scheme (port of the llama, mistral, qwen2, gemma2, qwen3,
mixtral, qwen2_moe, qwen3_moe, phi3, gemma, gemma3_text, deepseek_v2,
deepseek_v3, phi, phi-msft, phixtral, gpt_neox, gptj, minicpm, minicpm3,
glm, glm4, chatglm, aquila, internlm, internlm2, baichuan, qwen,
starcoder2, stablelm, cohere, olmo2 and falcon rows of
``ipex_llm_tpu/models/families.py``).

All of them run the port's one decoder.  llama, mistral and qwen2 share the
reference's llama weight names (mistral adds its sliding window, qwen2 its
qkv bias and ignores ``sliding_window`` as the reference does); gemma2 has
its own norm names and reads its head from the embedding table; qwen3 adds
per-head q/k norms.  phi3 stores q, k and v pre-merged as ``qkv_proj`` and
gate and up as ``gate_up_proj``, with a window on every layer and, in
Phi-3.5 and Phi-4, scaled and partial rotary positions; gemma reads its
head from the embedding table; gemma3_text is gemma2's block with per-head
q/k norms, a window on five layers of six and a second rope table for
them.  The MoE families add an :class:`MoEScheme` (the router, each
expert's gate/up/down, qwen2_moe's shared expert and its gate).  The
DeepSeek rows name MLA's projections (``q_proj`` or the low-rank
``q_a_proj``/``q_b_proj``, ``kv_a_proj_with_mqa``, ``kv_b_proj``), the
shared experts as one MLP, and V3's ``e_score_correction_bias``.  The
GPT-style rows (phi-2, phixtral, Pythia, GPT-J) name LayerNorms whose
biases sit beside their weights, one norm for both branches of the
parallel block (phi, phixtral, gptj) or two (gpt_neox), the ungated MLP's
``fc1``/``fc2`` (``dense_h_to_4h``/``dense_4h_to_h``, ``fc_in``/``fc_out``)
and a biased head; phixtral keeps the msft module tree (``transformer.h``,
``mixer.Wqkv``, ``lm_head.ln``/``lm_head.linear``) and its experts are
ungated (``moe.mlp.{e}.fc1``/``fc2``, no gate); Pythia's
``query_key_value`` interleaves q, k and v per head, which
:func:`_neox_qkv` reorders, weight and bias.  minicpm keeps llama's
names and minicpm3 DeepSeek's MLA names, with the muP scalings
(:func:`_mup_scalings`).  The GLM rows (glm, glm4, chatglm: chatglm2/3
and glm-4-9b-chat) run llama's gated block with the "two" rope on half of
each 128-wide head, a qkv bias and a pre-merged ``gate_up`` (glm4 adds
its two post norms, plain RMSNorms); chatglm reads the THUDM names
(``query_key_value``, ``dense_h_to_4h``, ``dense_4h_to_h``) and config
keys (``kv_channels``, ``multi_query_group_num``, ``padded_vocab_size``,
``ffn_hidden_size``, ``seq_length``, ``rope_ratio``).  The llama-layout
rows: aquila is llama's row, internlm llama's names under one ``bias``
flag (q, k, v and o), internlm2 its own names and the per-kv-group
``wqkv`` that :func:`_internlm2_qkv` reorders, weight and bias, baichuan
(7B) the pre-merged ``W_pack``, and qwen (v1) the ``transformer.h``
names, the fused ``c_attn`` and a halved ``intermediate_size``.
starcoder2 names the ungated MLP ``c_fc``/``c_proj`` under llama's tree;
stablelm keeps llama's names under LayerNorms; cohere reads one
``input_layernorm`` for both parallel branches and its head from the
embedding table; olmo2 names the norms it applies after each branch
``post_attention_layernorm`` and ``post_feedforward_layernorm``, and its
flat ``q_norm``/``k_norm``; falcon the ``transformer.h`` tree, the fused
``query_key_value`` (its three layouts reordered by :func:`_falcon_qkv`)
and norms under either architecture's names (``"a|b"`` templates, the
first name the checkpoint holds: ``models.build.resolve_name``).  chatglm
v1 checkpoints, baichuan-13B and falcon with ALiBi, chatglm without
RMSNorm, stablelm's ``qk_layernorm`` and parallel-residual variants and
cohere's ``use_qk_norm`` raise ``NotImplementedError`` (the first three
naming ROADMAP item 14), as does every other ``model_type``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable

import torch

from ipex_llm_tpu_torch.models.config import MODEL_TYPES, ModelConfig
from ipex_llm_tpu_torch.ops.rope import RopeScaling


@dataclass(frozen=True)
class WeightScheme:
    """Weight-name templates ({i} = layer index, {p} = weight or bias);
    None = not present.  The fields are the reference's; the port's
    ``build_params`` serves separate or pre-merged q/k/v and gate/up
    projections, the ungated MLP's up and down (gate and gate_up None),
    MLA's projections and the post norms, and refuses a scheme that sets
    any of the others."""

    embed: str = "model.embed_tokens.weight"
    final_norm: str = "model.norm.weight"
    lm_head: str = "lm_head.weight"
    attn_norm: str = "model.layers.{i}.input_layernorm.weight"
    mlp_norm: str = "model.layers.{i}.post_attention_layernorm.weight"
    post_attn_norm: str | None = None
    post_mlp_norm: str | None = None
    q: str | None = "model.layers.{i}.self_attn.q_proj.{p}"
    k: str | None = "model.layers.{i}.self_attn.k_proj.{p}"
    v: str | None = "model.layers.{i}.self_attn.v_proj.{p}"
    qkv: str | None = None      # pre-merged (phi3 / chatglm / baichuan W_pack)
    o: str = "model.layers.{i}.self_attn.o_proj.{p}"
    gate: str | None = "model.layers.{i}.mlp.gate_proj.{p}"
    up: str | None = "model.layers.{i}.mlp.up_proj.{p}"
    gate_up: str | None = None  # pre-merged (phi3)
    down: str = "model.layers.{i}.mlp.down_proj.{p}"
    q_norm: str | None = None
    k_norm: str | None = None
    pos_embed: str | None = None   # learned absolute positions (gpt2 wpe)
    embed_norm: str | None = None  # bloom word_embeddings_layernorm
    # MLA (deepseek): q (or q_a/q_b low-rank pair), kv_a, kv_b replace q/k/v
    q_a: str | None = None
    q_a_norm: str | None = None
    q_b: str | None = None
    kv_a: str | None = None
    kv_a_norm: str | None = None
    kv_b: str | None = None


@dataclass(frozen=True)
class MoEScheme:
    """MoE weight-name templates ({i} = layer, {e} = expert), the
    reference's; ``e_gate`` None: ungated experts (phixtral's fc1/fc2,
    biases beside the weights)."""

    router: str = "model.layers.{i}.mlp.gate.weight"
    e_gate: str | None = "model.layers.{i}.mlp.experts.{e}.gate_proj.weight"
    e_up: str = "model.layers.{i}.mlp.experts.{e}.up_proj.weight"
    e_down: str = "model.layers.{i}.mlp.experts.{e}.down_proj.weight"
    shared_gate: str | None = None
    shared_up: str | None = None
    shared_down: str | None = None
    shared_router: str | None = None  # qwen2-moe shared_expert_gate
    score_bias: str | None = None     # deepseek-v3 e_score_correction_bias


@dataclass(frozen=True)
class Family:
    name: str
    to_config: Callable[[dict], ModelConfig]
    scheme: WeightScheme = field(default_factory=WeightScheme)
    moe: MoEScheme | None = None
    # the reference's packed-qkv fixup (rows of a pre-merged qkv weight,
    # and of its bias, reordered to [q; k; v]: gpt_neox) and Conv1D
    # transpose (False for every ported family: build_params refuses it)
    qkv_transform: Callable | None = None
    transpose_weights: bool = False


def _rope_from_hf(hf: dict, head_dim: int) -> RopeScaling:
    """The rope table of an HF config: every field the reference reads
    (``rope_scaling``'s kind under ``rope_type`` or the older ``type``)."""
    rs = hf.get("rope_scaling") or {}
    return RopeScaling(
        head_dim=head_dim,
        base=hf.get("rope_theta", 10000.0),
        kind=rs.get("rope_type", rs.get("type", "default")),
        factor=rs.get("factor", 1.0),
        low_freq_factor=rs.get("low_freq_factor", 1.0),
        high_freq_factor=rs.get("high_freq_factor", 4.0),
        original_max_position=rs.get(
            "original_max_position_embeddings",
            hf.get("original_max_position_embeddings",
                   hf.get("max_position_embeddings", 8192))),
        partial_rotary_factor=hf.get("partial_rotary_factor", 1.0),
        attention_factor=rs.get("attention_factor"),
        short_factor=(tuple(rs["short_factor"]) if rs.get("short_factor")
                      else None),
        long_factor=(tuple(rs["long_factor"]) if rs.get("long_factor")
                     else None),
    )


def _base_cfg(hf: dict, **over) -> dict:
    """The reference fields an HF config sets; ``ModelConfig.from_fields``
    refuses any whose value the port does not serve (MLP biases)."""
    head_dim = hf.get("head_dim") or (hf["hidden_size"]
                                      // hf["num_attention_heads"])
    d = dict(
        model_type=hf.get("model_type", "llama"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        act=hf.get("hidden_act", "silu"),
        norm_eps=hf.get("rms_norm_eps", hf.get("layer_norm_eps", 1e-5)),
        rope=_rope_from_hf(hf, head_dim),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=hf.get("attention_bias", False),
        mlp_bias=hf.get("mlp_bias", False),
    )
    d.update(over)
    return d


def _llama(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(hf))


def _mistral(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(
        _base_cfg(hf, sliding_window=hf.get("sliding_window")))


def _qwen2(hf: dict) -> ModelConfig:
    # a bias on q, k and v, none on o; ``sliding_window`` (with
    # ``use_sliding_window`` false in the published configs) is ignored,
    # as the reference's _qwen2 ignores it
    return ModelConfig.from_fields(
        _base_cfg(hf, attention_bias=True, attention_out_bias=False))


def _gemma2(hf: dict) -> ModelConfig:
    n_layers = hf["num_hidden_layers"]
    return ModelConfig.from_fields(_base_cfg(
        hf,
        norm_offset=1.0,
        act=hf.get("hidden_activation", "gelu_pytorch_tanh"),
        embedding_multiplier=float(math.sqrt(hf["hidden_size"])),
        tie_word_embeddings=True,
        post_attn_norm=True,
        post_mlp_norm=True,
        attn_softcap=hf.get("attn_logit_softcapping", 50.0),
        logit_softcap=hf.get("final_logit_softcapping", 30.0),
        sliding_window=hf.get("sliding_window", 4096),
        # sliding (even) and full (odd) attention layers alternate
        layer_types=tuple(
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(n_layers)),
        attn_scale=hf.get("query_pre_attn_scalar", hf["hidden_size"]
                          // hf["num_attention_heads"]) ** -0.5,
    ))


def _qwen3(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(hf, qk_norm=True))


def _phi3(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(
        _base_cfg(hf, sliding_window=hf.get("sliding_window")))


def _gemma(hf: dict) -> ModelConfig:
    # a published Gemma config has no ``hidden_activation``: its
    # ``hidden_act`` "gelu" is the exact (erf) GELU, as in the reference
    return ModelConfig.from_fields(_base_cfg(
        hf,
        norm_offset=1.0,
        act=hf.get("hidden_activation",
                   hf.get("hidden_act", "gelu_pytorch_tanh")),
        embedding_multiplier=float(math.sqrt(hf["hidden_size"])),
        tie_word_embeddings=True,
    ))


def _gemma3(hf: dict) -> ModelConfig:
    """gemma2's block with per-head q/k norms, sliding layers on a 5:1
    pattern (``sliding_window_pattern``, or ``layer_types`` where given)
    and two rope tables: the sliding layers rotate with the local one
    (``rope_local_base_freq``, unscaled), the full layers with the global
    (scaled) one."""
    n_layers = hf["num_hidden_layers"]
    head_dim = hf.get("head_dim", 256)
    pattern = hf.get("sliding_window_pattern", 6)
    layer_types = tuple(
        hf["layer_types"] if hf.get("layer_types") else (
            "sliding_attention" if (i + 1) % pattern else "full_attention"
            for i in range(n_layers)))
    return ModelConfig.from_fields(_base_cfg(
        {**hf, "head_dim": head_dim},
        norm_offset=1.0,
        act=hf.get("hidden_activation",
                   hf.get("hidden_act", "gelu_pytorch_tanh")),
        embedding_multiplier=float(math.sqrt(hf["hidden_size"])),
        tie_word_embeddings=hf.get("tie_word_embeddings", True),
        post_attn_norm=True,
        post_mlp_norm=True,
        qk_norm=True,
        sliding_window=hf.get("sliding_window", 512),
        layer_types=layer_types,
        attn_scale=float(hf.get("query_pre_attn_scalar", 256)) ** -0.5,
        rope_local=RopeScaling(head_dim=head_dim,
                               base=hf.get("rope_local_base_freq", 10000.0)),
    ))


def _mixtral(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(
        hf,
        sliding_window=hf.get("sliding_window"),
        num_experts=hf.get("num_local_experts", 8),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        moe_intermediate_size=hf["intermediate_size"],
        moe_softmax_before_topk=False,   # top-k logits, softmax over the k
        moe_norm_topk_prob=True,
    ))


def _qwen2_moe(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(
        hf,
        attention_bias=True,
        num_experts=hf.get("num_experts", 60),
        num_experts_per_tok=hf.get("num_experts_per_tok", 4),
        moe_intermediate_size=hf.get("moe_intermediate_size",
                                     hf["intermediate_size"]),
        num_shared_experts=1,
        moe_shared_expert_gate=True,
        moe_softmax_before_topk=True,
        moe_norm_topk_prob=hf.get("norm_topk_prob", False),
    ))


def _qwen3_moe(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(
        hf,
        qk_norm=True,
        num_experts=hf.get("num_experts", 128),
        num_experts_per_tok=hf.get("num_experts_per_tok", 8),
        moe_intermediate_size=hf.get("moe_intermediate_size",
                                     hf["intermediate_size"]),
        moe_softmax_before_topk=True,
        moe_norm_topk_prob=hf.get("norm_topk_prob", True),
    ))


def _deepseek_common(hf: dict) -> dict:
    """The reference's ``_deepseek_common``: under MLA (``kv_lora_rank``)
    the K head is ``qk_nope + qk_rope`` wide, every query head has its own
    kv head (the naive per-head cache), the rope table spans the rope
    slice and softmax scales by the full K width (``mscale_all_dim`` is
    not read: ROADMAP queue 3)."""
    mla = bool(hf.get("kv_lora_rank"))
    qk_dim = (hf.get("qk_nope_head_dim", 128) + hf.get("qk_rope_head_dim", 64)
              if mla else hf.get("head_dim")
              or hf["hidden_size"] // hf["num_attention_heads"])
    hf2 = dict(hf)
    if mla:
        hf2["head_dim"] = qk_dim
        hf2["num_key_value_heads"] = hf["num_attention_heads"]
    d = _base_cfg(
        hf2,
        rope_layout="two",
        q_lora_rank=hf.get("q_lora_rank"),
        kv_lora_rank=hf.get("kv_lora_rank"),
        qk_nope_head_dim=hf.get("qk_nope_head_dim", 0),
        qk_rope_head_dim=hf.get("qk_rope_head_dim", 0),
        v_head_dim=hf.get("v_head_dim"),
        num_experts=hf.get("n_routed_experts") or 0,
        num_experts_per_tok=hf.get("num_experts_per_tok") or 0,
        moe_intermediate_size=hf.get("moe_intermediate_size", 0),
        num_shared_experts=hf.get("n_shared_experts") or 0,
        moe_layer_start=hf.get("first_k_dense_replace", 0),
        moe_router_scale=hf.get("routed_scaling_factor", 1.0),
        moe_norm_topk_prob=hf.get("norm_topk_prob", False),
        moe_softmax_before_topk=True,
    )
    if mla:
        d["rope"] = _rope_from_hf(hf, hf.get("qk_rope_head_dim", 64))
        d["attn_scale"] = qk_dim ** -0.5
    return d


def _deepseek_v2(hf: dict) -> ModelConfig:
    """V2 limits its experts to groups only under ``topk_method``
    ``group_limited_greedy`` (the reference's rule; ``greedy``, V2-Lite's,
    ignores ``n_group``)."""
    d = _deepseek_common(hf)
    if hf.get("topk_method", "greedy") == "group_limited_greedy":
        d.update(moe_n_group=hf.get("n_group") or 0,
                 moe_topk_group=hf.get("topk_group") or 0)
    return ModelConfig.from_fields(d)


def _deepseek_v3(hf: dict) -> ModelConfig:
    """V3's ``noaux_tc``: sigmoid scores, the score bias for the selection
    only, group score the sum of a group's top two."""
    d = _deepseek_common(hf)
    d.update(moe_n_group=hf.get("n_group") or 0,
             moe_topk_group=hf.get("topk_group") or 0,
             moe_score_func="sigmoid", moe_group_score="top2sum",
             moe_score_bias=True)
    return ModelConfig.from_fields(d)


def _mup_scalings(hf: dict) -> dict:
    """minicpm's muP scalings (the reference's ``_minicpm``): embeddings
    times ``scale_emb``, every residual branch times ``scale_depth /
    sqrt(L)``, the logits times ``dim_model_base / hidden_size``."""
    return dict(
        embedding_multiplier=float(hf.get("scale_emb", 1.0)),
        residual_multiplier=float(hf.get("scale_depth", 1.0))
        / math.sqrt(hf["num_hidden_layers"]),
        logit_scale=float(hf.get("dim_model_base", hf["hidden_size"]))
        / hf["hidden_size"])


def _minicpm(hf: dict) -> ModelConfig:
    """minicpm (1 and 2): llama's layout and names plus the muP
    scalings."""
    return ModelConfig.from_fields(_base_cfg(hf, **_mup_scalings(hf)))


def _minicpm3(hf: dict) -> ModelConfig:
    """minicpm3: DeepSeek's MLA (its ``q_a``/``kv_a`` low-rank names)
    on a dense model (no ``n_routed_experts``: a plain MLP on every
    layer), with the muP scalings.  V is ``v_head_dim`` wide where the
    config names it and else K's width, the reference's reading (a
    published MiniCPM3 config names none, and its modeling code takes V
    at ``hidden_size / num_attention_heads``: ROADMAP queue 3)."""
    d = _deepseek_common(hf)
    d.update(model_type="minicpm3", **_mup_scalings(hf))
    return ModelConfig.from_fields(d)


def _phi(hf: dict) -> ModelConfig:
    """phi-1/phi-2: the parallel block off ONE LayerNorm, partial rotary,
    the ungated gelu_new MLP, biases everywhere (the reference's
    ``_phi``)."""
    return ModelConfig.from_fields(_base_cfg(
        hf,
        norm_kind="layer",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        act=hf.get("hidden_act", "gelu_new"),
        mlp_gated=False,
        parallel_blocks=True,
        attention_bias=True,
        attention_out_bias=True,
    ))


def _phixtral(hf: dict) -> ModelConfig:
    """phixtral (``phi-msft``): phi-2 blocks with an MoE of ungated
    fc1 -> gelu -> fc2 experts, softmax before the top-k, renormalised
    over the k (the reference's ``_phixtral``).  The msft config spells
    its widths ``n_embd``/``n_head``/``n_layer`` and its rotary width
    ``rotary_dim``."""
    n_embd = hf.get("n_embd", hf.get("hidden_size", 2560))
    n_head = hf.get("n_head", hf.get("num_attention_heads", 32))
    head_dim = n_embd // n_head
    hf2 = dict(hf)
    hf2.setdefault("hidden_size", n_embd)
    hf2.setdefault("num_attention_heads", n_head)
    hf2.setdefault("num_hidden_layers", hf.get("n_layer", 32))
    hf2.setdefault("num_key_value_heads", hf.get("n_head_kv") or n_head)
    hf2.setdefault("intermediate_size", hf.get("n_inner") or 4 * n_embd)
    hf2.setdefault("max_position_embeddings", hf.get("n_positions", 2048))
    hf2.setdefault("partial_rotary_factor",
                   hf.get("rotary_dim", head_dim) / head_dim)
    return ModelConfig.from_fields(_base_cfg(
        hf2,
        norm_kind="layer",
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        act=hf.get("activation_function", "gelu_new"),
        mlp_gated=False,
        parallel_blocks=True,
        attention_bias=True,
        attention_out_bias=True,
        num_experts=hf.get("num_local_experts", 4),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        moe_intermediate_size=hf.get("n_inner") or 4 * n_embd,
        moe_softmax_before_topk=True,
        moe_norm_topk_prob=True,
    ))


def _gptneox(hf: dict) -> ModelConfig:
    """GPT-NeoX (Pythia): two LayerNorms, the parallel residual where
    ``use_parallel_residual`` (the default), partial rotary of
    ``rotary_pct``, the exact gelu (the reference's ``_gptneox``)."""
    hf2 = dict(hf)
    hf2.setdefault("partial_rotary_factor", hf.get("rotary_pct", 1.0))
    hf2.setdefault("rope_theta", hf.get("rotary_emb_base", 10000.0))
    return ModelConfig.from_fields(_base_cfg(
        hf2,
        norm_kind="layer",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        act=hf.get("hidden_act", "gelu"),
        mlp_gated=False,
        parallel_blocks=hf.get("use_parallel_residual", True),
        attention_bias=hf.get("attention_bias", True),
        attention_out_bias=True,
    ))


def _gptj(hf: dict) -> ModelConfig:
    """GPT-J: the parallel block off ONE LayerNorm, no bias on q/k/v/o,
    ``rotary_dim`` columns in the interleaved "two" layout, the ungated
    gelu_new MLP with biases, a biased head (the reference's ``_gptj``,
    which rebuilds the config from the ``n_*`` names)."""
    h = hf["n_embd"]
    head_dim = h // hf["n_head"]
    hf2 = dict(
        model_type="gptj", vocab_size=hf["vocab_size"], hidden_size=h,
        intermediate_size=hf.get("n_inner") or 4 * h,
        num_hidden_layers=hf["n_layer"], num_attention_heads=hf["n_head"],
        layer_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        max_position_embeddings=hf.get("n_positions", 2048),
        partial_rotary_factor=hf.get("rotary_dim", head_dim) / head_dim,
    )
    return ModelConfig.from_fields(_base_cfg(
        hf2, rope_layout="two", norm_kind="layer",
        act=hf.get("activation_function", "gelu_new"), mlp_gated=False,
        parallel_blocks=True, mlp_bias=True,
    ))


def _glm(hf: dict) -> ModelConfig:
    """GLM-4 (``transformers``' ``glm``): the interleaved "two" rope on half
    of each head, head_dim 128 unless the config names one, a qkv bias, no
    bias on o, the merged gate_up (the reference's ``_glm``)."""
    hf2 = dict(hf)
    hf2.setdefault("partial_rotary_factor", 0.5)
    hf2.setdefault("head_dim", 128)
    return ModelConfig.from_fields(_base_cfg(
        hf2, rope_layout="two",
        attention_bias=hf.get("attention_bias", True),
        attention_out_bias=False))


def _glm4(hf: dict) -> ModelConfig:
    """GLM-4-0414 (``glm4``): ``_glm`` and a norm of each block's output
    before its residual add, plain RMSNorms (no (1 + w) offset)."""
    return replace(_glm(hf), post_attn_norm=True, post_mlp_norm=True)


def _chatglm(hf: dict) -> ModelConfig:
    """chatglm2/3 and glm-4-9b-chat: mainline glm's math under the THUDM
    config keys (the reference's ``_chatglm``).  ``multi_query_group_num``
    kv heads only where ``multi_query_attention`` is set, the rope base
    10000 times ``rope_ratio``; a config without RMSNorm or without its
    final norm is refused, as the reference refuses it."""
    if not hf.get("rmsnorm", True) or hf.get("post_layer_norm") is False:
        raise NotImplementedError(
            "chatglm with rmsnorm false or post_layer_norm false (a "
            "LayerNorm or post-norm variant) is not served by either "
            "package (ROADMAP item 14)")
    heads = hf["num_attention_heads"]
    groups = (hf.get("multi_query_group_num", heads)
              if hf.get("multi_query_attention", False) else heads)
    hf2 = dict(
        model_type="chatglm",
        vocab_size=hf.get("padded_vocab_size", hf.get("vocab_size")),
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["ffn_hidden_size"],
        num_hidden_layers=hf["num_layers"],
        num_attention_heads=heads,
        num_key_value_heads=groups,
        head_dim=hf.get("kv_channels", hf["hidden_size"] // heads),
        max_position_embeddings=hf.get("seq_length", 8192),
        rms_norm_eps=hf.get("layernorm_epsilon", 1e-5),
        rope_theta=10000.0 * hf.get("rope_ratio", 1.0),
        partial_rotary_factor=0.5,
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    bias = hf.get("add_bias_linear", False)
    return ModelConfig.from_fields(_base_cfg(
        hf2, rope_layout="two",
        attention_bias=hf.get("add_qkv_bias", bias),
        attention_out_bias=bias, mlp_bias=bias))


def _internlm(hf: dict) -> ModelConfig:
    """internlm (v1): llama's layout under one ``bias`` flag for q, k, v
    and o (the reference's ``_internlm``)."""
    b = hf.get("bias", True)
    return ModelConfig.from_fields(_base_cfg(
        hf, attention_bias=b, attention_out_bias=b))


def _internlm2(hf: dict) -> ModelConfig:
    return ModelConfig.from_fields(_base_cfg(
        hf, attention_bias=hf.get("bias", False)))


def _baichuan(hf: dict) -> ModelConfig:
    """baichuan at 7B (Baichuan-7B, Baichuan2-7B): llama's block over the
    pre-merged ``W_pack``.  At hidden 5120 and up (13B) the model runs
    ALiBi in place of rope, which the port does not serve.  Baichuan2's
    ``NormHead`` (the head's rows normalised in its forward) is not
    applied, as the reference does not apply it (ROADMAP queue 3)."""
    if hf.get("hidden_size", 0) >= 5120:
        raise NotImplementedError(
            "baichuan-13B runs ALiBi in place of rope (ROADMAP item 14 "
            "step 4)")
    return ModelConfig.from_fields(_base_cfg(hf))


def _qwen(hf: dict) -> ModelConfig:
    """Qwen (v1): the fused ``c_attn``, RMSNorm, the "half" rope over the
    whole head, and a gated MLP whose ``intermediate_size`` counts both
    branches (each is half of it; the reference's ``_qwen``).  ``no_bias``
    governs ``c_proj`` and the MLP; ``c_attn``'s bias, which a Qwen
    checkpoint holds whatever it says, is loaded where present (the
    loader's rule).  ``use_dynamic_ntk`` and ``use_logn_attn`` are read by
    neither package (ROADMAP queue 3)."""
    heads = hf["num_attention_heads"]
    hf2 = dict(
        model_type="qwen",
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"] // 2,
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=heads,
        head_dim=hf.get("kv_channels", hf["hidden_size"] // heads),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-6),
        max_position_embeddings=hf.get("seq_length", 8192),
        rope_theta=hf.get("rotary_emb_base", 10000.0),
    )
    return ModelConfig.from_fields(_base_cfg(
        hf2, attention_bias=not hf.get("no_bias", False),
        attention_out_bias=False))


def _starcoder2(hf: dict) -> ModelConfig:
    """StarCoder2: LayerNorms with biases, the ungated tanh-GELU MLP, biases
    on q, k, v, o and the MLP under ``use_bias``, a window on every layer
    and a tied head (the reference's ``_starcoder2``)."""
    bias = hf.get("use_bias", True)
    return ModelConfig.from_fields(_base_cfg(
        hf,
        norm_kind="layer",
        norm_eps=hf.get("norm_epsilon", hf.get("layer_norm_eps", 1e-5)),
        act=hf.get("hidden_act", "gelu_pytorch_tanh"),
        mlp_gated=False,
        attention_bias=bias,
        attention_out_bias=bias,
        sliding_window=hf.get("sliding_window"),
        tie_word_embeddings=hf.get("tie_word_embeddings", True)))


def _stablelm(hf: dict) -> ModelConfig:
    """StableLM (2): llama's gated block under LayerNorms with biases, a
    partial rotary, a qkv bias under ``use_qkv_bias`` and none on o.  The
    ``qk_layernorm`` and parallel-residual variants (StableLM-2-12B) raise,
    as in the reference."""
    if hf.get("qk_layernorm") or hf.get("use_parallel_residual"):
        raise NotImplementedError(
            "stablelm qk_layernorm / parallel-residual variants (e.g. "
            "stablelm-2-12b) are not supported yet")
    return ModelConfig.from_fields(_base_cfg(
        hf,
        norm_kind="layer",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        attention_bias=hf.get("use_qkv_bias", False),
        attention_out_bias=False))


def _cohere(hf: dict) -> ModelConfig:
    """Command-R (cohere): the "two" rope over the whole head, LayerNorms
    without a bias, the parallel residual ``x + attn(ln(x)) + mlp(ln(x))``
    off one norm over llama's gated MLP, ``logit_scale`` on the logits, a
    tied head.  ``use_qk_norm`` (Command-R+) raises, as in the
    reference."""
    if hf.get("use_qk_norm"):
        raise NotImplementedError("cohere use_qk_norm variant unsupported")
    return ModelConfig.from_fields(_base_cfg(
        hf,
        rope_layout="two",
        norm_kind="layer",
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        parallel_blocks=True,
        logit_scale=hf.get("logit_scale", 1.0),
        tie_word_embeddings=True))


def _olmo2(hf: dict) -> ModelConfig:
    """OLMo-2: llama's block with each norm on its branch's output
    (``norm_after``) and RMSNorms over the whole q and k projections."""
    return ModelConfig.from_fields(_base_cfg(hf, qk_norm=True,
                                             norm_after=True))


def _falcon(hf: dict) -> ModelConfig:
    """Falcon (rope, no ALiBi): one kv head where ``multi_query`` (the old
    architecture's default), ``num_kv_heads`` in the new architecture,
    else one a query head; ``ffn_hidden_size`` or 4h; LayerNorms with
    biases, the parallel residual where ``parallel_attn``, the ungated
    ``gelu_new`` MLP, biases on the projections under ``bias``, a tied
    head (the reference's ``_falcon``).  ALiBi (Falcon-RW) raises."""
    if hf.get("alibi"):
        raise NotImplementedError(
            "falcon with alibi runs ALiBi in place of rope (ROADMAP item 14 "
            "step 4)")
    h = hf["hidden_size"]
    if hf.get("new_decoder_architecture", False):
        kv = hf.get("num_kv_heads") or hf["num_attention_heads"]
    elif hf.get("multi_query", True):
        kv = 1
    else:
        kv = hf["num_attention_heads"]
    hf2 = dict(hf)
    hf2["intermediate_size"] = hf.get("ffn_hidden_size") or 4 * h
    hf2["num_key_value_heads"] = kv
    bias = hf.get("bias", False)
    return ModelConfig.from_fields(_base_cfg(
        hf2, norm_kind="layer", norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        act="gelu_new", mlp_gated=False,
        parallel_blocks=hf.get("parallel_attn", True),
        attention_bias=bias, attention_out_bias=bias,
        tie_word_embeddings=True))


def _neox_qkv(w, cfg: ModelConfig):
    """GPT-NeoX ``query_key_value``: per-head ``[q_i; k_i; v_i]`` rows ->
    ``[q_all; k_all; v_all]`` (a bias passes as an ``[out, 1]`` column)."""
    h, hd = cfg.num_heads, cfg.head_dim
    return w.reshape(h, 3, hd, -1).transpose(0, 1).reshape(3 * h * hd, -1)


def _internlm2_qkv(w, cfg: ModelConfig):
    """internlm2 ``wqkv``: per kv group ``[q * G; k; v]`` rows -> ``[q_all;
    k_all; v_all]`` (a bias passes as an ``[out, 1]`` column; the
    reference's ``_internlm2_qkv``)."""
    g, hd = cfg.num_kv_heads, cfg.head_dim
    per = cfg.num_heads // g
    x = w.reshape(g, per + 2, hd, -1)
    return torch.cat([x[:, :per].reshape(g * per * hd, -1),
                      x[:, per].reshape(g * hd, -1),
                      x[:, per + 1].reshape(g * hd, -1)])


def _falcon_qkv(w, cfg: ModelConfig):
    """Falcon's ``query_key_value``: the old architecture's MQA rows are
    already ``[q_all; k; v]``, its MHA rows interleave per head (as
    GPT-NeoX's), the new architecture's group per kv head (as internlm2's)
    (the reference's ``_falcon_qkv``)."""
    if cfg.num_kv_heads == 1:
        return w
    if cfg.num_kv_heads == cfg.num_heads:
        return _neox_qkv(w, cfg)
    return _internlm2_qkv(w, cfg)


# the reference's _GEMMA2_SCHEME: pre- and post-feedforward norms, the
# attention block's output norm, and the head tied to the embedding table
_GEMMA2_SCHEME = WeightScheme(
    lm_head="model.embed_tokens.weight",
    mlp_norm="model.layers.{i}.pre_feedforward_layernorm.weight",
    post_attn_norm="model.layers.{i}.post_attention_layernorm.weight",
    post_mlp_norm="model.layers.{i}.post_feedforward_layernorm.weight",
)

# the reference's _GEMMA_SCHEME and gemma3_text and phi3 rows
_GEMMA_SCHEME = WeightScheme(lm_head="model.embed_tokens.weight")
_GEMMA3_SCHEME = WeightScheme(
    lm_head="model.embed_tokens.weight",
    mlp_norm="model.layers.{i}.pre_feedforward_layernorm.weight",
    post_attn_norm="model.layers.{i}.post_attention_layernorm.weight",
    post_mlp_norm="model.layers.{i}.post_feedforward_layernorm.weight",
    q_norm="model.layers.{i}.self_attn.q_norm.weight",
    k_norm="model.layers.{i}.self_attn.k_norm.weight",
)
_PHI3_SCHEME = WeightScheme(
    qkv="model.layers.{i}.self_attn.qkv_proj.{p}",
    q=None, k=None, v=None, gate=None, up=None,
    gate_up="model.layers.{i}.mlp.gate_up_proj.{p}",
)

_QK_NORM_SCHEME = WeightScheme(
    q_norm="model.layers.{i}.self_attn.q_norm.weight",
    k_norm="model.layers.{i}.self_attn.k_norm.weight",
)
_MIXTRAL_MOE = MoEScheme(
    router="model.layers.{i}.block_sparse_moe.gate.weight",
    e_gate="model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    e_up="model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
    e_down="model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
)
_QWEN2_MOE = MoEScheme(
    shared_gate="model.layers.{i}.mlp.shared_expert.gate_proj.weight",
    shared_up="model.layers.{i}.mlp.shared_expert.up_proj.weight",
    shared_down="model.layers.{i}.mlp.shared_expert.down_proj.weight",
    shared_router="model.layers.{i}.mlp.shared_expert_gate.weight",
)

# the reference's _DEEPSEEK_SCHEME (the q template serves V2-Lite's
# full-rank q_proj), _DEEPSEEK_MOE and _DEEPSEEK_V3_MOE
_DEEPSEEK_SCHEME = WeightScheme(
    k=None, v=None,
    q_a="model.layers.{i}.self_attn.q_a_proj.{p}",
    q_a_norm="model.layers.{i}.self_attn.q_a_layernorm.weight",
    q_b="model.layers.{i}.self_attn.q_b_proj.{p}",
    kv_a="model.layers.{i}.self_attn.kv_a_proj_with_mqa.{p}",
    kv_a_norm="model.layers.{i}.self_attn.kv_a_layernorm.weight",
    kv_b="model.layers.{i}.self_attn.kv_b_proj.{p}",
)
_DEEPSEEK_MOE = MoEScheme(
    shared_gate="model.layers.{i}.mlp.shared_experts.gate_proj.weight",
    shared_up="model.layers.{i}.mlp.shared_experts.up_proj.weight",
    shared_down="model.layers.{i}.mlp.shared_experts.down_proj.weight",
)
_DEEPSEEK_V3_MOE = replace(
    _DEEPSEEK_MOE,
    score_bias="model.layers.{i}.mlp.gate.e_score_correction_bias")

# the reference's _PHI_SCHEME: ONE LayerNorm feeds both parallel branches
_PHI_SCHEME = WeightScheme(
    final_norm="model.final_layernorm.weight",
    o="model.layers.{i}.self_attn.dense.{p}",
    gate=None,
    up="model.layers.{i}.mlp.fc1.{p}",
    gate_up=None,
    down="model.layers.{i}.mlp.fc2.{p}",
    mlp_norm="model.layers.{i}.input_layernorm.weight",
)
# phixtral keeps the msft phi-2 module tree; its experts are fc1/fc2
# under moe.mlp.{e} (the reference's _PHIXTRAL_SCHEME and _PHIXTRAL_MOE)
_PHIXTRAL_SCHEME = WeightScheme(
    embed="transformer.embd.wte.weight",
    final_norm="lm_head.ln.weight",
    lm_head="lm_head.linear.weight",
    attn_norm="transformer.h.{i}.ln.weight",
    mlp_norm="transformer.h.{i}.ln.weight",
    q=None, k=None, v=None,
    qkv="transformer.h.{i}.mixer.Wqkv.{p}",
    o="transformer.h.{i}.mixer.out_proj.{p}",
    gate=None, up=None, gate_up=None,
    down="transformer.h.{i}.moe.mlp.0.fc2.weight",  # unused (MoE layers)
)
_PHIXTRAL_MOE = MoEScheme(
    router="transformer.h.{i}.moe.gate.weight",
    e_gate=None,
    e_up="transformer.h.{i}.moe.mlp.{e}.fc1.weight",
    e_down="transformer.h.{i}.moe.mlp.{e}.fc2.weight",
)
_GPTNEOX_SCHEME = WeightScheme(
    embed="gpt_neox.embed_in.weight",
    final_norm="gpt_neox.final_layer_norm.weight",
    lm_head="embed_out.weight",
    attn_norm="gpt_neox.layers.{i}.input_layernorm.weight",
    mlp_norm="gpt_neox.layers.{i}.post_attention_layernorm.weight",
    qkv="gpt_neox.layers.{i}.attention.query_key_value.{p}",
    q=None, k=None, v=None,
    o="gpt_neox.layers.{i}.attention.dense.{p}",
    gate=None, gate_up=None,
    up="gpt_neox.layers.{i}.mlp.dense_h_to_4h.{p}",
    down="gpt_neox.layers.{i}.mlp.dense_4h_to_h.{p}",
)
_GPTJ_SCHEME = WeightScheme(
    embed="transformer.wte.weight",
    final_norm="transformer.ln_f.weight",
    lm_head="lm_head.weight",
    attn_norm="transformer.h.{i}.ln_1.weight",
    mlp_norm="transformer.h.{i}.ln_1.weight",  # ONE norm, parallel blocks
    q="transformer.h.{i}.attn.q_proj.{p}",
    k="transformer.h.{i}.attn.k_proj.{p}",
    v="transformer.h.{i}.attn.v_proj.{p}",
    o="transformer.h.{i}.attn.out_proj.{p}",
    gate=None, gate_up=None,
    up="transformer.h.{i}.mlp.fc_in.{p}",
    down="transformer.h.{i}.mlp.fc_out.{p}",
)

# the reference's _GLM_SCHEME, _GLM4_SCHEME (plain RMSNorms of each block's
# output) and _CHATGLM_SCHEME (THUDM names; query_key_value is already
# [q; k; v] and dense_h_to_4h [gate; up])
_GLM_SCHEME = WeightScheme(
    gate=None, up=None,
    gate_up="model.layers.{i}.mlp.gate_up_proj.{p}",
)
_GLM4_SCHEME = replace(
    _GLM_SCHEME,
    post_attn_norm="model.layers.{i}.post_self_attn_layernorm.weight",
    post_mlp_norm="model.layers.{i}.post_mlp_layernorm.weight",
)
_CHATGLM_SCHEME = WeightScheme(
    embed="transformer.embedding.word_embeddings.weight",
    final_norm="transformer.encoder.final_layernorm.weight",
    lm_head="transformer.output_layer.weight",
    attn_norm="transformer.encoder.layers.{i}.input_layernorm.weight",
    mlp_norm="transformer.encoder.layers.{i}.post_attention_layernorm.weight",
    qkv="transformer.encoder.layers.{i}.self_attention.query_key_value.{p}",
    q=None, k=None, v=None,
    o="transformer.encoder.layers.{i}.self_attention.dense.{p}",
    gate=None, up=None,
    gate_up="transformer.encoder.layers.{i}.mlp.dense_h_to_4h.{p}",
    down="transformer.encoder.layers.{i}.mlp.dense_4h_to_h.{p}",
)
# the reference's _BAICHUAN_SCHEME, _INTERNLM2_SCHEME and _QWEN_SCHEME
_BAICHUAN_SCHEME = WeightScheme(
    qkv="model.layers.{i}.self_attn.W_pack.{p}",
    q=None, k=None, v=None,
)
_INTERNLM2_SCHEME = WeightScheme(
    embed="model.tok_embeddings.weight",
    lm_head="output.weight",
    attn_norm="model.layers.{i}.attention_norm.weight",
    mlp_norm="model.layers.{i}.ffn_norm.weight",
    qkv="model.layers.{i}.attention.wqkv.{p}",
    q=None, k=None, v=None,
    o="model.layers.{i}.attention.wo.{p}",
    gate="model.layers.{i}.feed_forward.w1.{p}",
    up="model.layers.{i}.feed_forward.w3.{p}",
    down="model.layers.{i}.feed_forward.w2.{p}",
)
_QWEN_SCHEME = WeightScheme(
    embed="transformer.wte.weight",
    final_norm="transformer.ln_f.weight",
    lm_head="lm_head.weight",
    attn_norm="transformer.h.{i}.ln_1.weight",
    mlp_norm="transformer.h.{i}.ln_2.weight",
    qkv="transformer.h.{i}.attn.c_attn.{p}",
    q=None, k=None, v=None,
    o="transformer.h.{i}.attn.c_proj.{p}",
    # c_proj(silu(w2(x)) * w1(x)): w2 is the gate
    gate="transformer.h.{i}.mlp.w2.{p}",
    up="transformer.h.{i}.mlp.w1.{p}",
    down="transformer.h.{i}.mlp.c_proj.{p}",
)

# the reference's _STARCODER2_SCHEME, _COHERE_SCHEME (ONE norm feeds both
# parallel branches), _OLMO2_SCHEME (the norms after each branch, flat q/k
# norms) and _FALCON_SCHEME ("a|b" templates: the old architecture's one
# input_layernorm, the new one's ln_attn/ln_mlp; a sequential falcon's
# post_attention_layernorm first, so that the ever-present input norm
# cannot shadow it)
_STARCODER2_SCHEME = WeightScheme(
    gate=None, gate_up=None,
    up="model.layers.{i}.mlp.c_fc.{p}",
    down="model.layers.{i}.mlp.c_proj.{p}",
)
_COHERE_SCHEME = WeightScheme(
    lm_head="model.embed_tokens.weight",
    mlp_norm="model.layers.{i}.input_layernorm.weight",
)
_OLMO2_SCHEME = WeightScheme(
    attn_norm="model.layers.{i}.post_attention_layernorm.weight",
    mlp_norm="model.layers.{i}.post_feedforward_layernorm.weight",
    q_norm="model.layers.{i}.self_attn.q_norm.weight",
    k_norm="model.layers.{i}.self_attn.k_norm.weight",
)
_FALCON_SCHEME = WeightScheme(
    embed="transformer.word_embeddings.weight",
    final_norm="transformer.ln_f.weight",
    lm_head="transformer.word_embeddings.weight",
    attn_norm="transformer.h.{i}.input_layernorm.weight"
              "|transformer.h.{i}.ln_attn.weight",
    mlp_norm="transformer.h.{i}.post_attention_layernorm.weight"
             "|transformer.h.{i}.ln_mlp.weight"
             "|transformer.h.{i}.input_layernorm.weight",
    qkv="transformer.h.{i}.self_attention.query_key_value.{p}",
    q=None, k=None, v=None,
    o="transformer.h.{i}.self_attention.dense.{p}",
    gate=None, gate_up=None,
    up="transformer.h.{i}.mlp.dense_h_to_4h.{p}",
    down="transformer.h.{i}.mlp.dense_4h_to_h.{p}",
)

FAMILIES: dict[str, Family] = {
    "llama": Family("llama", _llama),
    "mistral": Family("mistral", _mistral),
    "qwen2": Family("qwen2", _qwen2),
    "gemma2": Family("gemma2", _gemma2, _GEMMA2_SCHEME),
    "qwen3": Family("qwen3", _qwen3, _QK_NORM_SCHEME),
    "mixtral": Family("mixtral", _mixtral, WeightScheme(), _MIXTRAL_MOE),
    "qwen2_moe": Family("qwen2_moe", _qwen2_moe, WeightScheme(), _QWEN2_MOE),
    "qwen3_moe": Family("qwen3_moe", _qwen3_moe, _QK_NORM_SCHEME,
                        MoEScheme()),
    "phi3": Family("phi3", _phi3, _PHI3_SCHEME),
    "gemma": Family("gemma", _gemma, _GEMMA_SCHEME),
    "gemma3_text": Family("gemma3_text", _gemma3, _GEMMA3_SCHEME),
    "deepseek_v2": Family("deepseek_v2", _deepseek_v2, _DEEPSEEK_SCHEME,
                          _DEEPSEEK_MOE),
    "deepseek_v3": Family("deepseek_v3", _deepseek_v3, _DEEPSEEK_SCHEME,
                          _DEEPSEEK_V3_MOE),
    "phi": Family("phi", _phi, _PHI_SCHEME),
    "phi-msft": Family("phi-msft", _phixtral, _PHIXTRAL_SCHEME,
                       _PHIXTRAL_MOE),
    "phixtral": Family("phixtral", _phixtral, _PHIXTRAL_SCHEME,
                       _PHIXTRAL_MOE),
    "gpt_neox": Family("gpt_neox", _gptneox, _GPTNEOX_SCHEME,
                       qkv_transform=_neox_qkv),
    "gptj": Family("gptj", _gptj, _GPTJ_SCHEME),
    "minicpm": Family("minicpm", _minicpm),
    "minicpm3": Family("minicpm3", _minicpm3, _DEEPSEEK_SCHEME),
    "glm": Family("glm", _glm, _GLM_SCHEME),
    "glm4": Family("glm4", _glm4, _GLM4_SCHEME),
    "chatglm": Family("chatglm", _chatglm, _CHATGLM_SCHEME),
    # aquila (Aquila, Aquila2) keeps llama's config keys and weight names
    "aquila": Family("aquila", _llama),
    "internlm": Family("internlm", _internlm),
    "internlm2": Family("internlm2", _internlm2, _INTERNLM2_SCHEME,
                        qkv_transform=_internlm2_qkv),
    "baichuan": Family("baichuan", _baichuan, _BAICHUAN_SCHEME),
    "qwen": Family("qwen", _qwen, _QWEN_SCHEME),
    "starcoder2": Family("starcoder2", _starcoder2, _STARCODER2_SCHEME),
    # stablelm keeps llama's weight names
    "stablelm": Family("stablelm", _stablelm),
    "cohere": Family("cohere", _cohere, _COHERE_SCHEME),
    "olmo2": Family("olmo2", _olmo2, _OLMO2_SCHEME),
    "falcon": Family("falcon", _falcon, _FALCON_SCHEME,
                     qkv_transform=_falcon_qkv),
}
assert tuple(FAMILIES) == MODEL_TYPES, "config.MODEL_TYPES names the families"


def get_family(model_type: str, hf_config: dict | None = None) -> Family:
    """The family of ``model_type``; ``hf_config`` tells a chatglm v1
    checkpoint, which the reference routes to its ``chatglm1`` row and the
    port refuses, from chatglm2 and later: THUDM reused ``chatglm`` for
    v1's LayerNorm, 2D-rope block, whose configs carry
    ``position_encoding_2d`` or ``inner_hidden_size`` (the reference's
    markers)."""
    if model_type == "chatglm" and hf_config is not None and (
            hf_config.get("position_encoding_2d")
            or "inner_hidden_size" in hf_config):
        raise NotImplementedError(
            "chatglm v1 (LayerNorm, the 2D rope, the GLM alpha residual) is "
            "not ported (ROADMAP item 14 step 4)")
    if model_type not in FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported (ROADMAP item 14, "
            f"family breadth); available: {sorted(FAMILIES)}")
    return FAMILIES[model_type]


def config_from_hf(hf: dict) -> ModelConfig:
    """``ModelConfig`` for an HF ``config.json`` dict: the family's
    ``to_config``."""
    model_type = hf.get("model_type", "llama")
    return get_family(model_type, hf).to_config(hf)
