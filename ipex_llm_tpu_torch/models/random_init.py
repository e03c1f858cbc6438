"""Random weights of the ported families made on the device (port of
``ipex_llm_tpu/models/random_init.py`` and the tree half of
``models/build.py``).

Weights come from a seeded ``torch.Generator`` on the target device and
are quantized one layer at a time with the port's own codec, so a
full-width model never sits in memory as fp32 at once.  The scale rules
are the reference's: norm weights ``1 + 0.05 * N(0, 1)``, every other
tensor ``N(0, 1) * 1.2 / sqrt(fan_in)`` (a qkv bias ``0.1 * N(0, 1)``;
a ``(1 + w)`` norm's weight ``0.05 * N(0, 1)``, so that both forms scale
by about 1).  The tree has the layout
:func:`ipex_llm_tpu_torch.models.convert.params_from_reference` produces:
stacked ``[L, ...]`` layer leaves, merged qkv and gate_up, weights
``[in, out]``, the qkv bias fp32, post norms where the config has them,
per-head q/k norms, an MoE layer's fp32 router ``[H, E]``, its
``[L, E, ...]`` expert stacks (each expert quantized on its own) and
qwen2_moe's shared expert and its gate, DeepSeek's MLA leaves, score
bias and ``layers_dense`` stack, no ``lm_head`` when the head is tied to
the embedding table, and the rope leaves of ``models.build.rope_buffers``
(gemma3's ``inv_freq_local`` too).  The GPT-style block's tree adds the
biases its checkpoints hold, fp32 ``0.1 * N(0, 1)`` (a LayerNorm's
``0.05 * N(0, 1)``): the LayerNorms' (not Cohere's:
:data:`NORM_BIAS_FREE_FAMILIES`), o's where ``attention_out_bias``, the
ungated MLP's ``up`` and, where ``mlp_bias`` or ``attention_out_bias``
(not Falcon's), ``up_bias``/``down_bias`` (and an ungated expert stack's
``moe_up_bias``/``moe_down_bias``) and the head's where the family's
checkpoints carry one (:data:`HEAD_BIAS_FAMILIES`); Qwen v1's tree holds
its ``c_attn`` bias (:data:`QKV_BIAS_FAMILIES`), OLMo-2's q/k norms span
the projections (:data:`FLAT_QK_NORM_FAMILIES`).
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.models.build import (LayerStack, dense_prefix,
                                             rope_buffers)
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.ops.rope import RopeScaling
from ipex_llm_tpu_torch.quantize.core import quantize


def llama_config(hidden_size: int = 64, intermediate_size: int = 256,
                 num_layers: int = 2, num_heads: int = 8,
                 num_kv_heads: int = 8, head_dim: int | None = None,
                 vocab_size: int = 128, max_position_embeddings: int = 2048,
                 **over) -> ModelConfig:
    hd = head_dim or hidden_size // num_heads
    d = dict(model_type="llama", vocab_size=vocab_size,
             hidden_size=hidden_size, intermediate_size=intermediate_size,
             num_layers=num_layers, num_heads=num_heads,
             num_kv_heads=num_kv_heads, head_dim=hd,
             max_position_embeddings=max_position_embeddings,
             rope=RopeScaling(head_dim=hd))
    d.update(over)
    return ModelConfig(**d)


def llama2_7b_config(**over) -> ModelConfig:
    """Llama-2-7B's published widths (hidden 4096, ffn 11008, 32 layers,
    32 heads of 128, vocab 32000, rms eps 1e-5)."""
    d = dict(hidden_size=4096, intermediate_size=11008, num_layers=32,
             num_heads=32, num_kv_heads=32, vocab_size=32000,
             max_position_embeddings=4096, norm_eps=1e-5)
    d.update(over)
    return llama_config(**d)


# huggingface.co/mistralai/Mistral-7B-v0.1, config.json (the fields the
# decoder reads)
MISTRAL_7B_V01_HF = {
    "model_type": "mistral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "sliding_window": 4096, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
}


def mistral_7b_config(**over) -> ModelConfig:
    """Mistral-7B-v0.1's published widths (hidden 4096, ffn 14336, 32
    layers, 32 query heads over 8 kv heads of 128, vocab 32000, sliding
    window 4096), through the families lookup; ``over`` replaces fields of
    the result (``num_layers`` to cut depth)."""
    cfg = config_from_hf(MISTRAL_7B_V01_HF)
    return replace(cfg, **over) if over else cfg


# huggingface.co/Qwen/Qwen2-7B, config.json (the fields the decoder reads;
# use_sliding_window is false, so sliding_window is not a window)
QWEN2_7B_HF = {
    "model_type": "qwen2", "vocab_size": 152064, "hidden_size": 3584,
    "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4,
    "max_position_embeddings": 131072, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "sliding_window": 131072,
    "use_sliding_window": False, "max_window_layers": 28,
    "hidden_act": "silu", "tie_word_embeddings": False,
    "bos_token_id": 151643, "eos_token_id": 151643,
}

# huggingface.co/google/gemma-2-9b, config.json (the fields the decoder
# reads)
GEMMA2_9B_HF = {
    "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 3584,
    "intermediate_size": 14336, "num_hidden_layers": 42,
    "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "attention_bias": False,
    "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
    "pad_token_id": 0,
}


def qwen2_7b_config(**over) -> ModelConfig:
    """Qwen2-7B's published widths (huggingface.co/Qwen/Qwen2-7B
    ``config.json``: hidden 3584, ffn 18944, 28 layers, 28 query heads
    over 4 kv heads of 128, vocab 152064, rope theta 1e6, qkv bias, no
    window), through the families lookup; ``over`` replaces fields of the
    result."""
    cfg = config_from_hf(QWEN2_7B_HF)
    return replace(cfg, **over) if over else cfg


def gemma2_9b_config(**over) -> ModelConfig:
    """Gemma-2-9B's published widths (huggingface.co/google/gemma-2-9b
    ``config.json``: hidden 3584, ffn 14336, 42 layers, 16 query heads
    over 8 kv heads of 256, vocab 256000 tied, a 4096 window on even
    layers, softcaps 50 and 30, query_pre_attn_scalar 256), through the
    families lookup; ``over`` replaces fields of the result
    (``num_layers`` with a ``layer_types`` of that length)."""
    cfg = config_from_hf(GEMMA2_9B_HF)
    return replace(cfg, **over) if over else cfg


# huggingface.co/mistralai/Mixtral-8x7B-v0.1, config.json (the fields the
# decoder reads)
MIXTRAL_8X7B_HF = {
    "model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_local_experts": 8, "num_experts_per_tok": 2,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-5, "sliding_window": None, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
}

# huggingface.co/Qwen/Qwen3-30B-A3B, config.json (the fields the decoder
# reads; q width 32 x 128 = 4096 against a hidden width of 2048)
QWEN3_30B_A3B_HF = {
    "model_type": "qwen3_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 6144, "moe_intermediate_size": 768,
    "num_hidden_layers": 48, "num_attention_heads": 32,
    "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128,
    "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "sliding_window": None, "use_sliding_window": False,
    "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151645,
}

# huggingface.co/Qwen/Qwen1.5-MoE-A2.7B, config.json (the fields the
# decoder reads: 60 experts of 1408, top 4, a shared expert of 5632 behind
# its sigmoid gate, a qkv bias)
QWEN15_MOE_A27B_HF = {
    "model_type": "qwen2_moe", "vocab_size": 151936, "hidden_size": 2048,
    "intermediate_size": 5632, "moe_intermediate_size": 1408,
    "shared_expert_intermediate_size": 5632, "num_hidden_layers": 24,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "num_experts": 60, "num_experts_per_tok": 4, "norm_topk_prob": False,
    "decoder_sparse_step": 1, "max_position_embeddings": 8192,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151643,
}

# huggingface.co/Qwen/Qwen3-8B, config.json (the fields the decoder reads:
# per-head q/k norms)
QWEN3_8B_HF = {
    "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 4096,
    "intermediate_size": 12288, "num_hidden_layers": 36,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-6, "sliding_window": None, "use_sliding_window": False,
    "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "bos_token_id": 151643,
    "eos_token_id": 151645,
}


def mixtral_8x7b_config(**over) -> ModelConfig:
    """Mixtral-8x7B-v0.1's published widths (hidden 4096, 32 layers, 32
    query heads over 8 kv heads of 128, 8 experts of 14336, top 2, vocab
    32000, rope theta 1e6, no window), through the families lookup;
    ``over`` replaces fields of the result."""
    cfg = config_from_hf(MIXTRAL_8X7B_HF)
    return replace(cfg, **over) if over else cfg


def qwen3_30b_a3b_config(**over) -> ModelConfig:
    """Qwen3-30B-A3B's published widths (hidden 2048, 48 layers, 32 query
    heads over 4 kv heads of 128, 128 experts of 768, top 8, renormalised,
    per-head q/k norms, vocab 151936, rope theta 1e6), through the
    families lookup; ``over`` replaces fields of the result."""
    cfg = config_from_hf(QWEN3_30B_A3B_HF)
    return replace(cfg, **over) if over else cfg


def qwen15_moe_a27b_config(**over) -> ModelConfig:
    """Qwen1.5-MoE-A2.7B's published widths through the families lookup;
    ``over`` replaces fields of the result (the card-against-CPU checks
    cut widths and depth).  The shared expert's width is not a config
    field: :func:`random_params` takes it as ``shared_intermediate``."""
    cfg = config_from_hf(QWEN15_MOE_A27B_HF)
    return replace(cfg, **over) if over else cfg


def qwen3_8b_config(**over) -> ModelConfig:
    """Qwen3-8B's published widths (hidden 4096, ffn 12288, 36 layers, 32
    query heads over 8 kv heads of 128, per-head q/k norms), through the
    families lookup; ``over`` replaces fields of the result."""
    cfg = config_from_hf(QWEN3_8B_HF)
    return replace(cfg, **over) if over else cfg


# huggingface.co/microsoft/Phi-3-mini-4k-instruct, config.json (the fields
# the decoder reads: pre-merged qkv_proj and gate_up_proj, 32 heads of 96,
# a 2047-slot window on every layer)
PHI3_MINI_4K_HF = {
    "model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
    "intermediate_size": 8192, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 4096,
    "original_max_position_embeddings": 4096, "rope_theta": 10000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-5, "sliding_window": 2047,
    "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": 32000, "pad_token_id": 32000,
}

# huggingface.co/google/gemma-7b, config.json (the fields the decoder
# reads; no ``hidden_activation``, so "gelu" is the exact GELU)
GEMMA_7B_HF = {
    "model_type": "gemma", "vocab_size": 256000, "hidden_size": 3072,
    "intermediate_size": 24576, "num_hidden_layers": 28,
    "num_attention_heads": 16, "num_key_value_heads": 16, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-6, "hidden_act": "gelu",
    "attention_bias": False, "tie_word_embeddings": True,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
}

# huggingface.co/google/gemma-3-4b-it, config.json's ``text_config`` (the
# fields the decoder reads: a 1024 window on five layers of six, the full
# layers' rope at theta 1e6 scaled linearly by 8, the sliding layers' at
# theta 1e4)
GEMMA3_4B_HF = {
    "model_type": "gemma3_text", "vocab_size": 262208, "hidden_size": 2560,
    "intermediate_size": 10240, "num_hidden_layers": 34,
    "num_attention_heads": 8, "num_key_value_heads": 4, "head_dim": 256,
    "max_position_embeddings": 131072, "rope_theta": 1000000.0,
    "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
    "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-6,
    "sliding_window": 1024, "sliding_window_pattern": 6,
    "query_pre_attn_scalar": 256, "hidden_activation": "gelu_pytorch_tanh",
    "attention_bias": False, "final_logit_softcapping": None,
    "attn_logit_softcapping": None, "tie_word_embeddings": True,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
}

# huggingface.co/meta-llama/Llama-3.1-8B, config.json (the fields the
# decoder reads: the llama3 rope)
LLAMA31_8B_HF = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 131072, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rms_norm_eps": 1e-5, "hidden_act": "silu", "attention_bias": False,
    "mlp_bias": False, "tie_word_embeddings": False,
    "bos_token_id": 128000, "eos_token_id": 128001,
}

# huggingface.co/microsoft/Phi-3.5-mini-instruct, config.json (the fields
# the decoder reads: Phi-3-mini's widths, a longrope table from 4096 to
# 131072 positions).  The published short_factor and long_factor lists
# (48 entries, one for each frequency of a 96-wide head) are not in the
# repository: phi35_mini_hf() draws lists of that length from a seed.
PHI35_MINI_HF = {
    **PHI3_MINI_4K_HF,
    "max_position_embeddings": 131072,
    "original_max_position_embeddings": 4096, "sliding_window": 262144,
    "rope_scaling": {"type": "longrope"},
}


def phi35_mini_hf(seed: int = 0, partial_rotary_factor: float = 1.0) -> dict:
    """``PHI35_MINI_HF`` with longrope factor lists made from ``seed`` (not
    the published values): as many entries as the rotary width has
    frequencies (48 at the published full rotary; fewer at a
    ``partial_rotary_factor`` below 1, as Phi-4-mini's 0.75), the short
    list rising from 1 to 3, the long one from 1 to 64, as the published
    lists rise."""
    head_dim = PHI35_MINI_HF["hidden_size"] // PHI35_MINI_HF[
        "num_attention_heads"]
    n = int(head_dim * partial_rotary_factor) // 2
    rng = np.random.default_rng(seed)
    short = 1.0 + np.sort(rng.uniform(0.0, 2.0, n))
    long = np.exp(np.sort(rng.uniform(0.0, math.log(64.0), n)))
    return {**PHI35_MINI_HF, "partial_rotary_factor": partial_rotary_factor,
            "rope_scaling": {"type": "longrope",
                             "short_factor": [float(v) for v in short],
                             "long_factor": [float(v) for v in long]}}


# huggingface.co/microsoft/phi-2, config.json (the fields the decoder
# reads: 32 heads of 80, 32 of whose columns rotate, the gelu_new MLP,
# LayerNorm eps 1e-5, an untied head with a bias)
PHI2_HF = {
    "model_type": "phi", "vocab_size": 51200, "hidden_size": 2560,
    "intermediate_size": 10240, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "max_position_embeddings": 2048, "rope_theta": 10000.0,
    "rope_scaling": None, "partial_rotary_factor": 0.4,
    "hidden_act": "gelu_new", "layer_norm_eps": 1e-5, "qk_layernorm": False,
    "tie_word_embeddings": False, "bos_token_id": 50256,
    "eos_token_id": 50256,
}

# huggingface.co/mlabonne/phixtral-4x2_8, config.json (model_type phi-msft:
# phi-2's widths in the msft names, four ungated experts, two a token)
PHIXTRAL_4X2_8_HF = {
    "model_type": "phi-msft", "vocab_size": 51200, "n_embd": 2560,
    "n_head": 32, "n_head_kv": None, "n_inner": None, "n_layer": 32,
    "n_positions": 2048, "rotary_dim": 32, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5, "num_local_experts": 4,
    "num_experts_per_tok": 2, "tie_word_embeddings": False,
}

# huggingface.co/EleutherAI/pythia-6.9b, config.json (32 heads of 128, a
# quarter of whose columns rotate, the exact gelu, two LayerNorms and the
# parallel residual)
PYTHIA_6_9B_HF = {
    "model_type": "gpt_neox", "vocab_size": 50432, "hidden_size": 4096,
    "intermediate_size": 16384, "num_hidden_layers": 32,
    "num_attention_heads": 32, "max_position_embeddings": 2048,
    "rotary_emb_base": 10000, "rotary_pct": 0.25, "hidden_act": "gelu",
    "layer_norm_eps": 1e-5, "use_parallel_residual": True,
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0,
}

# huggingface.co/EleutherAI/gpt-j-6b, config.json (16 heads of 256, 64 of
# whose columns rotate in the interleaved "two" layout, gelu_new)
GPTJ_6B_HF = {
    "model_type": "gptj", "vocab_size": 50400, "n_embd": 4096, "n_head": 16,
    "n_layer": 28, "n_positions": 2048, "n_inner": None, "rotary_dim": 64,
    "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
    "tie_word_embeddings": False, "bos_token_id": 50256,
    "eos_token_id": 50256,
}

# the families whose published checkpoints hold a bias on the lm head
# (Pythia's embed_out has none)
HEAD_BIAS_FAMILIES = ("phi", "phi-msft", "phixtral", "gptj")
# the families whose checkpoints hold a qkv bias whatever the config's
# flag says (Qwen v1's c_attn under no_bias)
QKV_BIAS_FAMILIES = ("qwen",)
# LayerNorm families whose norms have no bias (Cohere's)
NORM_BIAS_FREE_FAMILIES = ("cohere",)
# the families whose q/k norms span the whole projection (OLMo-2's)
FLAT_QK_NORM_FAMILIES = ("olmo2",)


def _published(hf: dict, over: dict) -> ModelConfig:
    cfg = config_from_hf(hf)
    return replace(cfg, **over) if over else cfg


def phi2_config(**over) -> ModelConfig:
    """Phi-2's published widths (hidden 2560, ffn 10240, 32 layers, 32
    heads of 80, vocab 51200), through the families lookup; ``over``
    replaces fields of the result."""
    return _published(PHI2_HF, over)


def phixtral_4x2_config(**over) -> ModelConfig:
    """Phixtral-4x2_8's published widths (Phi-2's, with four ungated
    experts of 10240, two a token)."""
    return _published(PHIXTRAL_4X2_8_HF, over)


def pythia_6_9b_config(**over) -> ModelConfig:
    """Pythia-6.9B's published widths (hidden 4096, ffn 16384, 32 layers,
    32 heads of 128, vocab 50432)."""
    return _published(PYTHIA_6_9B_HF, over)


def gptj_6b_config(**over) -> ModelConfig:
    """GPT-J-6B's published widths (hidden 4096, ffn 16384, 28 layers, 16
    heads of 256, vocab 50400)."""
    return _published(GPTJ_6B_HF, over)


def phi3_mini_4k_config(**over) -> ModelConfig:
    """Phi-3-mini-4k-instruct's published widths (hidden 3072, ffn 8192, 32
    layers, 32 heads of 96, vocab 32064, a 2047 window on every layer),
    through the families lookup; ``over`` replaces fields of the result."""
    cfg = config_from_hf(PHI3_MINI_4K_HF)
    return replace(cfg, **over) if over else cfg


def gemma_7b_config(**over) -> ModelConfig:
    """Gemma-7B's published widths (hidden 3072, ffn 24576, 28 layers, 16
    heads of 256, vocab 256000 tied, the exact GELU, no window), through
    the families lookup; ``over`` replaces fields of the result."""
    cfg = config_from_hf(GEMMA_7B_HF)
    return replace(cfg, **over) if over else cfg


def gemma3_4b_config(**over) -> ModelConfig:
    """Gemma-3-4B's published text widths (hidden 2560, ffn 10240, 34
    layers, 8 query heads over 4 kv heads of 256, vocab 262208 tied, a 1024
    window on five layers of six, rope theta 1e6 scaled linearly by 8 and
    a local table at theta 1e4), through the families lookup; ``over``
    replaces fields of the result (``num_layers`` with a ``layer_types``
    of that length)."""
    cfg = config_from_hf(GEMMA3_4B_HF)
    return replace(cfg, **over) if over else cfg


# huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json (the fields the
# decoder reads: MLA with a full-rank q_proj, K 128 + 64 wide and V 128, 64
# routed experts of 1408, top 6, two shared experts as one MLP 2816 wide,
# one dense layer of 10944 first, yarn rope over the 64-wide rope slice)
DEEPSEEK_V2_LITE_HF = {
    "model_type": "deepseek_v2", "vocab_size": 102400, "hidden_size": 2048,
    "intermediate_size": 10944, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "num_attention_heads": 16,
    "num_key_value_heads": 16, "q_lora_rank": None, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
    "first_k_dense_replace": 1, "moe_layer_freq": 1, "n_group": 1,
    "topk_group": 1, "topk_method": "greedy", "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "max_position_embeddings": 163840, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "bos_token_id": 100000,
    "eos_token_id": 100001,
}

# huggingface.co/deepseek-ai/DeepSeek-V3, config.json (the fields the
# decoder reads: MLA with a low-rank q of 1536, 128 heads, 256 routed
# experts of 2048, top 8 of the 4 best of 8 groups by the sum of a group's
# top two sigmoid scores plus the score bias, renormalised and scaled by
# 2.5, one shared expert, three dense layers of 18432 first).  The whole
# model does not fit one card: deepseek_v3_config() cuts the depth.
DEEPSEEK_V3_HF = {
    "model_type": "deepseek_v3", "vocab_size": 129280, "hidden_size": 7168,
    "intermediate_size": 18432, "moe_intermediate_size": 2048,
    "num_hidden_layers": 61, "num_attention_heads": 128,
    "num_key_value_heads": 128, "q_lora_rank": 1536, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "n_routed_experts": 256, "n_shared_experts": 1, "num_experts_per_tok": 8,
    "first_k_dense_replace": 3, "moe_layer_freq": 1, "n_group": 8,
    "topk_group": 4, "topk_method": "noaux_tc", "norm_topk_prob": True,
    "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
    "max_position_embeddings": 163840, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 1.0, "mscale_all_dim": 1.0,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 1,
}

# tiny DeepSeek-V2- and V3-shaped configs (3 layers: 1 dense, 2 MoE;
# hidden 64, 4 heads, K 16 + 8 wide, V 16, latent 32; V2 with a full-rank
# q and group-limited greedy routing over 4 groups, V3 with a low-rank q
# of 48): the tests' and the card's CPU oracle's models
_TINY_DEEPSEEK = {
    "vocab_size": 256, "hidden_size": 64, "intermediate_size": 160,
    "moe_intermediate_size": 32, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "n_routed_experts": 8, "num_experts_per_tok": 3,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "max_position_embeddings": 512, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
}
TINY_DEEPSEEK_V2_HF = {
    **_TINY_DEEPSEEK, "model_type": "deepseek_v2", "q_lora_rank": None,
    "n_shared_experts": 2, "n_group": 4, "topk_group": 2,
    "topk_method": "group_limited_greedy", "norm_topk_prob": False,
    "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 64,
                     "type": "yarn"},
}
TINY_DEEPSEEK_V3_HF = {
    **_TINY_DEEPSEEK, "model_type": "deepseek_v3", "q_lora_rank": 48,
    "n_shared_experts": 1, "n_group": 4, "topk_group": 2,
    "topk_method": "noaux_tc", "norm_topk_prob": True,
    "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
}


def deepseek_hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """The published weight names of an HF DeepSeek config (V2 or V3) and
    their ``[out, in]`` shapes, as its ``transformers`` class holds them:
    what a checkpoint written without that class needs."""
    h, nh, ffn = hf["hidden_size"], hf["num_attention_heads"], \
        hf["intermediate_size"]
    qk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
    kvr, qr, mi = hf["kv_lora_rank"], hf["q_lora_rank"], \
        hf["moe_intermediate_size"]
    out = {"model.embed_tokens.weight": (hf["vocab_size"], h),
           "model.norm.weight": (h,),
           "lm_head.weight": (hf["vocab_size"], h)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out.update({p + "input_layernorm.weight": (h,),
                    p + "post_attention_layernorm.weight": (h,),
                    a + "kv_a_proj_with_mqa.weight": (
                        kvr + hf["qk_rope_head_dim"], h),
                    a + "kv_a_layernorm.weight": (kvr,),
                    a + "kv_b_proj.weight": (
                        nh * (hf["qk_nope_head_dim"] + hf["v_head_dim"]),
                        kvr),
                    a + "o_proj.weight": (h, nh * hf["v_head_dim"])})
        if qr is None:
            out[a + "q_proj.weight"] = (nh * qk, h)
        else:
            out.update({a + "q_a_proj.weight": (qr, h),
                        a + "q_a_layernorm.weight": (qr,),
                        a + "q_b_proj.weight": (nh * qk, qr)})
        if i < hf["first_k_dense_replace"]:
            for n, s in (("gate_proj", (ffn, h)), ("up_proj", (ffn, h)),
                         ("down_proj", (h, ffn))):
                out[p + f"mlp.{n}.weight"] = s
            continue
        e = hf["n_routed_experts"]
        out[p + "mlp.gate.weight"] = (e, h)
        if hf["model_type"] == "deepseek_v3":
            out[p + "mlp.gate.e_score_correction_bias"] = (e,)
        si = mi * hf["n_shared_experts"]
        for j in range(e):
            q = p + f"mlp.experts.{j}."
            out.update({q + "gate_proj.weight": (mi, h),
                        q + "up_proj.weight": (mi, h),
                        q + "down_proj.weight": (h, mi)})
        out.update({p + "mlp.shared_experts.gate_proj.weight": (si, h),
                    p + "mlp.shared_experts.up_proj.weight": (si, h),
                    p + "mlp.shared_experts.down_proj.weight": (h, si)})
    return out


def deepseek_v2_lite_config(**over) -> ModelConfig:
    """DeepSeek-V2-Lite's published widths (hidden 2048, 27 layers, 16
    heads, K 192 and V 128, latent 512, 64 experts of 1408, top 6, two
    shared experts, one dense layer of 10944, vocab 102400), through the
    families lookup; ``over`` replaces fields of the result
    (``num_layers`` to cut depth)."""
    cfg = config_from_hf(DEEPSEEK_V2_LITE_HF)
    return replace(cfg, **over) if over else cfg


def deepseek_v3_config(**over) -> ModelConfig:
    """DeepSeek-V3's published widths (hidden 7168, 128 heads, K 192 and V
    128, q latent 1536, kv latent 512, 256 experts of 2048, top 8 of 4 of
    8 groups, one shared expert, dense layers of 18432, vocab 129280),
    through the families lookup, cut to its 3 dense prefix layers and 1
    MoE layer (the 61 layers do not fit one card; these 4 are about 10 GB
    at sym_int4); ``over`` replaces fields of the result."""
    cfg = replace(config_from_hf(DEEPSEEK_V3_HF), num_layers=4)
    return replace(cfg, **over) if over else cfg


# huggingface.co/openbmb/MiniCPM-2B-sft-bf16, config.json (the fields the
# decoder reads: llama's block, 36 heads of 64 over 36 kv heads, a tied
# head, and the muP scalings: embeddings times scale_emb 12, each residual
# branch times scale_depth 1.4 / sqrt(40), the logits times
# dim_model_base 256 / 2304).  Quoted from memory, nothing may be
# downloaded here: the widths, scalings and vocabulary are the model
# card's; max_position_embeddings, rope_theta, rms_norm_eps and the token
# ids are the llama defaults the MiniCPM code assumes, not checked
# against the published file.
MINICPM_2B_HF = {
    "model_type": "minicpm", "vocab_size": 122753, "hidden_size": 2304,
    "intermediate_size": 5760, "num_hidden_layers": 40,
    "num_attention_heads": 36, "num_key_value_heads": 36,
    "max_position_embeddings": 4096, "rope_theta": 10000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-5, "hidden_act": "silu",
    "tie_word_embeddings": True, "scale_emb": 12, "scale_depth": 1.4,
    "dim_model_base": 256, "bos_token_id": 1, "eos_token_id": 2,
}


def minicpm3_longrope(seed: int = 0, n: int = 16) -> dict:
    """MiniCPM3-4B's ``rope_scaling`` of kind longrope over its 32-wide
    rope slice (16 frequencies): the published short and long factor
    lists are not in this repository, so they are drawn from ``seed``
    (short in [1, 1.3), long in [1, 40), sorted rising as the published
    ones are)."""
    rng = torch.Generator().manual_seed(seed)
    short = 1.0 + 0.3 * torch.rand(n, generator=rng, dtype=torch.float64)
    long = 1.0 + 39.0 * torch.rand(n, generator=rng, dtype=torch.float64)
    return {"type": "longrope", "original_max_position_embeddings": 32768,
            "short_factor": sorted(float(v) for v in short),
            "long_factor": sorted(float(v) for v in long)}


# huggingface.co/openbmb/MiniCPM3-4B, config.json (the fields the decoder
# reads: DeepSeek's MLA on a dense model, 40 heads, a q latent of 768 and
# a kv latent of 256, K 64 nope + 32 rope columns, longrope over the rope
# slice, and minicpm's muP scalings).  Quoted from memory (nothing may be
# downloaded here); rms_norm_eps, tie_word_embeddings and the token ids
# are not checked against the published file, and the longrope factors
# are drawn from a seed (:func:`minicpm3_longrope`).  ``v_head_dim`` 64 is
# stated here although, as far as known, the published file names none:
# MiniCPM3's modeling code takes V at hidden_size / num_attention_heads =
# 64, while the reference's ``_deepseek_common`` (and so the port) reads a
# missing ``v_head_dim`` as K's width, 96 (ROADMAP queue 3).
MINICPM3_4B_HF = {
    "model_type": "minicpm3", "vocab_size": 73448, "hidden_size": 2560,
    "intermediate_size": 6400, "num_hidden_layers": 62,
    "num_attention_heads": 40, "num_key_value_heads": 40,
    "q_lora_rank": 768, "kv_lora_rank": 256, "qk_nope_head_dim": 64,
    "qk_rope_head_dim": 32, "v_head_dim": 64,
    "max_position_embeddings": 32768, "rope_theta": 10000.0,
    "rope_scaling": minicpm3_longrope(),
    "rms_norm_eps": 1e-5, "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "scale_emb": 12, "scale_depth": 1.4,
    "dim_model_base": 256, "bos_token_id": 1, "eos_token_id": 2,
}


def minicpm_2b_config(**over) -> ModelConfig:
    """MiniCPM-2B's published widths (hidden 2304, 40 layers, 36 heads of
    64, ffn 5760, vocab 122753 tied, the muP scalings), through the
    families lookup; ``over`` replaces fields of the result."""
    return _published(MINICPM_2B_HF, over)


def minicpm3_4b_config(**over) -> ModelConfig:
    """MiniCPM3-4B's published widths (hidden 2560, 62 layers, 40 heads,
    MLA with K 96 and V 64, q latent 768, kv latent 256, ffn 6400, vocab
    73448, longrope, the muP scalings), through the families lookup;
    ``over`` replaces fields of the result (``num_layers`` to cut
    depth)."""
    return _published(MINICPM3_4B_HF, over)


# The GLM and llama-layout families' published widths.  Each is quoted
# from memory from the model's config.json on huggingface.co (nothing may
# be downloaded here); the widths, head counts, vocabularies and the flags
# named in each comment are the model cards'; the fields marked unchecked
# are not checked against the published file.

# THUDM/glm-4-9b-chat, in the chatglm layout (40 layers, hidden 4096,
# ffn 13696, 32 heads of kv_channels 128 over multi_query_group_num 2, a
# GQA group of 16, padded vocabulary 151552, seq_length 131072, rope_ratio
# 500, add_qkv_bias true, add_bias_linear false).  Unchecked:
# layernorm_epsilon, pad_token_id and the eos list.
GLM4_9B_CHAT_HF = {
    "model_type": "chatglm", "padded_vocab_size": 151552,
    "hidden_size": 4096, "ffn_hidden_size": 13696, "num_layers": 40,
    "num_attention_heads": 32, "kv_channels": 128,
    "multi_query_attention": True, "multi_query_group_num": 2,
    "seq_length": 131072, "rope_ratio": 500, "rmsnorm": True,
    "post_layer_norm": True, "add_qkv_bias": True,
    "add_bias_linear": False, "layernorm_epsilon": 1.5625e-07,
    "tie_word_embeddings": False, "pad_token_id": 151329,
    "eos_token_id": [151329, 151336, 151338],
}
# THUDM/GLM-4-9B-0414, model_type glm4 (glm-4-9b-chat's widths: 2 kv
# heads, head_dim 128, partial_rotary_factor 0.5, attention_bias true; the
# post norms of each block).  Unchecked: max_position_embeddings,
# rope_theta, rms_norm_eps and the token ids.
GLM4_9B_0414_HF = {
    "model_type": "glm4", "vocab_size": 151552, "hidden_size": 4096,
    "intermediate_size": 13696, "num_hidden_layers": 40,
    "num_attention_heads": 32, "num_key_value_heads": 2, "head_dim": 128,
    "partial_rotary_factor": 0.5, "attention_bias": True,
    "max_position_embeddings": 32768, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "hidden_act": "silu",
    "tie_word_embeddings": False, "pad_token_id": 151329,
    "eos_token_id": [151329, 151336, 151338],
}
# THUDM/chatglm3-6b (28 layers, padded vocabulary 65024, otherwise
# glm-4-9b-chat's widths; seq_length 8192, no rope_ratio).  Unchecked:
# layernorm_epsilon and the token ids.
CHATGLM3_6B_HF = {
    **{k: v for k, v in GLM4_9B_CHAT_HF.items() if k != "rope_ratio"},
    "padded_vocab_size": 65024, "num_layers": 28, "seq_length": 8192,
    "layernorm_epsilon": 1e-5, "pad_token_id": 0, "eos_token_id": 2,
}
# internlm/internlm2-chat-7b (32 layers, hidden 4096, 32 heads over 8 kv
# heads, ffn 14336, vocabulary 92544, bias false, the wqkv layout).
# Unchecked: max_position_embeddings, rope_theta, the dynamic rope
# scaling's factor, rms_norm_eps and the token ids.
INTERNLM2_7B_HF = {
    "model_type": "internlm2", "vocab_size": 92544, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0,
    "rope_scaling": {"type": "dynamic", "factor": 2.0},
    "rms_norm_eps": 1e-5, "hidden_act": "silu", "bias": False,
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
}
# Qwen/Qwen-7B-Chat (32 layers, hidden 4096, 32 heads of kv_channels 128,
# intermediate_size 22016 counting both MLP branches, vocabulary 151936,
# no_bias true; c_attn holds a bias all the same).  Unchecked:
# layer_norm_epsilon, seq_length and rotary_emb_base.  use_dynamic_ntk and
# use_logn_attn are read by neither package (ROADMAP queue 3).
QWEN_7B_HF = {
    "model_type": "qwen", "vocab_size": 151936, "hidden_size": 4096,
    "intermediate_size": 22016, "num_hidden_layers": 32,
    "num_attention_heads": 32, "kv_channels": 128,
    "layer_norm_epsilon": 1e-6, "seq_length": 8192,
    "rotary_emb_base": 10000.0, "no_bias": True, "use_dynamic_ntk": True,
    "use_logn_attn": True, "tie_word_embeddings": False,
}
# baichuan-inc/Baichuan2-7B-Chat (32 layers, hidden 4096, 32 heads, ffn
# 11008, vocabulary 125696, W_pack; its NormHead is applied by neither
# package: ROADMAP queue 3).  Unchecked: max_position_embeddings,
# rms_norm_eps and the token ids.
BAICHUAN2_7B_HF = {
    "model_type": "baichuan", "vocab_size": 125696, "hidden_size": 4096,
    "intermediate_size": 11008, "num_hidden_layers": 32,
    "num_attention_heads": 32, "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-6, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "pad_token_id": 0,
}


def glm4_9b_chat_config(**over) -> ModelConfig:
    """glm-4-9b-chat's published widths (hidden 4096, 40 layers, 32 heads
    of 128 over 2 kv heads, ffn 13696, vocab 151552, the "two" rope on 64
    columns at base 5e6), through the families lookup; ``over`` replaces
    fields of the result."""
    return _published(GLM4_9B_CHAT_HF, over)


def glm4_9b_0414_config(**over) -> ModelConfig:
    """GLM-4-9B-0414's published widths (glm-4-9b-chat's, and the post
    norms)."""
    return _published(GLM4_9B_0414_HF, over)


def chatglm3_6b_config(**over) -> ModelConfig:
    """chatglm3-6b's published widths (glm-4-9b-chat's at 28 layers and
    vocab 65024, rope base 10000)."""
    return _published(CHATGLM3_6B_HF, over)


def internlm2_7b_config(**over) -> ModelConfig:
    """internlm2-chat-7b's published widths (hidden 4096, 32 layers, 32
    heads over 8, ffn 14336, vocab 92544)."""
    return _published(INTERNLM2_7B_HF, over)


def qwen_7b_config(**over) -> ModelConfig:
    """Qwen-7B-Chat's published widths (hidden 4096, 32 layers, 32 heads
    of 128, ffn 11008 a branch, vocab 151936)."""
    return _published(QWEN_7B_HF, over)


def baichuan2_7b_config(**over) -> ModelConfig:
    """Baichuan2-7B-Chat's published widths (hidden 4096, 32 layers, 32
    heads, ffn 11008, vocab 125696)."""
    return _published(BAICHUAN2_7B_HF, over)


# The five families of the falcon slice, quoted from memory as the GLM
# rows above are (nothing may be downloaded); each dict holds the fields
# the decoder reads, and the comment names those not checked against the
# published file.

# tiiuae/falcon-7b (the old architecture: 71 query heads of 64 over one kv
# head, multi_query, parallel_attn, no biases, no ALiBi, one LayerNorm a
# block).  The file sets no max_position_embeddings: 2048 is
# transformers' FalconConfig default, which a saved config writes out.
# Unchecked: the token ids.
FALCON_7B_HF = {
    "model_type": "falcon", "vocab_size": 65024, "hidden_size": 4544,
    "num_hidden_layers": 32, "num_attention_heads": 71,
    "multi_query": True, "new_decoder_architecture": False,
    "parallel_attn": True, "bias": False, "alibi": False,
    "layer_norm_epsilon": 1e-5, "max_position_embeddings": 2048,
    "rope_theta": 10000.0, "bos_token_id": 11, "eos_token_id": 11,
}
# tiiuae/falcon-40b (the new architecture: 128 query heads of 64 over 8 kv
# heads, ln_attn and ln_mlp, the per-group fused qkv).  Unchecked: the
# token ids; max_position_embeddings as Falcon-7B's.
FALCON_40B_HF = {
    **FALCON_7B_HF, "hidden_size": 8192, "num_hidden_layers": 60,
    "num_attention_heads": 128, "num_kv_heads": 8, "multi_query": True,
    "new_decoder_architecture": True,
}
# bigcode/starcoder2-7b (36 query heads of 128 over 4 kv heads, ffn 18432,
# a 4096 window on every layer, rope theta 1e6, biases everywhere, the
# tanh GELU).  Unchecked: max_position_embeddings, norm_epsilon, the token
# ids, and tie_word_embeddings (left to the family's default: tied).
STARCODER2_7B_HF = {
    "model_type": "starcoder2", "vocab_size": 49152, "hidden_size": 4608,
    "intermediate_size": 18432, "num_hidden_layers": 32,
    "num_attention_heads": 36, "num_key_value_heads": 4,
    "max_position_embeddings": 16384, "sliding_window": 4096,
    "rope_theta": 1000000.0, "norm_epsilon": 1e-5, "use_bias": True,
    "hidden_act": "gelu_pytorch_tanh", "bos_token_id": 0, "eos_token_id": 0,
}
# stabilityai/stablelm-2-1_6b (32 heads of 64, a quarter of whose columns
# rotate, a qkv bias, LayerNorms).  Unchecked: max_position_embeddings,
# rope_theta, layer_norm_eps, tie_word_embeddings and the token ids.
STABLELM2_1_6B_HF = {
    "model_type": "stablelm", "vocab_size": 100352, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 24,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "partial_rotary_factor": 0.25, "use_qkv_bias": True,
    "qk_layernorm": False, "use_parallel_residual": False,
    "max_position_embeddings": 4096, "rope_theta": 10000.0,
    "layer_norm_eps": 1e-5, "hidden_act": "silu",
    "tie_word_embeddings": False, "bos_token_id": 100257,
    "eos_token_id": 100257,
}
# CohereForAI/c4ai-command-r-v01 (64 heads of 128, ffn 22528, logit_scale
# 0.0625, rope theta 8e6, a tied 256000-row head).  Unchecked:
# max_position_embeddings, layer_norm_eps and the token ids.
COMMAND_R_V01_HF = {
    "model_type": "cohere", "vocab_size": 256000, "hidden_size": 8192,
    "intermediate_size": 22528, "num_hidden_layers": 40,
    "num_attention_heads": 64, "num_key_value_heads": 64,
    "logit_scale": 0.0625, "rope_theta": 8000000.0,
    "max_position_embeddings": 8192, "layer_norm_eps": 1e-5,
    "hidden_act": "silu", "use_qk_norm": False, "bos_token_id": 5,
    "eos_token_id": 255001, "pad_token_id": 0,
}
# allenai/OLMo-2-1124-7B (32 heads of 128, ffn 11008, rope theta 5e5, RMS
# eps 1e-6, the norms after each branch, flat q/k norms).  Unchecked:
# max_position_embeddings, tie_word_embeddings and the token ids.
OLMO2_7B_HF = {
    "model_type": "olmo2", "vocab_size": 100352, "hidden_size": 4096,
    "intermediate_size": 11008, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 4096, "hidden_act": "silu",
    "tie_word_embeddings": False, "pad_token_id": 100277,
    "eos_token_id": 100257,
}


def falcon_7b_config(**over) -> ModelConfig:
    """Falcon-7B's published widths (hidden 4544, 32 layers, 71 query
    heads of 64 over one kv head, ffn 4 x 4544, vocab 65024, 2048
    positions), through the families lookup; ``over`` replaces fields of
    the result."""
    return _published(FALCON_7B_HF, over)


def falcon_40b_config(**over) -> ModelConfig:
    """Falcon-40B's published widths (hidden 8192, 60 layers, 128 query
    heads of 64 over 8 kv heads, ffn 32768, vocab 65024)."""
    return _published(FALCON_40B_HF, over)


def starcoder2_7b_config(**over) -> ModelConfig:
    """StarCoder2-7B's published widths (hidden 4608, ffn 18432, 32
    layers, 36 heads of 128 over 4, vocab 49152, window 4096)."""
    return _published(STARCODER2_7B_HF, over)


def stablelm2_1_6b_config(**over) -> ModelConfig:
    """StableLM-2-1.6B's published widths (hidden 2048, ffn 5632, 24
    layers, 32 heads of 64, 16 columns rotated, vocab 100352)."""
    return _published(STABLELM2_1_6B_HF, over)


def command_r_v01_config(**over) -> ModelConfig:
    """Command-R-v01's published widths (hidden 8192, ffn 22528, 40 layers,
    64 heads of 128, vocab 256000 tied, logit scale 0.0625)."""
    return _published(COMMAND_R_V01_HF, over)


def olmo2_7b_config(**over) -> ModelConfig:
    """OLMo-2-1124-7B's published widths (hidden 4096, ffn 11008, 32
    layers, 32 heads of 128, vocab 100352)."""
    return _published(OLMO2_7B_HF, over)


def random_params(cfg: ModelConfig, qtype: str = "sym_int4", seed: int = 0,
                  device=None, shared_intermediate: int | None = None,
                  router_scale: float = 1.0) -> dict:
    """Full-width random params on ``device`` (``None`` = cuda), the
    linear weights in ``qtype`` (one of the ten block formats, or
    ``bf16``).  A config with ``num_shared_experts`` gets a shared expert
    ``shared_intermediate`` wide (default ``cfg.intermediate_size``, or
    DeepSeek's ``moe_intermediate_size * num_shared_experts``) and, where
    the config gates it, its gate; ``router_scale`` multiplies the router
    weights (wider router margins for the card-against-CPU checks).  An
    MLA config gets MLA's leaves in place of ``qkv``, a score-bias config
    an fp32 ``router_bias`` ``0.05 N(0, 1)``, a dense prefix its
    ``layers_dense`` stack, and the GPT-style block its biases (module
    doc)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, ffn, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def weight(n_in, n_out):
        return normal((n_in, n_out)) * (1.2 / math.sqrt(n_in))

    def norm_w(shape):
        return 1.0 - cfg.norm_offset + 0.05 * normal(shape)

    if cfg.is_mla:
        nh, hd = cfg.num_heads, cfg.head_dim
        attn = ({"q": (h, nh * hd)} if cfg.q_lora_rank is None else
                {"q_a": (h, cfg.q_lora_rank), "q_b": (cfg.q_lora_rank,
                                                      nh * hd)})
        attn.update(kv_a=(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                    kv_b=(cfg.kv_lora_rank,
                          nh * (cfg.qk_nope_head_dim + cfg.v_dim)))
        qkv_out = 0
    else:
        qkv_out = cfg.q_dim + 2 * cfg.kv_dim
        attn = {"qkv": (h, qkv_out)}
    attn["o"] = (cfg.num_heads * cfg.v_dim, h)
    gated = 2 if cfg.mlp_gated else 1     # gate_up's width, in ffn's
    norm_bias = cfg.norm_kind == "layer" and \
        cfg.model_type not in NORM_BIAS_FREE_FAMILIES

    def stack(n_l: int, moe: bool) -> dict:
        shapes = dict(attn)
        biases = {"o_bias": h} if cfg.attention_out_bias else {}
        if moe:
            mi, n_e = cfg.moe_intermediate_size, cfg.num_experts
            experts = {"moe_gate_up": (h, gated * mi), "moe_down": (mi, h)}
            if cfg.num_shared_experts:
                si = shared_intermediate or (
                    mi * cfg.num_shared_experts
                    if cfg.model_type.startswith("deepseek") else ffn)
                shapes.update(shared_gate_up=(h, 2 * si),
                              shared_down=(si, h))
        elif cfg.mlp_gated:
            n_e, experts = 0, {}
            shapes.update(gate_up=(h, 2 * ffn), down=(ffn, h))
        else:
            n_e, experts = 0, {}
            shapes.update(up=(h, ffn), down=(ffn, h))
            if cfg.mlp_bias or cfg.attention_out_bias:   # not Falcon's
                biases.update(up_bias=ffn, down_bias=h)
        stacks = LayerStack(n_l, n_e)
        for i in range(n_l):
            for name, (n_in, n_out) in shapes.items():
                stacks.put(i, name, quantize(weight(n_in, n_out), qtype))
            for name, (n_in, n_out) in experts.items():
                for e in range(n_e):
                    stacks.put(i, name, quantize(weight(n_in, n_out), qtype),
                               expert=e)
        norms = ["attn_norm", "mlp_norm"] + [
            n for n in ("post_attn_norm", "post_mlp_norm") if getattr(cfg, n)]
        layers = {n: norm_w((n_l, h)) for n in norms}
        if norm_bias:
            for n in ("attn_norm", "mlp_norm"):
                layers[n + "_bias"] = 0.05 * normal((n_l, h))
        for n, width in biases.items():
            layers[n] = 0.1 * normal((n_l, width))
        if cfg.qk_norm:
            flat = cfg.model_type in FLAT_QK_NORM_FAMILIES
            layers["q_norm"] = norm_w((n_l, cfg.q_dim if flat
                                       else cfg.head_dim))
            layers["k_norm"] = norm_w((n_l, cfg.kv_dim if flat
                                       else cfg.head_dim))
        if cfg.is_mla:
            if cfg.q_lora_rank is not None:
                layers["q_a_norm"] = norm_w((n_l, cfg.q_lora_rank))
            layers["kv_a_norm"] = norm_w((n_l, cfg.kv_lora_rank))
        if cfg.attention_bias or cfg.model_type in QKV_BIAS_FAMILIES:
            layers["qkv_bias"] = 0.1 * normal((n_l, qkv_out))
        if moe:
            layers["router"] = weight(h, n_l * n_e).reshape(
                h, n_l, n_e).permute(1, 0, 2).contiguous() * router_scale
            if cfg.moe_shared_expert_gate:
                layers["shared_router"] = weight(h, n_l).t().reshape(
                    n_l, h, 1).contiguous()
            if cfg.moe_score_bias:
                layers["router_bias"] = 0.05 * normal((n_l, n_e))
            if not cfg.mlp_gated:
                layers["moe_up_bias"] = 0.1 * normal((n_l, n_e, mi))
                layers["moe_down_bias"] = 0.1 * normal((n_l, n_e, h))
        layers.update(stacks.tree)
        return layers

    n_dense = dense_prefix(cfg)
    params = {}
    if n_dense:
        params["layers_dense"] = stack(n_dense, False)
    params["layers"] = stack(cfg.num_layers - n_dense,
                             cfg.layer_is_moe(n_dense))
    params.update({
        "embed": (normal((v, h)) * (1.2 / math.sqrt(h))).to(torch.bfloat16),
        "final_norm": norm_w((h,)),
        **rope_buffers(cfg, dev),
    })
    if norm_bias:
        params["final_norm_bias"] = 0.05 * normal((h,))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = quantize(weight(h, v), qtype)
        if cfg.model_type in HEAD_BIAS_FAMILIES:
            params["lm_head_bias"] = 0.1 * normal((v,))
    return params
