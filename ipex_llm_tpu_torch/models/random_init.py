"""Random llama-family weights made on the device (port of
``ipex_llm_tpu/models/random_init.py`` and the llama half of
``models/build.py``).

Weights come from a seeded ``torch.Generator`` on the target device and
are quantized one layer at a time with the port's own codec, so a
full-width model never sits in memory as fp32 at once.  The scale rules
are the reference's: norm weights ``1 + 0.05 * N(0, 1)``, every other
tensor ``N(0, 1) * 1.2 / sqrt(fan_in)``.  The tree has the layout
:func:`ipex_llm_tpu_torch.models.convert.params_from_reference` produces:
stacked ``[L, ...]`` layer leaves, merged qkv and gate_up, weights
``[in, out]``.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.models.build import LayerStack
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


def random_params(cfg: ModelConfig, qtype: str = "sym_int4", seed: int = 0,
                  device=None) -> dict:
    """Full-width random params on ``device`` (``None`` = cuda), the
    linear weights in ``qtype`` (one of the ten block formats, or
    ``bf16``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, ffn, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n_l = cfg.num_layers

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def weight(n_in, n_out):
        return normal((n_in, n_out)) * (1.2 / math.sqrt(n_in))

    def norm_w(shape):
        return 1.0 + 0.05 * normal(shape)

    shapes = {"qkv": (h, cfg.q_dim + 2 * cfg.kv_dim), "o": (cfg.q_dim, h),
              "gate_up": (h, 2 * ffn), "down": (ffn, h)}
    stacks = LayerStack(n_l)
    for i in range(n_l):
        for name, (n_in, n_out) in shapes.items():
            stacks.put(i, name, quantize(weight(n_in, n_out), qtype))
    layers = {"attn_norm": norm_w((n_l, h)), "mlp_norm": norm_w((n_l, h)),
              **stacks.tree}
    return {
        "layers": layers,
        "embed": (normal((v, h)) * (1.2 / math.sqrt(h))).to(torch.bfloat16),
        "final_norm": norm_w((h,)),
        "lm_head": quantize(weight(h, v), qtype),
        "inv_freq": torch.from_numpy(cfg.rope.inv_freq()).to(dev),
        "rope_mscale": 1.0,
    }
