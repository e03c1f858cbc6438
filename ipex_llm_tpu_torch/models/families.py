"""Model families: an HF ``config.json`` dict to a ``ModelConfig`` (port of
the llama and mistral rows of ``ipex_llm_tpu/models/families.py``).

Both families share the reference's llama weight names and the port's one
decoder; mistral adds its sliding window.  Every other ``model_type``
raises ``NotImplementedError``, as do rope scalings other than the default
(``ops.rope.RopeScaling`` refuses them).
"""

from __future__ import annotations

from typing import Callable

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.ops.rope import RopeScaling


def _rope_from_hf(hf: dict, head_dim: int) -> RopeScaling:
    rs = hf.get("rope_scaling") or {}
    return RopeScaling(
        head_dim=head_dim,
        base=hf.get("rope_theta", 10000.0),
        kind=rs.get("rope_type", rs.get("type", "default")),
        factor=rs.get("factor", 1.0),
        partial_rotary_factor=hf.get("partial_rotary_factor", 1.0),
    )


def _base_cfg(hf: dict, **over) -> dict:
    """The reference fields an HF config sets; ``ModelConfig.from_fields``
    refuses any whose value the port does not serve (biases)."""
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


FAMILIES: dict[str, Callable[[dict], ModelConfig]] = {
    "llama": _llama,
    "mistral": _mistral,
}


def config_from_hf(hf: dict) -> ModelConfig:
    """``ModelConfig`` for an HF ``config.json`` dict."""
    model_type = hf.get("model_type", "llama")
    if model_type not in FAMILIES:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported; available: "
            f"{sorted(FAMILIES)}")
    return FAMILIES[model_type](hf)
