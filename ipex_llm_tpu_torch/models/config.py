"""Decoder configuration (port of ``ipex_llm_tpu/models/config.py``).

The port keeps the reference's field names for the llama and mistral
families, so a reference config maps across field by field
(:meth:`ModelConfig.from_fields`).  Every architectural switch the port does
not cover is checked in ``__post_init__`` and raises
``NotImplementedError``: other families, a sliding window outside mistral,
per-layer window patterns, softcaps, biases, MLA and MoE are not routed to
a plain path.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ipex_llm_tpu_torch.ops.rope import RopeScaling


@dataclass(frozen=True)
class ModelConfig:
    """A llama-family decoder: pre-RMSNorm blocks, merged qkv and gate_up
    projections, SwiGLU MLP, rotary positions in the "half" layout; mistral
    adds a sliding window on every layer."""

    model_type: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 4096
    act: str = "silu"
    norm_eps: float = 1e-5
    rope: RopeScaling | None = None
    rope_layout: str = "half"
    tie_word_embeddings: bool = False
    sliding_window: int | None = None

    def __post_init__(self):
        if self.model_type not in ("llama", "mistral"):
            raise NotImplementedError(
                f"model_type {self.model_type!r} is not ported (llama, "
                "mistral)")
        if self.sliding_window is not None:
            if self.model_type != "mistral":
                raise NotImplementedError(
                    f"a sliding window on {self.model_type!r} is not ported")
            if int(self.sliding_window) <= 0:
                raise ValueError("sliding_window must be positive")
        if self.act != "silu" or self.rope_layout != "half":
            raise NotImplementedError(
                f"act={self.act!r} rope_layout={self.rope_layout!r} is not "
                "ported (silu, half)")
        if self.rope is None or self.rope.rotary_dim != self.head_dim:
            raise NotImplementedError(
                "rope over the whole head_dim is the only form ported")
        if self.tie_word_embeddings:
            raise NotImplementedError("tied embeddings are not ported")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """Every layer of a windowed model slides (per-layer patterns,
        ``layer_types``, are not ported)."""
        return self.sliding_window is not None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # Reference fields whose default value is the only one the port
    # serves; any other value raises in from_fields.
    _DEFAULTS = {
        "norm_kind": "rms", "norm_offset": 0.0, "qk_norm": False,
        "post_attn_norm": False, "post_mlp_norm": False, "rope_local": None,
        "partial_rotary": 1.0, "mrope_section": None,
        "attention_bias": False, "attention_out_bias": False,
        "mlp_bias": False, "mlp_gated": True, "parallel_blocks": False,
        "alibi": False, "learned_pos": 0, "embed_norm": False,
        "norm_after": False, "logit_scale": 1.0, "glm_alpha": 0.0,
        "rope_2d": False, "layer_types": None,
        "attn_softcap": None, "logit_softcap": None, "attn_scale": None,
        "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
        "kv_heads_per_layer": None, "num_experts": 0,
        "num_experts_per_tok": 0, "moe_intermediate_size": 0,
        "num_shared_experts": 0, "q_lora_rank": None, "kv_lora_rank": None,
        "qk_nope_head_dim": 0, "qk_rope_head_dim": 0, "v_head_dim": None,
    }

    @classmethod
    def from_fields(cls, values: dict) -> "ModelConfig":
        """Build from the reference config's fields (a plain dict such as
        ``dataclasses.asdict`` gives, with ``rope`` as a dict of
        ``RopeScaling`` fields).  Raises on any field whose value selects
        a feature outside the port."""
        own = {f.name for f in fields(cls)}
        kw = {}
        for name, val in values.items():
            if name in own:
                kw[name] = val
            elif name in cls._DEFAULTS:
                want = cls._DEFAULTS[name]
                if val != want and not (val is None and want is None):
                    raise NotImplementedError(
                        f"config field {name}={val!r} is not ported")
            elif name.startswith("moe_"):
                continue   # MoE router knobs; num_experts == 0 gates them
            else:
                raise NotImplementedError(f"config field {name!r} unknown")
        rope = kw.get("rope")
        if isinstance(rope, dict):
            kw["rope"] = RopeScaling(**{k: rope[k] for k in (
                "head_dim", "base", "kind", "factor",
                "partial_rotary_factor") if k in rope})
        return cls(**kw)
