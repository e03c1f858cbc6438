"""Decoder configuration (port of ``ipex_llm_tpu/models/config.py``).

The port keeps the reference's field names for the families it serves
(llama, mistral, qwen2, gemma2, qwen3, mixtral, qwen2_moe, qwen3_moe,
phi3, gemma, gemma3_text), so a reference config maps across field by
field (:meth:`ModelConfig.from_fields`): every rope scaling kind of
``ops.rope.RopeScaling`` and partial rotary (``rope.rotary_dim`` below
``head_dim``), gemma3's second rope table for its sliding layers
(``rope_local``), sliding windows (on every layer, or per
layer through ``layer_types``), attention and final-logit softcaps, an
attention scale, the qkv bias, (1 + w) norms, the post-block norms, an
embedding multiplier, tied embeddings, the tanh and the exact (erf) GELU,
per-head q/k norms, and the sparse mixture of experts of mixtral and the
qwen MoE families (top-k routing, softmax before or after the top-k, the
optional renormalisation and router scale, a shared expert with a sigmoid
gate).
Every other architectural switch is checked in ``__post_init__`` or
``from_fields`` and raises ``NotImplementedError`` (ROADMAP item 14):
other families, other biases, MLA, DeepSeek's group-limited routing,
sigmoid scores, score bias and dense prefix layers are not routed to a
plain path.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ipex_llm_tpu_torch.ops.mlp import ACT_FNS
from ipex_llm_tpu_torch.ops.rope import RopeScaling

LAYER_TYPES = ("sliding_attention", "full_attention")
# the model_types this decoder serves (``families.FAMILIES`` maps each)
MODEL_TYPES = ("llama", "mistral", "qwen2", "gemma2", "qwen3", "mixtral",
               "qwen2_moe", "qwen3_moe", "phi3", "gemma", "gemma3_text")


@dataclass(frozen=True)
class ModelConfig:
    """A llama-style decoder: pre-RMSNorm blocks, merged qkv and gate_up
    projections, a gated MLP, rotary positions in the "half" layout.
    mistral adds a sliding window on every layer, qwen2 a qkv bias, gemma2
    (1 + w) norms, post-attention and post-MLP norms, a window on its even
    layers, softcaps, ``sqrt(hidden)`` embeddings and a tied head.  phi3
    loads pre-merged qkv and gate_up weights and may rotate only part of
    each head (``rope.partial_rotary_factor``); gemma is gemma2's block
    without the post norms, windows or softcaps; gemma3_text adds per-head
    q/k norms to gemma2's block, a window on five layers of six and
    ``rope_local``, the table its sliding layers rotate with."""

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
    rope_local: RopeScaling | None = None  # gemma3: the sliding layers' table
    # the reference's field, which its decoder does not read either (the
    # rotary width is rope.partial_rotary_factor's)
    partial_rotary: float = 1.0
    rope_layout: str = "half"
    tie_word_embeddings: bool = False
    sliding_window: int | None = None
    layer_types: tuple[str, ...] | None = None   # per layer, LAYER_TYPES
    attention_bias: bool = False    # on q, k and v (not on o)
    norm_offset: float = 0.0        # 1.0: gemma's (1 + w) RMSNorm
    post_attn_norm: bool = False    # gemma2's norms of the block outputs
    post_mlp_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    attn_scale: float | None = None  # None: head_dim ** -0.5
    embedding_multiplier: float = 1.0
    qk_norm: bool = False           # qwen3: per-head q/k RMSNorm before rope
    # sparse mixture of experts (0 experts: a dense MLP on every layer)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0     # qwen2_moe: one shared expert
    moe_norm_topk_prob: bool = False
    # True: softmax over all experts, then top-k (qwen MoE); False: top-k
    # of the logits, then a softmax over the k (mixtral)
    moe_softmax_before_topk: bool = True
    moe_shared_expert_gate: bool = False  # qwen2_moe's sigmoid gate

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise NotImplementedError(
                f"model_type {self.model_type!r} is not ported (ROADMAP "
                f"item 14; ported: {', '.join(MODEL_TYPES)})")
        if self.sliding_window is not None and int(self.sliding_window) <= 0:
            raise ValueError("sliding_window must be positive")
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_layers or any(
                    t not in LAYER_TYPES for t in self.layer_types):
                raise ValueError(
                    f"layer_types must name {LAYER_TYPES} for each of the "
                    f"{self.num_layers} layers")
            if self.sliding_window is None and \
                    "sliding_attention" in self.layer_types:
                raise ValueError("sliding layers need a sliding_window")
        if self.act not in ACT_FNS or self.rope_layout != "half":
            raise NotImplementedError(
                f"act={self.act!r} rope_layout={self.rope_layout!r} is not "
                f"ported ({', '.join(ACT_FNS)}; half)")
        if self.rope is None or not 0 < self.rope.rotary_dim <= self.head_dim:
            raise NotImplementedError(
                "a rope table over at most head_dim columns is the only "
                "position form ported")
        if self.rope_local is not None and \
                self.rope_local.rotary_dim != self.rope.rotary_dim:
            raise ValueError("rope_local must rotate as many columns as rope")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if self.num_experts:
            if not 1 <= self.num_experts_per_tok <= self.num_experts or \
                    self.moe_intermediate_size <= 0:
                raise ValueError(
                    "an MoE config needs 1 <= num_experts_per_tok <= "
                    "num_experts and a positive moe_intermediate_size")
            if self.num_shared_experts > 1:
                raise NotImplementedError(
                    "more than one shared expert is not ported (ROADMAP "
                    "item 14)")

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` attends through the window: the
        ``layer_types`` entry where there is one, else every layer of a
        windowed model (the reference's rule)."""
        if self.layer_types is not None:
            return self.layer_types[layer_idx] == "sliding_attention"
        return self.sliding_window is not None

    def layer_is_moe(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` holds experts: every layer of an MoE
        config (DeepSeek's dense prefix layers are not ported)."""
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # Reference fields whose default value is the only one the port
    # serves; any other value raises in from_fields.
    _DEFAULTS = {
        "norm_kind": "rms", "mrope_section": None,
        "attention_out_bias": False,
        "mlp_bias": False, "mlp_gated": True, "parallel_blocks": False,
        "alibi": False, "learned_pos": 0, "embed_norm": False,
        "norm_after": False, "logit_scale": 1.0, "glm_alpha": 0.0,
        "rope_2d": False, "residual_multiplier": 1.0,
        "kv_heads_per_layer": None, "q_lora_rank": None,
        "kv_lora_rank": None, "qk_nope_head_dim": 0, "qk_rope_head_dim": 0,
        "v_head_dim": None,
        # DeepSeek's routing, its routed scaling factor and its dense
        # prefix layers (ROADMAP item 14)
        "moe_layer_start": 0, "moe_n_group": 0, "moe_topk_group": 0,
        "moe_score_func": "softmax", "moe_group_score": "max",
        "moe_score_bias": False, "moe_router_scale": 1.0,
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
                        f"config field {name}={val!r} is not ported "
                        "(ROADMAP item 14)")
            else:
                raise NotImplementedError(f"config field {name!r} unknown")
        if kw.get("layer_types") is not None:
            kw["layer_types"] = tuple(kw["layer_types"])
        for key in ("rope", "rope_local"):
            rope = kw.get(key)
            if isinstance(rope, dict):
                kw[key] = RopeScaling(**{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in rope.items()})
        return cls(**kw)
