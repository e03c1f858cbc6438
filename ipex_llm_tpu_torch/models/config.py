"""Decoder configuration (port of ``ipex_llm_tpu/models/config.py``).

The port keeps the reference's field names for the families it serves
(llama, mistral, qwen2, gemma2, qwen3, mixtral, qwen2_moe, qwen3_moe,
phi3, gemma, gemma3_text, deepseek_v2, deepseek_v3, phi, phixtral under
both its names, gpt_neox, gptj, minicpm, minicpm3, glm, glm4, chatglm,
aquila, internlm, internlm2, baichuan, qwen, starcoder2, stablelm, cohere,
olmo2, falcon), so a reference config maps across field by field
(:meth:`ModelConfig.from_fields`):
every rope scaling kind of ``ops.rope.RopeScaling`` and partial rotary
(``rope.rotary_dim`` below ``head_dim``), the "half" and interleaved
"two" rope layouts, gemma3's second rope table for its sliding layers
(``rope_local``), sliding windows (on every layer, or per layer through
``layer_types``), attention and final-logit softcaps, an attention scale,
the qkv bias, (1 + w) norms, the post-block norms, an embedding
multiplier, tied embeddings, the tanh and the exact (erf) GELU, per-head
q/k norms, the sparse mixture of experts of mixtral, the qwen MoE
families and DeepSeek (top-k routing, softmax before or after the top-k,
sigmoid scores, a selection-only score bias, group-limited selection, the
optional renormalisation and routed scaling factor, shared experts with
or without a sigmoid gate, dense prefix layers), and DeepSeek's
multi-head latent attention (MLA: a low-rank or full-rank q, the
compressed kv latent, K ``qk_nope + qk_rope`` wide and V ``v_head_dim``
wide), and the GPT-style block of phi, phixtral, gpt_neox and gptj:
LayerNorm with a bias (``norm_kind="layer"``), a bias on o
(``attention_out_bias``) and on the MLP (``mlp_bias``; the loader reads
every bias a checkpoint holds, as the reference's does), the ungated
``fc1 -> act -> fc2`` MLP (``mlp_gated=False``) and the parallel
residual (``parallel_blocks``), and minicpm's muP scalings (an
embedding multiplier, ``residual_multiplier`` on every residual branch,
``logit_scale`` on the logits), over llama's block (minicpm) or MLA on a
dense model (minicpm3), and olmo2's reordered norms (``norm_after``: each
block's norm on its output, none on its input) and flat q/k norms (over
the whole q and k projections, the leaves ``q_dim`` and ``kv_dim``
wide).
Every other architectural switch is checked in ``__post_init__`` or
``from_fields`` and raises ``NotImplementedError`` (ROADMAP item 14):
other families and other biases are not routed to a plain path.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from ipex_llm_tpu_torch.ops.mlp import ACT_FNS
from ipex_llm_tpu_torch.ops.rope import ROPE_LAYOUTS, RopeScaling

LAYER_TYPES = ("sliding_attention", "full_attention")
# the model_types this decoder serves (``families.FAMILIES`` maps each)
MODEL_TYPES = ("llama", "mistral", "qwen2", "gemma2", "qwen3", "mixtral",
               "qwen2_moe", "qwen3_moe", "phi3", "gemma", "gemma3_text",
               "deepseek_v2", "deepseek_v3", "phi", "phi-msft", "phixtral",
               "gpt_neox", "gptj", "minicpm", "minicpm3", "glm", "glm4",
               "chatglm", "aquila", "internlm", "internlm2", "baichuan",
               "qwen", "starcoder2", "stablelm", "cohere", "olmo2", "falcon")
NORM_KINDS = ("rms", "layer")
MOE_SCORE_FUNCS = ("softmax", "sigmoid")
MOE_GROUP_SCORES = ("max", "top2sum")


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
    ``rope_local``, the table its sliding layers rotate with.  deepseek_v2
    and deepseek_v3 replace q/k/v by MLA (``is_mla``: q, or q_a and q_b,
    kv_a and kv_b; one K head ``head_dim = qk_nope + qk_rope`` wide, whose
    rope slice is shared by every head, and V ``v_dim`` wide; the rope
    table spans the rope slice, in the "two" layout) and run a plain MLP
    on their first ``moe_layer_start`` layers.  phi, phixtral, gpt_neox
    and gptj run the GPT-style block: LayerNorms with a bias, biases on
    the projections, the ungated MLP and ``x + (attn + ffn)`` from the
    block's input (phi, phixtral and gptj name one LayerNorm for both
    branches, gpt_neox two).  minicpm is llama's block with muP scalings
    (embeddings, each residual branch and the logits multiplied), and
    minicpm3 the same scalings over MLA with a dense MLP on every
    layer.  glm, glm4 and chatglm (chatglm2/3, glm-4-9b-chat) are llama's
    block with a qkv bias and the "two" rope on half of each head (glm4
    adds the post norms, plain RMSNorms); aquila, internlm (a bias on q,
    k, v and o), internlm2, baichuan (7B) and qwen (v1) are llama's block
    under their own names and keys.  starcoder2 is the GPT-style block in
    sequence (two LayerNorms, biases, the ungated tanh-GELU MLP) with a
    window on every layer and a tied head; stablelm llama's gated block
    under LayerNorms with a partial rotary; cohere the parallel residual
    over a gated MLP off one bias-free LayerNorm, the "two" rope, a logit
    scale and a tied head; falcon (without ALiBi) the parallel GPT-style
    block off one LayerNorm (two in the new architecture) with a fused
    qkv, often over one kv head; olmo2 llama's block with its norms moved
    after each branch and flat q/k norms."""

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
    norm_kind: str = "rms"          # rms | layer (LayerNorm with a bias)
    rope: RopeScaling | None = None
    rope_local: RopeScaling | None = None  # gemma3: the sliding layers' table
    # the reference's field, which its decoder does not read either (the
    # rotary width is rope.partial_rotary_factor's)
    partial_rotary: float = 1.0
    rope_layout: str = "half"       # half | two (interleaved pairs)
    tie_word_embeddings: bool = False
    sliding_window: int | None = None
    layer_types: tuple[str, ...] | None = None   # per layer, LAYER_TYPES
    attention_bias: bool = False    # on q, k and v (not on o)
    # the reference's flags of the biases on o and on the MLP; the loader
    # reads every bias the checkpoint holds whatever they say
    attention_out_bias: bool = False
    mlp_bias: bool = False
    mlp_gated: bool = True          # False: fc1 -> act -> fc2
    parallel_blocks: bool = False   # x + (attn(ln(x)) + ffn(ln'(x)))
    norm_offset: float = 0.0        # 1.0: gemma's (1 + w) RMSNorm
    post_attn_norm: bool = False    # gemma2's norms of the block outputs
    post_mlp_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    attn_scale: float | None = None  # None: head_dim ** -0.5
    embedding_multiplier: float = 1.0
    # minicpm's muP scalings: each residual branch's output times
    # residual_multiplier (rounded to bf16) before its add, the fp32
    # logits times logit_scale before the softcap
    residual_multiplier: float = 1.0
    logit_scale: float = 1.0
    # q/k RMSNorm before rope: per head (qwen3, gemma3), or flat over the
    # whole projection where the leaves are q_dim and kv_dim wide (olmo2)
    qk_norm: bool = False
    # olmo2: x + norm(branch(x)), the block's norms on its outputs and none
    # on its input
    norm_after: bool = False
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
    # DeepSeek: the first moe_layer_start layers are dense; the routed
    # weights are multiplied by moe_router_scale; group-limited selection
    # keeps the experts of the moe_topk_group best of moe_n_group groups
    # (group score: its max, V2, or the sum of its top two, V3); sigmoid
    # scores (V3) and a score bias added for the selection only
    moe_layer_start: int = 0
    moe_router_scale: float = 1.0
    moe_n_group: int = 0
    moe_topk_group: int = 0
    moe_score_func: str = "softmax"   # softmax | sigmoid
    moe_group_score: str = "max"      # max | top2sum
    moe_score_bias: bool = False
    # MLA (DeepSeek multi-head latent attention): head_dim is the full qk
    # width (nope + rope); the cache holds K at head_dim and V at v_dim
    q_lora_rank: int | None = None
    kv_lora_rank: int | None = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int | None = None     # None: head_dim

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
        if self.norm_kind not in NORM_KINDS:
            raise NotImplementedError(
                f"norm_kind={self.norm_kind!r} is not ported")
        if self.act not in ACT_FNS or self.rope_layout not in ROPE_LAYOUTS:
            raise NotImplementedError(
                f"act={self.act!r} rope_layout={self.rope_layout!r} is not "
                f"ported ({', '.join(ACT_FNS)}; {', '.join(ROPE_LAYOUTS)})")
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
            if self.moe_score_func not in MOE_SCORE_FUNCS or \
                    self.moe_group_score not in MOE_GROUP_SCORES:
                raise NotImplementedError(
                    f"moe_score_func={self.moe_score_func!r} moe_group_score="
                    f"{self.moe_group_score!r} is not ported")
            if self.moe_n_group > 1 and (
                    self.num_experts % self.moe_n_group
                    or not 1 <= self.moe_topk_group <= self.moe_n_group):
                raise ValueError(
                    "group-limited routing needs moe_n_group to divide "
                    "num_experts and 1 <= moe_topk_group <= moe_n_group")
        if self.is_mla:
            if self.head_dim != self.qk_nope_head_dim + self.qk_rope_head_dim \
                    or self.num_kv_heads != self.num_heads \
                    or self.rope.rotary_dim != self.qk_rope_head_dim:
                raise ValueError(
                    "MLA needs head_dim = qk_nope + qk_rope, one kv head a "
                    "query head and a rope table over the rope slice")

    def layer_is_sliding(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` attends through the window: the
        ``layer_types`` entry where there is one, else every layer of a
        windowed model (the reference's rule)."""
        if self.layer_types is not None:
            return self.layer_types[layer_idx] == "sliding_attention"
        return self.sliding_window is not None

    def layer_is_moe(self, layer_idx: int) -> bool:
        """Whether layer ``layer_idx`` holds experts: every layer of an MoE
        config from ``moe_layer_start`` on (DeepSeek's dense prefix)."""
        return self.num_experts > 0 and layer_idx >= self.moe_layer_start

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def v_dim(self) -> int:
        """The V head's width: head_dim except under MLA."""
        return self.v_head_dim if self.v_head_dim is not None \
            else self.head_dim

    # Reference fields whose default value is the only one the port
    # serves; any other value raises in from_fields.
    _DEFAULTS = {
        "mrope_section": None, "alibi": False, "learned_pos": 0,
        "embed_norm": False,
        "glm_alpha": 0.0, "rope_2d": False, "kv_heads_per_layer": None,
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
