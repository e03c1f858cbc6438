"""Build the decoder's parameter tree from a weight source, and the
helpers of the serving engine's weight axis (port of
``ipex_llm_tpu/models/build.py``).

``build_params`` constructs the tree of a ported family's scheme straight
from a name -> tensor source (a checkpoint reader, a torch
``state_dict``): q, k and v merge into ``qkv`` and gate and up into
``gate_up`` (rows concatenated, then transposed to ``[in, out]``; the
q, k and v biases concatenate likewise into an fp32 ``qkv_bias``,
wherever the checkpoint holds them, whatever the config's flag says, as
the reference loads them: Qwen v1's ``c_attn`` under ``no_bias``), or
load as stored where the checkpoint holds them merged (phi3's
``qkv_proj`` and ``gate_up_proj``, chatglm's ``query_key_value`` and
``dense_h_to_4h``, baichuan's ``W_pack``, qwen's ``c_attn``; internlm2's
``wqkv`` and its bias reordered by the family's ``qkv_transform`` before
the weight is quantized), each
weight is quantized on the target device as soon as it is read, and
layers stack into ``[L, ...]`` leaves preallocated once and filled layer
by layer.  gemma2's post norms become ``post_attn_norm`` and
``post_mlp_norm``, qwen3's per-head q/k norms ``q_norm`` and ``k_norm``,
and a tied head leaves no ``lm_head`` leaf (the decoder reads the
embedding table).  An MoE layer holds, in place of ``gate_up``/``down``,
the fp32 router ``[H, E]`` and the experts' ``moe_gate_up``/``moe_down``
stacks ``[L, E, ...]``, filled expert by expert, and qwen2_moe's
``shared_gate_up``/``shared_down`` and fp32 ``shared_router`` ``[H, 1]``
(DeepSeek-V3's fp32 ``router_bias`` ``[E]``).  A DeepSeek layer holds
MLA's ``q`` (or ``q_a``, fp32 ``q_a_norm`` and ``q_b``), ``kv_a``, fp32
``kv_a_norm`` and ``kv_b`` in place of ``qkv``, and a model with a dense
prefix builds its first ``moe_layer_start`` layers into a second stack,
``layers_dense`` (the reference's ``build.py:302-362`` and ``:470-475``).
The GPT-style families load every bias the reference loads, where the
checkpoint holds it, each in fp32: the LayerNorms' (``attn_norm_bias``,
``mlp_norm_bias``, ``final_norm_bias``), ``qkv_bias`` (reordered with
the weight by the family's ``qkv_transform``: Pythia's per-head
interleave), ``o_bias``, the ungated MLP's ``up``/``up_bias`` and
``down_bias``, the head's ``lm_head_bias`` and the ungated experts'
``moe_up_bias`` ``[L, E, I]`` and ``moe_down_bias`` ``[L, E, H]``
(the reference's ``build.py:281-283``, ``:366-373``, ``:403-414``,
``:437-467``, ``:499-501`` and ``:511-513``).  Any other bias raises.
A norm template may name alternatives, ``"a|b"`` (falcon's old and new
architectures): the first the checkpoint holds is read, with the bias
beside it (:func:`resolve_name`, the reference's ``build.py:266-276``).
q/k norms are per head (``head_dim`` wide) or flat over the whole
projection (``q_dim`` and ``kv_dim`` wide: olmo2), as the checkpoint
holds them.
So the device never holds more than one full-precision weight (and a
slice of its fp32 working copy) beside the packed tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.families import MoEScheme, WeightScheme
from ipex_llm_tpu_torch.quantize.core import QTensor, quantize
from ipex_llm_tpu_torch.quantize.qtypes import resolve

NORM_DTYPE = torch.float32
# fp32 elements of one weight quantized at a time: the codec's temporaries
# stay a few hundred MB whatever the weight (quantization runs down each
# output column on its own, so a slice of rows of the HF [out, in] weight
# packs to the same bytes as the whole)
_CHUNK_ELEMS = 1 << 24


def _cat_columns(qts: list[QTensor]) -> QTensor:
    """QTensors of the same ``in`` side by side along ``out``."""
    if len(qts) == 1:
        return qts[0]
    q0 = qts[0]

    def cat(planes):
        return None if planes[0] is None else torch.cat(planes, dim=-1)
    return QTensor(cat([q.data for q in qts]), cat([q.scales for q in qts]),
                   cat([q.zeros for q in qts]), q0.qtype,
                   (q0.in_features, sum(q.out_features for q in qts)),
                   q0.block_size)


def quantize_weight(w: torch.Tensor, qtype: str, imatrix=None) -> QTensor:
    """Quantize one HF-layout ``[out, in]`` weight (on any device) to an
    ``[in, out]`` QTensor on the same device.

    The reference's ``mixed_fp4``/``mixed_fp8`` pick-the-better-format
    policy and ``imatrix`` weighting are not ported (ROADMAP item 13)."""
    if qtype in ("mixed_fp4", "mixed_fp8"):
        raise NotImplementedError(
            f"{qtype!r} (the per-tensor format pick) is not ported "
            "(ROADMAP item 13)")
    if imatrix is not None:
        raise NotImplementedError(
            "imatrix-weighted quantization is not ported (ROADMAP item 13)")
    rows = max(1, _CHUNK_ELEMS // max(1, w.shape[1]))
    return _cat_columns([
        quantize(w[r:r + rows].t().to(torch.float32).contiguous(), qtype)
        for r in range(0, w.shape[0], rows)])


class LayerStack:
    """``[L, ...]`` leaves filled layer by layer (and ``[L, E, ...]`` expert
    stacks expert by expert, ``n_experts`` E): each plane is allocated
    once, at its first put, and written in place."""

    def __init__(self, n_layers: int, n_experts: int = 0):
        self.n = n_layers
        self.n_experts = n_experts
        self.tree: dict[str, Any] = {}

    def put(self, i: int, key: str, leaf, expert: int | None = None) -> None:
        """Write ``leaf`` at layer ``i`` (and expert ``expert``)."""
        if key not in self.tree:
            lead = (self.n,) if expert is None else (self.n, self.n_experts)

            def empty(t):
                return torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                                   device=t.device)
            self.tree[key] = (leaf.planes(empty) if isinstance(leaf, QTensor)
                              else empty(leaf))
        at = i if expert is None else (i, expert)
        dst = self.tree[key]
        if isinstance(leaf, QTensor):
            for d, s in ((dst.data, leaf.data), (dst.scales, leaf.scales),
                         (dst.zeros, leaf.zeros)):
                if s is not None:
                    d[at] = s
        else:
            dst[at] = leaf


def resolve_name(tmpl: str, layer: int, has: Callable[[str], bool]) -> str:
    """Layer ``layer``'s weight name of ``tmpl``: of an ``"a|b|..."``
    template, the first alternative the checkpoint holds (the first where
    it holds none, so that the read names it in its error)."""
    names = [t.format(i=layer, p="weight") for t in tmpl.split("|")]
    return next((n for n in names if has(n)), names[0])


def stack_layer_trees(trees: list[dict[str, Any]]) -> dict[str, Any]:
    """Stack per-layer trees (QTensor-aware) along a new leading axis."""
    st = LayerStack(len(trees))
    for i, tree in enumerate(trees):
        for key, leaf in tree.items():
            st.put(i, key, leaf)
    return st.tree


# scheme fields whose weights the port's tree has no slot for
_SCHEME_UNSERVED = ("pos_embed", "embed_norm")


def build_params(
    cfg: ModelConfig,
    scheme: WeightScheme,
    get: Callable[[str], torch.Tensor],
    has: Callable[[str], bool],
    qtype: str = "sym_int4",
    lm_head_qtype: str | None = None,
    mixed_precision: bool = False,
    progress: Callable[[str], None] | None = None,
    moe_scheme: MoEScheme | None = None,
    embedding_qtype: str | None = None,
    qkv_transform: Callable | None = None,
    transpose_weights: bool = False,
    imatrix_data: dict | None = None,
    device=None,
) -> dict[str, Any]:
    """The decoder's tree from ``get(name)`` (a tensor in any float width,
    on the CPU) on ``device`` (``None`` = cuda), quantizing as it
    streams.  ``mixed_precision`` packs the lm head at sym_int8 rather
    than ``qtype`` (the reference's flag); ``lm_head_qtype`` outranks
    both.  ``moe_scheme`` names an MoE config's router and expert weights.
    The keyword arguments of other families' trees raise
    ``NotImplementedError`` naming their ROADMAP item."""
    for what, val, item in (
            ("imatrix_data", imatrix_data, "13"),
            ("embedding_qtype (a quantized embedding table)",
             embedding_qtype, "12"),
            ("transpose_weights", transpose_weights, "14")):
        if val:
            raise NotImplementedError(
                f"build_params: {what} is not ported (ROADMAP item {item})")
    unserved = [f for f in _SCHEME_UNSERVED if getattr(scheme, f) is not None]
    mla = scheme.kv_a is not None and cfg.is_mla
    if unserved or (not mla and scheme.qkv is None
                    and None in (scheme.q, scheme.k, scheme.v)) \
            or (qkv_transform is not None and scheme.qkv is None) \
            or (scheme.gate_up is None and scheme.up is None and any(
                not cfg.layer_is_moe(i) for i in range(cfg.num_layers))):
        raise NotImplementedError(
            f"weight scheme fields {unserved or ['q/k/v/gate/up = None']} "
            "are not ported (ROADMAP item 14)")
    if cfg.num_experts and moe_scheme is None:
        raise ValueError(f"model has {cfg.num_experts} experts but the "
                         "family declares no MoE weight scheme")
    if (scheme.q_norm is not None) != cfg.qk_norm:
        raise ValueError("q/k norm weights go with cfg.qk_norm")
    dev = resolve_device(device)

    def load(n: str) -> torch.Tensor:
        return get(n).to(dev)

    def bias_of(n: str) -> str | None:
        return n[: -len(".weight")] + ".bias" if n.endswith(".weight") \
            else None

    def refuse_bias(n: str) -> None:
        """Biases the port does not serve (module doc)."""
        b = bias_of(n)
        if b is not None and has(b):
            raise NotImplementedError(
                f"bias {b!r} is not ported (ROADMAP item 14)")

    def put_bias(st: LayerStack, i: int, key: str, n: str,
                 expert: int | None = None) -> None:
        """The bias beside weight ``n``, where the checkpoint holds one,
        as the fp32 leaf ``key``."""
        b = bias_of(n)
        if b is not None and has(b):
            st.put(i, key, load(b).to(torch.float32), expert=expert)

    def merged(names: list[str], q: str) -> QTensor:
        """Rows of ``names`` concatenated, quantized as one [in, out]
        weight: each part is uploaded, quantized and freed in turn (a
        quantized column does not depend on its neighbours)."""
        qts = []
        for n in names:
            refuse_bias(n)
            qts.append(quantize_weight(load(n), q))
        return _cat_columns(qts)

    def qk_norms(q: str, k: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The q and k norms, both per head or both flat."""
        refuse_bias(q)
        refuse_bias(k)
        tq, tk = (load(n).to(NORM_DTYPE) for n in (q, k))
        widths = (tuple(tq.shape), tuple(tk.shape))
        if widths not in (((cfg.head_dim,), (cfg.head_dim,)),
                          ((cfg.q_dim,), (cfg.kv_dim,))):
            raise NotImplementedError(
                f"{q}, {k} of shapes {widths}: q/k norms per head "
                f"({cfg.head_dim} wide) or flat ({cfg.q_dim} and "
                f"{cfg.kv_dim}) are ported (ROADMAP item 14)")
        return tq, tk

    n_dense = dense_prefix(cfg)
    dense_st = LayerStack(n_dense) if n_dense else None
    moe_st = LayerStack(cfg.num_layers - n_dense, cfg.num_experts)
    for layer in range(cfg.num_layers):
        if progress:
            progress(f"layer {layer + 1}/{cfg.num_layers}")
        st, i = ((dense_st, layer) if layer < n_dense
                 else (moe_st, layer - n_dense))

        def name(t: str) -> str:
            return t.format(i=layer, p="weight")
        for key, tmpl in (("attn_norm", scheme.attn_norm),
                          ("mlp_norm", scheme.mlp_norm)):
            n = resolve_name(tmpl, layer, has)
            st.put(i, key, load(n).to(NORM_DTYPE))
            put_bias(st, i, key + "_bias", n)
        for key, tmpl in (("post_attn_norm", scheme.post_attn_norm),
                          ("post_mlp_norm", scheme.post_mlp_norm)):
            if tmpl is None:
                continue
            refuse_bias(name(tmpl))
            st.put(i, key, load(name(tmpl)).to(NORM_DTYPE))
        if cfg.qk_norm:
            tq, tk = qk_norms(name(scheme.q_norm), name(scheme.k_norm))
            st.put(i, "q_norm", tq)
            st.put(i, "k_norm", tk)
        if mla:
            _put_mla_layer(st, i, scheme, cfg, name, load, merged, qtype)
        else:
            qkv = ([name(scheme.qkv)] if scheme.qkv is not None
                   else [name(t) for t in (scheme.q, scheme.k, scheme.v)])
            # the qkv bias wherever the checkpoint holds it, whatever
            # cfg.attention_bias says (Qwen v1's c_attn under no_bias)
            biases = [bias_of(n) for n in qkv]
            held = [has(b) for b in biases]
            if all(held):
                bias = torch.cat([load(b).to(torch.float32)
                                  for b in biases])
                if qkv_transform is not None:
                    bias = qkv_transform(bias[:, None], cfg)[:, 0]
                st.put(i, "qkv_bias", bias.contiguous())
            elif any(held):
                raise NotImplementedError(
                    f"bias {biases[held.index(True)]!r} without the other "
                    "q/k/v biases is not ported (ROADMAP item 14)")
            if qkv_transform is not None:
                st.put(i, "qkv", quantize_weight(
                    qkv_transform(load(qkv[0]), cfg), qtype))
            else:
                st.put(i, "qkv", _cat_columns([
                    quantize_weight(load(n), qtype) for n in qkv]))
        st.put(i, "o", quantize_weight(load(name(scheme.o)), qtype))
        put_bias(st, i, "o_bias", name(scheme.o))
        if cfg.layer_is_moe(layer):
            _put_moe_layer(st, i, layer, moe_scheme, cfg.num_experts, load,
                           merged, qtype, put_bias)
            continue
        if scheme.gate_up is None and scheme.gate is None:
            # the ungated MLP (fc1 -> act -> fc2), biases beside it
            st.put(i, "up", quantize_weight(load(name(scheme.up)), qtype))
            put_bias(st, i, "up_bias", name(scheme.up))
        else:
            st.put(i, "gate_up", merged(
                [name(scheme.gate_up)] if scheme.gate_up is not None
                else [name(scheme.gate), name(scheme.up)], qtype))
        st.put(i, "down", quantize_weight(load(name(scheme.down)), qtype))
        put_bias(st, i, "down_bias", name(scheme.down))

    params: dict[str, Any] = {"layers": moe_st.tree}
    if dense_st is not None:
        params["layers_dense"] = dense_st.tree
    emb = load(scheme.embed)
    params["embed"] = (emb if emb.dtype == torch.bfloat16
                       else emb.to(torch.float32).to(torch.bfloat16))
    del emb
    params["final_norm"] = load(scheme.final_norm).to(NORM_DTYPE)
    fn_bias = bias_of(scheme.final_norm)
    if fn_bias is not None and has(fn_bias):
        params["final_norm_bias"] = load(fn_bias).to(NORM_DTYPE)
    if not cfg.tie_word_embeddings:
        head_q = lm_head_qtype or ("sym_int8" if mixed_precision else qtype)
        params["lm_head"] = quantize_weight(load(scheme.lm_head), head_q)
        head_bias = bias_of(scheme.lm_head)
        if head_bias is not None and has(head_bias):
            params["lm_head_bias"] = load(head_bias).to(torch.float32)
    params.update(rope_buffers(cfg, dev))
    return params


def dense_prefix(cfg: ModelConfig) -> int:
    """The layers of the ``layers_dense`` stack: DeepSeek's first
    ``moe_layer_start`` layers where experts follow them, else none (one
    stack holds every layer, the reference's rule)."""
    if cfg.num_experts and 0 < cfg.moe_layer_start < cfg.num_layers:
        return cfg.moe_layer_start
    return 0


def _put_mla_layer(st: LayerStack, i: int, scheme: WeightScheme,
                   cfg: ModelConfig, name, load, merged, qtype: str) -> None:
    """MLA's leaves of stack layer ``i``: ``q`` (a full-rank q_proj) or
    ``q_a``, fp32 ``q_a_norm`` and ``q_b``, then ``kv_a``, fp32
    ``kv_a_norm`` and ``kv_b``, each linear one quantized weight."""
    if cfg.q_lora_rank is None:
        st.put(i, "q", merged([name(scheme.q)], qtype))
    else:
        st.put(i, "q_a", merged([name(scheme.q_a)], qtype))
        st.put(i, "q_a_norm", load(name(scheme.q_a_norm)).to(NORM_DTYPE))
        st.put(i, "q_b", merged([name(scheme.q_b)], qtype))
    st.put(i, "kv_a", merged([name(scheme.kv_a)], qtype))
    st.put(i, "kv_a_norm", load(name(scheme.kv_a_norm)).to(NORM_DTYPE))
    st.put(i, "kv_b", merged([name(scheme.kv_b)], qtype))


def rope_buffers(cfg: ModelConfig, device) -> dict[str, Any]:
    """The tree's rope leaves, as the reference builds them once at
    ``cfg.max_position_embeddings``: ``inv_freq`` fp32, ``rope_mscale`` a
    Python float, and gemma3's ``inv_freq_local`` where ``cfg.rope_local``
    is set."""
    n = cfg.max_position_embeddings
    out = {"inv_freq": torch.from_numpy(cfg.rope.inv_freq(n)).to(device),
           "rope_mscale": float(cfg.rope.mscale(n))}
    if cfg.rope_local is not None:
        out["inv_freq_local"] = torch.from_numpy(
            cfg.rope_local.inv_freq(n)).to(device)
    return out


def _put_moe_layer(st: LayerStack, i: int, layer: int, ms: MoEScheme,
                   n_experts: int, load, merged, qtype: str,
                   put_bias) -> None:
    """Checkpoint layer ``layer``'s router (fp32 ``[H, E]``), its experts'
    gate||up (fc1 alone for ungated experts, whose fc1 and fc2 biases go
    to ``moe_up_bias``/``moe_down_bias``) and down, each quantized on the
    device as it is read and written into the ``[L, E, ...]`` stacks at
    stack layer ``i``, the shared expert and its gate, and V3's fp32
    score bias ``[E]``, where the scheme names them."""
    st.put(i, "router", load(ms.router.format(i=layer)).to(torch.float32).t()
           .contiguous())
    if ms.score_bias is not None:
        st.put(i, "router_bias", load(ms.score_bias.format(i=layer)).to(
            torch.float32))
    for e in range(n_experts):
        up, down = ms.e_up.format(i=layer, e=e), ms.e_down.format(i=layer, e=e)
        if ms.e_gate is None:
            st.put(i, "moe_gate_up", quantize_weight(load(up), qtype),
                   expert=e)
            st.put(i, "moe_down", quantize_weight(load(down), qtype),
                   expert=e)
            put_bias(st, i, "moe_up_bias", up, expert=e)
            put_bias(st, i, "moe_down_bias", down, expert=e)
            continue
        st.put(i, "moe_gate_up", merged([ms.e_gate.format(i=layer, e=e), up],
                                        qtype), expert=e)
        st.put(i, "moe_down", merged([down], qtype), expert=e)
    if ms.shared_gate is not None:
        st.put(i, "shared_gate_up", merged([ms.shared_gate.format(i=layer),
                                            ms.shared_up.format(i=layer)],
                                           qtype))
        st.put(i, "shared_down", merged([ms.shared_down.format(i=layer)],
                                        qtype))
    if ms.shared_router is not None:
        st.put(i, "shared_router", load(ms.shared_router.format(i=layer)).to(
            torch.float32).t().contiguous())


def _requant_leaf(qt: QTensor, qtype: str) -> QTensor:
    """Re-pack one native-width QTensor (2-D, or stacked with leading axes)
    into ``qtype``: each logical ``[in, out]`` matrix quantizes on its own
    (over the stored bf16 values), then the planes restack along the
    original leading axes."""
    lead = tuple(qt.data.shape[:-2])
    flat = qt.data.reshape((-1,) + tuple(qt.shape))
    qts = [quantize(m, qtype) for m in flat]

    def restack(leaves):
        if leaves[0] is None:
            return None
        s = torch.stack(leaves)
        return s.reshape(lead + tuple(s.shape[1:])) if lead else s[0]

    return QTensor(restack([q.data for q in qts]),
                   restack([q.scales for q in qts]),
                   restack([q.zeros for q in qts]),
                   qts[0].qtype, qt.shape, qts[0].block_size)


def requantize_params(params: dict, qtype: str) -> dict:
    """Re-pack every native-width linear QTensor of a tree (stacked layer
    leaves and the lm head) as ``qtype`` planes: the engine's
    ``EngineConfig.weight_qtype`` axis.

    Plain tensors (embedding, norms, rope buffers) keep their width, and
    already-packed leaves pass through untouched: requantizing packed codes
    would stack quantization error.  An unknown name raises ``ValueError``
    at once; a format outside the port raises ``NotImplementedError`` only
    when a full-width leaf actually needs its codec, so an already-packed
    tree passes through whatever is asked."""
    try:
        info = resolve(qtype)
    except NotImplementedError as exc:
        info, missing = None, exc
    if info is not None and info.kind == "native":
        return params

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if not isinstance(tree, QTensor) or resolve(tree.qtype).kind \
                != "native":
            return tree
        if info is None:
            raise NotImplementedError(
                f"weight_qtype={qtype!r} has no codec in the port for the "
                f"full-width weight {'.'.join(path)}") from missing
        return _requant_leaf(tree, info.name)

    return walk(params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_bytes(params: dict) -> tuple[int, int]:
    """(packed_bytes, dense_bytes): what the tree holds on its device as
    stored, and what it would hold with every QTensor at bf16 full width
    (other tensors count the same on both sides)."""
    packed = dense = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            packed += leaf.nbytes
            dense += (math.prod(leaf.data.shape[:-2]) * leaf.in_features
                      * leaf.out_features * 2)
        elif isinstance(leaf, torch.Tensor):
            n = leaf.numel() * leaf.element_size()
            packed += n
            dense += n
    return packed, dense


def packed_qtypes(params: dict) -> tuple[str, ...]:
    """The block formats the tree's QTensors carry (native widths left
    out), sorted."""
    return tuple(sorted({leaf.qtype for leaf in _leaves(params)
                         if isinstance(leaf, QTensor)
                         and resolve(leaf.qtype).kind != "native"}))
