"""Tensor-parallel serving's per-rank model (port of
``ipex_llm_tpu/parallel/manual.py``).

The reference runs its whole fused tick inside one fully manual
``shard_map``: each shard runs the unmodified single-chip decoder over a
shard-local config, with explicit collectives at the two row-parallel
combines of a layer and one all-gather of the lm head's logits.  The port
does the same with one process a rank: every rank runs the decoder over
:func:`local_cfg` and its slice of the params (:func:`shard_params_manual`),
and the decoder takes the rank's ``TPGroup`` for the collectives
(``models/decoder.py``).  The Megatron layout:

- qkv and gate_up are column-parallel, their columns re-laid out first
  (:func:`relayout_packed`) so that a rank's contiguous block holds its
  heads of q, k and v (its halves of gate and up): a permutation of
  columns, so every column's dot product is the unsharded one;
- o and down are row-parallel: fp32 partials summed by
  ``ops/collectives.py::all_reduce`` under the engine's wire family;
- attention is head-local over the rank's kv heads of the paged pool;
- the embedding, the norms and the rope tables are replicated;
- the lm head is column-parallel when the vocabulary divides, and its
  logits are gathered before sampling, so every rank samples the same
  token; a tied head stays replicated.

:func:`ineligible_reason` says what this layout cannot serve; the engine
raises on it (the reference routes those to GSPMD, which the port has no
counterpart for).
"""

from __future__ import annotations

from dataclasses import replace as _dc_replace

import numpy as np
import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.parallel.shard import (_COL, _COL_BIAS, _ROW,
                                               shard_qtensor, tp_mode)
from ipex_llm_tpu_torch.quantize.core import QTensor


def ineligible_reason(cfg: ModelConfig, params: dict, axes: dict,
                      step_budget: int) -> str | None:
    """Why the per-rank layout cannot serve ``(cfg, params)`` over a mesh
    of ``axes`` (axis name to size, as a mesh's ``shape``) with the
    engine's ``step_budget``; None when it can.  The reference's rule, its
    reasons word for word (MLA, DeepSeek's attention, is refused; the
    port's configs have no alibi or 2D rope), and one of the port's own:
    a bias on a row-parallel o or down would be summed tp times by the
    all-reduce (it is added once after it in the reference's GSPMD
    path), so the GPT-style block, whose MLP is ungated besides, is
    refused at tp > 1."""
    tp = axes.get("tp", 1)
    if tp <= 1:
        return "no tp axis"
    others = {a: n for a, n in axes.items() if a != "tp" and n > 1}
    if others:
        return f"composed mesh (non-tp axes {others})"
    if step_budget <= 0:
        return "sequential engine (step_token_budget=0)"
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        return (f"heads do not divide tp ({cfg.num_heads}q/"
                f"{cfg.num_kv_heads}kv over tp={tp})")
    if cfg.is_mla:
        return "MLA attention (low-rank q/kv) not manual-sharded yet"
    layers = params.get("layers", {})
    if "layers_dense" in params or "moe_gate_up" in layers:
        return "MoE stacks not manual-sharded yet"
    if "qkv" not in layers:
        return "split q/k/v projections (GGUF import) not relaid-out yet"
    if not cfg.mlp_gated or "gate_up" not in layers:
        return "ungated / split MLP needs a sliced row input"
    if "o_bias" in layers or "down_bias" in layers:
        return "a row-parallel o/down bias is added once after the all-reduce"
    if cfg.qk_norm and "q_norm" in layers:
        qn = layers["q_norm"]
        width = (qn.shape[-1] if not isinstance(qn, QTensor)
                 else qn.out_features)
        if width == cfg.q_dim:
            return "flat qk-norm reduces over the full q_dim"
    for key, kind in (("qkv", "col"), ("gate_up", "col"), ("o", "row"),
                      ("down", "row")):
        qt = layers.get(key)
        if not isinstance(qt, QTensor):
            return f"{key} is not a QTensor"
        if tp_mode(qt, kind, tp) != kind:
            return (f"{key} does not {kind}-shard at tp={tp} "
                    f"(shape/blocks do not divide)")
    return None


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The rank-local config: heads divided by tp, everything else as it
    is."""
    if tp <= 1:
        return cfg
    return _dc_replace(cfg, num_heads=cfg.num_heads // tp,
                       num_kv_heads=cfg.num_kv_heads // tp)


def _block_perm(sections: tuple[int, ...], tp: int) -> np.ndarray:
    """Out-column permutation ``[a | b | ...]`` -> ``[a_0 b_0 | a_1 b_1 |
    ...]``: rank s's contiguous block holds its 1/tp of every section."""
    offs = np.concatenate([[0], np.cumsum(sections)])[:-1]
    idx: list[int] = []
    for s in range(tp):
        for off, w in zip(offs, sections):
            blk = w // tp
            idx.extend(range(off + s * blk, off + (s + 1) * blk))
    return np.asarray(idx, np.int64)


def _permute_out_cols(leaf, idx: np.ndarray):
    if leaf is None:
        return None
    sel = torch.as_tensor(idx)
    if isinstance(leaf, QTensor):
        return QTensor(*(None if t is None else
                         t.index_select(-1, sel.to(t.device))
                         for t in (leaf.data, leaf.scales, leaf.zeros)),
                       leaf.qtype, (leaf.in_features, len(idx)),
                       leaf.block_size)
    return leaf.index_select(-1, sel.to(leaf.device))


def _sections(layers: dict, cfg: ModelConfig) -> dict:
    secs = {"qkv": (cfg.q_dim, cfg.kv_dim, cfg.kv_dim)}
    gu = layers.get("gate_up")
    if isinstance(gu, QTensor):
        half = gu.out_features // 2
        secs["gate_up"] = (half, half)
    return secs


def relayout_packed(params: dict, cfg: ModelConfig, tp: int) -> dict:
    """The packed column-parallel projections (and their biases) with
    their columns permuted by :func:`_block_perm`; the identity at tp =
    1."""
    if tp <= 1:
        return params
    layers = dict(params["layers"])
    for key, secs in _sections(layers, cfg).items():
        if layers.get(key) is None:
            continue
        idx = _block_perm(secs, tp)
        layers[key] = _permute_out_cols(layers[key], idx)
        if layers.get(key + "_bias") is not None:
            layers[key + "_bias"] = _permute_out_cols(layers[key + "_bias"],
                                                      idx)
    return {**params, "layers": layers}


def shard_params_manual(params: dict, cfg: ModelConfig, tp: int,
                        rank: int) -> dict:
    """Rank ``rank``'s params: the packed projections re-laid out
    (:func:`relayout_packed`), then its slices under the reference's rules
    (``parallel/shard.py``); the embedding, norms, rope tables and any
    weight that does not split stay whole."""
    if tp <= 1:
        return params
    params = relayout_packed(params, cfg, tp)
    layers = {}
    for key, v in params["layers"].items():
        if isinstance(v, QTensor):
            kind = "col" if key in _COL else "row" if key in _ROW else "rep"
            layers[key] = shard_qtensor(v, tp_mode(v, kind, tp), tp, rank)
        elif key in _COL_BIAS and v.shape[-1] % tp == 0:
            n = v.shape[-1] // tp
            layers[key] = v[..., rank * n:(rank + 1) * n].contiguous()
        else:
            layers[key] = v
    out = {**params, "layers": layers}
    lm = params.get("lm_head")
    if isinstance(lm, QTensor):
        out["lm_head"] = shard_qtensor(lm, tp_mode(lm, "col", tp), tp, rank)
    return out
