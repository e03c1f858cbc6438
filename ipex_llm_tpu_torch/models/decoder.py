"""The llama-family decoder (port of ``ipex_llm_tpu/models/decoder.py``).

The reference scans one compiled layer body over stacked layer params; the
port keeps the params stacked (``[L, ...]`` leaves) and runs a Python loop
over the layer index.  Two forms, as in the reference:

- paged (the serving engine): every call carries per-row ``slot_offsets``,
  K/V are written into the pool in place through its block tables, and
  attention reads the pool through the ragged paged kernel;
- dense (``generate()``): ``slot_offsets=None`` writes at the cache's
  ``length`` (one offset for every row), ``kv_start`` masks each row's left
  padding, and attention goes to the flash kernel (prefill) or the decode
  kernel (T=1), with the sliding window on where ``cfg.layer_is_sliding``.

Rounding points follow the reference: activations are bf16, norms and rope
compute in fp32, linear layers accumulate in fp32 and round to bf16, the
logits are the lm head's bf16 output widened to fp32.
"""

from __future__ import annotations

from typing import Any

import torch

from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.ops import linear as linear_ops
from ipex_llm_tpu_torch.ops import mlp as mlp_ops
from ipex_llm_tpu_torch.ops import rope as rope_ops
from ipex_llm_tpu_torch.ops.attention import cached_sdpa
from ipex_llm_tpu_torch.ops.embedding import embed_lookup
from ipex_llm_tpu_torch.ops.norms import rms_norm
from ipex_llm_tpu_torch.quantize.core import QTensor

COMPUTE_DTYPE = torch.bfloat16


def layer_params(layers: dict[str, Any], i: int) -> dict[str, Any]:
    """Layer ``i`` of the stacked layer tree (views, no copies)."""
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QTensor):
            out[name] = leaf.planes(lambda t: t[i])
        else:
            out[name] = leaf[i]
    return out


def _attention_block(cfg: ModelConfig, lp: dict, x, kl, vl, cos, sin, slot0,
                     q_slots, kv_len, kv_start, sliding: bool, cache,
                     chunk_lens):
    b, t, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    qkv = linear_ops.linear(h, lp["qkv"])
    q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
    q = qkv[..., :q_dim].reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = qkv[..., q_dim:q_dim + kv_dim].reshape(b, t, cfg.num_kv_heads,
                                               cfg.head_dim)
    v = qkv[..., q_dim + kv_dim:].reshape(b, t, cfg.num_kv_heads,
                                          cfg.head_dim)
    q = rope_ops.apply_rope(q, cos, sin, cfg.rope_layout)
    k = rope_ops.apply_rope(k, cos, sin, cfg.rope_layout)
    kl, vl = cache.update_layer(kl, vl, k, v, slot0)
    attn = cached_sdpa(q, kl, vl, cache, causal=True, q_positions=q_slots,
                       kv_len=kv_len, kv_start=kv_start,
                       window=cfg.sliding_window, window_on=sliding,
                       chunk_lens=chunk_lens)
    attn = attn.reshape(b, t, cfg.q_dim)
    return linear_ops.linear(attn, lp["o"])


def _mlp_block(cfg: ModelConfig, lp: dict, x):
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate, up = mlp_ops.split_gate_up(linear_ops.linear(h, lp["gate_up"]))
    return linear_ops.linear(mlp_ops.gated_act_mul(gate, up, cfg.act),
                             lp["down"])


def embed_prelude(cfg: ModelConfig, params, tokens, rope_positions):
    """Token embeddings and the rope cos/sin tables: (x, cos, sin)."""
    x = embed_lookup(params["embed"], tokens, COMPUTE_DTYPE)
    cos, sin = rope_ops.cos_sin(rope_positions, params["inv_freq"],
                                params.get("rope_mscale", 1.0))
    return x, cos, sin


def logits_tail(cfg: ModelConfig, params, x):
    """Final norm and lm head: fp32 logits of the head's bf16 output."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return linear_ops.linear(x, params["lm_head"]).to(torch.float32)


def decoder_forward(cfg: ModelConfig, params: dict[str, Any],
                    tokens: torch.Tensor, cache,
                    rope_positions: torch.Tensor,
                    kv_start: torch.Tensor | None = None, *,
                    slot_offsets: torch.Tensor | None = None,
                    last_token_only: bool = False,
                    gather_positions: torch.Tensor | None = None,
                    chunk_lens: torch.Tensor | None = None):
    """Run the decoder; returns (logits, cache) with the cache updated in
    place.

    tokens/rope_positions [B, T].  Paged form: ``slot_offsets`` [B] is each
    row's first write slot, ``chunk_lens`` [B] its real token count (None =
    T; 0 = an idle row, whose offset is a sentinel past the table width).
    Dense form (``slot_offsets=None``): every row writes at slots
    ``[cache.length, cache.length + T)``, ``kv_start`` [B] is each row's
    first valid slot (left padding), and ``cache.length`` advances by T.
    Logits are [B, V] for ``last_token_only`` or ``gather_positions`` (one
    index per row, gathered before the lm head) and [B, T, V] otherwise.
    """
    b, t = tokens.shape
    dev = tokens.device
    x, cos, sin = embed_prelude(cfg, params, tokens, rope_positions)
    if slot_offsets is not None:
        if kv_start is not None or cfg.sliding_window is not None:
            raise NotImplementedError(
                "left padding and sliding windows over the paged pool are "
                "not ported")
        slot0 = slot_offsets
        q_slots = None
        kv_len = slot0 + (chunk_lens if chunk_lens is not None else t)
    else:
        slot0 = int(cache.length)
        q_slots = (slot0 + torch.arange(t, device=dev))[None].expand(b, t)
        kv_len = torch.full((b,), slot0 + t, dtype=torch.int32, device=dev)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        x = x + _attention_block(cfg, lp, x, cache.k[i], cache.v[i], cos,
                                 sin, slot0, q_slots, kv_len, kv_start,
                                 cfg.layer_is_sliding(i), cache, chunk_lens)
        x = x + _mlp_block(cfg, lp, x)
    if slot_offsets is None:
        cache.length = slot0 + t
    if last_token_only:
        x = x[:, -1:, :]
    elif gather_positions is not None:
        idx = gather_positions.long().clamp(0, t - 1)
        x = x[torch.arange(b, device=x.device), idx][:, None, :]
    logits = logits_tail(cfg, params, x)
    if last_token_only or gather_positions is not None:
        logits = logits[:, 0]
    return logits, cache
