"""Expert offload: an MoE model whose experts live in host memory (port of
``ipex_llm_tpu/offload.py``, the reference's FlashMoE equivalent).

The expert stacks (``moe_gate_up``, ``moe_down``) stay in host memory as
packed QTensors, pinned when the model runs on the card; everything else
(attention, router, norms, shared experts, embeddings, the head) lives on
the device.  A byte-budgeted device cache (:class:`ExpertStore`, over
``hostutil.HostLRU``) holds the hottest (layer, expert) entries; a miss
copies one entry's packed planes (about 4.5 bits a weight at sym_int4) to
the device on a copy stream of its own, with ``non_blocking`` copies from
the pinned stacks, and records an event that the compute stream waits on
before the entry's first product.  :class:`OffloadedMoE` drives the
decoder layer by layer from the host: after each layer's router the
top-k expert ids are read on the host (the one host read a layer that
data-dependent residency needs), the layer's misses are all issued, then
its expert products run (B2 a product: the GEMV at one token, the tiled
instance at a prefill) while the copies land.  Attention goes through the
decoder's ``_attention_block`` over the dense ``KVCache``: B4 at the
prefill, B3 at each decode step.

Refused by name, as the reference's drive does not serve them (it routes
with softmax scores only and indexes ``params["layers"]`` by the absolute
layer): group-limited routing, sigmoid scores, a score bias, expert
biases or ungated experts, the parallel residual and a dense prefix
stack (ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.hostutil import HostLRU
from ipex_llm_tpu_torch.kv import KVCache
from ipex_llm_tpu_torch.models import decoder as dec
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.ops import linear as linear_ops
from ipex_llm_tpu_torch.ops import mlp as mlp_ops
from ipex_llm_tpu_torch.quantize.core import QTensor

EXPERT_SLOTS = ("moe_gate_up", "moe_down")


def _on(x, device):
    """A tree leaf (tensor or QTensor) on ``device``; a float stays."""
    return x.to(device) if isinstance(x, (torch.Tensor, QTensor)) else x


def _planes(qt: QTensor) -> list[torch.Tensor]:
    return [t for t in (qt.data, qt.scales, qt.zeros) if t is not None]


class ExpertStore:
    """Host-memory packed expert stacks with a device LRU cache of (layer,
    expert) entries under a byte budget (``hostutil.HostLRU``, the packed
    bytes of an entry's planes as the reference's ``_qt_nbytes`` counts
    them, so hits, misses and evictions follow the reference's).

    ``host``: slot -> stacked ``[L, E, ...]`` QTensor in host memory
    (pinned for a card).  On a card each miss is copied on ``copy_stream``
    and its entry carries the event that ends the copy; ``bytes_copied``
    sums the copied bytes and :meth:`copy_seconds` the copy stream's time
    over them."""

    def __init__(self, host: dict[str, QTensor], budget_bytes: int,
                 device: torch.device):
        self.host = host
        self.budget = budget_bytes
        self.device = device
        self._cache = HostLRU(budget_bytes)
        self.bytes_copied = 0
        self.copy_stream = (torch.cuda.Stream(device)
                            if device.type == "cuda" else None)
        self._copy_events: list[tuple] = []

    @property
    def hits(self) -> int:
        return self._cache.hits

    @property
    def misses(self) -> int:
        return self._cache.misses

    @property
    def evictions(self) -> int:
        return self._cache.evictions

    def get(self, layer: int, expert: int) -> dict:
        """The entry ``{slot: QTensor on the device, "event": ...}`` of one
        (layer, expert); a miss issues its copy and returns at once."""
        key = (layer, expert)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        src = {slot: stacked.planes(lambda t: t[layer, expert])
               for slot, stacked in self.host.items()}
        nbytes = sum(qt.nbytes for qt in src.values())
        if self.copy_stream is None:
            entry = {slot: qt.planes(lambda t: t.to(self.device, copy=True))
                     for slot, qt in src.items()}
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # allocated and filled on the copy stream (allocated first, so
            # the timed region holds the copies alone); the compute stream's
            # readers mark their use (record_stream), so the allocator does
            # not hand an evicted entry's memory to a later copy while a
            # queued product still reads it
            with torch.cuda.stream(self.copy_stream):
                entry = {slot: qt.planes(
                    lambda t: torch.empty_like(t, device=self.device))
                    for slot, qt in src.items()}
                start.record()
                for slot, qt in src.items():
                    for dst, host in zip(_planes(entry[slot]), _planes(qt)):
                        dst.copy_(host, non_blocking=True)
                end.record()
            entry["event"] = end
            self._copy_events.append((start, end))
        self.bytes_copied += nbytes
        self._cache.put(key, entry, nbytes)
        return entry

    def prefetch(self, layer: int, experts) -> None:
        for e in experts:
            self.get(layer, int(e))

    def copy_seconds(self) -> float:
        """The copy stream's time over every copy so far (synchronises)."""
        total = 0.0
        for start, end in self._copy_events:
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
        return total


def split_expert_params(params: dict, device: torch.device
                        ) -> tuple[dict, dict[str, QTensor]]:
    """(device params without the expert stacks, the expert stacks in host
    memory, pinned when ``device`` is a card)."""
    def to_host(t: torch.Tensor) -> torch.Tensor:
        if device.type != "cuda":
            return t.cpu()
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t)

    layers = dict(params["layers"])
    host = {slot: layers.pop(slot).planes(to_host)
            for slot in EXPERT_SLOTS if slot in layers}
    out = {k: _on(v, device) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: _on(v, device) for k, v in layers.items()}
    return out, host


def _refusal(cfg: ModelConfig, params: dict) -> str | None:
    """Why the offloaded drive cannot serve this model, or None."""
    layers = params["layers"]
    for why, bad in (
            ("group-limited routing", cfg.moe_n_group > 1),
            ("sigmoid router scores", cfg.moe_score_func != "softmax"),
            ("a router score bias",
             cfg.moe_score_bias or "router_bias" in layers),
            ("ungated experts", not cfg.mlp_gated),
            ("expert biases",
             "moe_up_bias" in layers or "moe_down_bias" in layers),
            ("the parallel residual", cfg.parallel_blocks),
            ("a dense prefix stack (layers_dense)",
             "layers_dense" in params or cfg.moe_layer_start > 0)):
        if bad:
            return why
    return None


def _expert_ffn(h, gate_up: QTensor, down: QTensor, act: str):
    """h [..., H] through one gated expert (the reference's
    ``_expert_ffn``): B2 on each of its two products."""
    gate, up = mlp_ops.split_gate_up(linear_ops.linear(h, gate_up))
    return linear_ops.linear(mlp_ops.gated_act_mul(gate, up, act), down)


class OffloadedMoE:
    """Layer-by-layer MoE runtime with host-resident experts (the
    reference's ``OffloadedMoE``).  ``hbm_budget_mb`` caps the device-side
    expert cache; below the experts' footprint it streams.  Runs on the
    card unless ``device`` names the CPU."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 hbm_budget_mb: float = 4096.0, device=None):
        if cfg.num_experts == 0:
            raise ValueError("OffloadedMoE requires an MoE config")
        why = _refusal(cfg, params)
        if why is not None:
            raise NotImplementedError(
                f"expert offload of a model with {why} is not ported (the "
                "reference's drive does not serve it: ROADMAP queue 3)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params, host = split_expert_params(params, self.device)
        self.store = ExpertStore(host, int(hbm_budget_mb * 1024 * 1024),
                                 self.device)
        self.last_logits: torch.Tensor | None = None

    def _apply_experts(self, layer: int, h, w, idx) -> torch.Tensor:
        """Σ_e gate_e ⊙ expert_e(h) over the layer's selected experts, in
        ascending id order, each term and the running sum rounded to bf16
        as the reference's ``_apply_experts`` rounds them.  The reference
        pads the expert count to a power of two with zero-weight repeats
        of the first id, to bound its retraces; those repeats' store reads
        are kept (they touch or refetch an entry, so the hit, miss and
        eviction counts stay the reference's), their products dropped (a
        term ``0 * y`` changes no finite bf16 sum).  All of the layer's
        misses are issued before its first product."""
        used = sorted(set(idx.reshape(-1).tolist()))     # the host read
        n_pad = 1
        while n_pad < len(used):
            n_pad *= 2
        entries = [self.store.get(layer, used[i] if i < len(used)
                                  else used[0]) for i in range(n_pad)]
        compute = (torch.cuda.current_stream(self.device)
                   if self.store.copy_stream is not None else None)
        y = torch.zeros_like(h)
        for e, entry in zip(used, entries):
            if compute is not None:
                compute.wait_event(entry["event"])
                for slot in EXPERT_SLOTS:
                    for t in _planes(entry[slot]):
                        t.record_stream(compute)
            gate = ((idx == e) * w).sum(-1)          # fp32, one term
            ye = _expert_ffn(h, entry["moe_gate_up"], entry["moe_down"],
                             self.cfg.act)
            y = y + ye * gate[..., None].to(ye.dtype)
        return y

    def _forward(self, tokens: torch.Tensor, cache: KVCache) -> torch.Tensor:
        """tokens [1, T] through every layer at the cache's length; returns
        the last position's fp32 logits [1, V] and advances the cache."""
        cfg, p = self.cfg, self.params
        b, t = tokens.shape
        slot0 = int(cache.length)
        q_slots = (slot0 + torch.arange(t, device=self.device))[None].expand(
            b, t)
        kv_len = torch.full((b,), slot0 + t, dtype=torch.int32,
                            device=self.device)
        kv_start = torch.zeros((b,), dtype=torch.int32, device=self.device)
        x, cos, sin = dec.embed_prelude(cfg, p, tokens, q_slots)
        for layer in range(cfg.num_layers):
            lp = dec.layer_params(p["layers"], layer)
            attn = dec._attention_block(
                cfg, lp, x, cache.k[layer], cache.v[layer], cos, sin, slot0,
                q_slots, kv_len, kv_start, cfg.layer_is_sliding(layer),
                cache, None)
            x = dec.residual_add(cfg, x, attn)
            h = dec._norm(cfg, x, lp["mlp_norm"])
            w, idx = dec.route(cfg, dec._f32_product(h, lp["router"]))
            y = dec.with_shared_expert(
                cfg, lp, h, self._apply_experts(layer, h, w, idx))
            x = dec.residual_add(cfg, x, y)
        cache.length = slot0 + t
        return dec.logits_tail(cfg, p, x[:, -1:])[:, 0]

    def generate(self, prompt_ids, max_new_tokens: int = 32) -> np.ndarray:
        """Greedy batch-1 decode with streamed experts: [1, len(prompt) +
        new] (the reference's return); the steps' fp32 logits stay in
        ``last_logits`` [new, V]."""
        cfg = self.cfg
        prompt = np.asarray(prompt_ids, np.int64).reshape(1, -1)
        t0 = prompt.shape[1]
        cache = KVCache.init(cfg.num_layers, 1, t0 + max_new_tokens + 8,
                             cfg.num_kv_heads, cfg.head_dim,
                             v_head_dim=cfg.v_dim, device=self.device)
        tok = torch.from_numpy(prompt).to(self.device)
        steps, out = [], []
        for _ in range(max_new_tokens):
            logits = self._forward(tok, cache)
            steps.append(logits[0])
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            out.append(tok)
        self.last_logits = torch.stack(steps)
        new = torch.cat(out, dim=1).cpu().numpy()
        return np.concatenate([prompt, new], axis=1)
