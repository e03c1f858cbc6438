"""DeepSeek (deepseek_v2, deepseek_v3) in the port against the JAX package.

Tiny checkpoints (3 layers: one dense prefix layer, then two MoE layers;
hidden 64, 4 heads, K 16 + 8 wide and V 16, a kv latent of 32, 8 routed
experts of 32, top 3, group-limited over 4 groups; V2 with a full-rank q,
two shared experts and the V2-Lite yarn rope, V3 with a low-rank q of 48,
sigmoid scores and the score bias; random weights from a numpy seed) are
written by ``transformers``' own model classes, so the weight names are
the published ones.

- configs from the published ``config.json`` fields (DeepSeek-V2-Lite,
  DeepSeek-V3), V2's ``topk_method`` rule, the yarn scale the reference
  applies (``mscale_all_dim`` not read), the interleaved rope bitwise on
  float64 input;
- routing: ``route`` against the reference's ``_moe_block`` selection on
  the same fp32 logits (greedy V2, group-limited V2 by the group max, V3
  by the sum of a group's top two sigmoid scores plus the score bias,
  renormalised, times 2.5): the same experts where the selection margin is
  clear, weights within 1e-6;
- MLA: ``_attention_block`` of one layer over the dense cache, with and
  without the low-rank q, bf16 and e5m2 (the paged pool:
  ``test_torch_deepseek_engine``);
- ``from_pretrained`` equal to the reference's tree bitwise (sym_int4 and
  bf16), logits within 2.5% of the JAX model's; the low-bit files both
  ways, bitwise; ``build_server`` over the V2 checkpoint; the pool's page
  bytes count K and V at their widths; tensor parallelism refuses MLA
  with the reference's reason.
"""

import asyncio
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import Fp8KVCache as RefFp8KVCache
from ipex_llm_tpu.kv import KVCache as RefKVCache
from ipex_llm_tpu.kv import paged_page_bytes as ref_page_bytes
from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.decoder import _attention_block as ref_attention
from ipex_llm_tpu.models.decoder import _moe_block as ref_moe_block
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops import moe as ref_moe
from ipex_llm_tpu.ops import rope as ref_rope
from ipex_llm_tpu.quantize import quantize as ref_quantize
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.kv import Fp8KVCache, KVCache, paged_page_bytes
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.build import rope_buffers
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import _leaf, params_from_reference
from ipex_llm_tpu_torch.models.decoder import _attention_block, route
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (DEEPSEEK_V2_LITE_HF,
                                                   DEEPSEEK_V3_HF,
                                                   TINY_DEEPSEEK_V2_HF,
                                                   TINY_DEEPSEEK_V3_HF,
                                                   deepseek_hf_shapes,
                                                   deepseek_v2_lite_config,
                                                   deepseek_v3_config,
                                                   random_params)
from ipex_llm_tpu_torch.ops import rope
from ipex_llm_tpu_torch.parallel.manual import ineligible_reason
from ipex_llm_tpu_torch.serving.api_server import build_server
from ipex_llm_tpu_torch.serving.engine import EngineConfig, ServingEngine
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_moe import hf_model_weights
from tests.test_torch_quantize import reference_tree

TINY = {"deepseek_v2": TINY_DEEPSEEK_V2_HF, "deepseek_v3": TINY_DEEPSEEK_V3_HF}
FAMILIES = tuple(TINY)
_CLASSES = {"deepseek_v2": ("DeepseekV2ForCausalLM", "DeepseekV2Config"),
            "deepseek_v3": ("DeepseekV3ForCausalLM", "DeepseekV3Config")}
MLA_ERR = "MLA attention (low-rank q/kv) not manual-sharded yet"
# Token seeds of the logit checks, each the best of seeds 0-29 (dense) or
# 0-39 (paged) by the least lead of the last selected group over the next
# and of the k-th selected expert's score over the next eligible one, at
# any token of either MoE layer (the port's forward over each tiny
# checkpoint at sym_int4; the paged test, in test_torch_deepseek_engine,
# runs the same weights at bf16), noted: a selection flip moves a token's
# FFN output wholesale.  V2's softmax scores (8 experts) lie close.
LOGIT_SEED = {"deepseek_v2": 23,     # margin 3.0e-4
              "deepseek_v3": 29}     # margin 3.2e-2
PAGED_SEED = {"deepseek_v2": 32,     # margin 2.8e-5
              "deepseek_v3": 9}      # margin 6.7e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores (each worker's default pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def write_deepseek_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint of the tiny ``family`` written by its
    ``transformers`` class, weights ``test_torch_moe.hf_model_weights``
    (the router and the V3 score bias drawn wide)."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    transformers = pytest.importorskip("transformers")
    cls, ccls = (getattr(transformers, n) for n in _CLASSES[family])
    hf = {k: v for k, v in TINY[family].items() if k != "model_type"}
    model = cls(ccls(**hf)).to(torch.bfloat16)
    state = model.state_dict()
    # the names and shapes a checkpoint written without the class takes
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        deepseek_hf_shapes(TINY[family])
    model.load_state_dict(hf_model_weights(
        {k: v.shape for k, v in state.items()}, seed), strict=True)
    model.save_pretrained(path, safe_serialization=True)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["model_type"] == family
    return path


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_deepseek_checkpoint(
        str(tmp_path_factory.mktemp(request.param)), request.param)


@pytest.fixture(scope="module")
def models(ckpt):
    """(reference model, port model) in sym_int4 from the checkpoint, the
    reference through its jitted codec (which the port follows)."""
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        ref = RefAutoModelForCausalLM.from_pretrained(
            ckpt, load_in_low_bit="sym_int4")
    finally:
        ref_native.available = old
    port = AutoModelForCausalLM.from_pretrained(
        ckpt, load_in_low_bit="sym_int4", device="cpu")
    return ref, port


# the reference's attention block, compiled whole (one compile a shape,
# cheaper than its ops run one by one)
_ref_attention = jax.jit(ref_attention, static_argnums=(0, 10))


def _port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig.from_fields(dataclasses.asdict(ref_cfg))


# -- configs and rope ---------------------------------------------------------

def test_published_configs_match_reference_family():
    """V2-Lite and V3 from their published fields, as the reference maps
    them: K 192 = 128 + 64 and V 128, one kv head a query head, the rope
    table over the 64-wide rope slice, softmax scaled by 192^-0.5; V2's
    greedy ``topk_method`` takes no groups, ``group_limited_greedy`` does;
    V3's noaux_tc routing."""
    for hf, made in ((DEEPSEEK_V2_LITE_HF, deepseek_v2_lite_config()),
                     (DEEPSEEK_V3_HF, deepseek_v3_config(num_layers=61))):
        ref = ref_get_family(hf["model_type"], hf).to_config(hf)
        port = config_from_hf(hf)
        assert port == _port_cfg(ref) == made
        assert all(port.layer_is_moe(i) == ref.layer_is_moe(i)
                   for i in range(port.num_layers))
        assert (port.head_dim, port.v_dim, port.num_kv_heads,
                port.rope.rotary_dim, port.rope_layout) == (
            192, 128, port.num_heads, 64, "two")
        assert port.is_mla and port.attn_scale == 192 ** -0.5
    v2 = deepseek_v2_lite_config()
    assert (v2.hidden_size, v2.num_layers, v2.num_heads, v2.q_lora_rank,
            v2.kv_lora_rank, v2.num_experts, v2.num_experts_per_tok,
            v2.moe_intermediate_size, v2.num_shared_experts,
            v2.moe_layer_start, v2.intermediate_size, v2.vocab_size,
            v2.moe_n_group) == (2048, 27, 16, None, 512, 64, 6, 1408, 2, 1,
                                10944, 102400, 0)
    v3 = deepseek_v3_config()
    assert (v3.hidden_size, v3.num_layers, v3.num_heads, v3.q_lora_rank,
            v3.num_experts, v3.num_experts_per_tok, v3.moe_n_group,
            v3.moe_topk_group, v3.moe_score_func, v3.moe_group_score,
            v3.moe_score_bias, v3.moe_norm_topk_prob, v3.moe_router_scale,
            v3.moe_layer_start, v3.vocab_size) == (
        7168, 4, 128, 1536, 256, 8, 8, 4, "sigmoid", "top2sum", True, True,
        2.5, 3, 129280)
    grouped = {**DEEPSEEK_V2_LITE_HF, "topk_method": "group_limited_greedy",
               "n_group": 8, "topk_group": 3}
    assert (config_from_hf(grouped).moe_n_group,
            config_from_hf(grouped).moe_topk_group) == (8, 3)
    assert config_from_hf(grouped) == _port_cfg(
        ref_get_family("deepseek_v2", grouped).to_config(grouped))


def test_yarn_scale_mirrors_the_reference():
    """V2-Lite's yarn rope: the table and cos/sin scale are the
    reference's bitwise, ``0.1 ln 40 + 1`` on cos and sin (the reference
    reads neither ``mscale`` nor ``mscale_all_dim``, where HF scales the
    softmax by their ratio squared), and softmax by 192^-0.5 alone."""
    hf = DEEPSEEK_V2_LITE_HF
    ref = ref_get_family("deepseek_v2", hf).to_config(hf)
    port = config_from_hf(hf)
    n = port.max_position_embeddings
    buf = rope_buffers(port, "cpu")
    np.testing.assert_array_equal(buf["inv_freq"].numpy(),
                                  ref.rope.inv_freq(n))
    assert buf["rope_mscale"] == float(ref.rope.mscale(n)) == float(
        0.1 * np.log(40.0) + 1.0)
    assert port.attn_scale == ref.attn_scale == 192 ** -0.5


def test_interleaved_rope_bitwise():
    """The "two" layout rotates the pairs (x[2i], x[2i+1]): bitwise the
    reference's on float64 input and the reference's cos/sin tables (both
    compute in fp32), over a [B, T, 1, 64] k_pe (MLA's shared rope slice;
    q_pe's heads rotate alike, ``test_torch_rope``)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 1, 64))
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    inv = rope.RopeScaling(head_dim=64, kind="yarn", factor=40.0,
                           original_max_position=4096).inv_freq(163840)
    cj, sj = ref_rope.cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    want = np.asarray(ref_rope.apply_rope(jnp.asarray(x, jnp.float32), cj,
                                          sj, "two"))
    # the same tables on both sides: the rotation is what is held
    ct, st = (torch.from_numpy(np.array(a)) for a in (cj, sj))
    got = rope.apply_rope(torch.from_numpy(x), ct, st, "two")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not torch.equal(rope.apply_rope(torch.from_numpy(x), ct, st,
                                           "half"), got)


# -- routing ------------------------------------------------------------------

def _route_case(hf: dict, seed: int):
    """(reference cfg, reference MoE layer, port cfg, port router_bias):
    one random MoE layer of ``hf``'s tiny widths, without a shared expert
    (the capture below stops at the experts)."""
    cfg = dataclasses.replace(
        ref_get_family(hf["model_type"], hf).to_config(hf),
        num_shared_experts=0)
    rng = np.random.default_rng(seed)
    h, e, mi = cfg.hidden_size, cfg.num_experts, cfg.moe_intermediate_size

    def wt(n_in, n_out, s=1.2):
        return (rng.standard_normal((n_in, n_out)) * (s / np.sqrt(n_in))
                ).astype(np.float32)
    lp = {"mlp_norm": jnp.ones((h,), jnp.float32),
          "router": jnp.asarray(wt(h, e, 3.0)),
          "moe_gate_up": ref_quantize(wt(h, 2 * mi), "bf16"),
          "moe_down": ref_quantize(wt(mi, h), "bf16")}
    bias = None
    if cfg.moe_score_bias:
        bias = (0.2 * rng.standard_normal(e)).astype(np.float32)
        lp["router_bias"] = jnp.asarray(bias)
    return cfg, lp, _port_cfg(cfg), bias


@pytest.mark.parametrize("kind", ["v2_greedy", "v2_grouped", "v3"])
def test_route_matches_reference(kind, monkeypatch):
    """The reference's ``_moe_block`` selection and weights (captured at
    its ``moe_ffn`` call) against ``route`` on the same fp32 logits: the
    same experts wherever the k-th selection score leads the (k+1)-th by
    more than 1e-4, weights (the selected scores, renormalised, times the
    routed scaling factor) within 1e-6."""
    hf = {"v2_greedy": {**TINY_DEEPSEEK_V2_HF, "topk_method": "greedy"},
          "v2_grouped": TINY_DEEPSEEK_V2_HF, "v3": TINY_DEEPSEEK_V3_HF}[kind]
    cfg, lp, port_cfg, bias = _route_case(hf, seed=len(kind))
    assert (port_cfg.moe_n_group > 1) == (kind != "v2_greedy")
    seen = {}

    def capture(h, w, idx, *a, **kw):
        seen.update(w=np.asarray(w), idx=np.asarray(idx))
        return jnp.zeros_like(h)
    monkeypatch.setattr(ref_moe, "moe_ffn", capture)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((4, 16, cfg.hidden_size)) * 2,
                    jnp.bfloat16)
    ref_moe_block(cfg, lp, x)
    hn = ref_moe_block.__globals__["_norm"](x, lp["mlp_norm"], cfg)
    logits = np.asarray(jnp.matmul(hn.astype(jnp.float32), lp["router"]))
    w, idx = route(port_cfg, torch.from_numpy(logits),
                   None if bias is None else torch.from_numpy(bias))
    # the selection score's margin at the k-th pick (port side)
    lt = torch.from_numpy(logits)
    sc = torch.sigmoid(lt) if cfg.moe_score_func == "sigmoid" else \
        torch.softmax(lt, -1)
    sel = sc + (0 if bias is None else torch.from_numpy(bias))
    chosen = torch.gather(sel, -1, idx)
    rest = sel.scatter(-1, idx, -1e9)
    margin = (chosen.min(-1).values - rest.max(-1).values).numpy()
    sure = np.abs(margin) > 1e-4
    if kind == "v2_greedy":
        assert (margin > 0).all()
    assert sure.mean() > 0.8
    assert (idx.numpy()[sure] == seen["idx"][sure]).all()
    np.testing.assert_allclose(w.numpy()[sure], seen["w"][sure], rtol=0,
                               atol=1e-6)
    if cfg.moe_router_scale != 1.0:
        np.testing.assert_allclose(w.sum(-1).numpy(), cfg.moe_router_scale,
                                   rtol=1e-6)


def test_route_ties_take_the_lowest_index():
    """Exact ties in the group scores and the expert scores select the
    lowest index first, as ``lax.top_k`` does."""
    cfg = config_from_hf(TINY_DEEPSEEK_V3_HF)
    w, idx = route(cfg, torch.zeros(1, cfg.num_experts))
    # all groups tie: groups 0 and 1 are kept, their experts 0-3 tie
    assert idx[0].tolist() == [0, 1, 2]
    torch.testing.assert_close(w[0], torch.full((3,), 2.5 / 3))


# -- MLA ----------------------------------------------------------------------

def _mla_layer(hf: dict, seed: int):
    """(reference cfg, reference layer params, port cfg, port layer
    params) of one random MLA layer of ``hf``'s tiny widths, sym_int4."""
    cfg = ref_get_family(hf["model_type"], hf).to_config(hf)
    rng = np.random.default_rng(seed)
    h, nh = cfg.hidden_size, cfg.num_heads

    def wt(n_in, n_out):
        return ref_quantize((rng.standard_normal((n_in, n_out))
                             * (1.2 / np.sqrt(n_in))).astype(np.float32),
                            "sym_int4")

    def norm(n):
        return jnp.asarray(1 + 0.05 * rng.standard_normal(n), jnp.float32)
    lp = {"attn_norm": norm(h)}
    if cfg.q_lora_rank is None:
        lp["q"] = wt(h, nh * cfg.head_dim)
    else:
        lp.update(q_a=wt(h, cfg.q_lora_rank), q_a_norm=norm(cfg.q_lora_rank),
                  q_b=wt(cfg.q_lora_rank, nh * cfg.head_dim))
    lp.update(kv_a=wt(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
              kv_a_norm=norm(cfg.kv_lora_rank),
              kv_b=wt(cfg.kv_lora_rank,
                      nh * (cfg.qk_nope_head_dim + cfg.v_dim)),
              o=wt(nh * cfg.v_dim, h))
    port = {k: _leaf(v, "cpu") for k, v in reference_tree(lp).items()}
    return cfg, lp, _port_cfg(cfg), port


@pytest.mark.parametrize("family,storage", [("deepseek_v2", "fp8"),
                                            ("deepseek_v3", "bf16")])
def test_mla_block_dense_matches_reference(family, storage):
    """One MLA layer (V2: full-rank q, over an e5m2 cache; V3: the
    low-rank q, over bf16; the paged pool takes the other pairs in
    ``test_torch_deepseek_engine``) over the dense cache: a prefill of 9
    tokens after 3 filled slots, against the reference's
    ``_attention_block``; the unbalanced cache holds K at 24 and V at 16;
    the output within 2^-6 of its largest value over bf16 (3% over e5m2,
    where a one-ulp bf16 difference before the encode can move a stored
    code a whole step)."""
    cfg, lp, port_cfg, plp = _mla_layer(TINY[family], seed=3)
    b, t, s0, cap = 2, 9, 3, 16
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((b, t, cfg.hidden_size)) * 2).astype(np.float32)
    pos = np.broadcast_to(s0 + np.arange(t, dtype=np.int32), (b, t))
    inv = cfg.rope.inv_freq(cfg.max_position_embeddings)
    mscale = float(cfg.rope.mscale(cfg.max_position_embeddings))
    ref_cls, cls = ((RefKVCache, KVCache) if storage == "bf16"
                    else (RefFp8KVCache, Fp8KVCache))
    ref_cache = ref_cls.init(1, b, cap, cfg.num_kv_heads, cfg.head_dim,
                             v_head_dim=cfg.v_dim)
    cache = cls.init(1, b, cap, cfg.num_kv_heads, cfg.head_dim,
                     v_head_dim=cfg.v_dim, device="cpu")
    assert cache.k.shape[-1] == 24 and cache.v.shape[-1] == 16
    cj, sj = ref_rope.cos_sin(jnp.asarray(pos), jnp.asarray(inv), mscale)
    ct, st = rope.cos_sin(torch.from_numpy(pos.copy()), torch.from_numpy(inv),
                          mscale)
    slots = jnp.asarray(pos)
    kv_len = jnp.full((b,), s0 + t, jnp.int32)
    want, *_ = _ref_attention(cfg, lp, jnp.asarray(x, jnp.bfloat16),
                             ref_cache.k[0], ref_cache.v[0], cj, sj, s0,
                             slots, kv_len, None, False, ref_cache)
    got = _attention_block(port_cfg, plp, torch.from_numpy(x).to(
        torch.bfloat16), cache.k[0], cache.v[0], ct, st, s0,
        torch.from_numpy(pos.copy()), torch.from_numpy(np.array(kv_len)),
        None, False, cache, None)
    want = np.asarray(want.astype(jnp.float32))
    top = np.abs(want).max()
    tol = 2.0 ** -6 if storage == "bf16" else 0.03
    assert np.abs(got.float().numpy() - want).max() <= tol * top


def _paged_steps(cfg, seed: int, r=3, t=20):
    """A ragged prefill (chunks of 20, 7 and 13) and two decode steps of
    tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    chunk = np.array([20, 7, 13], np.int32)
    base = np.zeros(r, np.int32)
    pos = base[:, None] + np.arange(t, dtype=np.int32)[None, :]
    steps = [dict(tokens=rng.integers(0, cfg.vocab_size, (r, t)).astype(
        np.int32), pos=pos, kw=dict(slot_offsets=base, chunk_lens=chunk,
                                    gather_positions=chunk - 1))]
    lens = base + chunk
    for _ in range(2):
        steps.append(dict(
            tokens=rng.integers(0, cfg.vocab_size, (r, 1)).astype(np.int32),
            pos=lens[:, None].copy(),
            kw=dict(slot_offsets=lens.copy(), last_token_only=True)))
        lens = lens + 1
    return steps


# -- the model API ------------------------------------------------------------

def test_from_pretrained_matches_reference(models):
    """The port's tree equals the reference's carried across, bitwise (MLA
    leaves, the fp32 score bias, the dense prefix stack), and the model's
    logits (the dense cache, the whole prompt at once) agree with the JAX
    model's within 2.5% of their range."""
    ref, port = models
    assert port.config == _port_cfg(ref.config)
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    cfg, dense = port.config, port.params["layers_dense"]
    layers = port.params["layers"]
    assert dense["gate_up"].data.shape[0] == 1 and "router" not in dense
    assert layers["moe_gate_up"].data.shape[:2] == (2, cfg.num_experts)
    assert ("q_a" in layers) == (cfg.q_lora_rank is not None)
    assert ("router_bias" in layers) == cfg.moe_score_bias
    if cfg.moe_score_bias:
        assert layers["router_bias"].dtype == torch.float32
    assert port.params["inv_freq"].shape == (cfg.qk_rope_head_dim // 2,)
    tokens = np.random.default_rng(LOGIT_SEED[cfg.model_type]).integers(
        1, 256, (2, 12)).astype(np.int32)
    want = np.asarray(ref(tokens), np.float32)
    got = port(tokens).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 0.025 * (want.max() - want.min())


def test_bf16_tree_matches_reference(ckpt):
    """``load_in_low_bit="bf16"``: the port's tree is the reference's,
    bitwise."""
    ref = RefAutoModelForCausalLM.from_pretrained(ckpt, load_in_low_bit="bf16")
    port = AutoModelForCausalLM.from_pretrained(ckpt, load_in_low_bit="bf16",
                                                device="cpu")
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))


def test_low_bit_files_round_trip_both_ways(ckpt, models, tmp_path):
    """Port save -> port load and -> reference load, reference save -> port
    load: every leaf bitwise, both stacks included."""
    ref, port = models
    want = params_from_reference(reference_tree(ref.params), device="cpu")
    port.save_low_bit(str(tmp_path / "port"))
    again = AutoModelForCausalLM.load_low_bit(str(tmp_path / "port"),
                                              device="cpu")
    assert again.config == port.config
    assert_trees_equal(again.params, port.params)
    params, _, q = ref_serialize.load_low_bit(str(tmp_path / "port"))
    assert q == "sym_int4"
    assert_trees_equal(params_from_reference(reference_tree(params),
                                             device="cpu"), want)
    with open(os.path.join(ckpt, "config.json")) as f:
        hf = json.load(f)
    ref_serialize.save_low_bit(str(tmp_path / "ref"), ref.params, hf,
                               "sym_int4")
    params, hf2, _ = serialize.load_low_bit(str(tmp_path / "ref"),
                                            device="cpu")
    assert hf2 == hf
    assert_trees_equal(params, want)


class _Tok:
    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 256 for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_serves_a_checkpoint(ckpt):
    """``build_server`` over the checkpoint answers a completion."""
    srv = build_server(ckpt, tokenizer=_Tok(), device="cpu",
                       engine_config=EngineConfig(
                           max_rows=2, max_seq_len=128, page_size=16,
                           prefill_bucket=32))
    try:
        resp = asyncio.run(srv.call("POST", "/v1/completions", {
            "prompt": "5 9 12 40 7", "max_tokens": 4, "temperature": 0}))
        assert resp.status == 200
        assert resp.body["usage"]["completion_tokens"] == 4
    finally:
        srv.engine.stop()


# -- the pool and tensor parallelism ------------------------------------------

def test_page_bytes_and_tp_refusal():
    """A page counts K and V at their widths, as the reference's does (at
    V2-Lite's widths over 8 layers: 8 x 16 heads x 16 slots x (192 + 128)
    x 2 bytes); the engine's pool holds V at 128; tensor parallelism
    refuses MLA with the reference's reason, and ``ServingEngine(...,
    tp=2)`` raises it."""
    cfg = deepseek_v2_lite_config(num_layers=8)
    for storage in ("bf16", "fp8"):
        assert paged_page_bytes(8, 16, 16, 192, 128, storage=storage) == \
            ref_page_bytes(8, 16, 16, 192, 128, storage=storage) == \
            8 * 16 * 16 * 320 * (2 if storage == "bf16" else 1)
    assert paged_page_bytes(2, 4, 16, 64) == ref_page_bytes(2, 4, 16, 64)
    tiny = config_from_hf(TINY_DEEPSEEK_V2_HF)
    params = random_params(tiny, "sym_int4", seed=1, device="cpu")
    eng = ServingEngine(tiny, params, EngineConfig(
        max_rows=2, max_seq_len=64, page_size=16, prefill_bucket=32),
        device="cpu")
    assert tuple(eng.cache.k.shape[3:]) == (16, 24)
    assert tuple(eng.cache.v.shape[3:]) == (16, 16)
    assert eng.page_bytes == paged_page_bytes(3, 4, 16, 24, 16)
    assert ineligible_reason(cfg, {}, {"tp": 2}, 128) == MLA_ERR
    with pytest.raises(NotImplementedError, match="MLA attention"):
        ServingEngine(tiny, params, EngineConfig(max_rows=2, max_seq_len=64),
                      device="cpu", tp=types.SimpleNamespace(size=2, rank=0))
