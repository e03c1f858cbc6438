"""Mixture-of-experts serving and qwen3's q/k norms in the port against
the JAX package.

Tiny checkpoints (2 layers, hidden 64, vocab 256; random weights from a
numpy seed) are written by ``transformers``' own model classes, so the
weight names are the published ones: Mixtral (8 experts, top 2),
Qwen2-MoE (8 experts, top 4, a shared expert behind its sigmoid gate, a
qkv bias), Qwen3-MoE (8 experts, top 4, renormalised, per-head q/k norms,
a q width of 128 against the hidden 64) and dense Qwen3.

- ``ops.moe.moe_ffn`` on both routes (the gather route at 32 pairs or
  fewer, the ragged route above) against the JAX ``ops/moe.py`` on the
  same inputs, in sym_int4, bf16 and the 5-bit and 128-row-block formats
  (K padding inside a stack), within 2^-7 of each row's largest output,
  and the dense all-experts scan against both routes;
- the MoE block (norm, fp32 router, top-k, experts, shared expert)
  against the reference's ``_moe_block`` for the mixtral and qwen routers,
  with the selected experts equal where the router margins allow; ties go
  to the lowest expert index;
- configs from the published ``config.json`` fields; ``from_pretrained``
  equal to the reference's tree bitwise, logits within 2.5% of their range
  against the JAX model from the same directory; ``optimize_model`` over
  the ``transformers`` model bitwise ``from_pretrained``; the low-bit
  files both ways, bitwise; ``build_server`` over a tiny Mixtral.
"""

import asyncio
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.build import stack_layer_trees as ref_stack
from ipex_llm_tpu.models.decoder import _moe_block as ref_moe_block
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops import moe as ref_moe
from ipex_llm_tpu.quantize import quantize as ref_quantize
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import _leaf, params_from_reference
from ipex_llm_tpu_torch.models.decoder import _moe_block, route
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (MIXTRAL_8X7B_HF,
                                                   QWEN3_8B_HF,
                                                   QWEN3_30B_A3B_HF,
                                                   QWEN15_MOE_A27B_HF,
                                                   mixtral_8x7b_config,
                                                   qwen3_30b_a3b_config)
from ipex_llm_tpu_torch.ops import moe
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.optimize import optimize_model
from ipex_llm_tpu_torch.serving.api_server import build_server
from ipex_llm_tpu_torch.serving.engine import EngineConfig
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_quantize import reference_tree

PUBLISHED = {"mixtral": MIXTRAL_8X7B_HF, "qwen3_moe": QWEN3_30B_A3B_HF,
             "qwen2_moe": QWEN15_MOE_A27B_HF, "qwen3": QWEN3_8B_HF}

_COMMON = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512, rms_norm_eps=1e-6,
               rope_theta=1000000.0, hidden_act="silu",
               tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)
TINY_HF = {
    "mixtral": dict(_COMMON, model_type="mixtral", intermediate_size=96,
                    num_local_experts=8, num_experts_per_tok=2,
                    sliding_window=None),
    "qwen2_moe": dict(_COMMON, model_type="qwen2_moe", intermediate_size=96,
                      moe_intermediate_size=48,
                      shared_expert_intermediate_size=96, num_experts=8,
                      num_experts_per_tok=4, norm_topk_prob=False,
                      decoder_sparse_step=1, mlp_only_layers=[],
                      use_sliding_window=False),
    "qwen3_moe": dict(_COMMON, model_type="qwen3_moe", intermediate_size=96,
                      moe_intermediate_size=48, head_dim=32, num_experts=8,
                      num_experts_per_tok=4, norm_topk_prob=True,
                      decoder_sparse_step=1, mlp_only_layers=[],
                      use_sliding_window=False),
    "qwen3": dict(_COMMON, model_type="qwen3", intermediate_size=160,
                  head_dim=32, use_sliding_window=False),
}
FAMILIES = tuple(TINY_HF)
_CLASSES = {"mixtral": ("MixtralForCausalLM", "MixtralConfig"),
            "qwen2_moe": ("Qwen2MoeForCausalLM", "Qwen2MoeConfig"),
            "qwen3_moe": ("Qwen3MoeForCausalLM", "Qwen3MoeConfig"),
            "qwen3": ("Qwen3ForCausalLM", "Qwen3Config")}


def hf_model_weights(shapes: dict, seed: int) -> dict[str, torch.Tensor]:
    """bf16 weights for an HF state dict's names and shapes from a numpy
    seed: norms ``1 + 0.05 N``, biases ``0.5 N``, routers (``gate``,
    ``shared_expert_gate``) ``3 N / sqrt(fan_in)`` (wide router margins),
    every other weight ``1.2 N / sqrt(fan_in)``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        if "norm" in name:
            w = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith(".bias"):
            w = 0.5 * rng.standard_normal(shape)
        elif name.endswith((".gate.weight", "shared_expert_gate.weight")):
            w = rng.standard_normal(shape) * (3.0 / np.sqrt(shape[-1]))
        else:
            w = rng.standard_normal(shape) * (1.2 / np.sqrt(shape[-1]))
        out[name] = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    return out


def write_moe_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint of the tiny ``family`` written by its
    ``transformers`` class (``save_pretrained``), weights
    :func:`hf_model_weights`."""
    # the model classes import TensorFlow where it is installed unless
    # told the backend is torch
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    transformers = pytest.importorskip("transformers")
    cls, ccls = (getattr(transformers, n) for n in _CLASSES[family])
    model = cls(ccls(**TINY_HF[family])).to(torch.bfloat16)
    state = model.state_dict()
    model.load_state_dict(hf_model_weights(
        {k: v.shape for k, v in state.items()}, seed), strict=True)
    model.save_pretrained(path, safe_serialization=True)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["model_type"] == family
    return path


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_moe_checkpoint(
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


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_published_config_matches_reference_family(family):
    hf = PUBLISHED[family]
    ref = ref_get_family(family, hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref))
    assert all(port.layer_is_moe(i) == ref.layer_is_moe(i)
               for i in range(port.num_layers))
    if family == "mixtral":
        assert port == mixtral_8x7b_config()
        assert (port.hidden_size, port.num_layers, port.num_heads,
                port.num_kv_heads, port.head_dim, port.num_experts,
                port.num_experts_per_tok, port.moe_intermediate_size,
                port.vocab_size, port.rope.base, port.norm_eps) == (
            4096, 32, 32, 8, 128, 8, 2, 14336, 32000, 1e6, 1e-5)
        assert port.sliding_window is None
        assert not port.moe_softmax_before_topk
    if family == "qwen3_moe":
        assert port == qwen3_30b_a3b_config()
        assert (port.hidden_size, port.num_layers, port.num_heads,
                port.num_kv_heads, port.q_dim, port.num_experts,
                port.num_experts_per_tok, port.moe_intermediate_size,
                port.vocab_size) == (2048, 48, 32, 4, 4096, 128, 8, 768,
                                     151936)
        assert port.qk_norm and port.moe_norm_topk_prob
    if family == "qwen2_moe":
        assert (port.num_experts, port.num_experts_per_tok,
                port.num_shared_experts, port.attention_bias) == (
            60, 4, 1, True)
        assert port.moe_shared_expert_gate and not port.moe_norm_topk_prob


def test_config_refuses_what_is_not_ported():
    """DeepSeek's routing fields and dense prefix layers are in the slice
    since the deepseek families, ungated and biased experts since phixtral;
    a field of a family still to port (learned positions, alibi) raises
    naming item 14; a score function or group score the reference does not
    know raises; an MoE config without its top-k, or groups that do not
    divide the experts, is invalid; ``from_fields`` no longer skips
    unknown ``moe_*`` fields."""
    fields = dataclasses.asdict(mixtral_8x7b_config())
    for over in ({"moe_n_group": 4, "moe_topk_group": 2},
                 {"moe_score_func": "sigmoid"}, {"moe_group_score": "top2sum"},
                 {"moe_score_bias": True}, {"moe_layer_start": 1},
                 {"num_shared_experts": 2}, {"moe_router_scale": 2.5},
                 {"mlp_gated": False}, {"mlp_bias": True}):
        assert ModelConfig.from_fields({**fields, **over})
    for over in ({"learned_pos": 2048}, {"alibi": True}):
        with pytest.raises(NotImplementedError, match="item 14"):
            ModelConfig.from_fields({**fields, **over})
    for over in ({"moe_score_func": "sqrtsoftplus"},
                 {"moe_group_score": "mean"}):
        with pytest.raises(NotImplementedError):
            ModelConfig.from_fields({**fields, **over})
    for over in ({"moe_n_group": 3, "moe_topk_group": 1},
                 {"moe_n_group": 4, "moe_topk_group": 5}):
        with pytest.raises(ValueError):
            ModelConfig.from_fields({**fields, **over})
    with pytest.raises(NotImplementedError, match="unknown"):
        ModelConfig.from_fields({**fields, "moe_capacity_factor": 2.0})
    with pytest.raises(ValueError):
        ModelConfig.from_fields({**fields, "num_experts_per_tok": 0})


# -- the dispatch -------------------------------------------------------------

E, H, I = 8, 64, 48      # experts, hidden, expert width (K = 48 pads in
#                          the 64- and 128-row-block formats)


@pytest.fixture(scope="module", params=["sym_int4", "bf16", "asym_int5",
                                        "fp8_e4m3"])
def stacks(request):
    """(reference gate_up, down stacks, port stacks) quantized by the
    reference's jitted codec from one numpy seed, carried across."""
    rng = np.random.default_rng(3)
    gu = ref_stack([ref_quantize(rng.standard_normal((H, 2 * I)).astype(
        np.float32) * (1.2 / np.sqrt(H)), request.param) for _ in range(E)])
    dn = ref_stack([ref_quantize(rng.standard_normal((I, H)).astype(
        np.float32) * (1.2 / np.sqrt(I)), request.param) for _ in range(E)])
    return gu, dn, _leaf(reference_tree(gu), "cpu"), \
        _leaf(reference_tree(dn), "cpu")


def _routing(b, t, k, seed):
    """h [b, t, H], softmax-of-top-k weights and distinct expert ids."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, t, H)).astype(np.float32)
    logits = rng.standard_normal((b, t, E)).astype(np.float32)
    idx = np.argsort(-logits, -1, kind="stable")[..., :k].astype(np.int32)
    w = np.exp(np.take_along_axis(logits, idx, -1))
    return h, (w / w.sum(-1, keepdims=True)).astype(np.float32), idx


# the reference's dispatch and block, compiled whole (one compile a shape,
# cheaper than their ops run one by one)
_ref_moe_ffn = jax.jit(lambda h, w, idx, gu, dn: ref_moe.moe_ffn(
    h, w, idx, gu, dn, "silu", E))
_ref_moe_block = jax.jit(ref_moe_block, static_argnums=0)


def _close_rows(got: np.ndarray, want: np.ndarray, tol: float):
    top = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= tol * top).all(), \
        float((np.abs(got - want) / top).max())


@pytest.mark.parametrize("b,t,k", [(2, 1, 2), (4, 4, 2), (3, 1, 8),
                                   (2, 9, 2), (3, 8, 4)],
                         ids=["gather16", "gather32", "gather24",
                              "ragged36", "ragged96"])
def test_moe_ffn_matches_reference(stacks, b, t, k):
    """Both routes against the JAX dispatch on the same inputs (the route
    is picked by the static pair count b * t * k), within 2^-7 of each
    row's largest output; the dense all-experts scan agrees with either
    route within the reference's own sparse-vs-dense bound (2e-2).  The
    gather route is held against the reference's ops run one by one, whose
    bf16 sum of a token's pair outputs it mirrors (compiled, XLA sums them
    wider: up to 1% of a row apart), the ragged route against it
    compiled."""
    gu, dn, pgu, pdn = stacks
    h, w, idx = _routing(b, t, k, seed=b * 100 + t * 10 + k)
    ref_ffn = (_ref_moe_ffn if b * t * k > moe.GATHER_PAIR_LIMIT else
               lambda *a: ref_moe.moe_ffn(*a, "silu", E))
    want = np.asarray(ref_ffn(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w), jnp.asarray(idx), gu,
        dn).astype(jnp.float32))
    args = (torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(idx), pgu, pdn, "silu", E)
    got = moe.moe_ffn(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, H)
    _close_rows(got.float().numpy(), want, 2.0 ** -7)
    dense = moe.moe_dense(*args).float().numpy()
    _close_rows(dense, want, 2e-2)
    # a rerun is bitwise the first (fixed sum orders, no atomics)
    assert torch.equal(moe.moe_ffn(*args), got)


def _block_case(family: str, seed: int):
    """(reference cfg, reference layer params, port cfg, port layer
    params) of one random MoE layer of the tiny ``family``, in sym_int4."""
    hf = TINY_HF[family]
    cfg = ref_get_family(family, hf).to_config(hf)
    rng = np.random.default_rng(seed)
    mi, n_e = cfg.moe_intermediate_size, cfg.num_experts

    def wt(n_in, n_out, s=1.2):
        return (rng.standard_normal((n_in, n_out)) * (s / np.sqrt(n_in))
                ).astype(np.float32)
    lp = {"mlp_norm": jnp.asarray(1 + 0.05 * rng.standard_normal(H),
                                  jnp.float32),
          "router": jnp.asarray(wt(H, n_e, 3.0)),
          "moe_gate_up": ref_stack([ref_quantize(wt(H, 2 * mi), "sym_int4")
                                    for _ in range(n_e)]),
          "moe_down": ref_stack([ref_quantize(wt(mi, H), "sym_int4")
                                 for _ in range(n_e)])}
    if cfg.num_shared_experts:
        lp["shared_gate_up"] = ref_quantize(wt(H, 192), "sym_int4")
        lp["shared_down"] = ref_quantize(wt(96, H), "sym_int4")
        lp["shared_router"] = jnp.asarray(wt(H, 1, 3.0))
    port = {k: _leaf(v, "cpu") for k, v in reference_tree(lp).items()}
    return cfg, lp, ModelConfig.from_fields(dataclasses.asdict(cfg)), port


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe", "qwen3_moe"])
@pytest.mark.parametrize("t", [1, 12], ids=["gather", "ragged"])
def test_moe_block_matches_reference(family, t):
    """The whole block (norm, fp32 router, the family's top-k rule, the
    experts, qwen2_moe's gated shared expert) against the reference's
    ``_moe_block`` within 2^-7 of each row's largest output, and the
    selected experts equal wherever the k-th router logit leads the
    (k+1)-th by more than 0.01 (fp32 product orders differ by far less)."""
    cfg, lp, port_cfg, port_lp = _block_case(family, seed=len(family) + t)
    rng = np.random.default_rng(t)
    x = (rng.standard_normal((3, t, H)) * 2).astype(np.float32)
    want = np.asarray(_ref_moe_block(cfg, lp, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _moe_block(port_cfg, port_lp, xt, moe.dispatch())
    assert got.dtype == torch.bfloat16
    _close_rows(got.float().numpy(), want, 2.0 ** -7)
    # the selection: the port's route against the reference's rule on the
    # reference's own logits
    hf32 = np.asarray(ref_moe_block.__globals__["_norm"](
        jnp.asarray(x, jnp.bfloat16), lp["mlp_norm"], cfg).astype(
            jnp.float32))
    logits = hf32 @ np.asarray(lp["router"])
    k = cfg.num_experts_per_tok
    _, idx = route(port_cfg, torch.from_numpy(logits))
    srt = -np.sort(-logits, -1)
    sure = (srt[..., k - 1] - srt[..., k]) > 0.01
    assert sure.mean() > 0.7
    want_idx = np.argsort(-logits, -1, kind="stable")[..., :k]
    assert (np.sort(idx.numpy()[sure], -1) == np.sort(want_idx[sure], -1)
            ).all()


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_dense_switch_runs_the_scan(family, monkeypatch):
    """``IPEX_LLM_TPU_DENSE_MOE=1`` sends the block through the
    all-experts scan (B2 per expert, no expert-grouped product), in the
    port and the reference alike: within 2^-7 of each row's largest
    output."""
    cfg, lp, port_cfg, port_lp = _block_case(family, seed=9)
    x = (np.random.default_rng(9).standard_normal((2, 3, H)) * 2).astype(
        np.float32)
    monkeypatch.setenv("IPEX_LLM_TPU_DENSE_MOE", "1")
    assert not moe.use_sparse() and moe.dispatch() is moe.moe_dense
    want = np.asarray(ref_moe_block(cfg, lp, jnp.asarray(
        x, jnp.bfloat16)).astype(jnp.float32))
    before = b2e.COUNTS.plain_calls
    got = _moe_block(port_cfg, port_lp, torch.from_numpy(x).to(
        torch.bfloat16), moe.dispatch())
    assert b2e.COUNTS.plain_calls == before
    _close_rows(got.float().numpy(), want, 2.0 ** -7)


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe", "qwen3_moe"])
def test_route_ties_take_the_lowest_index(family):
    """Exact ties in the router logits select the lowest expert index
    first, as ``lax.top_k`` does."""
    hf = TINY_HF[family]
    cfg = ModelConfig.from_fields(dataclasses.asdict(
        ref_get_family(family, hf).to_config(hf)))
    k = cfg.num_experts_per_tok
    logits = torch.zeros(2, cfg.num_experts)
    logits[0, 5] = 1.0                    # one clear winner, then ties
    w, idx = route(cfg, logits)
    assert idx[0].tolist() == [5] + list(range(k - 1))
    assert idx[1].tolist() == list(range(k))
    torch.testing.assert_close(w[1], torch.full((k,), w[1, 0].item()))


# -- the model API ------------------------------------------------------------

# Token seeds of the logit checks, each the best of seeds 0-59 by the least
# lead of the k-th router logit over the (k+1)-th at any token of any layer
# (the port's forward over the tiny checkpoint), noted: a selection flip
# moves a token's FFN output wholesale, so the seeds keep the margins far
# past the two sides' rounding differences.
LOGIT_SEEDS = {"mixtral": 3,        # margin 0.19
               "qwen2_moe": 12,     # margin 0.16
               "qwen3_moe": 51,     # margin 0.12
               "qwen3": 5}          # no router

def test_from_pretrained_matches_reference(models):
    """The port's tree equals the reference's carried across, bitwise
    (router fp32 [H, E], [L, E, ...] expert stacks, the shared expert and
    its gate, q/k norms), and the model's logits over a ragged batch agree
    with the JAX model's within 2.5% of their range."""
    ref, port = models
    assert port.config == ModelConfig.from_fields(
        dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers, cfg = port.params["layers"], port.config
    if cfg.num_experts:
        assert layers["router"].dtype == torch.float32
        assert layers["router"].shape == (2, cfg.hidden_size,
                                          cfg.num_experts)
        assert layers["moe_gate_up"].data.shape[:2] == (2, cfg.num_experts)
        assert "gate_up" not in layers
    assert ("q_norm" in layers) == cfg.qk_norm
    if cfg.qk_norm:
        assert layers["q_norm"].shape == (2, cfg.head_dim)
    tokens = np.random.default_rng(LOGIT_SEEDS[cfg.model_type]).integers(
        1, 256, (2, 12)).astype(np.int32)
    want = np.asarray(ref(tokens), np.float32)
    got = port(tokens).numpy()
    assert got.shape == want.shape
    span = want.max() - want.min()
    assert np.abs(got - want).max() <= 0.025 * span
    assert np.isfinite(got).all()


def test_optimize_model_matches_from_pretrained(ckpt, models):
    """``optimize_model`` over the loaded ``transformers`` model builds the
    tree ``from_pretrained`` builds from its checkpoint, bitwise."""
    transformers = pytest.importorskip("transformers")
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        ckpt, torch_dtype=torch.bfloat16)
    got = optimize_model(hf, "sym_int4", device="cpu")
    assert got.config == models[1].config
    assert_trees_equal(got.params, models[1].params)


def test_bf16_stacks_from_pretrained_match_reference(tmp_path):
    """``load_in_low_bit="bf16"``: bf16 expert stacks through the ragged
    route's plain form (two rows of 12 ids: 96 pairs; the gather route's
    bf16 form is held in ``test_moe_ffn_matches_reference``), logits
    within 2.5% of the JAX model's."""
    d = write_moe_checkpoint(str(tmp_path), "qwen2_moe")
    ref = RefAutoModelForCausalLM.from_pretrained(d, load_in_low_bit="bf16")
    port = AutoModelForCausalLM.from_pretrained(d, load_in_low_bit="bf16",
                                                device="cpu")
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    tokens = np.random.default_rng(LOGIT_SEEDS["qwen2_moe"]).integers(
        1, 256, (2, 12)).astype(np.int32)
    want = np.asarray(ref(tokens), np.float32)
    got = port(tokens).numpy()
    assert np.abs(got - want).max() <= 0.025 * (want.max() - want.min())


def test_low_bit_files_round_trip_both_ways(ckpt, models, tmp_path):
    """Port save -> port load and -> reference load, reference save -> port
    load: every leaf bitwise, the expert stacks included."""
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
        return {"input_ids": [int(w) % 256 if w.isdigit() else 0
                              for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_over_a_tiny_mixtral(tmp_path):
    """``build_server`` loads a Mixtral checkpoint, serves a completion
    through the MoE engine, and reports the expert bytes in its weights."""
    d = write_moe_checkpoint(str(tmp_path), "mixtral", seed=4)
    srv = build_server(d, tokenizer=_Tok(), device="cpu",
                       engine_config=EngineConfig(
                           max_rows=2, max_seq_len=128, page_size=16,
                           prefill_bucket=16))
    try:
        out = asyncio.run(srv.call("POST", "/v1/completions", {
            "prompt": "5 9 12 40 7", "max_tokens": 5}))
        assert out.status == 200, out.body
        assert out.body["usage"]["completion_tokens"] == 5
        weights = srv.engine.weight_stats()
        layers = srv.engine.params["layers"]
        assert weights["weight_bytes"] >= layers["moe_gate_up"].nbytes + \
            layers["moe_down"].nbytes
        assert weights["packed_qtypes"] == ["sym_int4"]
    finally:
        srv.engine.stop()


# -- B2e's launch plan --------------------------------------------------------

def _slot_tiles(counts, tile, n_slots):
    """What each block of the kernel finds (csrc/qmatmul_experts.cu): slot
    s is the s-th row tile in expert order, (expert, first row, segment
    end), or None past the last tile."""
    seg = np.concatenate([[0], np.cumsum(counts)])
    tiles = [(e, lo, seg[e + 1]) for e in range(len(counts))
             for lo in range(seg[e], seg[e + 1], tile)]
    return [tiles[s] if s < len(tiles) else None for s in range(n_slots)]


@pytest.mark.parametrize("counts", [(0, 1, 7, 8, 9, 130), (5,) + (0,) * 127,
                                    (300, 0, 140, 1, 0, 9), (1,) * 64,
                                    (0, 0, 0)])
def test_b2e_grid_covers_every_row_once(counts):
    """The tiled instance's row tile follows the mean rows an expert; the
    grid's ``ceil(P / tile) + E`` slots cover every row tile of any split
    of P rows, and the tiles cover each row once, within its expert."""
    p, e = sum(counts), len(counts)
    tile = b2e.tile_rows(p, e)
    assert tile == (16 if -(-p // e) <= 16 else 64)
    n_slots = b2e.slots(p, e, tile)
    got = _slot_tiles(counts, tile, n_slots)
    assert sum(-(-c // tile) for c in counts) <= n_slots
    seen = np.zeros(p, int)
    seg = np.concatenate([[0], np.cumsum(counts)])
    for t in got:
        if t is not None:
            ex, lo, hi = t
            rows = np.arange(lo, min(lo + tile, hi))
            assert seg[ex] <= lo < hi == seg[ex + 1]
            seen[rows] += 1
    assert (seen == 1).all()
    ids = torch.repeat_interleave(torch.arange(e), torch.tensor(counts))
    assert b2e.segments(ids, e).tolist() == seg.tolist()
    srt = torch.sort(ids[torch.randperm(p)].int(), stable=True).values
    assert b2e.segments(srt, e).tolist() == seg.tolist()
