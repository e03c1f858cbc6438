"""The MiniCPM families in the port against the JAX package: minicpm
(llama's block with muP scalings) and minicpm3 (DeepSeek's MLA on a dense
model, the same scalings).

- configs: the published widths (MiniCPM-2B, MiniCPM3-4B) field for field
  the reference family's; a minicpm3 config without ``v_head_dim`` reads
  V at K's width, as the reference reads it (ROADMAP queue 3);
- the reference's own oracles on the port: minicpm with neutral
  scalings against ``transformers``' llama, its analytic scalings (the
  logit scale exactly linear, the embedding and depth scalings moving the
  logits), minicpm3 against ``transformers``' DeepseekV2 (MLA, dense
  layers) with neutral scalings;
- tiny checkpoints under the published names (minicpm: 2 heads of 64, a
  tied head; minicpm3: K 64 + 32, V 64, longrope) through
  ``from_pretrained`` against the reference's load: trees bitwise, logits
  within 2.5% of their range; ``generate()`` greedy token for token; the
  low-bit files both ways; ``optimize_model``; ``build_server`` (the
  decoder's forms and the engine: ``tests/test_torch_minicpm_engine.py``);
- B1, B3 and B4's plain versions at head_dim 64 and at (96, 64) against
  the Pallas kernels interpreted.
"""

import asyncio
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops.pallas.decode_attention import decode_sdpa as ref_decode
from ipex_llm_tpu.ops.pallas.flash_attention import flash_sdpa as ref_flash
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (MINICPM3_4B_HF,
                                                   MINICPM_2B_HF,
                                                   minicpm3_4b_config,
                                                   minicpm3_longrope,
                                                   minicpm_2b_config)
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.optimize import optimize_model
from ipex_llm_tpu_torch.serving.api_server import build_server
from ipex_llm_tpu_torch.serving.engine import EngineConfig
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_families5 import (TOKENS, _mha_llama, _minicpm_config,
                                  _save_synthetic)
from tests.test_torch_attention_dense import _pair, assert_rows_close
from tests.test_torch_families import _close
from tests.test_torch_loader import assert_trees_equal, write_checkpoint
from tests.test_torch_moe import hf_model_weights
from tests.test_torch_ops import _f32, _ragged_case
from tests.test_torch_quantize import reference_tree

# muP scalings far enough from 1 that each moves the logits (scale_depth
# 0.8 over 2 layers: each branch x 0.57)
_SCALINGS = {"scale_emb": 12, "scale_depth": 0.8, "dim_model_base": 32}
TINY_HF = {
    "minicpm": {
        "model_type": "minicpm", "vocab_size": 256, "hidden_size": 128,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "max_position_embeddings": 512, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "hidden_act": "silu",
        "tie_word_embeddings": True, "bos_token_id": 1, "eos_token_id": 2,
        **_SCALINGS},
    "minicpm3": {
        "model_type": "minicpm3", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 64,
        "qk_rope_head_dim": 32, "v_head_dim": 64,
        "max_position_embeddings": 512, "rope_theta": 10000.0,
        "rope_scaling": {**minicpm3_longrope(seed=5),
                         "original_max_position_embeddings": 256},
        "rms_norm_eps": 1e-5, "hidden_act": "silu", "attention_bias": False,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
        **_SCALINGS},
}
FAMILIES = tuple(TINY_HF)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """The published weight names of a MiniCPM config and their ``[out,
    in]`` shapes: llama's for minicpm (no ``lm_head`` when tied),
    DeepSeek's MLA names over a dense MLP for minicpm3."""
    h, f, nh = hf["hidden_size"], hf["intermediate_size"], \
        hf["num_attention_heads"]
    out = {"model.embed_tokens.weight": (hf["vocab_size"], h),
           "model.norm.weight": (h,)}
    if not hf["tie_word_embeddings"]:
        out["lm_head.weight"] = (hf["vocab_size"], h)
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out.update({p + "input_layernorm.weight": (h,),
                    p + "post_attention_layernorm.weight": (h,),
                    p + "mlp.gate_proj.weight": (f, h),
                    p + "mlp.up_proj.weight": (f, h),
                    p + "mlp.down_proj.weight": (h, f)})
        if hf["model_type"] == "minicpm":
            hd = h // nh
            kv = hf["num_key_value_heads"] * hd
            out.update({a + "q_proj.weight": (h, h),
                        a + "k_proj.weight": (kv, h),
                        a + "v_proj.weight": (kv, h),
                        a + "o_proj.weight": (h, h)})
            continue
        nope, rope, v = (hf["qk_nope_head_dim"], hf["qk_rope_head_dim"],
                         hf["v_head_dim"])
        qr, kvr = hf["q_lora_rank"], hf["kv_lora_rank"]
        out.update({a + "q_a_proj.weight": (qr, h),
                    a + "q_a_layernorm.weight": (qr,),
                    a + "q_b_proj.weight": (nh * (nope + rope), qr),
                    a + "kv_a_proj_with_mqa.weight": (kvr + rope, h),
                    a + "kv_a_layernorm.weight": (kvr,),
                    a + "kv_b_proj.weight": (nh * (nope + v), kvr),
                    a + "o_proj.weight": (h, nh * v)})
    return out


def write_minicpm_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint of the tiny ``family`` under the published names,
    weights ``test_torch_moe.hf_model_weights``."""
    hf = TINY_HF[family]
    return write_checkpoint(path, hf, hf_model_weights(hf_shapes(hf), seed),
                            "port")


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_minicpm_checkpoint(
        str(tmp_path_factory.mktemp(request.param)), request.param)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(reference model, port model) of the checkpoint in sym_int4, the
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

@pytest.mark.parametrize("hf,make,widths", [
    (MINICPM_2B_HF, minicpm_2b_config,
     (2304, 5760, 40, 36, 36, 64, 64, 122753)),
    (MINICPM3_4B_HF, minicpm3_4b_config,
     (2560, 6400, 62, 40, 40, 96, 64, 73448))],
    ids=["minicpm-2b", "minicpm3-4b"])
def test_published_config_matches_reference_family(hf, make, widths):
    """Field for field the reference family's config carried across; the
    published widths (hidden, ffn, layers, heads, kv heads, K and V
    widths, vocab) and the scalings: embeddings x 12, each branch x 1.4 /
    sqrt(L), logits x 256 / hidden; MLA's softmax scale 96^-0.5."""
    ref = ref_get_family(hf["model_type"], hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref)) == make()
    assert (port.hidden_size, port.intermediate_size, port.num_layers,
            port.num_heads, port.num_kv_heads, port.head_dim, port.v_dim,
            port.vocab_size) == widths
    assert port.embedding_multiplier == 12.0
    assert port.residual_multiplier == 1.4 / np.sqrt(port.num_layers)
    assert port.logit_scale == 256 / port.hidden_size
    assert port.num_experts == 0
    if port.is_mla:
        assert port.attn_scale == 96 ** -0.5 and port.rope.rotary_dim == 32
        assert port.rope.kind == "longrope" and port.q_lora_rank == 768
    else:
        assert port.tie_word_embeddings and port.attn_scale is None


def test_minicpm3_v_width_without_the_key_mirrors_the_reference():
    """A MiniCPM3 config that names no ``v_head_dim`` (as, to our
    knowledge, the published one does not) reads V at K's width, 96, in
    the reference and so in the port, while MiniCPM3's modeling code takes
    hidden / heads = 64: a real checkpoint's ``kv_b_proj`` (40 x (64 + 64)
    rows) would not fit (ROADMAP queue 3)."""
    hf = {k: v for k, v in MINICPM3_4B_HF.items() if k != "v_head_dim"}
    ref = ref_get_family("minicpm3", hf).to_config(hf)
    port = config_from_hf(hf)
    assert ref.v_dim == port.v_dim == 96 != hf["hidden_size"] // hf[
        "num_attention_heads"]
    assert config_from_hf(MINICPM3_4B_HF).v_dim == 64


# -- the reference's oracles ----------------------------------------------------

def _logits(path: str) -> np.ndarray:
    model = AutoModelForCausalLM.from_pretrained(path, load_in_low_bit="bf16",
                                                 device="cpu")
    return model(TOKENS).numpy()


def test_minicpm_neutral_matches_llama(tmp_path):
    """With neutral scalings (scale_emb 1, scale_depth sqrt(L), base =
    hidden) minicpm is ``transformers``' llama, within the reference
    test's 6%."""
    _, sd, want = _mha_llama(tmp_path, seed=10)
    got = _logits(_save_synthetic(tmp_path, "minicpm", _minicpm_config(), sd))
    assert np.abs(got - want).max() / np.abs(want).max() < 0.06


def test_minicpm_mup_scalings(tmp_path):
    """The logit scale is exactly linear: halving ``dim_model_base`` halves
    every fp32 logit, bitwise; ``scale_emb`` and ``scale_depth`` move the
    logits (the reference's analytic check, held bitwise here)."""
    _, sd, _ = _mha_llama(tmp_path, seed=11)
    base = _logits(_save_synthetic(tmp_path, "m_base", _minicpm_config(), sd))
    halved = _logits(_save_synthetic(
        tmp_path, "m_half", _minicpm_config(dim_model_base=32), sd))
    np.testing.assert_array_equal(halved, 0.5 * base)
    for name, over in (("m_emb", dict(scale_emb=2.0)),
                       ("m_depth", dict(scale_depth=0.5 * np.sqrt(2)))):
        moved = _logits(_save_synthetic(tmp_path, name,
                                        _minicpm_config(**over), sd))
        assert np.isfinite(moved).all()
        assert np.abs(moved - base).max() / np.abs(base).max() > 0.01, name


def test_minicpm3_mla_matches_deepseek(tmp_path):
    """minicpm3 with neutral scalings over ``transformers``'
    DeepseekV2ForCausalLM's tensors (MLA, no routed experts): its logits,
    within the reference test's 6%."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.DeepseekV2Config(
        vocab_size=150, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=None,
        first_k_dense_replace=99, max_position_embeddings=256,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(12)
    hf = transformers.DeepseekV2ForCausalLM(cfg).eval()
    sd = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    with torch.no_grad():
        want = hf(torch.from_numpy(TOKENS).long()).logits.float().numpy()
    config = {
        "model_type": "minicpm3", "vocab_size": 150, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 256,
        "q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16,
        "scale_emb": 1.0, "scale_depth": float(np.sqrt(2)),
        "dim_model_base": 64}
    got = _logits(_save_synthetic(tmp_path, "minicpm3", config, sd))
    assert np.abs(got - want).max() / np.abs(want).max() < 0.06


# -- B1, B3 and B4's plain versions at 64 and (96, 64) -------------------------

@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
@pytest.mark.parametrize("d,dv", [(64, 64), (96, 64)])
def test_ragged_plain_matches_pallas(pool, d, dv):
    """B1's plain version on the row mix of ``tests/test_torch_ops.py`` at
    (K, V) widths (64, 64) and (96, 64) against the Pallas kernel
    interpreted: valid queries within one bf16 ulp of the row's largest
    output, idle rows exact zeros."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, d=d)
    if dv != d:      # V of its own width: the first dv columns of K's draw
        jax_args = (jax_args[0], jax_args[1], jax_args[2][..., :dv],
                    *jax_args[3:])
        torch_args = (torch_args[0], torch_args[1],
                      torch_args[2][..., :dv].contiguous(), *torch_args[3:])
    want = _f32(ref_ragged(*jax_args, scale=d ** -0.5))
    b1.COUNTS.reset()
    got = _f32(b1.ragged_paged_sdpa(*torch_args, scale=d ** -0.5))
    assert b1.COUNTS.plain_calls == 1 and b1.COUNTS.launches == 0
    assert got.shape[-1] == dv
    for i, n in enumerate(chunk):
        if n == 0:
            assert not got[i].any() and not want[i].any()
            continue
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0,
                                   atol=2.0 ** -7 * np.abs(want[i, :n]).max())


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("d,dv,g", [(64, 64, 1), (64, 64, 4), (96, 64, 1)])
def test_decode_plain_matches_pallas(storage, d, dv, g):
    """B3's plain version at (64, 64) (G = 1, MiniCPM-2B's, and 4,
    Llama-3.2-1B's) and (96, 64) (MiniCPM3's) over left padding and a
    window that cuts, against the Pallas kernel interpreted, within 2^-7
    of each row's largest output; the row that sees no key gives 0."""
    rng = np.random.default_rng(64 + d + g)
    b, s, hkv = 3, 160, 2
    q_t, q_j = _pair(rng, (b, 1, hkv * g, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, dv), storage)
    kv_len = np.array([150, 160, 70], np.int32)
    kv_start = np.array([0, 137, 70], np.int32)
    b3.COUNTS.reset()
    got = b3.decode_sdpa(q_t, k_t, v_t, kv_len=torch.from_numpy(kv_len),
                         kv_start=torch.from_numpy(kv_start), window=48)
    assert b3.COUNTS.plain_calls == 1 and b3.COUNTS.launches == 0
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), window=48)
    assert got.shape[-1] == dv and not got[2].float().any()
    assert_rows_close(got, want, what=f"B3 {storage} ({d}, {dv})")


@pytest.mark.parametrize("d,dv", [(64, 64), (96, 64)])
def test_flash_plain_matches_pallas(d, dv):
    """B4's plain version at (64, 64) and (96, 64) over left-padded rows
    with a window that cuts, against the Pallas kernel interpreted, within
    2^-7 of each row's largest output."""
    rng = np.random.default_rng(d + dv)
    b, t, s, hq, hkv = 2, 72, 96, 2, 2
    q_t, q_j = _pair(rng, (b, t, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d))
    v_t, v_j = _pair(rng, (b, hkv, s, dv))
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    kw = dict(causal=True, kv_len=np.full((b,), t, np.int32),
              kv_start=np.array([0, 30], np.int32), window=24)
    b4.COUNTS.reset()
    got = b4.flash_sdpa(q_t, k_t.transpose(1, 2), v_t.transpose(1, 2),
                        q_positions=torch.from_numpy(pos),
                        **{k: torch.from_numpy(v) if isinstance(
                            v, np.ndarray) else v for k, v in kw.items()})
    assert b4.COUNTS.plain_calls == 1 and b4.COUNTS.launches == 0
    want = ref_flash(q_j, k_j.transpose(0, 2, 1, 3), v_j.transpose(0, 2, 1, 3),
                     q_positions=jnp.asarray(pos),
                     **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                        for k, v in kw.items()})
    assert got.shape[-1] == dv
    assert_rows_close(got, want, what=f"B4 ({d}, {dv})")


# -- loading, logits, generate -------------------------------------------------

def test_from_pretrained_matches_reference(loaded):
    """The trees bitwise (minicpm's tied head: no ``lm_head`` leaf;
    minicpm3's MLA leaves over dense layers, no expert or prefix stack),
    and the full-sequence logits of a 40-id prompt within 2.5% of their
    largest value."""
    ref, port = loaded
    assert port.config == ModelConfig.from_fields(
        dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers = port.params["layers"]
    assert "layers_dense" not in port.params and "router" not in layers
    assert ("kv_b" in layers) == port.config.is_mla
    assert ("lm_head" in port.params) == (
        not port.config.tie_word_embeddings)
    ids = np.random.default_rng(3).integers(1, 256, (2, 40))
    _close(port(ids), np.asarray(ref(ids), np.float32), "bf16",
           "full-sequence logits")


# prompt seeds of the greedy check, the first tried unless noted; the token
# check itself is exact
GREEDY_SEEDS = {"minicpm": 0, "minicpm3": 0}
PROMPT_LENS = (40, 9, 27)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    width = max(PROMPT_LENS)
    ids = np.zeros((len(PROMPT_LENS), width), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(PROMPT_LENS):
        ids[i, width - n:] = rng.integers(3, 256, n)
        mask[i, width - n:] = 1
    return ids, mask


def test_generate_greedy_matches_reference(loaded):
    """Greedy ``generate()`` of both models over a ragged left-padded batch
    (prompts of 40, 9 and 27 ids; B4 prefills and B3 decodes, at (64, 64)
    for minicpm and (96, 64) for minicpm3), token for token."""
    ref, port = loaded
    ids, mask = _batch(GREEDY_SEEDS[port.config.model_type])
    kw = dict(attention_mask=mask, max_new_tokens=6, do_sample=False)
    b4.COUNTS.reset()
    b3.COUNTS.reset()
    got = np.asarray(port.generate(ids, **kw))
    assert b4.COUNTS.plain_calls == b3.COUNTS.plain_calls // 5 == 2
    np.testing.assert_array_equal(got, np.asarray(ref.generate(ids, **kw)))


# -- the entry points ------------------------------------------------------------

def test_low_bit_files_round_trip_both_ways(ckpt, loaded, tmp_path):
    """Port save -> port load and -> reference load, reference save -> port
    load: every leaf bitwise."""
    ref, port = loaded
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


class _HF:
    """A loaded HF model's surface ``optimize_model`` reads (MiniCPM's
    modeling code is not in ``transformers``)."""

    def __init__(self, hf: dict, tensors: dict):
        self.config = type("Cfg", (), {"to_dict": lambda _: dict(hf)})()
        self._state = tensors

    def state_dict(self):
        return self._state


@pytest.mark.parametrize("family", FAMILIES)
def test_optimize_model_takes_a_loaded_model(family, tmp_path):
    """``optimize_model`` over a loaded model's config and state dict
    builds the tree ``from_pretrained`` builds from the same weights
    saved, bitwise."""
    hf = TINY_HF[family]
    tensors = hf_model_weights(hf_shapes(hf), 2)
    got = optimize_model(_HF(hf, tensors), low_bit="sym_int4", device="cpu")
    want = AutoModelForCausalLM.from_pretrained(
        write_checkpoint(str(tmp_path), hf, tensors, "port"),
        load_in_low_bit="sym_int4", device="cpu")
    assert got.config == want.config
    assert_trees_equal(got.params, want.params)


class _Tok:
    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 256 for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_serves_a_checkpoint(ckpt):
    """``build_server`` over each tiny checkpoint answers a completion."""
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
