"""The GPT-style families (phi, phixtral, gpt_neox, gptj) in the port
against the JAX package.

Tiny checkpoints (2 layers, vocab 256, random weights from a numpy seed)
hold the published weight names: phi (Phi-2: 2 heads of 80, 32 of whose
columns rotate), gpt_neox (Pythia: 4 heads of 16, a quarter rotating, the
per-head interleaved ``query_key_value``, the parallel residual off two
LayerNorms) and gptj (2 heads of 32, 8 columns rotating in the
interleaved layout, no bias on q/k/v/o) are written by ``transformers``'
own model classes; phixtral (2 heads of 80, four ungated experts with
biases, two a token) is written with numpy under the msft names
(``transformer.h.{i}.mixer.Wqkv``, ``moe.mlp.{e}.fc1``, ``lm_head.ln``,
``lm_head.linear``), since ``transformers`` has no class for it.

Held here:

- the published Phi-2, phixtral-4x2_8, Pythia-6.9B and GPT-J-6B configs
  through the port's families equal the reference family's config carried
  across, field for field;
- ``layer_norm``, ``act`` and the ungated, biased ``moe_gather`` and
  ``moe_ragged`` against the JAX functions;
- B1's, B3's and B4's plain versions at head_dim 80 against the Pallas
  kernels in the interpreter;
- ``from_pretrained`` (sym_int4) of each package over the same
  checkpoint: the trees bitwise, every bias included (phixtral's
  ``ln.bias``, which the reference's MoE block leaves unread, too); the
  full-sequence logits within 2.5% of their largest value, and greedy
  ``generate()`` token for token (margin-chosen prompt seeds);
- the paged decoder against the JAX ``decoder_forward`` over the
  reference's tree carried across; the parallel residual, the head's bias
  and the LayerNorms' biases each move the logits when taken away;
- ``save_low_bit``/``load_low_bit`` both ways between the packages,
  ``optimize_model`` of a loaded ``transformers`` model, and one request
  through ``build_server``;
- the refusals: other ``model_type``s name ROADMAP item 14, tensor
  parallelism of the GPT-style block item 15.

The engine's checks (against the JAX engine, mixed against sequential,
four-step horizon against one step) are in
``tests/test_torch_gpt_families_engine.py``.
"""

import asyncio
import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.build import stack_layer_trees as ref_stack
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops import mlp as ref_mlp
from ipex_llm_tpu.ops import moe as ref_moe
from ipex_llm_tpu.ops import norms as ref_norms
from ipex_llm_tpu.ops.pallas.decode_attention import decode_sdpa as ref_decode
from ipex_llm_tpu.ops.pallas.flash_attention import flash_sdpa as ref_flash
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged
from ipex_llm_tpu.quantize import quantize as ref_quantize
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import _leaf, params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.models.families import config_from_hf, get_family
from ipex_llm_tpu_torch.models.random_init import (GPTJ_6B_HF, PHI2_HF,
                                                   PHIXTRAL_4X2_8_HF,
                                                   PYTHIA_6_9B_HF,
                                                   gptj_6b_config,
                                                   phi2_config,
                                                   phixtral_4x2_config,
                                                   pythia_6_9b_config)
from ipex_llm_tpu_torch.ops import mlp, moe, norms
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.optimize import optimize_model
from ipex_llm_tpu_torch.parallel.manual import ineligible_reason
from ipex_llm_tpu_torch.serving.api_server import build_server
from ipex_llm_tpu_torch.serving.engine import EngineConfig, ServingEngine
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_attention_dense import _pair, assert_rows_close
from tests.test_torch_families import _close
from tests.test_torch_families_phi_gemma import _caches, _run
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_ops import _f32, _ragged_case
from tests.test_torch_quantize import reference_tree

TINY_HF = {
    "phi": {
        "model_type": "phi", "vocab_size": 256, "hidden_size": 160,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "max_position_embeddings": 512, "rope_theta": 10000.0,
        "partial_rotary_factor": 0.4, "hidden_act": "gelu_new",
        "layer_norm_eps": 1e-5, "qk_layernorm": False,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2},
    "phixtral": {
        "model_type": "phi-msft", "vocab_size": 256, "n_embd": 160,
        "n_head": 2, "n_head_kv": None, "n_inner": 192, "n_layer": 2,
        "n_positions": 512, "rotary_dim": 32,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
        "num_local_experts": 4, "num_experts_per_tok": 2,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2},
    "gpt_neox": {
        "model_type": "gpt_neox", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "max_position_embeddings": 512,
        "rotary_emb_base": 10000, "rotary_pct": 0.25, "hidden_act": "gelu",
        "layer_norm_eps": 1e-5, "use_parallel_residual": True,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2},
    "gptj": {
        "model_type": "gptj", "vocab_size": 256, "n_embd": 64, "n_head": 2,
        "n_layer": 2, "n_positions": 512, "n_inner": 128, "rotary_dim": 8,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2},
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


def _phixtral_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """The msft module tree of a phixtral checkpoint: per layer one
    LayerNorm, the packed Wqkv and out_proj, the router and each expert's
    fc1/fc2, all with biases but the router; the embedding and the head's
    LayerNorm and linear."""
    h, v, e = hf["n_embd"], hf["vocab_size"], hf["num_local_experts"]
    inner = hf["n_inner"] or 4 * h
    out = {"transformer.embd.wte.weight": (v, h),
           "lm_head.ln.weight": (h,), "lm_head.ln.bias": (h,),
           "lm_head.linear.weight": (v, h), "lm_head.linear.bias": (v,)}
    for i in range(hf["n_layer"]):
        p = f"transformer.h.{i}."
        out.update({p + "ln.weight": (h,), p + "ln.bias": (h,),
                    p + "mixer.Wqkv.weight": (3 * h, h),
                    p + "mixer.Wqkv.bias": (3 * h,),
                    p + "mixer.out_proj.weight": (h, h),
                    p + "mixer.out_proj.bias": (h,),
                    p + "moe.gate.weight": (e, h)})
        for x in range(e):
            q = f"{p}moe.mlp.{x}."
            out.update({q + "fc1.weight": (inner, h), q + "fc1.bias": (inner,),
                        q + "fc2.weight": (h, inner), q + "fc2.bias": (h,)})
    return out


def _draw(shapes: dict, seed: int) -> dict[str, torch.Tensor]:
    """bf16 tensors for ``{name: shape}``: a LayerNorm's weight 1 + 0.05 N
    and bias 0.05 N, other biases 0.1 N, other weights N * 1.2 /
    sqrt(fan_in) (a router's N * 3 / sqrt(fan_in), for wide margins)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        norm = any(k in name for k in ("ln", "layernorm", "layer_norm"))
        if norm and name.endswith("weight"):
            w = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            w = (0.05 if norm else 0.1) * rng.standard_normal(shape)
        else:
            scale = 3.0 if "gate" in name else 1.2
            w = rng.standard_normal(shape) * (scale / np.sqrt(shape[-1]))
        out[name] = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    return out


def hf_model(family: str, seed: int = 0):
    """A ``transformers`` model of the tiny config (phi, gpt_neox, gptj)
    holding the seeded weights of :func:`_draw`, in bf16."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    transformers = pytest.importorskip("transformers")
    hf = TINY_HF[family]
    cls, ccls = {"phi": (transformers.PhiForCausalLM,
                         transformers.PhiConfig),
                 "gpt_neox": (transformers.GPTNeoXForCausalLM,
                              transformers.GPTNeoXConfig),
                 "gptj": (transformers.GPTJForCausalLM,
                          transformers.GPTJConfig)}[family]
    model = cls(ccls(**hf))
    state = model.state_dict()
    tensors = _draw({n: tuple(p.shape) for n, p in state.items()
                     if p.is_floating_point()}, seed)
    model = model.to(torch.bfloat16)
    model.load_state_dict(tensors, strict=False)
    return model


def write_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint of ``family``'s tiny config under the published
    names (module doc)."""
    if family == "phixtral":
        from ipex_llm_tpu_torch.models.loader import save_safetensors
        hf = TINY_HF[family]
        os.makedirs(path, exist_ok=True)
        save_safetensors(_draw(_phixtral_shapes(hf), seed),
                         os.path.join(path, "model.safetensors"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf, f)
        return path
    hf_model(family, seed).save_pretrained(path, safe_serialization=True)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["model_type"] == family
    return path


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_checkpoint(str(tmp_path_factory.mktemp(request.param)),
                            request.param)


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
    (PHI2_HF, phi2_config, (2560, 10240, 32, 32, 80, 32, 51200)),
    (PHIXTRAL_4X2_8_HF, phixtral_4x2_config,
     (2560, 10240, 32, 32, 80, 32, 51200)),
    (PYTHIA_6_9B_HF, pythia_6_9b_config,
     (4096, 16384, 32, 32, 128, 32, 50432)),
    (GPTJ_6B_HF, gptj_6b_config, (4096, 16384, 28, 16, 256, 64, 50400))],
    ids=["phi-2", "phixtral-4x2_8", "pythia-6.9b", "gpt-j-6b"])
def test_published_config_matches_reference_family(hf, make, widths):
    """Field for field the reference family's config carried across; the
    published widths (hidden, ffn, layers, heads, head_dim, rotated
    columns, vocab); LayerNorm, the ungated MLP and the parallel
    residual."""
    ref = ref_get_family(hf["model_type"], hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref)) == make()
    assert (port.hidden_size, port.intermediate_size, port.num_layers,
            port.num_heads, port.head_dim, port.rope.rotary_dim,
            port.vocab_size) == widths
    assert port.norm_kind == "layer" and not port.mlp_gated
    assert port.parallel_blocks and port.norm_eps == 1e-5
    assert port.rope_layout == ("two" if port.model_type == "gptj"
                                else "half")
    if port.model_type == "phi-msft":
        assert (port.num_experts, port.num_experts_per_tok,
                port.moe_intermediate_size) == (4, 2, 10240)
        assert port.moe_softmax_before_topk and port.moe_norm_topk_prob


def test_other_model_types_still_raise():
    """Families outside the port still name ROADMAP item 14, and so does a
    field of the GPT-style registry the port does not serve (learned
    positions)."""
    for mt in ("gpt_bigcode", "deci", "bloom", "mpt", "gpt2"):
        with pytest.raises(NotImplementedError, match="item 14"):
            get_family(mt)
    fields = dataclasses.asdict(ref_get_family("phi", PHI2_HF).to_config(
        PHI2_HF))
    with pytest.raises(NotImplementedError, match="item 14"):
        ModelConfig.from_fields({**fields, "learned_pos": 2048})
    with pytest.raises(NotImplementedError, match="norm_kind"):
        dataclasses.replace(phi2_config(), norm_kind="group")


# -- the ops -------------------------------------------------------------------

def test_layer_norm_and_act_match_reference():
    """``layer_norm`` (with and without weight and bias) and ``act`` in each
    of the new activations against the JAX functions, on bf16 input: the
    same bf16 values, or one bf16 ulp apart where the two sums of the
    mean and variance round apart."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 160)).astype(np.float32) * 3 + 1
    w = (1 + 0.05 * rng.standard_normal(160)).astype(np.float32)
    b = (0.05 * rng.standard_normal(160)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for wb in ((w, b), (w, None), (None, None)):
        want = _f32(ref_norms.layer_norm(
            xj, *[None if a is None else jnp.asarray(a) for a in wb], 1e-5))
        got = norms.layer_norm(
            xt, *[None if a is None else torch.from_numpy(a) for a in wb],
            1e-5)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), want, rtol=2.0 ** -7, atol=0)
    for name in ("gelu_new", "gelu", "gelu_pytorch_tanh", "silu"):
        got = mlp.act(xt, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(ref_mlp.act(xj, name)),
                                   rtol=2.0 ** -7, atol=1e-6)


E, H, I = 4, 64, 96


@pytest.fixture(scope="module", params=["sym_int4", "bf16"])
def ungated(request):
    """(reference fc1, fc2 stacks and biases, port ones): E ungated
    experts quantized by the reference's codec from one numpy seed."""
    rng = np.random.default_rng(4)

    def wt(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) * (1.2 / np.sqrt(n_in))
                ).astype(np.float32)
    ref = (ref_stack([ref_quantize(wt(H, I), request.param)
                      for _ in range(E)]),
           ref_stack([ref_quantize(wt(I, H), request.param)
                      for _ in range(E)]),
           jnp.asarray(0.1 * rng.standard_normal((E, I)), jnp.float32),
           jnp.asarray(0.1 * rng.standard_normal((E, H)), jnp.float32))
    return ref, tuple(_leaf(reference_tree(x), "cpu") if i < 2 else
                      torch.from_numpy(np.array(x))
                      for i, x in enumerate(ref))


@pytest.mark.parametrize("b,t", [(2, 3), (3, 16)], ids=["gather", "ragged"])
def test_ungated_moe_matches_reference(ungated, b, t):
    """Phixtral's experts (fc1 -> gelu_new -> fc2, biases gathered by each
    pair's expert) on each route against the JAX function of that route,
    within 2^-7 of each row's largest output; the dense scan against the
    route within the reference's sparse-vs-dense bound (2e-2); and the
    biases move the output."""
    (gu, dn, ub, db), (pgu, pdn, pub, pdb) = ungated
    rng = np.random.default_rng(b * 10 + t)
    h = rng.standard_normal((b, t, H)).astype(np.float32)
    logits = rng.standard_normal((b, t, E)).astype(np.float32)
    idx = np.argsort(-logits, -1, kind="stable")[..., :2].astype(np.int32)
    w = np.exp(np.take_along_axis(logits, idx, -1))
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    gather = b * t * 2 <= moe.GATHER_PAIR_LIMIT
    ref_fn = ref_moe.moe_gather if gather else (
        lambda *a, **k: ref_moe.moe_ragged(*a, n_experts=E, **k))
    want = np.asarray(ref_fn(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w), jnp.asarray(idx), gu,
        dn, "gelu_new", gated=False, up_bias=ub, down_bias=db).astype(
            jnp.float32))
    args = (torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(idx), pgu, pdn, "gelu_new", E)
    kw = dict(gated=False, up_bias=pub, down_bias=pdb)
    port_fn = moe.moe_gather if gather else moe.moe_ragged
    got = port_fn(*args, **kw)
    assert torch.equal(got, moe.moe_ffn(*args, **kw))
    top = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got.float().numpy() - want) <= 2.0 ** -7 * top).all()
    dense = moe.moe_dense(*args, **kw).float().numpy()
    assert (np.abs(dense - want) <= 2e-2 * top).all()
    plain = port_fn(*args, gated=False).float().numpy()
    assert np.abs(plain - want).max() > 0.05 * np.abs(want).max()


# -- B1, B3 and B4's plain versions at head_dim 80 ----------------------------

@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
def test_ragged_plain_at_head_dim_80_matches_pallas(pool):
    """B1's plain version on the row mix of ``tests/test_torch_ops.py`` at
    head_dim 80 against the Pallas kernel interpreted: valid queries within
    one bf16 ulp of the row's largest output, idle rows exact zeros."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, d=80)
    want = _f32(ref_ragged(*jax_args))
    b1.COUNTS.reset()
    got = _f32(b1.ragged_paged_sdpa(*torch_args))
    assert b1.COUNTS.plain_calls == 1 and b1.COUNTS.launches == 0
    assert got.shape[-1] == 80
    for i, n in enumerate(chunk):
        if n == 0:
            assert not got[i].any() and not want[i].any()
            continue
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0,
                                   atol=2.0 ** -7 * np.abs(want[i, :n]).max())


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
def test_decode_plain_at_head_dim_80_matches_pallas(storage):
    """B3's plain version at head_dim 80 (G = 1, Phi-2's; left padding and
    a window that cuts) against the Pallas kernel interpreted, within 2^-7
    of each row's largest output; the row that sees no key gives 0."""
    rng = np.random.default_rng(80)
    b, s, hkv, d = 3, 160, 2, 80
    q_t, q_j = _pair(rng, (b, 1, hkv, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([150, 160, 70], np.int32)
    kv_start = np.array([0, 137, 70], np.int32)
    b3.COUNTS.reset()
    got = b3.decode_sdpa(q_t, k_t, v_t, kv_len=torch.from_numpy(kv_len),
                         kv_start=torch.from_numpy(kv_start), window=48)
    assert b3.COUNTS.plain_calls == 1 and b3.COUNTS.launches == 0
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), window=48)
    assert not got[2].float().any()
    assert_rows_close(got, want, what=f"B3 {storage} D=80")


def test_flash_plain_at_head_dim_80_matches_pallas():
    """B4's plain version at head_dim 80 over left-padded rows with a
    window that cuts, against the Pallas kernel interpreted, within 2^-7
    of each row's largest output."""
    rng = np.random.default_rng(81)
    b, t, s, hq, hkv, d = 2, 72, 96, 2, 2, 80
    q_t, q_j = _pair(rng, (b, t, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d))
    v_t, v_j = _pair(rng, (b, hkv, s, d))
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
    assert_rows_close(got, want, what="B4 D=80")


# -- loading, logits, generate -------------------------------------------------

def test_from_pretrained_matches_reference(loaded):
    """The trees bitwise, every bias included (Pythia's qkv weight and bias
    reordered to [q; k; v]), and the full-sequence logits of a 40-id
    prompt within 2.5% of their largest value."""
    ref, port = loaded
    assert port.config == ModelConfig.from_fields(
        dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers = port.params["layers"]
    assert {"attn_norm_bias", "mlp_norm_bias", "down_bias" if "down" in
            layers else "moe_down_bias"} <= set(layers)
    assert ("lm_head_bias" in port.params) == \
        (port.config.model_type != "gpt_neox")
    ids = np.random.default_rng(3).integers(1, 256, (2, 40))
    _close(port(ids), np.asarray(ref(ids), np.float32), "bf16",
           "full-sequence logits")


# prompt seeds of the greedy check, one per family, each the best of seeds
# 0-29 (0-99 for phi) by the least lead of an emitted token over its
# runner-up along the port's three greedy streams (logits of each whole
# sequence in one prefill, of about 5); the token check itself is exact
GREEDY_SEEDS = {"phi": 92, "phi-msft": 19, "gpt_neox": 16, "gptj": 27}
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
    """Greedy ``generate()`` of both models over a ragged left-padded
    batch (prompts of 40, 9 and 27 ids; B4 prefills and B3 decodes, at
    head_dim 80 for phi and phixtral), token for token."""
    ref, port = loaded
    ids, mask = _batch(GREEDY_SEEDS[port.config.model_type])
    kw = dict(attention_mask=mask, max_new_tokens=6, do_sample=False)
    b4.COUNTS.reset()
    b3.COUNTS.reset()
    got = np.asarray(port.generate(ids, **kw))
    assert b4.COUNTS.plain_calls == b3.COUNTS.plain_calls // 5 == 2
    np.testing.assert_array_equal(got, np.asarray(ref.generate(ids, **kw)))


# -- the decoder over trees carried across ------------------------------------

@pytest.mark.parametrize("form,storage", [("paged", "bf16"),
                                          ("paged", "fp8"),
                                          ("dense", "bf16")])
def test_decoder_matches_reference(loaded, form, storage):
    """The port's decoder on the reference's tree carried across against
    ``decoder_forward`` (a ragged paged prefill and three decode steps, or
    a left-padded dense one), within the decoder tests' bounds.  On the
    dense form, the parallel residual (taken sequentially), the head's
    bias and the LayerNorms' biases each move the logits when taken
    away."""
    ref, _ = loaded
    cfg, params = ref.config, ref.params
    port_cfg = ModelConfig.from_fields(dataclasses.asdict(cfg))
    port_params = params_from_reference(reference_tree(params), device="cpu")
    ref_cache, port_cache = _caches(form, cfg, storage)
    want = _run(form, cfg, params, ref_forward, jnp.asarray, storage,
                ref_cache)
    got = _run(form, port_cfg, port_params, decoder_forward,
               torch.from_numpy, storage, port_cache())
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, storage, f"step {i}")
    if form != "dense":
        return
    layers = port_params["layers"]
    variants = [
        (dataclasses.replace(port_cfg, parallel_blocks=False), port_params),
        (port_cfg, {**port_params, "layers": {
            k: v for k, v in layers.items() if not k.endswith("norm_bias")},
            "final_norm_bias": None})]
    if "lm_head_bias" in port_params:
        variants.append((port_cfg, {**port_params, "lm_head_bias": None}))
    for c, p in variants:
        moved = _run(form, c, {k: v for k, v in p.items() if v is not None},
                     decoder_forward, torch.from_numpy, storage,
                     port_cache())
        assert max(float((m - g).abs().max()) for m, g in zip(moved, got)) \
            > 0.05


# -- the entry points ------------------------------------------------------------

def test_low_bit_files_round_trip_both_ways(ckpt, loaded, tmp_path):
    """Port save -> port load and -> reference load, reference save -> port
    load: every leaf bitwise, the biases included."""
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


@pytest.mark.parametrize("family", ["phi", "gpt_neox", "gptj"])
def test_optimize_model_takes_a_loaded_hf_model(family, tmp_path):
    """``optimize_model`` over a loaded ``PhiForCausalLM``,
    ``GPTNeoXForCausalLM`` and ``GPTJForCausalLM`` builds the tree
    ``from_pretrained`` builds from the same weights saved, bitwise."""
    model = hf_model(family, seed=2)
    got = optimize_model(model, low_bit="sym_int4", device="cpu")
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    want = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_in_low_bit="sym_int4", device="cpu")
    assert got.config == want.config
    assert_trees_equal(got.params, want.params)


class _Tok:
    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 256 for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_serves_a_checkpoint(tmp_path):
    """``build_server`` over a tiny phixtral checkpoint answers a
    completion."""
    path = write_checkpoint(str(tmp_path), "phixtral", seed=4)
    srv = build_server(path, tokenizer=_Tok(), device="cpu",
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


def test_tensor_parallel_refuses_the_gpt_block():
    """At tp > 1 the ungated MLP is refused with the reference's reason, a
    row-parallel o/down bias with the port's own, and ``ServingEngine(...,
    tp=2)`` raises naming ROADMAP item 15."""
    from ipex_llm_tpu_torch.models.random_init import random_params
    cfg = phi2_config(hidden_size=160, intermediate_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=2, vocab_size=256)
    params = random_params(cfg, "sym_int4", seed=1, device="cpu")
    assert ineligible_reason(cfg, params, {"tp": 2}, 128) == \
        "ungated / split MLP needs a sliced row input"
    gated = {"layers": {"qkv": None, "gate_up": None, "o_bias": None}}
    assert "bias" in ineligible_reason(
        dataclasses.replace(cfg, mlp_gated=True), gated, {"tp": 2}, 128)
    with pytest.raises(NotImplementedError, match="item 15"):
        ServingEngine(cfg, params, EngineConfig(max_rows=2, max_seq_len=64),
                      device="cpu", tp=types.SimpleNamespace(size=2, rank=0))
