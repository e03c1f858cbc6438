"""The GLM families (glm, glm4, chatglm) and the llama-layout families
(aquila, internlm, internlm2, baichuan, qwen) in the port against the JAX
package.

Tiny checkpoints (2 layers, random bf16 weights from a numpy seed) are
written with numpy under each family's published names, at the widths of
the reference's own tiny configs (``tests/test_families3.py``,
``tests/test_families5.py``, ``tests/test_families.py``: hidden 64, 4
heads of 16, vocab 150): glm and glm4 (``transformers``' names; the "two"
rope on 8 of 16 columns, a qkv bias, the merged ``gate_up_proj``, glm4's
post norms), chatglm (the THUDM names and config keys, 2 kv groups,
``rope_ratio`` 2), aquila (llama's), internlm (llama's, with biases on q,
k, v and o), internlm2 (``wqkv`` in its per-kv-group layout, with a bias),
baichuan (``W_pack``) and qwen (``c_attn`` with a bias under ``no_bias:
true``, as a Qwen-7B checkpoint holds it).

Held here:

- the published configs (GLM-4-9B in both layouts, chatglm3-6b,
  internlm2-chat-7b, Qwen-7B-Chat, Baichuan2-7B-Chat) through the port's
  families equal the reference family's config carried across;
- the refusals name ROADMAP item 14: chatglm v1, baichuan-13B and
  chatglm without RMSNorm;
- B1's, B3's and B4's plain versions at GLM-4-9B's GQA group of 16
  (32 query heads over 2 kv heads, head_dim 128) against the Pallas
  kernels in the interpreter;
- ``from_pretrained`` (sym_int4) of each package over the same
  checkpoint: configs equal, trees bitwise (every bias, the internlm2
  relayout of weight and bias), full-sequence logits within 2.5% of their
  largest value, greedy ``generate()`` token for token (margin-chosen
  prompt seeds); ``save_low_bit``/``load_low_bit`` both ways;
  ``optimize_model`` over ``transformers``' ``GlmForCausalLM`` and
  ``Glm4ForCausalLM``; one request through ``build_server``.

The engine's checks are in ``tests/test_torch_glm_families_engine.py``.
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
from ipex_llm_tpu_torch.models import random_init as ri
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.families import config_from_hf, get_family
from ipex_llm_tpu_torch.models.loader import save_safetensors
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.optimize import optimize_model
from ipex_llm_tpu_torch.serving.api_server import build_server
from ipex_llm_tpu_torch.serving.engine import EngineConfig
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_attention_dense import _pair, assert_rows_close
from tests.test_torch_families import _close
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_ops import _f32, _ragged_case
from tests.test_torch_quantize import reference_tree

_LLAMA = {"vocab_size": 150, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
          "max_position_embeddings": 256, "hidden_act": "silu",
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2}
_GLM = {**_LLAMA, "head_dim": 16, "partial_rotary_factor": 0.5,
        "attention_bias": True, "rope_theta": 10000.0, "pad_token_id": 0,
        "eos_token_id": [2, 149]}
TINY_HF = {
    "glm": {**_GLM, "model_type": "glm"},
    "glm4": {**_GLM, "model_type": "glm4"},
    "chatglm": {
        "model_type": "chatglm", "hidden_size": 64, "ffn_hidden_size": 128,
        "num_layers": 2, "num_attention_heads": 4, "kv_channels": 16,
        "multi_query_attention": True, "multi_query_group_num": 2,
        "padded_vocab_size": 150, "layernorm_epsilon": 1.5625e-07,
        "add_qkv_bias": True, "add_bias_linear": False, "rmsnorm": True,
        "post_layer_norm": True, "seq_length": 256, "rope_ratio": 2.0,
        "tie_word_embeddings": False, "pad_token_id": 0,
        "eos_token_id": [2, 149]},
    "aquila": {**_LLAMA, "model_type": "aquila", "num_key_value_heads": 4},
    "internlm": {**_LLAMA, "model_type": "internlm",
                 "num_key_value_heads": 4, "bias": True},
    "internlm2": {**_LLAMA, "model_type": "internlm2", "bias": True},
    "baichuan": {**_LLAMA, "model_type": "baichuan"},
    "qwen": {
        "model_type": "qwen", "vocab_size": 150, "hidden_size": 64,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "kv_channels": 16,
        "layer_norm_epsilon": 1e-6, "seq_length": 256,
        "rotary_emb_base": 10000.0, "no_bias": True,
        "tie_word_embeddings": False},
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


def _widths(hf: dict) -> tuple[int, int, int, int, int, int, int]:
    """(hidden, ffn a branch, layers, heads, kv heads, head_dim, vocab) of
    a tiny config in any family's keys."""
    if hf["model_type"] == "chatglm":
        return (hf["hidden_size"], hf["ffn_hidden_size"], hf["num_layers"],
                hf["num_attention_heads"], hf["multi_query_group_num"],
                hf["kv_channels"], hf["padded_vocab_size"])
    if hf["model_type"] == "qwen":
        return (hf["hidden_size"], hf["intermediate_size"] // 2,
                hf["num_hidden_layers"], hf["num_attention_heads"],
                hf["num_attention_heads"], hf["kv_channels"],
                hf["vocab_size"])
    return (hf["hidden_size"], hf["intermediate_size"],
            hf["num_hidden_layers"], hf["num_attention_heads"],
            hf["num_key_value_heads"],
            hf.get("head_dim") or hf["hidden_size"]
            // hf["num_attention_heads"], hf["vocab_size"])


def hf_shapes(hf: dict) -> dict[str, tuple[int, ...]]:
    """The published weight names of ``hf``'s family and their ``[out,
    in]`` shapes (module doc)."""
    mt = hf["model_type"]
    h, f, n_l, nh, nkv, hd, v = _widths(hf)
    qkv = (nh + 2 * nkv) * hd
    if mt == "chatglm":
        top = {"transformer.embedding.word_embeddings.weight": (v, h),
               "transformer.encoder.final_layernorm.weight": (h,),
               "transformer.output_layer.weight": (v, h),
               "transformer.rotary_pos_emb.inv_freq": (hd // 4,)}
        p = "transformer.encoder.layers.{i}."
        layer = {"input_layernorm.weight": (h,),
                 "post_attention_layernorm.weight": (h,),
                 "self_attention.query_key_value.weight": (qkv, h),
                 "self_attention.query_key_value.bias": (qkv,),
                 "self_attention.dense.weight": (h, nh * hd),
                 "mlp.dense_h_to_4h.weight": (2 * f, h),
                 "mlp.dense_4h_to_h.weight": (h, f)}
    elif mt == "qwen":
        top = {"transformer.wte.weight": (v, h),
               "transformer.ln_f.weight": (h,), "lm_head.weight": (v, h)}
        p = "transformer.h.{i}."
        layer = {"ln_1.weight": (h,), "ln_2.weight": (h,),
                 "attn.c_attn.weight": (qkv, h), "attn.c_attn.bias": (qkv,),
                 "attn.c_proj.weight": (h, nh * hd),
                 "mlp.w1.weight": (f, h), "mlp.w2.weight": (f, h),
                 "mlp.c_proj.weight": (h, f)}
    elif mt == "internlm2":
        top = {"model.tok_embeddings.weight": (v, h),
               "model.norm.weight": (h,), "output.weight": (v, h)}
        p = "model.layers.{i}."
        layer = {"attention_norm.weight": (h,), "ffn_norm.weight": (h,),
                 "attention.wqkv.weight": (qkv, h),
                 "attention.wo.weight": (h, nh * hd),
                 "feed_forward.w1.weight": (f, h),
                 "feed_forward.w3.weight": (f, h),
                 "feed_forward.w2.weight": (h, f)}
        if hf.get("bias"):
            layer.update({"attention.wqkv.bias": (qkv,),
                          "attention.wo.bias": (h,)})
    else:
        top = {"model.embed_tokens.weight": (v, h),
               "model.norm.weight": (h,), "lm_head.weight": (v, h)}
        p = "model.layers.{i}."
        layer = {"input_layernorm.weight": (h,),
                 "post_attention_layernorm.weight": (h,),
                 "self_attn.o_proj.weight": (h, nh * hd),
                 "mlp.down_proj.weight": (h, f)}
        if mt == "baichuan":
            layer["self_attn.W_pack.weight"] = (qkv, h)
        else:
            for n, rows in (("q", nh * hd), ("k", nkv * hd), ("v", nkv * hd)):
                layer[f"self_attn.{n}_proj.weight"] = (rows, h)
                if mt in ("glm", "glm4") or hf.get("bias"):
                    layer[f"self_attn.{n}_proj.bias"] = (rows,)
        if hf.get("bias"):
            layer["self_attn.o_proj.bias"] = (h,)
        if mt in ("glm", "glm4"):
            layer["mlp.gate_up_proj.weight"] = (2 * f, h)
        else:
            layer.update({"mlp.gate_proj.weight": (f, h),
                          "mlp.up_proj.weight": (f, h)})
        if mt == "glm4":
            layer.update({"post_self_attn_layernorm.weight": (h,),
                          "post_mlp_layernorm.weight": (h,)})
    out = dict(top)
    for i in range(n_l):
        out.update({p.format(i=i) + k: s for k, s in layer.items()})
    return out


def draw(shapes: dict, seed: int) -> dict[str, torch.Tensor]:
    """bf16 tensors for ``{name: shape}``: a norm's weight 1 + 0.05 N, a
    bias 0.1 N, ``inv_freq`` rope frequencies, other weights N * 1.2 /
    sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("inv_freq"):
            w = 10000.0 ** (-np.arange(shape[0]) / shape[0])
        elif "norm" in name or name.endswith(("ln_1.weight", "ln_2.weight",
                                              "ln_f.weight")):
            w = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            w = 0.1 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) * (1.2 / np.sqrt(shape[-1]))
        out[name] = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    return out


def write_checkpoint(path: str, family: str, seed: int = 0,
                     hf: dict | None = None) -> str:
    """A bf16 checkpoint of ``family``'s tiny config (or ``hf``) under the
    published names."""
    hf = hf or TINY_HF[family]
    os.makedirs(path, exist_ok=True)
    save_safetensors(draw(hf_shapes(hf), seed),
                     os.path.join(path, "model.safetensors"),
                     metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return path


def reference_model(path: str):
    """The reference's sym_int4 load through its jitted codec (which the
    port follows)."""
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        return RefAutoModelForCausalLM.from_pretrained(
            path, load_in_low_bit="sym_int4")
    finally:
        ref_native.available = old


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_checkpoint(str(tmp_path_factory.mktemp(request.param)),
                            request.param)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(reference model, port model) of the checkpoint in sym_int4."""
    return reference_model(ckpt), AutoModelForCausalLM.from_pretrained(
        ckpt, load_in_low_bit="sym_int4", device="cpu")


# -- configs and refusals -----------------------------------------------------

@pytest.mark.parametrize("hf,make,widths", [
    (ri.GLM4_9B_CHAT_HF, ri.glm4_9b_chat_config,
     (4096, 13696, 40, 32, 2, 128, 64, 151552)),
    (ri.GLM4_9B_0414_HF, ri.glm4_9b_0414_config,
     (4096, 13696, 40, 32, 2, 128, 64, 151552)),
    (ri.CHATGLM3_6B_HF, ri.chatglm3_6b_config,
     (4096, 13696, 28, 32, 2, 128, 64, 65024)),
    (ri.INTERNLM2_7B_HF, ri.internlm2_7b_config,
     (4096, 14336, 32, 32, 8, 128, 128, 92544)),
    (ri.QWEN_7B_HF, ri.qwen_7b_config,
     (4096, 11008, 32, 32, 32, 128, 128, 151936)),
    (ri.BAICHUAN2_7B_HF, ri.baichuan2_7b_config,
     (4096, 11008, 32, 32, 32, 128, 128, 125696))],
    ids=["glm-4-9b-chat", "glm-4-9b-0414", "chatglm3-6b",
         "internlm2-chat-7b", "qwen-7b-chat", "baichuan2-7b-chat"])
def test_published_config_matches_reference_family(hf, make, widths):
    """Field for field the reference family's config carried across; the
    published widths (hidden, ffn a branch, layers, heads, kv heads,
    head_dim, rotated columns, vocab); GLM's "two" rope and qkv bias,
    glm-4-9b-chat's rope base 10000 x 500."""
    ref = ref_get_family(hf["model_type"], hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref)) == make()
    assert (port.hidden_size, port.intermediate_size, port.num_layers,
            port.num_heads, port.num_kv_heads, port.head_dim,
            port.rope.rotary_dim, port.vocab_size) == widths
    glm = port.model_type in ("chatglm", "glm4")
    assert port.rope_layout == ("two" if glm else "half")
    assert port.attention_bias == glm and not port.attention_out_bias
    assert port.post_attn_norm == port.post_mlp_norm == \
        (port.model_type == "glm4")
    if hf is ri.GLM4_9B_CHAT_HF:
        assert port.rope.base == 5e6 and port.max_position_embeddings == \
            131072


@pytest.mark.parametrize("hf,what", [
    ({**TINY_HF["chatglm"], "position_encoding_2d": True}, "step 4"),
    ({**TINY_HF["chatglm"], "inner_hidden_size": 256}, "step 4"),
    ({**TINY_HF["baichuan"], "hidden_size": 5120}, "step 4"),
    ({**TINY_HF["chatglm"], "rmsnorm": False}, "item 14"),
    ({**TINY_HF["chatglm"], "post_layer_norm": False}, "item 14")],
    ids=["chatglm1-2d-rope", "chatglm1-inner", "baichuan-13b",
         "chatglm-layernorm", "chatglm-no-final-norm"])
def test_unserved_variants_are_refused(hf, what, tmp_path):
    """chatglm v1 (either marker), baichuan at hidden 5120 (13B, ALiBi)
    and chatglm without RMSNorm or its final norm raise
    ``NotImplementedError`` naming ROADMAP item 14 from the families
    lookup and from ``from_pretrained``: none is served by another
    family's math."""
    with pytest.raises(NotImplementedError, match=what):
        config_from_hf(hf)
    path = write_checkpoint(str(tmp_path), hf["model_type"],
                            hf=TINY_HF[hf["model_type"]])
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    with pytest.raises(NotImplementedError, match=what):
        AutoModelForCausalLM.from_pretrained(path, device="cpu")
    if hf.get("position_encoding_2d") or "inner_hidden_size" in hf:
        with pytest.raises(NotImplementedError, match="chatglm v1"):
            get_family("chatglm", hf)
        assert get_family("chatglm").name == "chatglm"


# -- B1, B3 and B4's plain versions at a GQA group of 16 ----------------------

@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
def test_ragged_plain_at_group_16_matches_pallas(pool):
    """B1's plain version on the row mix of ``tests/test_torch_ops.py`` at
    GLM-4-9B's 32 query heads over 2 kv heads (head_dim 128: decode rows
    put 16 query heads on one kv head) against the Pallas kernel
    interpreted: valid queries within one bf16 ulp of the row's largest
    output, idle rows exact zeros."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, hq=32, hkv=2, d=128)
    want = _f32(ref_ragged(*jax_args))
    b1.COUNTS.reset()
    got = _f32(b1.ragged_paged_sdpa(*torch_args))
    assert b1.COUNTS.plain_calls == 1 and b1.COUNTS.launches == 0
    for i, n in enumerate(chunk):
        if n == 0:
            assert not got[i].any() and not want[i].any()
            continue
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0,
                                   atol=2.0 ** -7 * np.abs(want[i, :n]).max())


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
def test_decode_plain_at_group_16_matches_pallas(storage):
    """B3's plain version at G = 16 (head_dim 128; left padding and a
    window that cuts) against the Pallas kernel interpreted, within 2^-7
    of each row's largest output; the row that sees no key gives 0."""
    rng = np.random.default_rng(16)
    b, s, hkv, d = 3, 160, 2, 128
    q_t, q_j = _pair(rng, (b, 1, 16 * hkv, d))
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
    assert_rows_close(got, want, what=f"B3 {storage} G=16")


def test_flash_plain_at_group_16_matches_pallas():
    """B4's plain version at G = 16 (head_dim 128) over left-padded rows
    with a window that cuts, against the Pallas kernel interpreted, within
    2^-7 of each row's largest output."""
    rng = np.random.default_rng(17)
    b, t, s, hkv, d = 2, 72, 96, 2, 128
    q_t, q_j = _pair(rng, (b, t, 16 * hkv, d))
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
    assert_rows_close(got, want, what="B4 G=16")


# -- loading, logits, generate -------------------------------------------------

def test_from_pretrained_matches_reference(loaded):
    """Configs equal; the trees bitwise, every bias included (internlm's o
    bias, internlm2's wqkv weight and bias reordered to [q; k; v], qwen's
    c_attn bias under ``no_bias``); the full-sequence logits of a 40-id
    prompt within 2.5% of their largest value."""
    ref, port = loaded
    cfg = port.config
    assert cfg == ModelConfig.from_fields(dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers = port.params["layers"]
    assert ("qkv_bias" in layers) == (cfg.model_type not in ("aquila",
                                                              "baichuan"))
    assert ("o_bias" in layers) == (cfg.model_type in ("internlm",
                                                       "internlm2"))
    if cfg.model_type == "qwen":
        assert not cfg.attention_bias
    ids = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 40))
    _close(port(ids), np.asarray(ref(ids), np.float32), "bf16",
           "full-sequence logits")


# prompt seeds of the greedy check, one per family, each the best of seeds
# 0-29 by the least lead of an emitted token over its runner-up along the
# port's three greedy streams (logits of each whole sequence in one
# prefill; the lead noted, where one bf16 ulp is 0.016-0.031), no stream
# meeting an eos id; the token check itself is exact
GREEDY_SEEDS = {"glm": 1,            # lead 0.047
                "glm4": 13,          # lead 0.078
                "chatglm": 27,       # lead 0.078
                "aquila": 8,         # lead 0.125
                "internlm": 29,      # lead 0.063
                "internlm2": 20,     # lead 0.078
                "baichuan": 27,      # lead 0.094
                "qwen": 9}           # lead 0.078
PROMPT_LENS = (40, 9, 27)


def prompt_batch(seed: int, vocab: int):
    """Left-padded prompts of ``PROMPT_LENS`` ids and their mask."""
    rng = np.random.default_rng(seed)
    width = max(PROMPT_LENS)
    ids = np.zeros((len(PROMPT_LENS), width), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(PROMPT_LENS):
        ids[i, width - n:] = rng.integers(3, vocab, n)
        mask[i, width - n:] = 1
    return ids, mask


def test_generate_greedy_matches_reference(loaded):
    """Greedy ``generate()`` of both models over a ragged left-padded
    batch (prompts of 40, 9 and 27 ids; B4 prefills and B3 decodes),
    token for token."""
    ref, port = loaded
    ids, mask = prompt_batch(GREEDY_SEEDS[port.config.model_type],
                             port.config.vocab_size)
    kw = dict(attention_mask=mask, max_new_tokens=6, do_sample=False)
    b4.COUNTS.reset()
    b3.COUNTS.reset()
    got = np.asarray(port.generate(ids, **kw))
    assert b4.COUNTS.plain_calls == b3.COUNTS.plain_calls // 5 == 2
    np.testing.assert_array_equal(got, np.asarray(ref.generate(ids, **kw)))


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


@pytest.mark.parametrize("family", ["glm", "glm4"])
def test_optimize_model_takes_a_loaded_hf_model(family, tmp_path):
    """``optimize_model`` over a ``transformers`` ``GlmForCausalLM`` and
    ``Glm4ForCausalLM`` holding the tiny checkpoint's weights builds the
    tree ``from_pretrained`` builds from them saved, bitwise."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cls, ccls = {"glm": (transformers.GlmForCausalLM,
                         transformers.GlmConfig),
                 "glm4": (transformers.Glm4ForCausalLM,
                          transformers.Glm4Config)}[family]
    hf = {k: v for k, v in TINY_HF[family].items() if k != "model_type"}
    model = cls(ccls(**hf)).to(torch.bfloat16)
    tensors = draw(hf_shapes(TINY_HF[family]), seed=2)
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    assert not unexpected and not [m for m in missing
                                   if "rotary" not in m], missing
    got = optimize_model(model, low_bit="sym_int4", device="cpu")
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    want = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_in_low_bit="sym_int4", device="cpu")
    assert got.config == want.config
    assert_trees_equal(got.params, want.params)
    assert_trees_equal(got.params, AutoModelForCausalLM.from_pretrained(
        write_checkpoint(str(tmp_path / "numpy"), family, seed=2),
        load_in_low_bit="sym_int4", device="cpu").params)


class _Tok:
    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 150 for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_serves_a_checkpoint(tmp_path):
    """``build_server`` over a tiny chatglm checkpoint answers a
    completion."""
    path = write_checkpoint(str(tmp_path), "chatglm", seed=4)
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
