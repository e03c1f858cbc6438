"""The Qwen2 and Gemma-2 families in the port against the JAX package.

Tiny checkpoints (2 and 4 layers, hidden 64, vocab 256; Gemma-2 at
head_dim 32 with a window of 8 on its even layers; random weights from a
numpy seed) are written with ``transformers``' own model classes, so the
weight names are the published ones:

- configs: ``config_from_hf`` on the published Qwen2-7B and Gemma-2-9B
  ``config.json`` fields equals the reference family's config carried
  across (``ModelConfig.from_fields``); Qwen2's ``sliding_window`` with
  ``use_sliding_window: false`` is no window;
- loading: the port's ``from_pretrained`` equals the reference's, carried
  across, bitwise in bf16, sym_int4, nf4 and sym_int8 (fp4 and asym_int4
  against the reference's jitted codec, as the loader tests hold them);
  ``save_low_bit``/``load_low_bit`` round-trip, and each package loads
  the other's files;
- the decoder, dense and paged, against ``decoder_forward`` over bf16 and
  e5m2 caches, with the window cutting and both softcaps binding;
- ``cached_sdpa`` over the paged pool with a window and with a softcap
  (the gathered route) against the reference's, on a tick of decode, chunk
  and idle rows;
- greedy ``generate()`` token for token against the JAX ``generate``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu import generation as ref_gen
from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.kv import make_cache as ref_make_cache
from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.build import build_params as ref_build_params
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops.attention import cached_sdpa as ref_cached_sdpa
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch import generation as port_gen
from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (GEMMA2_9B_HF, QWEN2_7B_HF,
                                                   gemma2_9b_config,
                                                   qwen2_7b_config)
from ipex_llm_tpu_torch.ops.attention import cached_sdpa
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_loader import (CPP_DIVERGES, assert_trees_equal,
                                     reference_build)
from tests.test_torch_quantize import reference_tree

WINDOW = 8

PUBLISHED = {
    # huggingface.co/Qwen/Qwen2-7B/blob/main/config.json
    "qwen2": {
        "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
        "bos_token_id": 151643, "eos_token_id": 151643, "hidden_act": "silu",
        "hidden_size": 3584, "initializer_range": 0.02,
        "intermediate_size": 18944, "max_position_embeddings": 131072,
        "max_window_layers": 28, "model_type": "qwen2",
        "num_attention_heads": 28, "num_hidden_layers": 28,
        "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
        "rope_theta": 1000000.0, "sliding_window": 131072,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "transformers_version": "4.37.2", "use_cache": True,
        "use_sliding_window": False, "vocab_size": 152064},
    # huggingface.co/google/gemma-2-9b/blob/main/config.json
    "gemma2": {
        "architectures": ["Gemma2ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "attn_logit_softcapping": 50.0,
        "bos_token_id": 2, "cache_implementation": "hybrid",
        "eos_token_id": 1, "final_logit_softcapping": 30.0, "head_dim": 256,
        "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 3584,
        "initializer_range": 0.02, "intermediate_size": 14336,
        "max_position_embeddings": 8192, "model_type": "gemma2",
        "num_attention_heads": 16, "num_hidden_layers": 42,
        "num_key_value_heads": 8, "pad_token_id": 0,
        "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06,
        "rope_theta": 10000.0, "sliding_window": 4096,
        "sliding_window_size": 4096, "torch_dtype": "float32",
        "transformers_version": "4.42.0.dev0", "use_cache": True,
        "vocab_size": 256000},
}

TINY_HF = {
    "qwen2": {
        "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 160,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "max_position_embeddings": 512,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "hidden_act": "silu",
        "tie_word_embeddings": False, "sliding_window": WINDOW,
        "use_sliding_window": False, "max_window_layers": 2,
        "bos_token_id": 1, "eos_token_id": 2},
    "gemma2": {
        "model_type": "gemma2", "architectures": ["Gemma2ForCausalLM"],
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 4, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 32,
        "max_position_embeddings": 512, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "hidden_act": "gelu_pytorch_tanh",
        "hidden_activation": "gelu_pytorch_tanh", "sliding_window": WINDOW,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "query_pre_attn_scalar": 4, "tie_word_embeddings": True,
        "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0},
}
FAMILIES = tuple(TINY_HF)


def family_weights(hf: dict, seed: int = 0) -> dict[str, torch.Tensor]:
    """HF-named bf16 weights ([out, in]) of the family from a numpy seed.
    Linear weights N * 1.2 / sqrt(fan_in); norms 1 + 0.05 N, or 0.05 N
    for gemma's (1 + w); qwen2's q/k/v biases 0.5 N.  Gemma-2's q and k
    are three times wider and its embedding N * 2, so that attention
    scores (at query_pre_attn_scalar 4) pass the attention softcap of 50
    and logits the final softcap of 30: both caps bind."""
    rng = np.random.default_rng(seed)
    gemma = hf["model_type"] == "gemma2"
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = hf.get("head_dim") or h // hf["num_attention_heads"]
    q, kv = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, h), "model.norm.weight": (h,)}
    if not hf["tie_word_embeddings"]:
        shapes["lm_head.weight"] = (v, h)
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f)})
        if gemma:
            shapes[p + "pre_feedforward_layernorm.weight"] = (h,)
            shapes[p + "post_feedforward_layernorm.weight"] = (h,)
        else:
            for proj, n in (("q", q), ("k", kv), ("v", kv)):
                shapes[p + f"self_attn.{proj}_proj.bias"] = (n,)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("norm.weight"):
            w = (0.0 if gemma else 1.0) + 0.05 * rng.standard_normal(shape)
        elif name.endswith(".bias"):
            w = 0.5 * rng.standard_normal(shape)
        elif name == "model.embed_tokens.weight" and gemma:
            w = 2.0 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) * (1.2 / np.sqrt(shape[-1]))
            if gemma and ("q_proj" in name or "k_proj" in name):
                w = w * 3.0
        out[name] = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    return out


def write_family_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint written by ``transformers``' model class of the
    family (``save_pretrained``), its weights ``family_weights``."""
    # the model classes import TensorFlow where it is installed unless
    # told the backend is torch: about 8 s of a worker's import time
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    transformers = pytest.importorskip("transformers")
    hf = TINY_HF[family]
    cls, ccls = {"qwen2": (transformers.Qwen2ForCausalLM,
                           transformers.Qwen2Config),
                 "gemma2": (transformers.Gemma2ForCausalLM,
                            transformers.Gemma2Config)}[family]
    model = cls(ccls(**{k: v for k, v in hf.items()
                        if k != "architectures"})).to(torch.bfloat16)
    tensors = family_weights(hf, seed)
    if hf["tie_word_embeddings"]:
        tensors["lm_head.weight"] = tensors["model.embed_tokens.weight"]
    model.load_state_dict(tensors, strict=True)
    model.save_pretrained(path, safe_serialization=True)
    with open(os.path.join(path, "config.json")) as f:
        assert json.load(f)["model_type"] == family
    return path


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    return write_family_checkpoint(
        str(tmp_path_factory.mktemp(request.param)), request.param)


def family_pair(path: str, qtype: str = "sym_int4"):
    """(reference cfg, reference params, port cfg, port params) of a
    checkpoint through the reference's jitted codec, carried across."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    cfg = ref_get_family(hf["model_type"], hf).to_config(hf)
    port, tree = reference_build(path, qtype)
    return cfg, tree, ModelConfig.from_fields(dataclasses.asdict(cfg)), port


def weights_pair(family: str, qtype: str = "sym_int4", seed: int = 0):
    """``family_pair`` of the same weights without writing a checkpoint:
    the reference's jitted codec over ``family_weights`` directly (the
    reader widens bf16 to fp32 exactly, as here)."""
    hf = TINY_HF[family]
    fam = ref_get_family(family, hf)
    cfg = fam.to_config(hf)
    tensors = family_weights(hf, seed)
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        tree = ref_build_params(cfg, fam.scheme,
                                lambda n: tensors[n].float().numpy(),
                                lambda n: n in tensors, qtype=qtype)
    finally:
        ref_native.available = old
    return cfg, tree, ModelConfig.from_fields(dataclasses.asdict(cfg)), \
        params_from_reference(reference_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def pair(ckpt):
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        return family_pair(ckpt)
    finally:
        ref_native.available = old


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_published_config_matches_reference_family(family):
    hf = PUBLISHED[family]
    ref = ref_get_family(family, hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref))
    # the port's own copy of the published fields gives the same config
    assert config_from_hf({"qwen2": QWEN2_7B_HF,
                           "gemma2": GEMMA2_9B_HF}[family]) == port
    assert port == (qwen2_7b_config() if family == "qwen2"
                    else gemma2_9b_config())
    if family == "qwen2":
        assert (port.hidden_size, port.intermediate_size, port.num_layers,
                port.num_heads, port.num_kv_heads, port.head_dim,
                port.vocab_size, port.rope.base) == (
            3584, 18944, 28, 28, 4, 128, 152064, 1e6)
        assert port.attention_bias and not port.tie_word_embeddings
        assert port.sliding_window is None
        assert not any(port.layer_is_sliding(i) for i in range(28))
    else:
        assert (port.hidden_size, port.intermediate_size, port.num_layers,
                port.num_heads, port.num_kv_heads, port.head_dim,
                port.vocab_size) == (3584, 14336, 42, 16, 8, 256, 256000)
        assert [port.layer_is_sliding(i) for i in range(4)] == [
            True, False, True, False]
        assert (port.sliding_window, port.attn_softcap, port.logit_softcap,
                port.attn_scale, port.norm_offset) == (4096, 50.0, 30.0,
                                                       1 / 16, 1.0)
        assert port.tie_word_embeddings and port.post_attn_norm \
            and port.post_mlp_norm and port.act == "gelu_pytorch_tanh"
        # sqrt(3584) = 59.87 rounds to 59.75 in bf16, the factor applied
        assert port.embedding_multiplier == pytest.approx(59.8665, abs=1e-4)
        assert float(torch.tensor(port.embedding_multiplier,
                                  dtype=torch.bfloat16)) == 59.75


# -- loading ------------------------------------------------------------------

def test_checkpoint_and_weights_give_one_tree(pair):
    """The checkpoint ``transformers`` wrote and the weights it was written
    from build the same config and, bitwise, the same tree
    (``weights_pair``, which tests/test_torch_windowed_engine.py serves)."""
    cfg, _, port_cfg, port_params = pair
    w_cfg, _, w_port_cfg, w_params = weights_pair(cfg.model_type)
    assert w_port_cfg == port_cfg
    assert_trees_equal(w_params, port_params)

LOAD_FORMATS = ("bf16", "sym_int4", "nf4", "sym_int8") + CPP_DIVERGES


@pytest.mark.parametrize("qtype", LOAD_FORMATS)
def test_from_pretrained_matches_reference(ckpt, qtype, monkeypatch):
    """The port's model API against the reference's over the same
    checkpoint, bitwise; in ``CPP_DIVERGES`` against the reference's
    jitted codec, which the port follows (its C++ quantizer packs some
    blocks of those two formats otherwise)."""
    if qtype in CPP_DIVERGES:
        monkeypatch.setattr(ref_native, "available", lambda: False)
    ref = RefAutoModelForCausalLM.from_pretrained(ckpt,
                                                  load_in_low_bit=qtype)
    port = AutoModelForCausalLM.from_pretrained(ckpt, load_in_low_bit=qtype,
                                                device="cpu")
    assert port.config == ModelConfig.from_fields(
        dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers = port.params["layers"]
    if port.config.attention_bias:
        assert layers["qkv_bias"].dtype == torch.float32
        assert layers["qkv_bias"].shape == (2, port.config.q_dim
                                            + 2 * port.config.kv_dim)
    if port.config.tie_word_embeddings:
        assert "lm_head" not in port.params
        assert {"post_attn_norm", "post_mlp_norm"} <= set(layers)


@pytest.mark.parametrize("qtype", ("sym_int4", "bf16"))
def test_low_bit_files_round_trip_both_ways(ckpt, tmp_path, qtype,
                                            monkeypatch):
    """Port save -> port load and -> reference load, reference save ->
    port load: every leaf bitwise (biases, post norms, a tree without
    ``lm_head``)."""
    monkeypatch.setattr(ref_native, "available", lambda: False)
    want, ref_tree = reference_build(ckpt, qtype)
    port = AutoModelForCausalLM.from_pretrained(ckpt, load_in_low_bit=qtype,
                                                device="cpu")
    port.save_low_bit(str(tmp_path / "port"))
    again = AutoModelForCausalLM.load_low_bit(str(tmp_path / "port"),
                                              device="cpu")
    assert again.config == port.config
    assert_trees_equal(again.params, port.params)
    params, _, q = ref_serialize.load_low_bit(str(tmp_path / "port"))
    assert q == qtype
    assert_trees_equal(params_from_reference(reference_tree(params),
                                             device="cpu"), want)
    with open(os.path.join(ckpt, "config.json")) as f:
        hf = json.load(f)
    ref_serialize.save_low_bit(str(tmp_path / "ref"), ref_tree, hf, qtype)
    params, hf2, _ = serialize.load_low_bit(str(tmp_path / "ref"),
                                            device="cpu")
    assert hf2 == hf
    assert_trees_equal(params, want)


# -- the decoder --------------------------------------------------------------

def _close(got: torch.Tensor, want, storage: str, what: str):
    """Within 2.5% of the largest |logit| at worst over a bf16 cache (the
    decoder tests' bound), 6% at worst and 1% on average over e5m2."""
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape, what
    top = np.abs(want).max()
    max_tol, mean_tol = (0.025, 0.005) if storage in ("bf16", "normal") \
        else (0.06, 0.01)
    err = np.abs(got.numpy() - want)
    assert err.max() <= max_tol * top, (what, err.max() / top)
    assert err.mean() <= mean_tol * top, (what, err.mean() / top)


def _dense_run(cfg, params, forward, make, storage, steps, kv_start, to):
    cache = make(storage)
    outs = []
    for tk, ps in steps:
        logits, cache = forward(cfg, params, to(tk), cache, to(ps),
                                to(kv_start), last_token_only=True)
        outs.append(logits)
    return outs


def _dense_steps(vocab, seed=21):
    """A left-padded prefill (rows of 30, 11 and 22 in a 32 bucket: the
    window of 8 cuts them) and three decode steps."""
    rng = np.random.default_rng(seed)
    b, t = 3, 32
    lengths = np.array([30, 11, 22], np.int32)
    tokens = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, t - n:] = rng.integers(1, vocab, n)
    kv_start = (t - lengths).astype(np.int32)
    pos = np.maximum(np.arange(t)[None] - kv_start[:, None], 0).astype(
        np.int32)
    steps = [(tokens, pos)]
    for i in range(3):
        steps.append((rng.integers(1, vocab, (b, 1)).astype(np.int32),
                      (lengths + i)[:, None].astype(np.int32)))
    return steps, kv_start


@pytest.mark.parametrize("storage", ["normal", "fp8"])
def test_dense_decoder_matches_reference(pair, storage):
    """Left-padded prefill and decode steps over the dense cache; the
    window cuts (Gemma-2's sliding layers), the softcaps bind: the port's
    logits move when either is taken away."""
    cfg, params, port_cfg, port_params = pair
    steps, kv_start = _dense_steps(cfg.vocab_size)
    b, cap = 3, 48

    def port_run(c):
        return _dense_run(c, port_params, decoder_forward, lambda s: make_cache(
            s, c.num_layers, b, cap, c.num_kv_heads, c.head_dim,
            device="cpu"), storage, steps, kv_start, torch.from_numpy)
    want = _dense_run(cfg, params, ref_forward, lambda s: ref_make_cache(
        s, cfg.num_layers, b, cap, cfg.num_kv_heads, cfg.head_dim), storage,
        steps, kv_start, jnp.asarray)
    got = port_run(port_cfg)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, storage, f"step {i}")
    if port_cfg.model_type != "gemma2":
        return
    for over in (dict(sliding_window=10 ** 6), dict(attn_softcap=None),
                 dict(logit_softcap=None)):
        moved = port_run(dataclasses.replace(port_cfg, **over))
        assert max(float((m - g).abs().max()) for m, g in zip(moved, got)) \
            > 0.1, over


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_paged_decoder_matches_reference(pair, storage):
    """A ragged prefill over the paged pool (rows of 24, 9 and 17 ids in
    one chunk of 24) and three decode steps: the gathered route (a window
    or a softcap) for Gemma-2, B1's for Qwen2."""
    cfg, params, port_cfg, port_params = pair
    ps, maxp, r, t = 16, 4, 3, 24
    n_pages = 1 + r * maxp
    tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
    ref_cache = RefPagedKVCache.init(
        cfg.num_layers, n_pages, r, maxp, cfg.num_kv_heads, ps,
        cfg.head_dim, storage=storage).with_tables(jnp.asarray(tables))
    cache = PagedKVCache.init(port_cfg.num_layers, n_pages, r, maxp,
                              port_cfg.num_kv_heads, ps, port_cfg.head_dim,
                              storage=storage, device="cpu")
    cache.tables.copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(17)
    chunk = np.array([24, 9, 17], np.int32)
    base = np.zeros(r, np.int32)
    steps = [dict(tokens=rng.integers(0, cfg.vocab_size, (r, t)).astype(
        np.int32), pos=np.arange(t, dtype=np.int32)[None].repeat(r, 0),
        base=base, chunk=chunk, gather=chunk - 1)]
    lens = base + chunk
    for _ in range(3):
        steps.append(dict(
            tokens=rng.integers(0, cfg.vocab_size, (r, 1)).astype(np.int32),
            pos=lens[:, None].copy(), base=lens.copy(), chunk=None,
            gather=None))
        lens = lens + 1
    for i, s in enumerate(steps):
        kw = dict(slot_offsets=s["base"])
        if s["chunk"] is not None:
            kw.update(chunk_lens=s["chunk"], gather_positions=s["gather"])
        else:
            kw.update(last_token_only=True)
        want, ref_cache = ref_forward(
            cfg, params, jnp.asarray(s["tokens"]), ref_cache,
            jnp.asarray(s["pos"]), **{k: jnp.asarray(v) if isinstance(
                v, np.ndarray) else v for k, v in kw.items()})
        got, cache = decoder_forward(
            port_cfg, port_params, torch.from_numpy(s["tokens"]), cache,
            torch.from_numpy(s["pos"]), **{k: torch.from_numpy(v)
                                           if isinstance(v, np.ndarray)
                                           else v for k, v in kw.items()})
        _close(got, want, storage, f"step {i}")


# -- cached_sdpa over the paged pool -------------------------------------------

@pytest.mark.parametrize("storage", ["bf16", "fp8"])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("variant", ["window", "softcap"])
def test_cached_sdpa_gathered_route_matches_reference(variant, t, storage):
    """One layer of a tick over a 4-row pool (pages of 16, -1 table tails):
    at T=8 a chunk row (5 queries), two decode rows (1 query) and an idle
    row (0 queries, its slot the sentinel at the table width); at T=1 the
    decode and idle rows.  Every
    valid query row within 2^-7 of its largest reference output."""
    rng = np.random.default_rng(5 + t + len(variant))
    r, hq, hkv, d, ps, maxp = 4, 4, 2, 32, 16, 4
    n_pages = 1 + r * maxp
    dt = torch.bfloat16 if storage == "bf16" else torch.float8_e5m2
    k = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d)).astype(
        np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((n_pages, hkv, ps, d)).astype(
        np.float32)).to(dt)
    tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
    tables[1, 2:] = -1
    tables[3, 1:] = -1
    sentinel = maxp * ps
    chunk = np.array([5, 1, 1, 0] if t > 1 else [1, 1, 1, 0], np.int32)
    slot0 = np.array([40, 20, 55, sentinel], np.int32)
    kv_len = slot0 + chunk
    q = (3.0 * rng.standard_normal((r, t, hq, d))).astype(np.float32)
    q_slots = slot0[:, None] + np.arange(t, dtype=np.int32)[None]
    kw = dict(scale=0.5, window=12 if variant == "window" else None,
              softcap=5.0 if variant == "softcap" else None)

    def ref_pool(x):
        a = x.view(torch.uint8 if x.element_size() == 1 else torch.int16)
        return jnp.asarray(a.numpy()).view(
            jnp.float8_e5m2 if x.element_size() == 1 else jnp.bfloat16)
    ref_cache = RefPagedKVCache(ref_pool(k)[None], ref_pool(v)[None],
                                jnp.asarray(tables), jnp.int32(0),
                                storage=storage)
    want = ref_cached_sdpa(
        jnp.asarray(q, jnp.bfloat16), ref_cache.k[0], ref_cache.v[0],
        ref_cache, causal=True, q_positions=jnp.asarray(q_slots),
        kv_len=jnp.asarray(kv_len), kv_start=None, window_on=True,
        chunk_lens=jnp.asarray(chunk), **kw)
    cache = PagedKVCache(k[None], v[None], torch.from_numpy(tables),
                         storage=storage)
    got = cached_sdpa(
        torch.from_numpy(q).to(torch.bfloat16), cache.k[0], cache.v[0],
        cache, causal=True, q_positions=torch.from_numpy(q_slots),
        kv_len=torch.from_numpy(kv_len), kv_start=None, window_on=True,
        chunk_lens=torch.from_numpy(chunk), **kw)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (r, t, hq, d)
    for i, n in enumerate(chunk):
        top = np.abs(want[i, :n]).max(axis=(1, 2), keepdims=True)
        assert (np.abs(got[i, :n] - want[i, :n]) <= 2.0 ** -7 * top).all(), i
    assert np.isfinite(got).all()


# -- generate -----------------------------------------------------------------

# Prompt seeds of the cross-framework check, one per family, each the best
# of seeds 0-99 (as tests/test_torch_generation.py's GREEDY_SEEDS): along
# every stream, over both caches, the port's emitted token leads its
# runner-up by at least the margin noted (logits of the whole sequence in
# one prefill); the token check itself is exact.
GREEDY_SEEDS = {"qwen2": 43,         # margin 0.078 (logits of about 3)
                "gemma2": 7}         # margin 3.74 (logits of about 30)
PROMPT_LENS = (40, 9, 27)
NEW_TOKENS = 6


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, n))) for n in lens]


@pytest.mark.parametrize("kv_kind", ["normal", "fp8"])
def test_generate_greedy_matches_reference(pair, kv_kind):
    """Token-identical greedy sequences over a ragged left-padded batch;
    Gemma-2's window cuts the long prompts in its sliding layers."""
    cfg, params, port_cfg, port_params = pair
    prompts = _prompts(cfg.vocab_size, PROMPT_LENS,
                       GREEDY_SEEDS[cfg.model_type])
    want = ref_gen.generate(cfg, params, prompts, ref_gen.GenerationConfig(
        max_new_tokens=NEW_TOKENS), kv_kind=kv_kind)
    got = port_gen.generate(port_cfg, port_params, prompts,
                            port_gen.GenerationConfig(
                                max_new_tokens=NEW_TOKENS), kv_kind=kv_kind)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_new_tokens, want.num_new_tokens)
