"""The phi3, gemma and gemma3_text families in the port against the JAX
package.

Tiny checkpoints (2 layers, vocab 256, random weights from a numpy seed)
are written with ``transformers``' own model classes, so the weight names
are the published ones:

- phi3: 2 heads of 96 (hidden 192), pre-merged ``qkv_proj`` and
  ``gate_up_proj``, a window of 8 on every layer, and Phi-3.5/Phi-4's
  rope: ``longrope`` from 64 to 512 positions (the long list in force)
  over a partial rotary of 0.75 (72 of the 96 columns);
- gemma: 2 query heads over 1 kv head of 256, the exact GELU (the
  published config's ``hidden_act`` "gelu" without ``hidden_activation``),
  a tied head, no window;
- gemma3_text: 2 query heads over 1 kv head of 256, per-head q/k norms, a
  window of 8 on the first layer and full attention on the second, the
  global table at theta 1e6 scaled linearly by 8 and the local one at 1e4.

Held here:

- the published Phi-3-mini-4k, Gemma-7B and Gemma-3-4B configs through
  the port's families equal the reference family's config carried across;
- ``from_pretrained`` (sym_int4) of each package over the same checkpoint:
  the trees bitwise, the full-sequence logits within 2.5% of their
  largest value, greedy ``generate()`` token for token on a ragged
  left-padded batch (margin-chosen prompt seeds);
- the decoder, dense and paged, against ``decoder_forward`` over the
  reference's tree carried across by ``models/convert.py``, within the
  decoder tests' bounds; the local table, the partial rotary and longrope
  each move the logits when taken away;
- ``ServingEngine`` on the tiny gemma3_text and phi3: mixed ticks equal
  one chunk a tick, and a 4-step decode horizon one step, bitwise.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.kv import make_cache as ref_make_cache
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
from ipex_llm_tpu_torch.models.build import rope_buffers
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (GEMMA3_4B_HF,
                                                   GEMMA_7B_HF,
                                                   PHI3_MINI_4K_HF,
                                                   gemma3_4b_config,
                                                   gemma_7b_config,
                                                   phi3_mini_4k_config)
from ipex_llm_tpu_torch.ops.rope import RopeScaling
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_engine import _port_streams
from tests.test_torch_families import _close
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_quantize import reference_tree

WINDOW = 8
_ROPE_RNG = np.random.default_rng(96)

TINY_HF = {
    "phi3": {
        "model_type": "phi3", "vocab_size": 256, "hidden_size": 192,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "max_position_embeddings": 512,
        "original_max_position_embeddings": 64, "rope_theta": 10000.0,
        "partial_rotary_factor": 0.75,
        "rope_scaling": {
            "type": "longrope",
            "short_factor": [float(v) for v in 1.0 + np.sort(
                _ROPE_RNG.uniform(0.0, 2.0, 36))],
            "long_factor": [float(v) for v in np.exp(np.sort(
                _ROPE_RNG.uniform(0.0, np.log(64.0), 36)))]},
        "rms_norm_eps": 1e-5, "sliding_window": WINDOW, "hidden_act": "silu",
        "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
        "pad_token_id": 0},
    "gemma": {
        "model_type": "gemma", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 256,
        "max_position_embeddings": 512, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "hidden_act": "gelu",
        "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
        "pad_token_id": 0},
    "gemma3_text": {
        "model_type": "gemma3_text", "vocab_size": 256, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 256,
        "max_position_embeddings": 512, "rope_theta": 1000000.0,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "rope_local_base_freq": 10000.0, "rms_norm_eps": 1e-6,
        "sliding_window": WINDOW,
        "layer_types": ["sliding_attention", "full_attention"],
        "query_pre_attn_scalar": 64,
        "hidden_activation": "gelu_pytorch_tanh",
        "tie_word_embeddings": True, "bos_token_id": 2, "eos_token_id": 1,
        "pad_token_id": 0},
}
FAMILIES = tuple(TINY_HF)


def write_checkpoint(path: str, family: str, seed: int = 0) -> str:
    """A bf16 checkpoint written by ``transformers``' model class of the
    family: linear weights N * 1.2 / sqrt(fan_in), the embedding N * 2 for
    the gemmas (whose embeddings are scaled down by sqrt(hidden)), norms
    1 + 0.05 N (0.05 N for the gemmas' (1 + w) norms).  ``transformers``
    writes ``hidden_activation: null`` for gemma; the published Gemma-7B
    config has no such key, and it is dropped as there."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_TORCH", "1")
    transformers = pytest.importorskip("transformers")
    hf = TINY_HF[family]
    cls, ccls = {"phi3": (transformers.Phi3ForCausalLM,
                          transformers.Phi3Config),
                 "gemma": (transformers.GemmaForCausalLM,
                           transformers.GemmaConfig),
                 "gemma3_text": (transformers.Gemma3ForCausalLM,
                                 transformers.Gemma3TextConfig)}[family]
    model = cls(ccls(**hf))
    gemma = family != "phi3"
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("norm.weight"):
            w = (0.0 if gemma else 1.0) + 0.05 * rng.standard_normal(shape)
        elif name == "model.embed_tokens.weight" and gemma:
            w = 2.0 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) * (1.2 / np.sqrt(shape[-1]))
        tensors[name] = torch.from_numpy(w.astype(np.float32)).to(
            torch.bfloat16)
    if hf["tie_word_embeddings"]:
        tensors["lm_head.weight"] = tensors["model.embed_tokens.weight"]
    model = model.to(torch.bfloat16)
    model.load_state_dict(tensors, strict=False)
    model.save_pretrained(path, safe_serialization=True)
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        written = json.load(f)
    if written.get("hidden_activation", 0) is None:
        del written["hidden_activation"]
        with open(cfg_path, "w") as f:
            json.dump(written, f)
    assert written["model_type"] == family
    return path


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores (each worker's default pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

@pytest.mark.parametrize("family,hf,make", [
    ("phi3", PHI3_MINI_4K_HF, phi3_mini_4k_config),
    ("gemma", GEMMA_7B_HF, gemma_7b_config),
    ("gemma3_text", GEMMA3_4B_HF, gemma3_4b_config)])
def test_published_config_matches_reference_family(family, hf, make):
    ref = ref_get_family(family, hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref)) == make()
    widths = (port.hidden_size, port.intermediate_size, port.num_layers,
              port.num_heads, port.num_kv_heads, port.head_dim,
              port.vocab_size)
    if family == "phi3":
        assert widths == (3072, 8192, 32, 32, 32, 96, 32064)
        assert port.sliding_window == 2047 and port.rope.rotary_dim == 96
    elif family == "gemma":
        assert widths == (3072, 24576, 28, 16, 16, 256, 256000)
        assert port.act == "gelu" and port.tie_word_embeddings
        assert port.sliding_window is None and port.attn_softcap is None
    else:
        assert widths == (2560, 10240, 34, 8, 4, 256, 262208)
        sliding = [port.layer_is_sliding(i) for i in range(34)]
        assert [i for i, s in enumerate(sliding) if not s] == [5, 11, 17,
                                                               23, 29]
        assert (port.rope.kind, port.rope.factor, port.rope.base,
                port.rope_local.base) == ("linear", 8.0, 1e6, 1e4)
        assert port.attn_scale == 256 ** -0.5 and port.qk_norm
        assert port.attn_softcap is None and port.logit_softcap is None


# -- loading, logits, generate ------------------------------------------------

def test_from_pretrained_matches_reference(loaded):
    """The trees bitwise (pre-merged phi3 weights loaded as stored; the
    rope leaves at max_position_embeddings, gemma3's local table beside
    them), and the full-sequence logits of a 40-id prompt within 2.5% of
    their largest value."""
    ref, port = loaded
    assert port.config == ModelConfig.from_fields(
        dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    assert ("inv_freq_local" in port.params) == \
        (port.config.model_type == "gemma3_text")
    ids = np.random.default_rng(3).integers(1, 256, (2, 40))
    want = np.asarray(ref(ids), np.float32)
    got = port(ids)
    _close(got, want, "bf16", "full-sequence logits")


# prompt seeds of the greedy check, one per family, each the best of seeds
# 0-99 by the least lead of an emitted token over its runner-up along the
# port's three greedy streams (logits of each whole sequence in one
# prefill); the margin noted; the token check itself is exact
GREEDY_SEEDS = {"phi3": 71,          # margin 0.094 (logits of about 4)
                "gemma": 20,         # margin 91.6 (logits of about 150)
                "gemma3_text": 20}   # margin 92.3 (logits of about 150)
PROMPT_LENS = (40, 9, 27)
NEW_TOKENS = 6


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
    batch (prompts of 40, 9 and 27 ids: the window of 8 cuts them in
    phi3's and gemma3's sliding layers), token for token."""
    ref, port = loaded
    ids, mask = _batch(GREEDY_SEEDS[port.config.model_type])
    kw = dict(attention_mask=mask, max_new_tokens=NEW_TOKENS,
              do_sample=False)
    want = np.asarray(ref.generate(ids, **kw))
    got = np.asarray(port.generate(ids, **kw))
    np.testing.assert_array_equal(got, want)


# -- the decoder over trees carried across ------------------------------------

def _paged_steps(vocab, r=3, t=24):
    rng = np.random.default_rng(17)
    chunk = np.array([24, 9, 17], np.int32)
    steps = [dict(tokens=rng.integers(0, vocab, (r, t)).astype(np.int32),
                  pos=np.arange(t, dtype=np.int32)[None].repeat(r, 0),
                  base=np.zeros(r, np.int32), chunk=chunk)]
    lens = chunk.copy()
    for _ in range(3):
        steps.append(dict(tokens=rng.integers(0, vocab, (r, 1)).astype(
            np.int32), pos=lens[:, None].copy(), base=lens.copy(),
            chunk=None))
        lens = lens + 1
    return steps


def _run(form, cfg, params, forward, to, storage, cache):
    """Logits of a paged tick sequence (a ragged prefill of 24, 9 and 17
    ids in one chunk, three decode steps) or of a dense one (a left-padded
    prefill of 30, 11 and 22 ids, three decode steps)."""
    outs = []
    if form == "paged":
        for s in _paged_steps(cfg.vocab_size):
            kw = dict(slot_offsets=to(s["base"]))
            if s["chunk"] is not None:
                kw.update(chunk_lens=to(s["chunk"]),
                          gather_positions=to(s["chunk"] - 1))
            else:
                kw["last_token_only"] = True
            logits, cache = forward(cfg, params, to(s["tokens"]), cache,
                                    to(s["pos"]), **kw)
            outs.append(logits)
        return outs
    rng = np.random.default_rng(21)
    lengths = np.array([30, 11, 22], np.int32)
    t = 32
    tokens = np.zeros((3, t), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, t - n:] = rng.integers(1, cfg.vocab_size, n)
    kv_start = (t - lengths).astype(np.int32)
    pos = np.maximum(np.arange(t)[None] - kv_start[:, None], 0).astype(
        np.int32)
    steps = [(tokens, pos)] + [
        (rng.integers(1, cfg.vocab_size, (3, 1)).astype(np.int32),
         (lengths + i)[:, None].astype(np.int32)) for i in range(3)]
    for tk, ps in steps:
        logits, cache = forward(cfg, params, to(tk), cache, to(ps),
                                to(kv_start), last_token_only=True)
        outs.append(logits)
    return outs


def _caches(form, cfg, storage):
    ps, maxp, r = 16, 4, 3
    if form == "paged":
        tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
        ref = RefPagedKVCache.init(cfg.num_layers, 1 + r * maxp, r, maxp,
                                   cfg.num_kv_heads, ps, cfg.head_dim,
                                   storage=storage).with_tables(
            jnp.asarray(tables))

        def port():
            c = PagedKVCache.init(cfg.num_layers, 1 + r * maxp, r, maxp,
                                  cfg.num_kv_heads, ps, cfg.head_dim,
                                  storage=storage, device="cpu")
            c.tables.copy_(torch.from_numpy(tables))
            return c
        return ref, port
    kind = "normal" if storage == "bf16" else "fp8"
    return (ref_make_cache(kind, cfg.num_layers, 3, 48, cfg.num_kv_heads,
                           cfg.head_dim),
            lambda: make_cache(kind, cfg.num_layers, 3, 48, cfg.num_kv_heads,
                               cfg.head_dim, device="cpu"))


@pytest.mark.parametrize("form,storage", [("paged", "bf16"),
                                          ("paged", "fp8"),
                                          ("dense", "bf16")])
def test_decoder_matches_reference(loaded, form, storage):
    """The port's decoder on the reference's tree carried across
    (``params_from_reference``) against ``decoder_forward``: head_dim 96
    with partial rotary and longrope (phi3), 256 (gemma, gemma3), gemma3's
    two tables.  Each of those moves the logits when taken away: the
    local table (the global one on every layer), the partial rotary (rope
    over the whole head) and longrope (the unscaled table)."""
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
    variants = []
    if port_cfg.rope_local is not None:
        variants.append((port_cfg, {
            **port_params, "inv_freq_local": port_params["inv_freq"]}))
    if port_cfg.rope.rotary_dim < port_cfg.head_dim:
        full = dataclasses.replace(port_cfg, rope=dataclasses.replace(
            port_cfg.rope, partial_rotary_factor=1.0, short_factor=None,
            long_factor=None, kind="default"))
        variants.append((full, {**port_params, **rope_buffers(full, "cpu")}))
        plain = dataclasses.replace(port_cfg, rope=RopeScaling(
            head_dim=port_cfg.head_dim, partial_rotary_factor=0.75))
        variants.append((plain, {**port_params,
                                 **rope_buffers(plain, "cpu")}))
    for c, p in variants:
        moved = _run(form, c, p, decoder_forward, torch.from_numpy, storage,
                     port_cache())
        assert max(float((m - g).abs().max()) for m, g in zip(moved, got)) \
            > 0.1, c.rope


# -- the serving engine -------------------------------------------------------

@pytest.mark.parametrize("family", ["gemma3_text", "phi3"])
def test_engine_mixed_equals_sequential_and_h4_equals_h1(family,
                                                         tmp_path_factory):
    """Bit-identical token and logprob streams across the engine's paths
    (the rows of tests/test_torch_engine.py: greedy, seeded and
    engine-seeded sampled): mixed ticks against one chunk a tick, and a
    4-step decode horizon against one step.  gemma3's sliding layer takes
    the gathered route with the local table, its full layer B1's;
    phi3's every layer the gathered route at head_dim 96."""
    path = write_checkpoint(str(tmp_path_factory.mktemp(family)), family)
    port = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", device="cpu")
    cfg, params = port.config, port.params
    mixed, m_mixed = _port_streams(cfg, params)
    seq, m_seq = _port_streams(cfg, params, step_token_budget=0)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert mixed == seq
    assert h4 == mixed
