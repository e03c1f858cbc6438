"""The falcon, starcoder2, stablelm, cohere and olmo2 families in the port
against the JAX package.

Tiny checkpoints are the reference's own tiny configs
(``tests/test_families.py``, ``tests/test_families4.py``: hidden 64, 4
heads of 16, 2 layers, vocab 150), built with ``transformers``' classes
and saved, every parameter drawn from a numpy seed (norms 1 + 0.05 N,
biases 0.1 N, weights N * 1.2 / sqrt(fan_in)): starcoder2 (a window of
24, below the 40-id prompt, so that it binds), cohere, stablelm (a
quarter of each head rotated, a qkv bias), olmo2 (the norms after each
branch, flat q/k norms), and falcon in its three ``query_key_value``
layouts: the old architecture over one kv head (Falcon-7B's MQA, as
stored), the old architecture with a kv head a query head (per-head
rows, with biases) and the new architecture (per-kv-group rows, two
LayerNorms a block).

Held here:

- the published configs (Falcon-7B and -40B, StarCoder2-7B,
  StableLM-2-1.6B, Command-R-v01, OLMo-2-7B) through the port's families
  equal the reference family's config carried across;
- the refusals: falcon with ALiBi (ROADMAP item 14 step 4), stablelm's
  ``qk_layernorm`` and parallel residual, cohere's ``use_qk_norm``;
  olmo2's flat q/k norm at tp (the reference's reason);
- B3's plain version at GQA groups of 17, 32 and 71 against the Pallas
  kernel interpreted, and B1's and B4's at 71;
- ``from_pretrained`` (sym_int4) of each package over the same
  checkpoint: configs equal, trees bitwise, full-sequence logits within
  2.5% of their largest value, greedy ``generate()`` token for token
  (margin-chosen prompt seeds); ``save_low_bit``/``load_low_bit`` both
  ways.

The engine's checks are in ``tests/test_torch_falcon_families_engine.py``.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.ops.pallas.decode_attention import decode_sdpa as ref_decode
from ipex_llm_tpu.ops.pallas.flash_attention import flash_sdpa as ref_flash
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged
from ipex_llm_tpu_torch.models import random_init as ri
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.parallel.manual import ineligible_reason
from ipex_llm_tpu_torch.serving.engine import EngineConfig, ServingEngine
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_attention_dense import _pair, assert_rows_close
from tests.test_torch_families import _close
from tests.test_torch_glm_families import prompt_batch, reference_model
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_ops import _f32, _ragged_case
from tests.test_torch_quantize import reference_tree

os.environ.setdefault("USE_TF", "0")

_TINY = dict(vocab_size=150, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4)
_FALCON = dict(_TINY, parallel_attn=True, alibi=False)
# family -> (transformers class names, config keywords)
TINY = {
    "starcoder2": ("Starcoder2", dict(
        _TINY, intermediate_size=128, num_key_value_heads=2,
        max_position_embeddings=256, use_bias=True,
        tie_word_embeddings=True, sliding_window=24)),
    "cohere": ("Cohere", dict(
        _TINY, intermediate_size=128, num_key_value_heads=2,
        logit_scale=0.5, max_position_embeddings=256, use_qk_norm=False,
        pad_token_id=0)),
    "stablelm": ("StableLm", dict(
        _TINY, intermediate_size=128, num_key_value_heads=2,
        partial_rotary_factor=0.25, use_qkv_bias=True,
        max_position_embeddings=256)),
    "olmo2": ("Olmo2", dict(
        _TINY, intermediate_size=128, num_key_value_heads=2,
        max_position_embeddings=256)),
    "falcon": ("Falcon", dict(
        _FALCON, multi_query=True, new_decoder_architecture=False,
        bias=False)),
    "falcon_mha": ("Falcon", dict(
        _FALCON, multi_query=False, new_decoder_architecture=False,
        bias=True)),
    "falcon_new": ("Falcon", dict(
        _FALCON, num_kv_heads=2, multi_query=False,
        new_decoder_architecture=True, bias=False)),
}
FAMILIES = tuple(TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_model(family: str, seed: int = 0, **over):
    """``transformers``' model of ``family``'s tiny config (``over``
    replaces config keywords), every parameter drawn from a numpy
    seed."""
    import transformers

    name, kw = TINY[family]
    cfg = getattr(transformers, f"{name}Config")(**{**kw, **over})
    model = getattr(transformers, f"{name}ForCausalLM")(cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "norm" in n or "ln_" in n:
                w = (1.0 + 0.05 * rng.standard_normal(p.shape)
                     if n.endswith("weight")
                     else 0.05 * rng.standard_normal(p.shape))
            elif n.endswith("bias"):
                w = 0.1 * rng.standard_normal(p.shape)
            else:
                w = rng.standard_normal(p.shape) * (1.2 / np.sqrt(
                    p.shape[-1]))
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    return model


def write_checkpoint(path: str, family: str, seed: int = 0, **over) -> str:
    """``family``'s tiny checkpoint (``hf_model``) saved with
    ``save_pretrained``."""
    hf_model(family, seed, **over).save_pretrained(
        path, safe_serialization=True)
    return path


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return request.param


@pytest.fixture(scope="module")
def ckpt(family, tmp_path_factory):
    return write_checkpoint(str(tmp_path_factory.mktemp(family)), family)


@pytest.fixture(scope="module")
def loaded(ckpt):
    """(reference model, port model) of the checkpoint in sym_int4."""
    return reference_model(ckpt), AutoModelForCausalLM.from_pretrained(
        ckpt, load_in_low_bit="sym_int4", device="cpu")


# -- configs and refusals -----------------------------------------------------

@pytest.mark.parametrize("hf,make,widths", [
    (ri.FALCON_7B_HF, ri.falcon_7b_config,
     (4544, 18176, 32, 71, 1, 64, 64, 65024)),
    (ri.FALCON_40B_HF, ri.falcon_40b_config,
     (8192, 32768, 60, 128, 8, 64, 64, 65024)),
    (ri.STARCODER2_7B_HF, ri.starcoder2_7b_config,
     (4608, 18432, 32, 36, 4, 128, 128, 49152)),
    (ri.STABLELM2_1_6B_HF, ri.stablelm2_1_6b_config,
     (2048, 5632, 24, 32, 32, 64, 16, 100352)),
    (ri.COMMAND_R_V01_HF, ri.command_r_v01_config,
     (8192, 22528, 40, 64, 64, 128, 128, 256000)),
    (ri.OLMO2_7B_HF, ri.olmo2_7b_config,
     (4096, 11008, 32, 32, 32, 128, 128, 100352))],
    ids=["falcon-7b", "falcon-40b", "starcoder2-7b", "stablelm-2-1.6b",
         "command-r-v01", "olmo-2-7b"])
def test_published_config_matches_reference_family(hf, make, widths):
    """Field for field the reference family's config carried across; the
    published widths (hidden, ffn, layers, heads, kv heads, head_dim,
    rotated columns, vocab); each family's block switches."""
    ref = ref_get_family(hf["model_type"], hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref)) == make()
    assert (port.hidden_size, port.intermediate_size, port.num_layers,
            port.num_heads, port.num_kv_heads, port.head_dim,
            port.rope.rotary_dim, port.vocab_size) == widths
    mt = port.model_type
    assert port.norm_kind == ("rms" if mt == "olmo2" else "layer")
    assert port.mlp_gated == (mt not in ("falcon", "starcoder2"))
    assert port.parallel_blocks == (mt in ("falcon", "cohere"))
    assert port.norm_after == port.qk_norm == (mt == "olmo2")
    assert port.tie_word_embeddings == (mt in ("falcon", "starcoder2",
                                               "cohere"))
    assert port.sliding_window == (4096 if mt == "starcoder2" else None)
    if mt == "cohere":
        assert port.rope_layout == "two" and port.logit_scale == 0.0625
    if hf is ri.FALCON_7B_HF:
        assert port.max_position_embeddings == 2048 and port.act == \
            "gelu_new" and not port.attention_bias


@pytest.mark.parametrize("family,over,what", [
    ("falcon", dict(alibi=True), "step 4"),
    ("stablelm", dict(qk_layernorm=True), "qk_layernorm"),
    ("stablelm", dict(use_parallel_residual=True), "parallel-residual"),
    ("cohere", dict(use_qk_norm=True), "use_qk_norm")],
    ids=["falcon-alibi", "stablelm-qk-layernorm",
         "stablelm-parallel-residual", "cohere-qk-norm"])
def test_unserved_variants_are_refused(family, over, what, tmp_path):
    """Falcon with ALiBi (Falcon-RW: ROADMAP item 14 step 4), stablelm's
    ``qk_layernorm`` and parallel residual (StableLM-2-12B) and cohere's
    ``use_qk_norm`` (Command-R+) raise ``NotImplementedError`` from the
    families lookup and from ``from_pretrained``; the reference refuses
    the last three with the same words."""
    path = write_checkpoint(str(tmp_path), family)
    with open(os.path.join(path, "config.json")) as f:
        hf = {**json.load(f), **over}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    with pytest.raises(NotImplementedError, match=what):
        config_from_hf(hf)
    with pytest.raises(NotImplementedError, match=what):
        AutoModelForCausalLM.from_pretrained(path, device="cpu")
    if family != "falcon":
        with pytest.raises(NotImplementedError, match=what):
            ref_get_family(hf["model_type"], hf).to_config(hf)


def test_tensor_parallel_refuses_the_flat_qk_norm(tmp_path):
    """olmo2's q/k norms reduce over the whole projection, so the
    per-rank layout refuses them with the reference's reason, and
    ``ServingEngine(..., tp=2)`` raises naming ROADMAP item 15."""
    port = AutoModelForCausalLM.from_pretrained(
        write_checkpoint(str(tmp_path), "olmo2"), load_in_low_bit="sym_int4",
        device="cpu")
    cfg, params = port.config, port.params
    assert params["layers"]["q_norm"].shape[-1] == cfg.q_dim
    assert ineligible_reason(cfg, params, {"tp": 2}, 128) == \
        "flat qk-norm reduces over the full q_dim"
    with pytest.raises(NotImplementedError, match="item 15"):
        ServingEngine(cfg, params, EngineConfig(max_rows=2, max_seq_len=64),
                      device="cpu", tp=types.SimpleNamespace(size=2, rank=0))


# -- B1, B3 and B4's plain versions past a GQA group of 16 --------------------

@pytest.mark.parametrize("g,d,hkv,kw", [
    (17, 128, 2, dict(window=48)), (32, 128, 2, dict(softcap=30.0)),
    (71, 64, 1, {}), (71, 64, 1, dict(window=48))],
    ids=["G=17-window", "G=32-softcap", "G=71", "G=71-window"])
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
def test_decode_plain_past_group_16_matches_pallas(storage, g, d, hkv, kw):
    """B3's plain version at G = 17, 32 and Falcon-7B's 71 (one kv head,
    head_dim 64; left padding, a window that cuts, a softcap) against the
    Pallas kernel interpreted, within 2^-7 of each row's largest output;
    the row that sees no key gives 0."""
    rng = np.random.default_rng(g + d)
    b, s = 3, 160
    q_t, q_j = _pair(rng, (b, 1, g * hkv, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([150, 160, 70], np.int32)
    kv_start = np.array([0, 37, 70], np.int32)
    b3.COUNTS.reset()
    got = b3.decode_sdpa(q_t, k_t, v_t, kv_len=torch.from_numpy(kv_len),
                         kv_start=torch.from_numpy(kv_start), **kw)
    assert b3.COUNTS.plain_calls == 1 and b3.COUNTS.launches == 0
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), **kw)
    assert not got[2].float().any()
    assert_rows_close(got, want, what=f"B3 {storage} G={g}")


@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
def test_ragged_plain_at_group_71_matches_pallas(pool):
    """B1's plain version on the row mix of ``tests/test_torch_ops.py`` at
    Falcon-7B's 71 query heads over one kv head of 64 against the Pallas
    kernel interpreted: valid queries within one bf16 ulp of the row's
    largest output, idle rows exact zeros."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, hq=71, hkv=1, d=64)
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


def test_flash_plain_at_group_71_matches_pallas():
    """B4's plain version at G = 71 (one kv head of 64) over left-padded
    rows, against the Pallas kernel interpreted, within 2^-7 of each row's
    largest output."""
    rng = np.random.default_rng(71)
    b, t, s, d = 2, 40, 64, 64
    q_t, q_j = _pair(rng, (b, t, 71, d))
    k_t, k_j = _pair(rng, (b, 1, s, d))
    v_t, v_j = _pair(rng, (b, 1, s, d))
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    kw = dict(causal=True, kv_len=np.full((b,), t, np.int32),
              kv_start=np.array([0, 13], np.int32))
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
    assert_rows_close(got, want, what="B4 G=71")


# -- loading, logits, generate -------------------------------------------------

def test_from_pretrained_matches_reference(loaded):
    """Configs equal; the trees bitwise (falcon's qkv in each layout, its
    norms under either architecture's names, the LayerNorm biases, olmo2's
    flat q/k norms); the full-sequence logits of a 40-id prompt within
    2.5% of their largest value."""
    ref, port = loaded
    cfg = port.config
    assert cfg == ModelConfig.from_fields(dataclasses.asdict(ref.config))
    assert_trees_equal(port.params, params_from_reference(
        reference_tree(ref.params), device="cpu"))
    layers = port.params["layers"]
    mt = cfg.model_type
    assert ("attn_norm_bias" in layers) == (mt not in ("olmo2", "cohere"))
    if mt == "olmo2":
        assert (layers["q_norm"].shape[-1], layers["k_norm"].shape[-1]) == \
            (cfg.q_dim, cfg.kv_dim)
    ids = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 40))
    _close(port(ids), np.asarray(ref(ids), np.float32), "bf16",
           "full-sequence logits")


# prompt seeds of the greedy check, one per checkpoint, each the best of
# seeds 0-29 by the least lead of an emitted token over its runner-up
# along the port's three greedy streams (logits of each whole sequence in
# one prefill; the lead noted); the token check itself is exact
GREEDY_SEEDS = {"starcoder2": 27,     # lead 0.104
                "cohere": 18,         # lead 0.073
                "stablelm": 23,       # lead 0.203
                "olmo2": 4,           # lead 0.078
                "falcon": 19,         # lead 0.091
                "falcon_mha": 25,     # lead 0.326
                "falcon_new": 16}     # lead 0.135


def test_generate_greedy_matches_reference(family, loaded):
    """Greedy ``generate()`` of both models over a ragged left-padded
    batch (prompts of 40, 9 and 27 ids; B4 prefills and B3 decodes),
    token for token."""
    ref, port = loaded
    ids, mask = prompt_batch(GREEDY_SEEDS[family], port.config.vocab_size)
    kw = dict(attention_mask=mask, max_new_tokens=6, do_sample=False)
    b4.COUNTS.reset()
    b3.COUNTS.reset()
    got = np.asarray(port.generate(ids, **kw))
    assert b4.COUNTS.plain_calls == b3.COUNTS.plain_calls // 5 == 2
    np.testing.assert_array_equal(got, np.asarray(ref.generate(ids, **kw)))


def test_low_bit_files_round_trip_both_ways(ckpt, loaded, tmp_path):
    """Port save -> port load and -> reference load, reference save -> port
    load: every leaf bitwise (olmo2's flat q/k norms, the LayerNorm
    biases)."""
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
