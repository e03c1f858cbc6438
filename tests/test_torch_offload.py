"""Expert offload and its LRU in the port against the JAX package.

- ``hostutil.HostLRU`` against the reference's on scripted operation
  sequences (the cases of ``tests/test_serving_pagestore.py``'s HostLRU
  tests and more): every counter, byte count, key order and eviction
  callback equal after every step;
- ``offload.OffloadedMoE.generate`` against the reference's on the same
  checkpoint: the reference test's tiny Mixtral at its budget of 0.004 MB
  (about one expert entry, so every layer evicts) and a tiny Qwen1.5-MoE
  (a shared expert behind its sigmoid router, softmax before the top-k):
  greedy tokens equal, each step's fp32 logits within ``LOGIT_TOL`` of the
  step's largest, hits, misses and evictions equal; the port's small and
  full budgets bitwise equal; the tokens equal the port's resident
  ``generate()``;
- the reference's split params carried by ``convert``;
- each routing kind the drive does not serve refused by name.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ipex_llm_tpu.offload as ref_offload
from ipex_llm_tpu.hostutil import HostLRU as RefHostLRU
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.hostutil import HostLRU
from ipex_llm_tpu_torch.models.convert import params_from_split_reference
from ipex_llm_tpu_torch.models.random_init import (TINY_DEEPSEEK_V2_HF,
                                                   TINY_DEEPSEEK_V3_HF,
                                                   random_params)
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.offload import ExpertStore, OffloadedMoE
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_loader import assert_trees_equal
from tests.test_torch_moe import write_moe_checkpoint
from tests.test_torch_quantize import reference_tree

# bf16 logits widened to fp32 by both sides; the two packages' B2 and
# attention sum in different orders, so a step's logits may differ by a
# few bf16 ulps of its largest (one ulp is 2^-8 of a value's binade)
LOGIT_TOL = 2.0 ** -5
NEW = 6
PROMPT = np.arange(3, 13, dtype=np.int32)


# -- HostLRU ------------------------------------------------------------------

def _state(lru) -> tuple:
    return (list(lru.keys()), dict(lru._sizes), lru.used, lru.hits,
            lru.misses, lru.evictions, len(lru), lru.budget)


LRU_SCRIPTS = {
    # tests/test_serving_pagestore.py: budget, LRU order and counters
    "budget and order": (100, [
        ("put", "a", 1, 40), ("put", "b", 2, 40), ("get", "a"),
        ("put", "c", 3, 40), ("get", "b"), ("put", "big", 4, 500),
        ("get", "big")]),
    # snapshot, pop and restore
    "snapshot and pop": (100, [
        ("put", "a", "x", 30), ("snapshot",), ("put", "b", "y", 30),
        ("pop", "a"), ("restore",), ("pop", "missing"), ("get", "a")]),
    # replacing a key, touches without counting, a peek, a zero budget
    "replace and peek": (64, [
        ("put", (0, 1), "p", 32), ("put", (0, 2), "q", 32),
        ("peek", (0, 1)), ("put", (0, 3), "r", 16), ("put", (0, 2), "s", 48),
        ("get", (0, 1), False), ("get", (0, 3)), ("put", (1, 0), "t", 64)]),
    "zero budget": (0, [
        ("put", 1, 1, 8), ("put", 2, 2, 8), ("get", 1), ("get", 2),
        ("pop", 2), ("put", 3, 3, 0)]),
}


@pytest.mark.parametrize("script", sorted(LRU_SCRIPTS))
def test_hostlru_matches_reference(script):
    budget, ops = LRU_SCRIPTS[script]
    evicted = {"ref": [], "port": []}
    ref = RefHostLRU(budget, on_evict=lambda k, v: evicted["ref"].append(
        (k, v)))
    port = HostLRU(budget, on_evict=lambda k, v: evicted["port"].append(
        (k, v)))
    snaps = {}
    for op in ops:
        for name, lru in (("ref", ref), ("port", port)):
            if op[0] == "put":
                lru.put(op[1], op[2], op[3])
            elif op[0] == "get":
                snaps[name, "got"] = lru.get(op[1], *op[2:])
            elif op[0] == "peek":
                snaps[name, "got"] = lru.peek(op[1])
            elif op[0] == "pop":
                snaps[name, "got"] = lru.pop(op[1])
            elif op[0] == "snapshot":
                snaps[name] = lru.snapshot()
            else:
                lru.restore(snaps[name])
        assert _state(port) == _state(ref), op
        assert snaps.get(("port", "got")) == snaps.get(("ref", "got")), op
        assert evicted["port"] == evicted["ref"], op
        assert (1 in port) == (1 in ref) and ("a" in port) == ("a" in ref)


def test_expert_store_rides_hostlru():
    """One budget and eviction implementation: the store's counters are
    its HostLRU's."""
    store = ExpertStore({}, 1024, torch.device("cpu"))
    assert isinstance(store._cache, HostLRU) and store._cache.budget == 1024
    assert (store.hits, store.misses, store.evictions) == (0, 0, 0)


# -- the offloaded drive against the reference's --------------------------------

def _mixtral_checkpoint(path: str) -> str:
    """The reference test's tiny Mixtral (``tests/test_moe.py``: hidden 32,
    2 layers, 4 experts of 64, top 2, vocab 120, ``transformers``' own
    initialisation at torch seed 5)."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    cfg = transformers.MixtralConfig(
        vocab_size=120, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False)
    torch.manual_seed(5)
    transformers.MixtralForCausalLM(cfg).save_pretrained(
        path, safe_serialization=True)
    return path


@pytest.fixture(scope="module", params=["mixtral", "qwen2_moe"])
def pair(request, tmp_path_factory):
    """(family, reference model, port model, checkpoint) in sym_int4."""
    d = str(tmp_path_factory.mktemp(request.param))
    if request.param == "mixtral":
        _mixtral_checkpoint(d)
    else:
        # a margin-chosen seed (ROADMAP queue 3's greedy caveat): at seed 3
        # one decode step's router holds a near-tie between its 4th and
        # 5th expert, which the two packages' fp32 router sums break apart
        # (one hit more in the reference), though the tokens agree
        write_moe_checkpoint(d, "qwen2_moe", seed=0)
    ref = RefAutoModelForCausalLM.from_pretrained(d, load_in_low_bit="sym_int4")
    port = AutoModelForCausalLM.from_pretrained(d, load_in_low_bit="sym_int4",
                                                device="cpu")
    return request.param, ref, port


def _ref_generate(ref, budget_mb, monkeypatch):
    """The reference's offloaded generate, each step's logits recorded."""
    steps = []
    final = ref_offload._final_logits

    def spy(cfg, params, x):
        out = final(cfg, params, x)
        steps.append(np.asarray(out)[0])
        return out
    monkeypatch.setattr(ref_offload, "_final_logits", spy)
    off = ref_offload.OffloadedMoE(ref.config, ref.params,
                                   hbm_budget_mb=budget_mb)
    toks = off.generate(PROMPT, max_new_tokens=NEW)
    return off, toks, np.stack(steps)


BUDGETS = {"0.004 MB": 0.004, "full": 4096.0}


@pytest.fixture(scope="module")
def runs(pair):
    """The port's offloaded generate at each budget."""
    _, _, port = pair
    out = {}
    for name, mb in BUDGETS.items():
        off = OffloadedMoE(port.config, port.params, hbm_budget_mb=mb,
                           device="cpu")
        out[name] = (off, off.generate(PROMPT, max_new_tokens=NEW))
    return out


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_offload_matches_reference(pair, runs, budget, monkeypatch):
    family, ref, _ = pair
    want_off, want, want_logits = _ref_generate(ref, BUDGETS[budget],
                                                monkeypatch)
    off, got = runs[budget]
    np.testing.assert_array_equal(got, want)
    got_logits = off.last_logits.numpy()
    top = np.abs(want_logits).max(axis=-1, keepdims=True)
    assert (np.abs(got_logits - want_logits) <= LOGIT_TOL * top).all()
    assert (off.store.hits, off.store.misses, off.store.evictions) == (
        want_off.store.hits, want_off.store.misses,
        want_off.store._cache.evictions), family
    assert off.store._cache.used == want_off.store._cache.used
    assert list(off.store._cache.keys()) == list(
        want_off.store._cache.keys())
    if budget == "0.004 MB":     # every layer streams and evicts
        n_entries = port_entries = off.cfg.num_layers * off.cfg.num_experts
        assert off.store.misses > n_entries and off.store.evictions > 0, (
            port_entries, off.store.misses)
    else:
        assert off.store.evictions == 0


def test_small_budget_is_bitwise_the_full_one(runs):
    (small, a), (full, b) = runs["0.004 MB"], runs["full"]
    np.testing.assert_array_equal(a, b)
    assert torch.equal(small.last_logits, full.last_logits)
    assert small.store.bytes_copied > full.store.bytes_copied > 0


def test_offload_tokens_equal_the_resident_generate(pair, runs):
    """The reference test's own check: the streamed model's greedy tokens
    are the resident model's."""
    _, _, port = pair
    want = np.asarray(port.generate(PROMPT[None], max_new_tokens=NEW,
                                    eos_token_id=()))
    np.testing.assert_array_equal(runs["full"][1], want)


def test_split_params_carry_from_the_reference(pair):
    """The reference's split tree (device params without the expert
    stacks, the stacks on the host) carried by ``convert`` is the port's
    whole tree, bitwise, and the port's split holds the same planes."""
    _, ref, port = pair
    dev, host = ref_offload.split_expert_params(ref.params)
    tree = params_from_split_reference(reference_tree(dev),
                                       reference_tree(host), device="cpu")
    assert_trees_equal(tree, port.params)
    off = OffloadedMoE(port.config, tree, hbm_budget_mb=1.0, device="cpu")
    assert sorted(off.store.host) == ["moe_down", "moe_gate_up"]
    assert not {"moe_gate_up", "moe_down"} & set(off.params["layers"])


# -- refusals -------------------------------------------------------------------

def _tiny(hf, **over):
    cfg = config_from_hf(hf)
    return dataclasses.replace(cfg, **over) if over else cfg


REFUSED = {
    "group-limited routing": lambda: _tiny(TINY_DEEPSEEK_V2_HF,
                                           moe_layer_start=0),
    "sigmoid router scores": lambda: _tiny(
        TINY_DEEPSEEK_V3_HF, moe_layer_start=0, moe_n_group=0,
        moe_topk_group=0, moe_score_bias=False),
    "a router score bias": lambda: _tiny(
        TINY_DEEPSEEK_V3_HF, moe_layer_start=0, moe_n_group=0,
        moe_topk_group=0, moe_score_func="softmax"),
    "ungated experts": lambda: _tiny(
        TINY_DEEPSEEK_V2_HF, moe_layer_start=0, moe_n_group=0,
        moe_topk_group=0, mlp_gated=False),
    "the parallel residual": lambda: _tiny(
        TINY_DEEPSEEK_V2_HF, moe_layer_start=0, moe_n_group=0,
        moe_topk_group=0, parallel_blocks=True),
    "a dense prefix stack": lambda: _tiny(
        TINY_DEEPSEEK_V2_HF, moe_n_group=0, moe_topk_group=0),
}


@pytest.mark.parametrize("why", sorted(REFUSED))
def test_unserved_routing_kinds_are_refused(why):
    cfg = REFUSED[why]()
    params = random_params(cfg, "sym_int4", seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match=why):
        OffloadedMoE(cfg, params, device="cpu")


def test_expert_biases_are_refused():
    cfg = _tiny(TINY_DEEPSEEK_V2_HF, moe_layer_start=0, moe_n_group=0,
                moe_topk_group=0)
    params = random_params(cfg, "sym_int4", seed=1, device="cpu")
    OffloadedMoE(cfg, params, hbm_budget_mb=0.01, device="cpu")   # served
    layers = dict(params["layers"])
    layers["moe_down_bias"] = torch.zeros(cfg.num_layers, cfg.num_experts,
                                          cfg.hidden_size)
    with pytest.raises(NotImplementedError, match="expert biases"):
        OffloadedMoE(cfg, {**params, "layers": layers}, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        OffloadedMoE(dataclasses.replace(cfg, num_experts=0), params,
                     device="cpu")
