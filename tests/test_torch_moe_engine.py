"""The port's serving engine over a mixture-of-experts model.

A tiny Mixtral-shaped model (8 experts, top 2, 2 layers, hidden 64,
random sym_int4 weights from a seed) through ``ServingEngine`` on the
CPU.  The MoE dispatch picks its route from the static pair count of each
forward (rows x tokens x k: a decode tick of 4 rows is 8 pairs, the gather
route; a prefill chunk or a verify forward is past 32, the ragged route),
and the two routes round differently, as in the reference.  So:

- bitwise: a 4-step decode horizon against one step (every decode step is
  the same forward), the fused speculative tick against the sequential
  engine's host walk (the same verify forwards), a tick retried after a
  transient fault at each guarded site, and the survivors of a poisoned
  request's quarantine;
- token for token, logprobs within 0.2 nats: mixed ticks against the
  sequential engine, and spec against spec off, on greedy rows of a
  margin-chosen seed (a token's route can differ between the two).

Against the JAX ``ServingEngine``, a tiny Qwen3-MoE checkpoint (8
experts, top 4) loaded by both packages serves one speculative schedule:
every ``moe_ffn`` call has the reference's static (rows, tokens, k), so
each forward takes the reference's route, and the greedy streams match.
"""

import numpy as np
import pytest

from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.ops import moe as ref_moe
from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.models.random_init import (mixtral_8x7b_config,
                                                   random_params)
from ipex_llm_tpu_torch.ops import moe
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.ops.rope import RopeScaling
from ipex_llm_tpu_torch.serving.faults import (DeterministicFault,
                                               FaultInjector, TransientFault)
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_engine import (EC, _drive, _port_streams, _prompts,
                                     _schedule)
from tests.test_torch_faults import MIXED_SITES, _assert_bitwise, _wave
from tests.test_torch_faults import _drive as fault_drive
from tests.test_torch_faults import _engine as fault_engine
from tests.test_torch_moe import write_moe_checkpoint
from tests.test_torch_spec import _run as spec_run

SPEC = dict(spec_k=3, decode_horizon=4)
# Prompt seeds of the token-for-token checks, each the best of seeds 0-99
# by the least lead of an emitted token over its runner-up along the
# sequential (or spec-off) engine's greedy streams (each stream's logits in
# one prefill), noted; the token check itself is exact.
MIXED_SEED = 13     # margin 0.094 (three bf16 ulps at logits of about 4)
SPEC_SEED = 42      # margin 0.047
# Prompt seed of the cross-engine check, by the same rule along the port's
# two greedy streams of its schedule (the tiny Qwen3-MoE, spec on).
REF_SEED = 14       # margin 0.172 (five bf16 ulps at logits of about 4)


def tiny_mixtral():
    cfg = mixtral_8x7b_config(
        hidden_size=64, intermediate_size=96, moe_intermediate_size=96,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        vocab_size=256, max_position_embeddings=512,
        rope=RopeScaling(head_dim=16, base=1e6))
    return cfg, random_params(cfg, "sym_int4", seed=7, device="cpu",
                              router_scale=2.5)


@pytest.fixture(scope="module")
def port():
    return tiny_mixtral()


@pytest.fixture(scope="module")
def baseline(port):
    """The unfaulted run of tests/test_torch_faults.py's wave."""
    reqs = _wave(port[0].vocab_size)
    return {"streams": fault_drive(fault_engine(port), reqs),
            "logprobs": [r.logprobs for r in reqs],
            "reasons": [r.finish_reason for r in reqs]}


def _greedy_run(port, prompts, **ec):
    """Greedy requests of 8 new tokens on ``_prompts``' schedule through a
    port engine: (tokens, logprobs, finish reason) of each, and metrics."""
    cfg, params = port
    eng = ServingEngine(cfg, params, EngineConfig(**EC, **ec), device="cpu")
    reqs = _drive(eng, _schedule(Request, prompts, max_new_tokens=8))
    return ([(r.output_ids, r.logprobs, r.finish_reason) for r in reqs],
            eng.metrics)


def test_h4_equals_h1_and_mixed_matches_sequential(port):
    """A 4-step decode horizon is bitwise one step (greedy, seeded and
    engine-seeded sampled rows); mixed ticks against one row, one chunk a
    tick: token for token, logprobs within 0.2 nats."""
    cfg, params = port
    before = b2e.COUNTS.plain_calls
    mixed, _ = _port_streams(cfg, params)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert b2e.COUNTS.plain_calls > before       # the experts ran
    assert m_h4["decode_horizon_effective"] == 4
    assert h4 == mixed
    prompts = _prompts(cfg.vocab_size, seed=MIXED_SEED)
    mixed, m_mixed = _greedy_run(port, prompts)
    seq, m_seq = _greedy_run(port, prompts, step_token_budget=0)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    for (ta, la, ra), (tb, lb, rb) in zip(mixed, seq):
        assert ta == tb and ra == rb == "length"
        np.testing.assert_allclose(la, lb, rtol=0, atol=0.2)


def test_fused_spec_matches_host_walk_and_spec_off(port):
    """The fused speculative tick (spec_k 3, horizon 4: its verify forward
    is 4 rows x 4 tokens x 2 = 32 pairs or more) is bitwise the sequential
    engine's host walk, and greedy rows equal spec off token for token."""
    pair = (None, None) + tuple(port)
    rng = np.random.default_rng(SPEC_SEED)
    prompts = [list(map(int, np.tile(rng.integers(1, 256, 4), 10))),
               list(map(int, rng.integers(1, 256, 40))),
               list(map(int, np.tile(rng.integers(1, 256, 5), 8)))]
    reqs = [dict(prompt_ids=prompts[0], max_new_tokens=18),
            dict(prompt_ids=prompts[2], max_new_tokens=14, temperature=0.8,
                 top_p=0.9, top_k=40, seed=321),
            dict(prompt_ids=prompts[1], max_new_tokens=10)]
    fused = spec_run(pair, SPEC, reqs)
    oracle = spec_run(pair, dict(step_token_budget=0,
                                 spec_k=SPEC["spec_k"]), reqs)
    off = spec_run(pair, {}, reqs)
    assert fused[0] == oracle[0] and fused[1] == oracle[1]
    assert fused[2] == oracle[2] == ["length"] * 3
    assert fused[3]["spec_steps"] > 0 and fused[3]["draft_proposed"] > 0
    for i in (0, 2):                          # the greedy rows
        assert fused[0][i] == off[0][i]
        np.testing.assert_allclose(fused[1][i], off[1][i], rtol=0,
                                   atol=0.2)


@pytest.mark.parametrize("site", MIXED_SITES)
def test_transient_fault_retries_bitwise(port, baseline, site):
    """A ``TransientFault`` at the second hit of each guarded site rolls
    the tick back and runs it again: the streams are bitwise the unfaulted
    run's (the dispatch sums in fixed orders, with no atomics)."""
    inj = FaultInjector().inject(site, TransientFault, nth=2)
    eng = fault_engine(port, inj)
    reqs = _wave(port[0].vocab_size)
    streams = fault_drive(eng, reqs)
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, baseline)


def test_poisoned_request_is_isolated(port, baseline):
    """A deterministic fault tied to one request fails it alone; the other
    three are bitwise the unfaulted run's."""
    reqs = _wave(port[0].vocab_size)
    reqs[2].request_id = "poisoned"
    inj = FaultInjector().inject("mixed-step", DeterministicFault, nth=1,
                                 request_id="poisoned", times=None)
    eng = fault_engine(port, inj)
    streams = fault_drive(eng, reqs)
    assert reqs[2].finish_reason == "error" and streams[2] == []
    assert eng.metrics["errors_isolated"] == 1
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, baseline, skip=(2,))


@pytest.fixture(scope="module")
def qwen3_moe_models(tmp_path_factory):
    """(reference model, port model) in sym_int4 from one tiny Qwen3-MoE
    checkpoint, the reference through its jitted codec."""
    path = write_moe_checkpoint(str(tmp_path_factory.mktemp("qwen3_moe")),
                                "qwen3_moe")
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        ref = RefAutoModelForCausalLM.from_pretrained(
            path, load_in_low_bit="sym_int4")
    finally:
        ref_native.available = old
    return ref, AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", device="cpu")


def test_routes_and_streams_match_reference_engine(qwen3_moe_models,
                                                   monkeypatch):
    """The speculative engine (spec_k 3, horizon 4) of each package serves
    two greedy prompts of 23 and 40 ids arriving together (one JAX engine:
    each program it compiles costs seconds): the (rows, tokens, k) of the
    port's ``moe_ffn`` calls are the shapes the JAX engine traces its
    dispatch at (the mixed tick's buckets and the verify forward, 4 x 4 x
    4 pairs: the ragged route), and the streams are token-identical,
    logprobs within 0.2 nats, 0.05 on average."""
    ref, port = qwen3_moe_models
    shapes = {"ref": set(), "port": set()}

    def recording(mod, key):
        ffn = mod.moe_ffn

        def wrapped(h, w, idx, *args, **kw):
            shapes[key].add((h.shape[0], h.shape[1], idx.shape[-1]))
            return ffn(h, w, idx, *args, **kw)
        monkeypatch.setattr(mod, "moe_ffn", wrapped)
    recording(ref_moe, "ref")
    recording(moe, "port")
    prompts = [(ids, 0) for ids, _ in
               _prompts(port.config.vocab_size, seed=REF_SEED)[1:3]]
    want = _drive(RefServingEngine(ref.config, ref.params, RefEngineConfig(
        planner="static", perfwatch=False, **EC, **SPEC)),
        _schedule(RefRequest, prompts, max_new_tokens=6))
    got = _drive(ServingEngine(port.config, port.params,
                               EngineConfig(**EC, **SPEC), device="cpu"),
                 _schedule(Request, prompts, max_new_tokens=6))
    k = port.config.num_experts_per_tok
    assert shapes["port"] == shapes["ref"]
    assert (EC["max_rows"], SPEC["spec_k"] + 1, k) in shapes["port"]
    assert all(b * t * k > moe.GATHER_PAIR_LIMIT
               for b, t, _ in shapes["port"])
    for a, b in zip(got, want):
        assert a.output_ids == b.output_ids
        assert a.finish_reason == b.finish_reason == "length"
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=0.2)
        assert np.abs(np.subtract(a.logprobs, b.logprobs)).mean() < 0.05
