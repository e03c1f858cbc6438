"""Prompt-lookup speculative decoding in the port's serving engine (a port
of ``tests/test_serving_spec.py`` without its fault-rollback case, which
waits for the transactional tick).

The contract: with ``spec_k > 0`` the mixed engine drafts, verifies and
accepts on the device inside its tick (``spec_horizon_loop``), and its
streams are bit-identical (tokens, logprobs, finish reasons) to the
sequential engine's host walk (``step_token_budget=0``, ``_spec_step``)
and token-identical to the spec-off engine, for greedy and seeded rows,
across decode horizons, mid-horizon EOS inside accepted runs, per-request
opt-outs and pool pressure.  The device proposer and the host proposer are
held bitwise against the JAX package's, and greedy spec streams against
the JAX spec engine's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.ops.speculate import \
    propose_ngram_rows as ref_propose_ngram_rows
from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu.serving.engine import _propose_ngram as ref_propose_ngram
from ipex_llm_tpu_torch.ops.speculate import propose_ngram_rows
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine, _propose_ngram,
                                               stream_tokens)
from tests.test_torch_decoder import tiny_pair

# ONE engine shape for the module, so the JAX engine compiles its tick
# programs once
EC = dict(max_rows=4, max_seq_len=256, page_size=16, prefill_bucket=32)
SPEC = dict(spec_k=3, decode_horizon=4)

# Prompt seed of the cross-engine check, by the rule of
# tests/test_torch_engine.py's GREEDY_SEED, over seeds 0-399 of
# ``_prompts``: along each of the three 10-token greedy streams the emitted
# token leads its runner-up by at least 0.125 (four bf16 ulps at these
# logits), and the port's spec engine accepts a draft on them.
SPEC_GREEDY_SEED = 219


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("bf16")


def _periodic(base_len: int, reps: int, rng) -> list[int]:
    return list(map(int, np.tile(rng.integers(1, 256, base_len), reps)))


def _prompts(seed: int):
    """Two repeating prompts (the text prompt lookup serves) and a
    non-repeating one of two prefill chunks."""
    rng = np.random.default_rng(seed)
    return [_periodic(4, 10, rng), _periodic(5, 8, rng),
            list(map(int, rng.integers(1, 256, 40)))]


def _run(pair, ec: dict, req_kws):
    """Serve ``req_kws`` together through a port engine driven tick by
    tick; returns (streams, logprobs, finish reasons, metrics, spec_stats)."""
    _, _, port_cfg, port_params = pair
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC, **ec),
                        device="cpu")
    reqs = [eng.submit(Request(**kw)) for kw in req_kws]
    for _ in range(2000):
        eng._tick()
        if all(r.finish_reason is not None for r in reqs):
            break
    assert all(r.finish_reason is not None for r in reqs)
    return ([r.output_ids for r in reqs], [r.logprobs for r in reqs],
            [r.finish_reason for r in reqs], dict(eng.metrics),
            eng.spec_stats())


# -- the proposers ------------------------------------------------------------

def test_proposers_match_the_reference_bitwise():
    """The port's device proposer and host proposer compute, bit for bit,
    what the JAX package's ``propose_ngram_rows`` and ``_propose_ngram``
    compute: the same match (longest n-gram first, most recent occurrence
    wins), the same run length (clipped at the history end), zeros past
    the run."""
    rng = np.random.default_rng(5)
    s = 96
    for trial in range(40):
        k = int(rng.integers(1, 6))
        ngram = int(rng.integers(1, 5))
        r = int(rng.integers(1, 5))
        hist = np.zeros((r, s), np.int32)
        lens = np.zeros((r,), np.int32)
        for i in range(r):
            ln = int(rng.integers(1, s))
            hist[i, :ln] = rng.integers(0, 6, ln)    # tiny vocab: matches
            lens[i] = ln                             # abound
        drafts, n_prop = propose_ngram_rows(torch.from_numpy(hist),
                                            torch.from_numpy(lens), k, ngram)
        ref_d, ref_n = ref_propose_ngram_rows(jnp.asarray(hist),
                                              jnp.asarray(lens), k, ngram)
        assert drafts.dtype == n_prop.dtype == torch.int32
        np.testing.assert_array_equal(drafts.numpy(), np.asarray(ref_d))
        np.testing.assert_array_equal(n_prop.numpy(), np.asarray(ref_n))
        for i in range(r):
            h = hist[i, :lens[i]]
            d = _propose_ngram(h, k, ngram)
            np.testing.assert_array_equal(d, ref_propose_ngram(h, k, ngram))
            valid = d >= 0
            wn = k if valid.all() else int(valid.argmin())
            assert int(n_prop[i]) == wn, (trial, i)
            np.testing.assert_array_equal(drafts[i, :wn].numpy(), d[:wn])
            assert not drafts[i, wn:].any()


# -- the fused tick against the host walk and against spec off ---------------

@pytest.mark.parametrize("kv", [
    "bf16",
    # the e5m2 form proves the same code paths over another pool; the JAX
    # suite keeps it in the slow tier, and so does the port
    pytest.param("fp8", marks=pytest.mark.slow),
])
def test_fused_spec_matches_host_walk_oracle_and_spec_off(pair, kv):
    """Greedy and seeded streams through the fused spec engine (mixed
    ticks, horizon 4) are bit-identical in tokens, logprobs and finish
    reasons to the host-walk oracle (the sequential engine), share its
    verify-round accounting, and are token-identical to the spec-off
    engine.  Logprobs against spec off agree within 5e-3: the verify
    forward is [R, spec_k + 1] wide where the plain step is [R, 1]."""
    prompts = _prompts(11)
    reqs = [dict(prompt_ids=prompts[0], max_new_tokens=18),      # greedy
            dict(prompt_ids=prompts[1], max_new_tokens=14,
                 temperature=0.8, top_p=0.9, top_k=40, seed=321),  # seeded
            dict(prompt_ids=prompts[2], max_new_tokens=10)]      # 2 chunks
    fused = _run(pair, dict(kv_storage=kv, **SPEC), reqs)
    oracle = _run(pair, dict(kv_storage=kv, step_token_budget=0,
                             spec_k=SPEC["spec_k"]), reqs)
    off = _run(pair, dict(kv_storage=kv), reqs)
    assert fused[0] == oracle[0]
    assert fused[1] == oracle[1]
    assert fused[2] == oracle[2] == ["length"] * 3
    assert fused[0] == off[0]
    for a, b in zip(fused[1], off[1]):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)
    assert fused[3]["spec_steps"] > 0 and fused[3]["mixed_steps"] > 0
    assert oracle[3]["mixed_steps"] == 0
    for key in ("spec_emitted", "spec_row_steps", "spec_accept_rate",
                "draft_proposed", "draft_accepted"):
        assert fused[3][key] == oracle[3][key], key
    assert fused[3]["draft_proposed"] > 0
    assert 0.0 <= fused[4]["accept_rate"] <= 1.0


def test_spec_greedy_streams_match_reference_engine(pair):
    """The port's spec engine and the JAX spec engine (the same weights,
    both mixed, spec_k 3, horizon 4) emit the same greedy streams on the
    prompts of SPEC_GREEDY_SEED; logprobs agree within 0.2 nats, as the
    spec-off streams of tests/test_torch_engine.py do."""
    cfg, params, _, _ = pair
    prompts = _prompts(SPEC_GREEDY_SEED)
    kws = [dict(prompt_ids=p, max_new_tokens=10) for p in prompts]
    port = _run(pair, SPEC, kws)
    ref_eng = RefServingEngine(cfg, params, RefEngineConfig(
        planner="static", perfwatch=False, **EC, **SPEC))
    ref = [ref_eng.submit(RefRequest(**kw)) for kw in kws]
    for _ in range(2000):
        ref_eng._tick()
        if all(r.finish_reason is not None for r in ref):
            break
    assert [r.output_ids for r in ref] == port[0]
    assert [r.finish_reason for r in ref] == port[2] == ["length"] * 3
    for r, lp in zip(ref, port[1]):
        np.testing.assert_allclose(lp, r.logprobs, rtol=0, atol=0.2)
    assert port[4]["draft_accepted"] > 0
    assert ref_eng.spec_stats()["draft_proposed"] > 0


def test_spec_horizon_matches_h1_and_accepts(pair):
    """H=4 and H=1 spec engines emit identical streams; drafts are
    accepted (more tokens than row-rounds) and a horizon tick emits more
    than one token."""
    reqs = [dict(prompt_ids=_prompts(1)[0], max_new_tokens=20)]
    h4 = _run(pair, SPEC, reqs)
    h1 = _run(pair, dict(spec_k=SPEC["spec_k"], decode_horizon=1), reqs)
    assert h4[0] == h1[0] and h4[1] == h1[1]
    m = h4[3]
    assert m["spec_emitted"] > m["spec_row_steps"], m
    assert m["spec_tokens_per_dispatch"] > 1.0, m
    assert h4[4]["draft_accepted"] > 0


def test_spec_mid_horizon_eos_with_rejected_drafts(pair):
    """A row whose EOS lands inside an accepted run stops where every
    engine stops: the device cuts the run at the first EOS, no later token
    leaks, and the finish reason is 'stop'.  On this prompt (found by
    search: the tiny model rarely copies its prompt) the spec engine's
    stream takes output tokens 10 and 11 in one verify round (a draft
    accepted, the others rejected), and token 10 is new to the stream, so
    declaring it EOS cuts that round after its first token."""
    prompt = _prompts(233)[0]
    eos_pos = 10
    plain = _run(pair, {}, [dict(prompt_ids=prompt, max_new_tokens=16)])
    probe = _run(pair, SPEC, [dict(prompt_ids=prompt, max_new_tokens=16)])
    assert probe[0] == plain[0]
    assert probe[3]["draft_accepted"] == 1
    eos_tok = plain[0][0][eos_pos]
    assert eos_tok not in plain[0][0][:eos_pos]
    reqs = [dict(prompt_ids=prompt, max_new_tokens=16,
                 eos_token_id=(int(eos_tok),))]
    fused = _run(pair, SPEC, reqs)
    oracle = _run(pair, dict(step_token_budget=0, spec_k=SPEC["spec_k"]),
                  reqs)
    off = _run(pair, {}, reqs)
    assert fused[0] == oracle[0] == off[0] == [plain[0][0][:eos_pos + 1]]
    assert fused[1] == oracle[1]
    assert fused[2] == oracle[2] == off[2] == ["stop"]
    # the cut round emitted one token of its accepted two
    assert fused[3]["spec_emitted"] == eos_pos
    assert fused[3]["draft_accepted"] == 0
    assert fused[3]["draft_proposed"] > 0


def test_spec_budget_cut_inside_an_accepted_run(pair):
    """The budget ends the stream inside an accepted run (output tokens
    6-9 of this prompt come from one verify round; the budget is 7): every
    engine stops at 7 tokens, and the host walk counts what it emitted,
    as the fused tick does.  (The JAX host walk counts the whole accepted
    chain there: 9 tokens and 3 accepted drafts against the fused tick's
    6 and 0; ROADMAP queue 3.)"""
    reqs = [dict(prompt_ids=_prompts(1)[0], max_new_tokens=7)]
    fused = _run(pair, SPEC, reqs)
    oracle = _run(pair, dict(step_token_budget=0, spec_k=SPEC["spec_k"]),
                  reqs)
    off = _run(pair, {}, reqs)
    assert fused[0] == oracle[0] == off[0] and len(fused[0][0]) == 7
    for m in (fused[3], oracle[3]):
        assert (m["spec_emitted"], m["draft_accepted"]) == (6, 0)
        assert m["draft_proposed"] == 3


def test_spec_per_request_optout(pair):
    """``speculative=False`` and ``Request.spec_k`` ride the same spec
    tick as per-row widths: an opted-out row proposes nothing, a capped row
    at most its cap, and every stream equals the spec-off engine's (greedy)
    or the same seed's (sampled)."""
    p = _prompts(1)[0]
    reqs = [dict(prompt_ids=p, max_new_tokens=12, speculative=False),
            dict(prompt_ids=p, max_new_tokens=12, spec_k=1),
            dict(prompt_ids=p, max_new_tokens=12, temperature=0.9, seed=7,
                 spec_k=0)]
    fused = _run(pair, SPEC, reqs)
    off = _run(pair, {}, reqs)
    assert fused[0] == off[0] and fused[2] == off[2]
    for a, b in zip(fused[1], off[1]):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)
    # only the capped row drafts, one token a round, and it accepts on
    # this prompt (tests/test_torch_spec.py::_prompts(1))
    alone = _run(pair, SPEC, [reqs[1]])
    assert fused[4]["draft_proposed"] == alone[4]["draft_proposed"] > 0
    assert fused[3]["draft_proposed"] <= fused[3]["spec_row_steps"]
    none = _run(pair, SPEC, [reqs[0], reqs[2]])
    assert none[4]["draft_proposed"] == 0 and none[3]["spec_steps"] > 0


def test_spec_under_pool_pressure_falls_back_to_plain_steps(pair):
    """With pages for the streams but not for the verify windows, a row
    takes plain steps through the wide forward instead of finishing early:
    both spec engines serve every request to its budget with the spec-off
    streams.  Two 40-id prompts hold 3 pages each of a 6-page pool; the
    second row's window needs a fourth page before the first row, done
    after 8 tokens, gives its pages back."""
    prompts = _prompts(1)
    reqs = [dict(prompt_ids=prompts[0], max_new_tokens=8),
            dict(prompt_ids=prompts[2], max_new_tokens=24)]
    want = _run(pair, {}, reqs)
    for ec in (SPEC, dict(step_token_budget=0, spec_k=SPEC["spec_k"])):
        got = _run(pair, dict(pool_pages=7, **ec), reqs)
        assert got[0] == want[0] and got[2] == ["length"] * 2
        assert got[3]["alloc_fail_clamps"] > 0
        assert got[3]["spec_steps"] > 0


def test_spec_stats_and_config(pair):
    """``spec_stats()`` reports the draft economics; a horizon on the
    sequential spec engine and an n-gram length of 0 are refused."""
    stats = _run(pair, SPEC, [dict(prompt_ids=_prompts(1)[0],
                                   max_new_tokens=16)])[4]
    assert stats["spec_k"] == SPEC["spec_k"] and stats["fused"]
    assert stats["spec_ngram"] == 3
    assert stats["draft_proposed"] >= stats["draft_accepted"] > 0
    assert 0.0 < stats["accept_rate"] <= 1.0
    assert 0.0 < stats["accept_rate_lifetime"] <= 1.0
    assert stats["tokens_per_dispatch"] > 1.0
    _, _, port_cfg, port_params = pair
    for bad in (dict(step_token_budget=0, **SPEC),
                dict(spec_k=2, spec_ngram=0), dict(spec_k=-1)):
        with pytest.raises(ValueError):
            ServingEngine(port_cfg, port_params, EngineConfig(**EC, **bad),
                          device="cpu")


def test_spec_engine_thread_streams(pair):
    """The threaded engine streams a speculative request token by token,
    as ``stream_tokens`` readers see it."""
    _, _, port_cfg, port_params = pair
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC, **SPEC),
                        device="cpu").start()
    try:
        req = eng.submit(Request(prompt_ids=_prompts(1)[0],
                                 max_new_tokens=12))
        assert list(stream_tokens(req, timeout=60)) == req.output_ids
        assert len(req.output_ids) == 12 and req.finish_reason == "length"
    finally:
        eng.stop()
    assert not eng._thread.is_alive()
