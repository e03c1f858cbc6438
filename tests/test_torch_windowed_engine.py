"""The port's serving engine over windowed and soft-capped models.

A window, a softcap or left padding sends a paged layer down the
reference's gathered route (``ops/attention.py::cached_sdpa``: each row's
pages gathered into a head-major layer, then B3 at T=1 and B4 otherwise).
On tiny mistral (a window of 16 on every layer), qwen2 (no window, B1's
route, a qkv bias) and gemma2 (a window of 8 on its even layers, softcaps
on every layer, head_dim 32) models:

- against the JAX ``ServingEngine`` on the same weights: greedy streams
  token-identical, logprobs within 0.2 nats (0.05 on average);
- inside the port, on the gemma2 model: the mixed engine equals the
  sequential one and a 4-step decode horizon one step, bitwise; the fused
  speculative tick equals the sequential engine's host walk bitwise and
  spec-off in tokens (its verify forward is T = 4 over the gathered
  layer); a transient fault retries the tick bitwise.
"""

import numpy as np
import pytest
import torch

from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.serving.faults import FaultInjector, TransientFault
from tests.test_torch_engine import (EC, _drive, _port_streams, _prompts,
                                     _schedule)
from tests.test_torch_families import weights_pair
from tests.test_torch_faults import MIXED_SITES, _assert_bitwise, _wave
from tests.test_torch_faults import _drive as fault_drive
from tests.test_torch_faults import _engine as fault_engine
from tests.test_torch_generation import tiny_pair as generation_pair
from tests.test_torch_spec import _run as spec_run

# Prompt seeds of the cross-engine check, one per family, by the rule of
# tests/test_torch_engine.py's GREEDY_SEED: each the best of seeds 0-99 by
# the least lead of an emitted token over its runner-up along the port's
# four greedy streams (logits of each whole sequence in one prefill), the
# margin noted; the token check itself is exact.
GREEDY_SEEDS = {"mistral": 5,        # margin 0.125 (logits of about 10)
                "qwen2": 49,         # margin 0.078 (logits of about 4)
                "gemma2": 97}        # margin 3.18 (logits of about 30)
SPEC = dict(spec_k=3, decode_horizon=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores (each worker's default pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(family: str):
    """(reference cfg, reference params, port cfg, port params) in
    sym_int4: the tiny mistral of tests/test_torch_generation.py, and the
    tiny qwen2 and gemma2 of tests/test_torch_families.py (the weights of
    its checkpoints, built without writing them)."""
    if family == "mistral":
        return generation_pair("sym_int4", "mistral")
    return weights_pair(family)


@pytest.fixture(scope="module")
def gemma2():
    """The windowed and soft-capped model the port's own engine
    equivalences run on (mistral's window alone is a subset of its
    route; qwen2's engine paths are B1's, which tests/test_torch_engine.py
    holds)."""
    return _pair("gemma2")


@pytest.fixture(scope="module", params=["mistral", "qwen2", "gemma2"])
def pair(request):
    if request.param == "gemma2":
        return request.getfixturevalue("gemma2")
    return _pair(request.param)


@pytest.fixture(scope="module")
def gemma2_baseline(gemma2):
    """The unfaulted run of tests/test_torch_faults.py's wave."""
    reqs = _wave(gemma2[2].vocab_size)
    return {"streams": fault_drive(fault_engine(gemma2[2:]), reqs),
            "logprobs": [r.logprobs for r in reqs],
            "reasons": [r.finish_reason for r in reqs]}


def test_greedy_streams_match_reference_engine(pair):
    """Token-identical greedy streams against the JAX engine (prompts of 5,
    23, 40 and 70 ids arriving over five ticks: the windows cut the longer
    ones), logprobs within 0.2 nats, 0.05 on average, as the llama engine
    tests hold them.  The windowed models' paged layers take the gathered
    route (B3 at T=1, B4 for the prefill chunks), qwen2's B1's."""
    cfg, params, port_cfg, port_params = pair
    prompts = _prompts(cfg.vocab_size, GREEDY_SEEDS[cfg.model_type])
    ref = _drive(RefServingEngine(cfg, params, RefEngineConfig(
        planner="static", perfwatch=False, **EC)),
        _schedule(RefRequest, prompts, max_new_tokens=6))
    calls = {m: m.COUNTS.plain_calls for m in (b1, b3, b4)}
    port = _drive(ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                                device="cpu"),
                  _schedule(Request, prompts, max_new_tokens=6))
    for a, b in zip(port, ref):
        assert a.output_ids == b.output_ids
        assert a.finish_reason == b.finish_reason == "length"
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=0.2)
        assert np.abs(np.subtract(a.logprobs, b.logprobs)).mean() < 0.05
    ran = {m.NAME: m.COUNTS.plain_calls - calls[m] for m in (b1, b3, b4)}
    windowed = port_cfg.sliding_window is not None
    assert (ran["ragged_paged_attention"] == 0) == windowed, ran
    assert (ran["decode_attention"] > 0 and ran["flash_attention"] > 0) \
        == windowed, ran


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_windowed_mixed_equals_sequential_and_h4_equals_h1(gemma2,
                                                            storage):
    """Bit-identical token and logprob streams across the engine's paths
    over the gathered route: mixed ticks vs one row, one chunk per tick,
    and a 4-step decode horizon vs one step (greedy, seeded and
    engine-seeded sampled rows)."""
    _, _, port_cfg, port_params = gemma2
    mixed, m_mixed = _port_streams(port_cfg, port_params, storage)
    seq, m_seq = _port_streams(port_cfg, port_params, storage,
                               step_token_budget=0)
    h4, m_h4 = _port_streams(port_cfg, port_params, storage,
                             decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert mixed == seq
    assert h4 == mixed


def test_windowed_fused_spec_matches_host_walk_and_spec_off(gemma2):
    """The fused speculative tick (spec_k 3, horizon 4: the verify forward
    is T = 4 through B4 over the gathered layer, with each row's query
    slots as q_positions) is bitwise the sequential engine's host walk and
    token-identical to spec off, on two repeating prompts (which prompt
    lookup drafts from) longer than the window and a random one."""
    rng = np.random.default_rng(11)
    prompts = [list(map(int, np.tile(rng.integers(1, 256, 4), 10))),
               list(map(int, np.tile(rng.integers(1, 256, 5), 8))),
               list(map(int, rng.integers(1, 256, 40)))]
    reqs = [dict(prompt_ids=prompts[0], max_new_tokens=18),
            dict(prompt_ids=prompts[1], max_new_tokens=14, temperature=0.8,
                 top_p=0.9, top_k=40, seed=321),
            dict(prompt_ids=prompts[2], max_new_tokens=10)]
    fused = spec_run(gemma2, SPEC, reqs)
    oracle = spec_run(gemma2, dict(step_token_budget=0,
                                   spec_k=SPEC["spec_k"]), reqs)
    off = spec_run(gemma2, {}, reqs)
    assert fused[0] == oracle[0] and fused[1] == oracle[1]
    assert fused[2] == oracle[2] == ["length"] * 3
    assert fused[0] == off[0]
    assert fused[3]["spec_steps"] > 0 and fused[3]["draft_proposed"] > 0
    assert fused[3]["draft_accepted"] == oracle[3]["draft_accepted"]


@pytest.mark.parametrize("site", MIXED_SITES)
def test_windowed_transient_fault_retries_bitwise(gemma2, gemma2_baseline,
                                                  site):
    """A ``TransientFault`` at the second hit of each guarded site of the
    mixed tick rolls the tick back and runs it again: the streams of
    tests/test_torch_faults.py's wave (prompts of 24-70 ids, which the
    window cuts) are bitwise the unfaulted run's."""
    port = gemma2[2:]
    inj = FaultInjector().inject(site, TransientFault, nth=2)
    eng = fault_engine(port, inj)
    reqs = _wave(port[0].vocab_size)
    streams = fault_drive(eng, reqs)
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    assert eng.metrics.get("errors", 0) == 0
    _assert_bitwise(reqs, streams, gemma2_baseline)
