"""The port's serving engine over the MiniCPM families of
``tests/test_torch_minicpm.py``'s tiny checkpoints, against the JAX
engine and against itself:

- the port's engine and the JAX engine (``planner="static"``) on the same
  four staggered greedy prompts, token for token, logprobs within 0.2
  nats; mixed ticks bitwise one row at a time, a four-step decode horizon
  bitwise one step.
"""

import numpy as np
import pytest
import torch

from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from tests.test_torch_engine import EC, _drive, _port_streams, _prompts
from tests.test_torch_engine import _schedule
from tests.test_torch_minicpm import ckpt, loaded  # noqa: F401 (fixtures)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the tiny models' many
    small ops run fastest on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the engine -------------------------------------------------------------------

# prompt seed of the cross-engine check, the first tried unless noted; the
# token check itself is exact
ENGINE_SEEDS = {"minicpm": 0, "minicpm3": 0}


def test_greedy_streams_match_reference_engine(loaded):
    """Token-identical greedy streams of the two engines over the same
    checkpoint; logprobs within 0.2 nats, 0.05 on average."""
    ref, port = loaded
    prompts = _prompts(port.config.vocab_size,
                       seed=ENGINE_SEEDS[port.config.model_type])
    want = _drive(RefServingEngine(ref.config, ref.params, RefEngineConfig(
        planner="static", perfwatch=False, **EC)),
        _schedule(RefRequest, prompts, max_new_tokens=6))
    got = _drive(ServingEngine(port.config, port.params, EngineConfig(**EC),
                               device="cpu"),
                 _schedule(Request, prompts, max_new_tokens=6))
    for a, b in zip(got, want):
        assert a.output_ids == b.output_ids
        assert a.finish_reason == b.finish_reason == "length"
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0, atol=0.2)
        assert np.abs(np.subtract(a.logprobs, b.logprobs)).mean() < 0.05


def test_mixed_equals_sequential_and_h4_equals_h1(loaded):
    """The engine's paths (greedy, seeded and engine-seeded sampled rows):
    mixed ticks bitwise one row, one chunk a tick, and a four-step horizon
    bitwise one step; B1's plain version on every tick."""
    _, port = loaded
    cfg, params = port.config, port.params
    b1.COUNTS.reset()
    mixed, m_mixed = _port_streams(cfg, params)
    assert b1.COUNTS.plain_calls > 0
    seq, m_seq = _port_streams(cfg, params, step_token_budget=0)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert h4 == mixed == seq
