"""The port's serving engine over the falcon slice's tiny checkpoints
(``tests/test_torch_falcon_families.py``), against the JAX engine and
against itself.

- The port's engine and the JAX engine (``planner="static"``) serve the
  same four staggered greedy prompts of ``tests/test_torch_engine.py``
  (5 to 70 ids, rows joining mid-wave) over the tiny falcon checkpoint
  (Falcon-7B's layout: one kv head, the parallel block), token for token,
  logprobs within 0.2 nats; the prompt seed is chosen for its margins
  (the least lead of an emitted token over its runner-up, noted beside
  it).
- Mixed ticks against one row, one chunk a tick, and a four-step decode
  horizon against one step, bitwise in tokens and logprobs (greedy, seeded
  and engine-seeded sampled rows), for falcon (every query head over one
  kv head), olmo2 (the norms after each branch, flat q/k norms) and
  starcoder2 (a window of 24 on every layer: the gathered route).
"""

import numpy as np
import pytest
import torch

from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_engine import EC, _drive, _port_streams, _prompts
from tests.test_torch_engine import _schedule
from tests.test_torch_falcon_families import write_checkpoint
from tests.test_torch_glm_families import reference_model

# prompt seed of the cross-engine check: the best of seeds 0-99 by the
# least lead of an emitted token over its runner-up along the port
# engine's greedy streams (logits of each whole sequence in one prefill),
# the lead noted; the token check itself is exact
ENGINE_SEED = 15             # lead 0.104


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["falcon", "olmo2", "starcoder2"])
def port(request, tmp_path_factory):
    return AutoModelForCausalLM.from_pretrained(
        write_checkpoint(str(tmp_path_factory.mktemp(request.param)),
                         request.param),
        load_in_low_bit="sym_int4", device="cpu")


def test_greedy_streams_match_reference_engine(tmp_path):
    """Token-identical greedy streams of the two engines over the tiny
    falcon checkpoint (see ENGINE_SEED); logprobs within 0.2 nats, 0.05
    on average."""
    path = write_checkpoint(str(tmp_path), "falcon")
    ref = reference_model(path)
    port = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", device="cpu")
    prompts = _prompts(port.config.vocab_size, seed=ENGINE_SEED)
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


def test_mixed_equals_sequential_and_h4_equals_h1(port):
    """The engine's paths (greedy, seeded and engine-seeded sampled rows):
    mixed ticks against one row, one chunk a tick, and a four-step horizon
    against one step, bitwise in tokens and logprobs."""
    cfg, params = port.config, port.params
    mixed, m_mixed = _port_streams(cfg, params)
    seq, m_seq = _port_streams(cfg, params, step_token_budget=0)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert mixed == seq
    assert h4 == mixed
