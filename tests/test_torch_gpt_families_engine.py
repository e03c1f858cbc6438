"""The port's serving engine over the GPT-style families (phi, phixtral,
gpt_neox, gptj) of ``tests/test_torch_gpt_families.py``'s tiny
checkpoints, against the JAX engine and against itself.

- The port's engine and the JAX engine (``planner="static"``) serve the
  same four staggered greedy prompts of ``tests/test_torch_engine.py``
  (5 to 70 ids, rows joining mid-wave), token for token, logprobs within
  0.2 nats; the prompt seed of each family is chosen for its margins (the
  least lead of an emitted token over its runner-up, noted beside it).
- Mixed ticks against one row, one chunk a tick, and a four-step decode
  horizon against one step: bitwise in tokens and logprobs for phi (head
  dim 80: B1's plain version at 80 on every tick) and gptj (the "two"
  rope on 8 of 32 columns); for phixtral the MoE route follows the
  forward's pair count, so the mixed engine holds in tokens only (ROADMAP
  queue 3) and the horizon bitwise.
"""

import numpy as np
import pytest
import torch

from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu.transformers import \
    AutoModelForCausalLM as RefAutoModelForCausalLM
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_engine import EC, _drive, _port_streams, _prompts
from tests.test_torch_engine import _schedule
from tests.test_torch_gpt_families import write_checkpoint

# prompt seed of the cross-engine check, one per family: the best of seeds
# 0-99 by the least lead of an emitted token over its runner-up along the
# port engine's greedy streams (logits of each whole sequence in one
# prefill, of about 5; one bf16 ulp there is 0.031), the lead noted; the
# token check itself is exact
ENGINE_SEEDS = {"phi": 96,           # lead 0.047
                "phixtral": 89,      # lead 0.078
                "gpt_neox": 59,      # lead 0.078
                "gptj": 69}          # lead 0.063


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(path: str, ref: bool):
    port = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", device="cpu")
    if not ref:
        return None, port
    old = ref_native.available
    ref_native.available = lambda: False
    try:
        return RefAutoModelForCausalLM.from_pretrained(
            path, load_in_low_bit="sym_int4"), port
    finally:
        ref_native.available = old


@pytest.mark.parametrize("family", ["phi", "phixtral", "gpt_neox", "gptj"])
def test_greedy_streams_match_reference_engine(family, tmp_path):
    """Token-identical greedy streams of the two engines over the same
    checkpoint (see ENGINE_SEEDS); logprobs within 0.2 nats, 0.05 on
    average."""
    ref, port = _models(write_checkpoint(str(tmp_path), family), ref=True)
    prompts = _prompts(port.config.vocab_size, seed=ENGINE_SEEDS[family])
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


@pytest.mark.parametrize("family", ["phi", "gptj", "phixtral"])
def test_mixed_equals_sequential_and_h4_equals_h1(family, tmp_path):
    """The engine's paths (greedy, seeded and engine-seeded sampled rows):
    a four-step horizon bitwise one step; mixed ticks against one row, one
    chunk a tick, bitwise for phi and gptj, in tokens for phixtral."""
    _, port = _models(write_checkpoint(str(tmp_path), family), ref=False)
    cfg, params = port.config, port.params
    b1.COUNTS.reset()
    mixed, m_mixed = _port_streams(cfg, params)
    assert b1.COUNTS.plain_calls > 0
    seq, m_seq = _port_streams(cfg, params, step_token_budget=0)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert h4 == mixed
    if cfg.num_experts:
        assert [s[0] for s in mixed] == [s[0] for s in seq]
    else:
        assert mixed == seq
