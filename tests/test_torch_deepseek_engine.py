"""DeepSeek's paged decoder against the JAX package, and the port's serving
engine and ``generate()`` over a DeepSeek-V2-shaped model.

- the decoder over the paged pool (the dense prefix stack, then the MoE
  stack; K 24 and V 16 wide): a ragged prefill, then two T=1 decode steps,
  against the JAX ``decoder_forward`` on the reference's tree (built by
  the reference from one numpy draw, bf16) carried across by
  ``convert.py``, V2 (full-rank q) over a bf16 pool and V3 (the low-rank
  q) over an e5m2 pool; bounds of ``test_torch_decoder``;
- the engine on the tiny V2 model of ``random_init`` (sym_int4 weights
  from a seed), as ``test_torch_moe_engine`` holds the MoE families: a
  4-step decode horizon bitwise one step, mixed ticks token for token the
  sequential engine, the fused speculative tick bitwise the host walk, a
  tick retried after a transient fault bitwise the unfaulted run;
- ``generate()`` over the dense cache at K 24 and V 16: the flash kernel's
  wrapper (B4) prefills and the decode kernel's (B3) decodes, and the
  greedy stream's first token is the full forward's argmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.models.build import build_params as ref_build_params
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu_torch.kv import PagedKVCache
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (TINY_DEEPSEEK_V2_HF,
                                                   TINY_DEEPSEEK_V3_HF,
                                                   deepseek_hf_shapes,
                                                   random_params)
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.serving.faults import FaultInjector, TransientFault
from ipex_llm_tpu_torch.transformers.model import TPUModelForCausalLM
from tests.test_torch_deepseek import PAGED_SEED, _paged_steps, _port_cfg
from tests.test_torch_engine import EC, _drive, _port_streams, _prompts
from tests.test_torch_engine import _schedule
from tests.test_torch_faults import _assert_bitwise, _wave
from tests.test_torch_faults import _drive as fault_drive
from tests.test_torch_faults import _engine as fault_engine
from tests.test_torch_moe import hf_model_weights
from tests.test_torch_quantize import reference_tree
from tests.test_torch_spec import _run as spec_run

SPEC = dict(spec_k=3, decode_horizon=4)
# Prompt seed of the mixed-against-sequential check, the first one tried:
# the token check is exact, and holds only away from near-ties of the
# greedy logits (the MoE route of a forward follows its pair count, so
# the two engines round differently: ROADMAP queue 3).
MIXED_SEED = 0
_ref_forward = jax.jit(ref_forward, static_argnums=0,
                       static_argnames=("last_token_only",))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores (each worker's default pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_tree(hf: dict, seed: int = 0):
    """(reference cfg, reference bf16 tree) of ``hf``'s tiny widths, built
    by the reference's ``build_params`` from ``hf_model_weights`` under
    the published names."""
    tensors = {k: v.float().numpy() for k, v in hf_model_weights(
        deepseek_hf_shapes(hf), seed).items()}
    fam = ref_get_family(hf["model_type"], hf)
    cfg = fam.to_config(hf)
    return cfg, ref_build_params(cfg, fam.scheme, tensors.__getitem__,
                                 tensors.__contains__, qtype="bf16",
                                 moe_scheme=fam.moe)


@pytest.mark.parametrize("hf,storage", [(TINY_DEEPSEEK_V2_HF, "bf16"),
                                        (TINY_DEEPSEEK_V3_HF, "fp8")],
                         ids=["v2-bf16", "v3-fp8"])
def test_decoder_paged_matches_reference(hf, storage):
    """Logits within 2.5% of their range (mean 0.5%) over bf16, 6% (mean
    1%) over e5m2, each side attending to the K/V it wrote; the port's
    kernel wrappers take their plain versions (B1 on the tick's rows)."""
    cfg, tree = _reference_tree(hf)
    port_cfg = _port_cfg(cfg)
    params = params_from_reference(reference_tree(tree), device="cpu")
    ps, maxp, r = 16, 3, 3
    n_pages = 1 + r * maxp
    tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
    ref_cache = RefPagedKVCache.init(
        cfg.num_layers, n_pages, r, maxp, cfg.num_kv_heads, ps, cfg.head_dim,
        v_head_dim=cfg.v_dim, storage=storage).with_tables(
            jnp.asarray(tables))
    cache = PagedKVCache.init(cfg.num_layers, n_pages, r, maxp,
                              cfg.num_kv_heads, ps, cfg.head_dim,
                              storage=storage, device="cpu",
                              v_head_dim=cfg.v_dim)
    cache.tables.copy_(torch.from_numpy(tables))
    before = b1.COUNTS.plain_calls
    for i, s in enumerate(_paged_steps(cfg, PAGED_SEED[cfg.model_type])):
        want, ref_cache = _ref_forward(
            cfg, tree, jnp.asarray(s["tokens"]), ref_cache,
            jnp.asarray(s["pos"]),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in s["kw"].items()})
        got, cache = decoder_forward(
            port_cfg, params, torch.from_numpy(s["tokens"]), cache,
            torch.from_numpy(s["pos"]),
            **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in s["kw"].items()})
        want = np.asarray(want)
        assert got.shape == want.shape == (r, cfg.vocab_size), i
        span = want.max() - want.min()
        max_tol, mean_tol = (0.025, 0.005) if storage == "bf16" else (
            0.06, 0.01)
        err = np.abs(got.numpy() - want)
        assert err.max() <= max_tol * span, (i, err.max() / span)
        assert err.mean() <= mean_tol * span, i
    assert b1.COUNTS.plain_calls == before + 3 * cfg.num_layers


@pytest.fixture(scope="module")
def port():
    cfg = config_from_hf(TINY_DEEPSEEK_V2_HF)
    return cfg, random_params(cfg, "sym_int4", seed=7, device="cpu",
                              router_scale=2.5)


def _greedy_run(port, prompts, **ec):
    cfg, params = port
    eng = ServingEngine(cfg, params, EngineConfig(**EC, **ec), device="cpu")
    reqs = _drive(eng, _schedule(Request, prompts, max_new_tokens=8))
    return ([(r.output_ids, r.logprobs, r.finish_reason) for r in reqs],
            eng.metrics)


def test_h4_equals_h1_and_mixed_matches_sequential(port):
    """A 4-step decode horizon is bitwise one step (greedy and sampled
    rows); mixed ticks against one row, one chunk a tick: token for token,
    logprobs within 0.2 nats (a token's MoE route can differ)."""
    cfg, params = port
    one, _ = _port_streams(cfg, params)
    h4, m_h4 = _port_streams(cfg, params, decode_horizon=4)
    assert m_h4["decode_horizon_effective"] == 4
    assert h4 == one
    prompts = _prompts(cfg.vocab_size, seed=MIXED_SEED)
    mixed, m_mixed = _greedy_run(port, prompts)
    seq, m_seq = _greedy_run(port, prompts, step_token_budget=0)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    for (ta, la, ra), (tb, lb, rb) in zip(mixed, seq):
        assert ta == tb and ra == rb == "length"
        np.testing.assert_allclose(la, lb, rtol=0, atol=0.2)


def test_fused_spec_matches_host_walk(port):
    """The fused speculative tick (spec_k 3, horizon 4) is bitwise the
    sequential engine's host walk."""
    pair = (None, None) + tuple(port)
    rng = np.random.default_rng(3)
    reqs = [dict(prompt_ids=list(map(int, np.tile(rng.integers(1, 256, 4),
                                                  10))), max_new_tokens=14),
            dict(prompt_ids=list(map(int, rng.integers(1, 256, 30))),
                 max_new_tokens=10, temperature=0.8, top_p=0.9, seed=5)]
    fused = spec_run(pair, SPEC, reqs)
    oracle = spec_run(pair, dict(step_token_budget=0,
                                 spec_k=SPEC["spec_k"]), reqs)
    assert fused[0] == oracle[0] and fused[1] == oracle[1]
    assert fused[2] == oracle[2] == ["length"] * 2
    assert fused[3]["spec_steps"] > 0 and fused[3]["draft_proposed"] > 0


def test_transient_fault_retries_bitwise(port):
    """A ``TransientFault`` at the mixed step's second hit rolls the tick
    back and runs it again: bitwise the unfaulted run."""
    reqs = _wave(port[0].vocab_size)
    base = {"streams": fault_drive(fault_engine(port), reqs),
            "logprobs": [r.logprobs for r in reqs],
            "reasons": [r.finish_reason for r in reqs]}
    inj = FaultInjector().inject("mixed-step", TransientFault, nth=2)
    eng = fault_engine(port, inj)
    reqs = _wave(port[0].vocab_size)
    streams = fault_drive(eng, reqs)
    assert inj.fired == 1 and eng.metrics["retries"] == 1
    _assert_bitwise(reqs, streams, base)


def test_generate_runs_b4_then_b3(port):
    """``generate()`` over the dense cache (K 24, V 16): the prompt of 130
    ids goes through B4's wrapper, each new token through B3's (their
    plain versions here); the first greedy token is the full forward's
    argmax at the prompt's end."""
    cfg, params = port
    m = TPUModelForCausalLM(cfg, params, dict(TINY_DEEPSEEK_V2_HF),
                            "sym_int4")
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        3, 256, (2, 130)).astype(np.int64))
    c3, c4 = b3.COUNTS.plain_calls, b4.COUNTS.plain_calls
    out = m.generate(ids, max_new_tokens=4, do_sample=False)
    assert out.shape == (2, 134)
    assert b4.COUNTS.plain_calls - c4 == cfg.num_layers
    assert b3.COUNTS.plain_calls - c3 == 3 * cfg.num_layers
    full = m(ids.numpy())
    assert torch.equal(out[:, 130], full[:, -1].argmax(-1))
