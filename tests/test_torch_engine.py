"""The port's serving engine against the JAX ``ServingEngine``, and the
port's own engine equivalences.

Both engines serve the same greedy prompts of different lengths with the
same weights (the JAX tree carried across byte for byte).  Greedy streams
must be token-identical; logprobs agree within a tolerance.  Inside the
port, the mixed engine must equal the sequential one (``step_token_budget``
default vs 0) and a 4-step decode horizon must equal one step, bitwise in
tokens and logprobs, for greedy and seeded sampled rows.  The int4
mixed-equals-sequential identity fails in the JAX package on this
toolchain (ROADMAP queue 3), so it is held inside the port only.
"""

import numpy as np
import pytest
import torch

from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine, stream_tokens)
from tests.test_torch_decoder import tiny_pair

EC = dict(max_rows=4, max_seq_len=256, page_size=16, prefill_bucket=32)

# prompt lengths: under one page, two pages, a full chunk plus a tail, and
# more than two chunks; arrival ticks staggered so rows join mid-wave
PROMPTS = ((5, 0), (23, 0), (40, 2), (70, 5))


# Prompt seed of the cross-engine check.  With random weights and a
# 256-token vocabulary the top two bf16 logits are often equal or one bf16
# ulp apart, and the two implementations round differently, so a stream
# that meets such a near-tie may legitimately fork.  Seed 358 was chosen
# because along every stream below, for both weight widths, the emitted
# token leads its runner-up by at least 0.156 (five bf16 ulps at logit
# scale ~5), well past where the two sides differ; the token check itself
# is exact.
GREEDY_SEED = 358


def _prompts(vocab: int, seed: int = GREEDY_SEED):
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(1, vocab, n))), t)
            for n, t in PROMPTS]


def _drive(eng, schedule, max_ticks=2000):
    """Run the engine synchronously, submitting ``schedule[tick]``'s
    requests before that tick; returns the requests in schedule order."""
    reqs = [r for _, rs in sorted(schedule.items()) for r in rs]
    for t in range(max_ticks):
        for r in schedule.get(t, ()):
            eng.submit(r)
        eng._tick()
        if all(r.finish_reason is not None for r in reqs):
            break
    assert all(r.finish_reason is not None for r in reqs)
    return reqs


def _schedule(make, prompts, **kw):
    sched = {}
    for ids, t in prompts:
        sched.setdefault(t, []).append(make(prompt_ids=ids, **kw))
    return sched


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the tiny models' many
    small ops run fastest on one, and the suite's workers share the
    machine's cores (each worker's default pool oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["bf16", "sym_int4"])
def pair(request):
    return tiny_pair(request.param)


def test_greedy_streams_match_reference_engine(pair):
    """Token-identical greedy streams (see GREEDY_SEED).  Logprobs agree
    within 0.2 nats, 0.05 on average: the logits of the two sides agree to
    under 1% of their ~15-wide range (test_torch_decoder), about 0.12, and
    a logprob, a logit minus the log-sum-exp of all of them, can take at
    most twice the largest logit difference."""
    cfg, params, port_cfg, port_params = pair
    prompts = _prompts(cfg.vocab_size)
    ref = _drive(RefServingEngine(cfg, params, RefEngineConfig(
        planner="static", perfwatch=False, **EC)),
        _schedule(RefRequest, prompts, max_new_tokens=6))
    port = _drive(ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                                device="cpu"),
                  _schedule(Request, prompts, max_new_tokens=6))
    for a, b in zip(port, ref):
        assert a.output_ids == b.output_ids
        assert a.finish_reason == b.finish_reason == "length"
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=0.2)
        assert np.abs(np.subtract(a.logprobs, b.logprobs)).mean() < 0.05
    assert list(stream_tokens(port[0], timeout=5)) == port[0].output_ids


def _port_streams(port_cfg, port_params, storage="bf16", **ec):
    prompts = _prompts(port_cfg.vocab_size, seed=31)
    specs = [dict(max_new_tokens=10),
             dict(max_new_tokens=10, temperature=0.8, top_p=0.9, top_k=40,
                  seed=321),
             dict(max_new_tokens=10, temperature=0.7),   # engine-seeded
             dict(max_new_tokens=6)]
    sched = {}
    for (ids, t), spec in zip(prompts, specs):
        sched.setdefault(t, []).append(Request(prompt_ids=ids, **spec))
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(kv_storage=storage, **EC, **ec),
                        device="cpu")
    reqs = _drive(eng, sched)
    return ([(r.output_ids, r.logprobs, r.finish_reason) for r in reqs],
            eng.metrics)


@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_mixed_equals_sequential_and_h4_equals_h1(pair, storage):
    """Bit-identical token and logprob streams across the engine's
    paths: mixed ticks vs one row, one chunk per tick, and a 4-step decode
    horizon vs one step (greedy, seeded and engine-seeded sampled rows)."""
    _, _, port_cfg, port_params = pair
    mixed, m_mixed = _port_streams(port_cfg, port_params, storage)
    seq, m_seq = _port_streams(port_cfg, port_params, storage,
                               step_token_budget=0)
    h4, m_h4 = _port_streams(port_cfg, port_params, storage,
                             decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert mixed == seq
    assert h4 == mixed


def test_prefix_cache_shares_pages_and_keeps_streams(pair):
    """A second request with the same 40-token prompt reuses its two full
    pages from the prefix cache and emits the same greedy stream."""
    _, _, port_cfg, port_params = pair
    ids = _prompts(port_cfg.vocab_size)[2][0]
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                        device="cpu")
    (a,) = _drive(eng, {0: [Request(prompt_ids=ids, max_new_tokens=5)]})
    (b,) = _drive(eng, {0: [Request(prompt_ids=ids, max_new_tokens=5)]})
    assert eng.metrics["prefix_hits"] == 1
    assert eng.metrics["prefix_pages_shared"] == 2
    assert a.output_ids == b.output_ids


def test_engine_threads_and_rejects_oversized_prompts(pair):
    _, _, port_cfg, port_params = pair
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                        device="cpu").start()
    try:
        ok = eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4))
        big = eng.submit(Request(prompt_ids=[1] * 250, max_new_tokens=10))
        assert len(list(stream_tokens(ok, timeout=60))) == 4
        assert list(stream_tokens(big, timeout=60)) == []
        assert big.finish_reason == "length"
    finally:
        eng.stop()
    assert not eng._thread.is_alive()


def test_eos_stops_rows_on_every_engine_path(pair):
    """A request whose EOS is its own first greedy token finishes 'stop'
    after one token (inside the mixed tick's first-token merge); one whose
    EOS is its fourth token stops there (inside a decode horizon).  Mixed,
    sequential and H=4 engines agree."""
    _, _, port_cfg, port_params = pair
    prompts = _prompts(port_cfg.vocab_size)
    probe = _drive(ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                                 device="cpu"),
                   _schedule(Request, prompts[:2], max_new_tokens=6))
    a_eos = probe[0].output_ids[0]
    b_eos = probe[1].output_ids[3]
    assert b_eos not in probe[1].output_ids[:3]
    runs = []
    for ec in ({}, {"step_token_budget": 0}, {"decode_horizon": 4}):
        reqs = _drive(
            ServingEngine(port_cfg, port_params, EngineConfig(**EC, **ec),
                          device="cpu"),
            {0: [Request(prompt_ids=prompts[0][0], max_new_tokens=6,
                         eos_token_id=(a_eos,)),
                 Request(prompt_ids=prompts[1][0], max_new_tokens=6,
                         eos_token_id=(b_eos, 9999))]})
        assert [r.finish_reason for r in reqs] == ["stop", "stop"]
        assert reqs[0].output_ids == [a_eos]
        assert reqs[1].output_ids == probe[1].output_ids[:4]
        runs.append([(r.output_ids, r.logprobs) for r in reqs])
    assert runs[0] == runs[1] == runs[2]


def test_weight_qtype_repack_and_byte_budgeted_pool():
    """``weight_qtype="sym_int4"`` on a bf16 tree serves the same streams
    as the tree packed beforehand; ``kv_pool_bytes`` sizes the pool in
    pages of the storage width (fp8 pages are half the bytes)."""
    from ipex_llm_tpu_torch.models.build import requantize_params

    _, _, port_cfg, port_params = tiny_pair("bf16")

    prompts = _prompts(port_cfg.vocab_size)[:2]
    budget = 40 * 2 * 2 * 16 * 16 * 2 * 2     # 40 bf16 pages of this model
    streams = []
    for params, ec in ((port_params, dict(weight_qtype="sym_int4",
                                          kv_pool_bytes=budget)),
                       (requantize_params(port_params, "sym_int4"), {})):
        eng = ServingEngine(port_cfg, params, EngineConfig(**EC, **ec),
                            device="cpu")
        reqs = _drive(eng, _schedule(Request, prompts, max_new_tokens=5))
        streams.append([r.output_ids for r in reqs])
    assert streams[0] == streams[1]
    for storage, pages in (("bf16", 40), ("fp8", 80)):
        eng = ServingEngine(port_cfg, port_params, EngineConfig(
            kv_storage=storage, kv_pool_bytes=budget, **EC), device="cpu")
        assert eng.ec.n_pages == pages
        assert eng.cache.k.shape[1] == pages


def test_dry_pool_requeues_admission_and_streams_hold(pair):
    """With room for one long request's pages at a time, the second waits
    at the head of the queue and still emits the stream it emits alone."""
    _, _, port_cfg, port_params = pair
    prompts = _prompts(port_cfg.vocab_size)
    ids = prompts[3][0]                       # 70 tokens: 5 pages + decode
    alone = _drive(ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                                 device="cpu"),
                   {0: [Request(prompt_ids=ids, max_new_tokens=6)]})
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(pool_pages=9, **EC), device="cpu")
    reqs = _drive(eng, {0: [Request(prompt_ids=ids, max_new_tokens=6),
                            Request(prompt_ids=list(reversed(ids)),
                                    max_new_tokens=6),
                            Request(prompt_ids=ids, max_new_tokens=6)]})
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    assert reqs[0].output_ids == reqs[2].output_ids == alone[0].output_ids
    assert eng.metrics["alloc_fail_clamps"] > 0


def test_abort_frees_the_row_mid_stream(pair):
    """An aborted request stops at the next tick with 'abort', its pages
    go back to the pool, and the request beside it is unaffected."""
    _, _, port_cfg, port_params = pair
    prompts = _prompts(port_cfg.vocab_size)
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                        device="cpu")
    keep, gone = (Request(prompt_ids=prompts[1][0], max_new_tokens=6),
                  Request(prompt_ids=prompts[2][0], max_new_tokens=6))
    eng.submit(keep)
    eng.submit(gone)
    for _ in range(3):
        eng._tick()
    gone.abort()
    for _ in range(100):
        if keep.finish_reason and gone.finish_reason:
            break
        eng._tick()
    assert gone.finish_reason == "abort" and len(gone.output_ids) < 6
    assert keep.finish_reason == "length"
    (alone,) = _drive(ServingEngine(port_cfg, port_params,
                                    EngineConfig(**EC), device="cpu"),
                      {0: [Request(prompt_ids=prompts[1][0],
                                   max_new_tokens=6)]})
    assert keep.output_ids == alone.output_ids
    assert len(eng.alloc.free) + len(eng.alloc.prefix) == eng.ec.n_pages - 1


def test_a_failing_tick_fails_its_requests_and_the_engine_serves_on(
        pair, monkeypatch):
    """A fault of the engine, not of a request (it fires with every
    request masked, so bisection cannot place it), finishes every
    in-flight and queued request with 'error' (no client waits forever)
    and freezes the flight ring with the error; the next request is
    served normally."""
    _, _, port_cfg, port_params = pair
    eng = ServingEngine(port_cfg, port_params, EngineConfig(**EC),
                        device="cpu")
    first = Request(prompt_ids=[3, 4, 5], max_new_tokens=4)
    real = eng._expire_deadlines

    def fails_while_first_waits():
        if any(r is first for r in eng._pending):
            raise RuntimeError("injected tick failure")
        real()

    monkeypatch.setattr(eng, "_expire_deadlines", fails_while_first_waits)
    eng.start()
    try:
        eng.submit(first)
        assert list(stream_tokens(first, timeout=60)) == []
        assert first.finish_reason == "error"
        assert eng.metrics["errors"] == 1
        assert eng.metrics["errors_isolated"] == 0
        dump = eng.flight.view()["dumps"][-1]
        assert dump["reason"] == "fail_all" and "injected" in dump["error"]
        second = eng.submit(Request(prompt_ids=[3, 4, 5], max_new_tokens=4))
        assert len(list(stream_tokens(second, timeout=60))) == 4
        assert second.finish_reason == "length"
    finally:
        eng.stop()


# -- the weight axis: EngineConfig.weight_qtype in the ten block formats ------
# (ports of tests/test_serving_lowbit.py)

FORMATS = ("sym_int4", "asym_int4", "nf4", "fp4", "sym_int5", "asym_int5",
           "sym_int8", "fp6", "fp8_e4m3", "fp8_e5m2")

# Prompt seed of the low-bit cross-engine check, chosen by GREEDY_SEED's
# rule over seeds 0-399: along every stream below, in nf4 and in
# asym_int5, the emitted token leads its runner-up by at least 0.094
# (three bf16 ulps at these logits); the token check itself is exact.
LOWBIT_GREEDY_SEED = 37


@pytest.fixture(scope="module")
def bf16_pair():
    return tiny_pair("bf16")


@pytest.mark.parametrize("qtype", FORMATS)
def test_repack_packs_linear_stacks_and_lm_head(bf16_pair, qtype):
    """``weight_qtype`` re-packs exactly the linear weights of a bf16
    tree: the stacked layer QTensors and the lm head become the format's
    planes (data rows = padded contraction rows x den / num, a zeros plane
    for the asymmetric formats), the embedding and norms keep their width,
    and the byte accounting covers the tree."""
    from ipex_llm_tpu_torch.models.build import param_bytes
    from ipex_llm_tpu_torch.ops.cuda.qmatmul import data_row_factor
    from ipex_llm_tpu_torch.quantize.qtypes import resolve

    _, _, port_cfg, port_params = bf16_pair
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(weight_qtype=qtype, **EC), device="cpu")
    info = resolve(qtype)
    num, den = data_row_factor(qtype)
    leaves = [(eng.params["layers"][k], (port_cfg.num_layers,))
              for k in ("qkv", "o", "gate_up", "down")]
    leaves.append((eng.params["lm_head"], ()))
    for qt, lead in leaves:
        assert qt.qtype == qtype and qt.block_size == info.block_size
        assert qt.data.dtype == torch.uint8
        in_pad = -(-qt.in_features // qt.block_size) * qt.block_size
        n_blocks = in_pad // qt.block_size
        assert qt.data.shape == lead + (in_pad * den // num,
                                        qt.out_features)
        assert qt.scales.shape == lead + (n_blocks, qt.out_features)
        assert (qt.zeros is not None) == (info.kind == "int_asym")
        if qt.zeros is not None:
            assert qt.zeros.shape == qt.scales.shape
    assert eng.params["embed"].dtype == torch.bfloat16
    assert eng.params["final_norm"].dtype == torch.float32
    ws = eng.weight_stats()
    assert ws["qtype"] == qtype and ws["requested_qtype"] == qtype
    assert ws["packed_qtypes"] == [qtype]
    assert (ws["weight_bytes"], ws["dense_bytes"]) == param_bytes(eng.params)
    assert ws["dense_bytes"] == param_bytes(port_params)[0]
    assert ws["weight_bytes"] + ws["bytes_saved"] == ws["dense_bytes"]


def test_packed_tree_passes_through_with_a_warning(bf16_pair):
    """An already-packed tree is never requantized (that would stack
    quantization error): the same leaf objects come back whatever width is
    asked, an engine asked for another width warns and reports the width
    the planes serve, and a tree packed at two widths (a sym_int8 lm head
    over a sym_int4 body) reports "mixed", even when the request matches
    one of them."""
    from ipex_llm_tpu_torch.models.build import requantize_params

    _, _, port_cfg, port_params = bf16_pair
    p4 = requantize_params(port_params, "sym_int4")
    for ask in ("nf4", "q4_k"):
        again = requantize_params(p4, ask)
        assert again["layers"]["qkv"] is p4["layers"]["qkv"]
        assert again["lm_head"] is p4["lm_head"]
    with pytest.warns(UserWarning, match="already packed"):
        eng = ServingEngine(port_cfg, p4, EngineConfig(weight_qtype="nf4",
                                                       **EC), device="cpu")
    ws = eng.weight_stats()
    assert (ws["qtype"], ws["requested_qtype"], ws["packed_qtypes"]) == (
        "sym_int4", "nf4", ["sym_int4"])
    mixed = dict(p4, lm_head=requantize_params(
        {"lm_head": port_params["lm_head"]}, "sym_int8")["lm_head"])
    with pytest.warns(UserWarning, match="already packed"):
        eng2 = ServingEngine(port_cfg, mixed, EngineConfig(
            weight_qtype="nf4", **EC), device="cpu")
    assert eng2.weight_stats()["qtype"] == "mixed"
    eng3 = ServingEngine(port_cfg, mixed, EngineConfig(
        weight_qtype="sym_int4", **EC), device="cpu")
    ws3 = eng3.weight_stats()
    assert (ws3["qtype"], ws3["requested_qtype"], ws3["packed_qtypes"]) == (
        "mixed", "sym_int4", ["sym_int4", "sym_int8"])
    reqs = _drive(eng3, _schedule(Request, _prompts(port_cfg.vocab_size)[:2],
                                  max_new_tokens=4))
    assert all(len(r.output_ids) == 4 for r in reqs)


def test_plain_array_tree_warns_and_reports_unpacked(bf16_pair):
    """A packed width asked over a tree whose linear weights are plain
    tensors (which the repack cannot tell from an embedding table) warns,
    and ``weight_stats()`` claims no width: nothing is served packed."""
    _, _, port_cfg, port_params = bf16_pair
    plain = dict(port_params, lm_head=port_params["lm_head"].data,
                 layers={k: getattr(v, "data", v)
                         for k, v in port_params["layers"].items()})
    with pytest.warns(UserWarning, match="no quantizable"):
        eng = ServingEngine(port_cfg, plain, EngineConfig(
            weight_qtype="sym_int4", **EC), device="cpu")
    ws = eng.weight_stats()
    assert ws["qtype"] is None and ws["requested_qtype"] == "sym_int4"
    assert ws["packed_qtypes"] == [] and ws["bytes_saved"] == 0
    reqs = _drive(eng, _schedule(Request, _prompts(port_cfg.vocab_size)[:1],
                                 max_new_tokens=3))
    assert len(reqs[0].output_ids) == 3


@pytest.mark.parametrize("alias,target", [
    ("woq_int4", "sym_int4"), ("fp8", "fp8_e5m2"),
    ("torch_fp8_e4m3", "fp8_e4m3"), ("fp6_k", "fp6")])
def test_alias_width_reports_canonical(bf16_pair, alias, target):
    """An alias packs, and reports, the canonical format; the alias itself
    stays only in ``requested_qtype``."""
    _, _, port_cfg, port_params = bf16_pair
    ws = ServingEngine(port_cfg, port_params,
                       EngineConfig(weight_qtype=alias, **EC),
                       device="cpu").weight_stats()
    assert (ws["qtype"], ws["requested_qtype"], ws["packed_qtypes"]) == (
        target, alias, [target])


def test_engine_rejects_unknown_and_unported_qtype(bf16_pair):
    """An unknown name raises the reference's ValueError; a reference
    format outside the port (a k-quant) raises NotImplementedError where
    the reference raises its ValueError for a kind without a repack codec;
    a native width is a no-op."""
    _, _, port_cfg, port_params = bf16_pair
    with pytest.raises(ValueError, match="load_in_low_bit"):
        ServingEngine(port_cfg, port_params,
                      EngineConfig(weight_qtype="int3", **EC), device="cpu")
    with pytest.raises(NotImplementedError, match="q4_k"):
        ServingEngine(port_cfg, port_params,
                      EngineConfig(weight_qtype="q4_k", **EC), device="cpu")
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(weight_qtype="bf16", **EC), device="cpu")
    assert eng.weight_stats()["packed_qtypes"] == []
    assert eng.weight_stats()["qtype"] == "bf16"


@pytest.mark.parametrize("qtype", ["nf4", "asym_int5"])
def test_lowbit_greedy_streams_match_reference_engine(bf16_pair, qtype):
    """Both engines repack the same bf16 tree into ``qtype`` (bitwise the
    same planes, tests/test_torch_quantize.py) and serve token-identical
    greedy streams (see LOWBIT_GREEDY_SEED); logprobs within the bounds of
    test_greedy_streams_match_reference_engine."""
    cfg, params, port_cfg, port_params = bf16_pair
    prompts = _prompts(cfg.vocab_size, LOWBIT_GREEDY_SEED)
    ref = _drive(RefServingEngine(cfg, params, RefEngineConfig(
        planner="static", perfwatch=False, weight_qtype=qtype, **EC)),
        _schedule(RefRequest, prompts, max_new_tokens=6))
    eng = ServingEngine(port_cfg, port_params,
                        EngineConfig(weight_qtype=qtype, **EC), device="cpu")
    port = _drive(eng, _schedule(Request, prompts, max_new_tokens=6))
    for a, b in zip(port, ref):
        assert a.output_ids == b.output_ids
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=0.2)
        assert np.abs(np.subtract(a.logprobs, b.logprobs)).mean() < 0.05
    assert eng.weight_stats()["qtype"] == qtype


@pytest.mark.parametrize("qtype", ["nf4", "fp8_e4m3"])
def test_lowbit_mixed_equals_sequential_and_h4_equals_h1(bf16_pair, qtype):
    """The engine's path equivalences hold in a 64-row-block codebook
    format and a 128-row-block minifloat: mixed ticks equal one row, one
    chunk per tick, and a 4-step horizon equals one step, bitwise in
    tokens and logprobs."""
    from ipex_llm_tpu_torch.models.build import requantize_params

    _, _, port_cfg, port_params = bf16_pair
    packed = requantize_params(port_params, qtype)
    mixed, m_mixed = _port_streams(port_cfg, packed)
    seq, m_seq = _port_streams(port_cfg, packed, step_token_budget=0)
    h4, m_h4 = _port_streams(port_cfg, packed, decode_horizon=4)
    assert m_mixed["mixed_steps"] > 0 and m_seq["mixed_steps"] == 0
    assert m_h4["decode_horizon_effective"] == 4
    assert mixed == seq
    assert h4 == mixed
