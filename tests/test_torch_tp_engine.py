"""Tensor-parallel serving through the port's engine on the CPU: two ranks
of a gloo group (spawned processes, ``tests/torch_tp_ranks.py``) running
``ServingEngine(..., tp=group)`` in lockstep over their plain versions.

- tp = 2 against the JAX engine's manual tick on a ``make_mesh(MeshSpec(
  tp=2))`` mesh (``eng._tp_manual``), on the reference test's config
  (``tests/test_serving_tp_manual.py:52``): greedy tokens equal (prompt
  seed 77, the reference test's: a near-tie would fork the two sides'
  streams, and none does on it), logprobs within the engine tests' 0.2
  nats, 0.05 on average;
- tp = 2 against the port's tp = 1 engine in tokens, greedy and seeded,
  with ``spec_k`` 3 and a decode horizon of 4, every rank drawing the same
  tokens;
- a fault scripted on both ranks retries in lockstep, bitwise the clean
  run; a poisoned request bisected on both ranks fails alone, the others
  bitwise;
- a fault on rank 1 alone ends both ranks within two group timeouts;
- minicpm (the muP scalings) at tp = 2 as at tp = 1, minicpm3 refused
  as MLA;
- ``build_server(tensor_parallel_size=2)`` (what ``main
  --tensor-parallel-size 2`` calls) starts its follower and reports the
  ``parallel`` block in ``/health``; ``main`` parses the lifted flags.
"""

import numpy as np
import pytest

from ipex_llm_tpu.parallel import MeshSpec as RefMeshSpec
from ipex_llm_tpu.parallel import make_mesh
from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu_torch.serving import api_server
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import random_params
from ipex_llm_tpu_torch.parallel.manual import ineligible_reason
from tests import torch_tp_ranks
from tests.test_torch_decoder import tiny_pair

EC = dict(max_rows=4, max_seq_len=256, page_size=16, prefill_bucket=32)
SPEC = dict(EC, spec_k=3, decode_horizon=4)


def _ref_case():
    """The reference manual-tp test's model (8 q and 8 kv heads of 8,
    hidden 64, vocab 128, bf16 weights) and its three prompts."""
    cfg, params, port_cfg, port_params = tiny_pair(
        "bf16", vocab_size=128, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=8, head_dim=8)
    rng = np.random.default_rng(77)
    prompts = [list(map(int, rng.integers(0, 128, n))) for n in (7, 19, 41)]
    return cfg, params, port_cfg, port_params, prompts


def _reqs(prompts, seeded=False, n_out=10):
    return [dict(prompt_ids=p, max_new_tokens=n_out,
                 temperature=0.9 if seeded else 0.0,
                 top_p=0.95 if seeded else 1.0,
                 seed=42 + i if seeded else None, request_id=f"r{i}")
            for i, p in enumerate(prompts)]


def _drive(eng, reqs):
    reqs = [eng.submit(r) for r in reqs]
    while any(r.finish_reason is None for r in reqs):
        eng._tick()
    return reqs


def _minicpm():
    """A tiny minicpm (4 heads of 32, a tied head, sym_int4 from a seed)
    whose muP scalings are far from 1: embeddings x 12, each branch x 0.8
    / sqrt(2), logits x 0.25."""
    cfg = config_from_hf({
        "model_type": "minicpm", "vocab_size": 256, "hidden_size": 128,
        "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "max_position_embeddings": 512, "tie_word_embeddings": True,
        "scale_emb": 12, "scale_depth": 0.8, "dim_model_base": 32})
    return cfg, random_params(cfg, "sym_int4", seed=3, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's tp = 2 streams, the port's tp = 1 streams, and the
    port's tp = 2 runs on both ranks (one spawned group for all)."""
    cfg, params, port_cfg, port_params, prompts = _ref_case()
    ref = RefServingEngine(cfg, params, RefEngineConfig(
        max_rows=3, max_seq_len=256, prefill_bucket=32, planner="static",
        perfwatch=False), mesh=make_mesh(RefMeshSpec(tp=2)))
    assert ref._tp_manual, ref._tp_fallback_reason
    want_ref = _drive(ref, [RefRequest(**{k: v for k, v in r.items()
                                          if k != "request_id"})
                            for r in _reqs(prompts)])
    _, _, qcfg, qparams = tiny_pair("sym_int4", hidden_size=128,
                                    head_dim=32, intermediate_size=256)
    rng = np.random.default_rng(31)
    qprompts = [list(map(int, rng.integers(1, 256, n)))
                for n in (5, 23, 40, 70)]
    qprompts[1] = [5, 9, 12, 40] * 6          # speculation drafts here
    tp1 = {}
    for name, seeded in (("greedy", False), ("seeded", True)):
        eng = ServingEngine(qcfg, qparams, EngineConfig(**SPEC),
                            device="cpu")
        tp1[name] = _drive(eng, [Request(**r) for r in _reqs(
            qprompts, seeded)])
    mcfg, mparams = _minicpm()
    tp1["minicpm"] = _drive(
        ServingEngine(mcfg, mparams, EngineConfig(**SPEC), device="cpu"),
        [Request(**r) for r in _reqs(qprompts)])
    runs = [
        dict(model=0, ec=dict(max_rows=3, max_seq_len=256,
                              prefill_bucket=32), reqs=_reqs(prompts)),
        dict(model=1, ec=SPEC, reqs=_reqs(qprompts)),
        dict(model=1, ec=SPEC, reqs=_reqs(qprompts, seeded=True)),
        dict(model=1, ec=SPEC, reqs=_reqs(qprompts), faults=[
            dict(site="decode-dispatch", exc="TransientFault", nth=2,
                 ranks=(0, 1))]),
        dict(model=1, ec=SPEC, reqs=_reqs(qprompts), faults=[
            dict(site="mixed-step", exc="DeterministicFault", times=None,
                 request_id="r2", ranks=(0, 1))]),
        dict(model=2, ec=SPEC, reqs=_reqs(qprompts)),
    ]
    got = torch_tp_ranks.spawn(
        torch_tp_ranks.engine_rank, 2, tmp_path_factory.mktemp("tp2"),
        [(port_cfg, port_params), (qcfg, qparams), (mcfg, mparams)], runs)
    return want_ref, tp1, got


def test_tp2_matches_the_reference_manual_tick(runs):
    """Greedy tokens equal to the JAX engine's tp = 2 manual tick; logprobs
    within 0.2 nats, 0.05 on average (tests/test_torch_engine.py's bound:
    the two sides' logits differ by their summation order); both ranks
    emit the same streams."""
    want, _, got = runs
    for rank in (0, 1):
        run = got[rank][0]
        assert run["tokens"] == [r.output_ids for r in want]
        assert run["finish"] == ["length"] * 3
        for a, b in zip(run["logprobs"], want):
            np.testing.assert_allclose(a, b.logprobs, rtol=0, atol=0.2)
            assert np.abs(np.subtract(a, b.logprobs)).mean() < 0.05
        assert run["parallel"]["tp"] == 2
        assert run["parallel"]["backend"] == "gloo"
    assert got[1][0]["logprobs"] == got[0][0]["logprobs"]


@pytest.mark.parametrize("i,name", [(1, "greedy"), (2, "seeded")])
def test_tp2_matches_tp1_with_speculation_and_a_horizon(runs, i, name):
    """spec_k 3, horizon 4: tp = 2 emits tp = 1's tokens, greedy and
    seeded, on both ranks (logprobs within 0.02 nats: the row split sums
    each product in two fp32 partials); speculation ran."""
    _, tp1, got = runs
    for rank in (0, 1):
        run = got[rank][i]
        assert run["tokens"] == [r.output_ids for r in tp1[name]]
        for a, b in zip(run["logprobs"], tp1[name]):
            np.testing.assert_allclose(a, b.logprobs, rtol=0, atol=0.02)
        assert run["metrics"]["spec_steps"] > 0
        assert run["metrics"]["retries"] == run["metrics"]["errors"] == 0
    assert got[0][i]["logprobs"] == got[1][i]["logprobs"]


def test_tp2_serves_minicpm_as_tp1(runs):
    """minicpm's muP scalings at tp = 2 (the residual multiplier after
    the row all-reduce, the logit scale on the tied head's replicated
    logits): tp = 1's greedy tokens on both ranks, logprobs within 0.02
    nats, with speculation and a horizon of 4."""
    _, tp1, got = runs
    for rank in (0, 1):
        run = got[rank][5]
        assert run["tokens"] == [r.output_ids for r in tp1["minicpm"]]
        for a, b in zip(run["logprobs"], tp1["minicpm"]):
            np.testing.assert_allclose(a, b.logprobs, rtol=0, atol=0.02)
        assert run["metrics"]["errors"] == 0
    assert got[0][5]["logprobs"] == got[1][5]["logprobs"]


def test_minicpm3_is_refused_at_tp_as_mla():
    """minicpm3 stays refused at tp > 1 with the reference's MLA reason;
    minicpm is eligible."""
    from ipex_llm_tpu_torch.models.random_init import TINY_DEEPSEEK_V2_HF
    mcfg, mparams = _minicpm()
    assert ineligible_reason(mcfg, mparams, {"tp": 2}, 128) is None
    hf = {k: v for k, v in TINY_DEEPSEEK_V2_HF.items()
          if not k.startswith(("n_", "first_k", "moe_", "topk", "num_exp"))}
    cfg = config_from_hf({**hf, "model_type": "minicpm3", "scale_emb": 12,
                          "scale_depth": 1.4, "dim_model_base": 32})
    assert cfg.is_mla and cfg.num_experts == 0
    params = random_params(cfg, "sym_int4", seed=1, device="cpu")
    assert ineligible_reason(cfg, params, {"tp": 2}, 128) == \
        "MLA attention (low-rank q/kv) not manual-sharded yet"


def test_a_fault_on_both_ranks_retries_in_lockstep(runs):
    """A TransientFault scripted at the second decode dispatch of both
    ranks: each rolls back and retries once, and the streams are bitwise
    the clean run's."""
    _, _, got = runs
    for rank in (0, 1):
        clean, faulted = got[rank][1], got[rank][3]
        assert faulted["metrics"]["retries"] == 1
        assert faulted["tokens"] == clean["tokens"]
        assert faulted["logprobs"] == clean["logprobs"]
        assert faulted["metrics"]["ticks"] == clean["metrics"]["ticks"]


def test_a_poisoned_request_is_bisected_in_lockstep(runs):
    """A DeterministicFault bound to request r2 on both ranks: the ranks
    bisect together, r2 alone finishes "error", the others bitwise the
    clean run."""
    _, _, got = runs
    for rank in (0, 1):
        clean, faulted = got[rank][1], got[rank][4]
        assert faulted["finish"][2] == "error"
        assert faulted["metrics"]["errors_isolated"] == 1
        for j in (0, 1, 3):
            assert faulted["tokens"][j] == clean["tokens"][j]
            assert faulted["logprobs"][j] == clean["logprobs"][j]


def test_a_fault_on_one_rank_ends_every_rank(tmp_path):
    """A fault scripted on rank 1 alone: rank 1 raises where rank 0 goes
    on to its next collective; neither hangs.  Both ranks end, every
    request fails, within two group timeouts of the fault."""
    _, _, qcfg, qparams = tiny_pair("sym_int4", hidden_size=128,
                                    head_dim=32, intermediate_size=256)
    timeout = 3.0
    run = dict(model=0, ec=EC, reqs=_reqs([[3, 4, 5, 6] * 5] * 2),
               faults=[dict(site="mixed-step", exc="DeterministicFault",
                            times=None, ranks=(1,))])
    got = torch_tp_ranks.spawn(torch_tp_ranks.engine_rank, 2, tmp_path,
                               [(qcfg, qparams)], [run], timeout_s=timeout)
    for rank in (0, 1):
        res = got[rank][0]
        assert res["metrics"]["errors"] == 1
        assert "CollectiveError" in res["last_error"]
        assert res["seconds"] < 2 * timeout + 5.0
    assert got[0][0]["finish"] == ["error", "error"]


@pytest.fixture
def tiny_checkpoint(tmp_path):
    from tests.test_torch_loader import hf_weights, tiny_hf, write_checkpoint
    # widths whose o and down split in whole sym_int4 blocks at tp = 2
    hf = {**tiny_hf(), "hidden_size": 128, "intermediate_size": 256}
    return write_checkpoint(str(tmp_path / "ckpt"), hf,
                            hf_weights(hf, seed=3), "port")


class _Tok:
    eos_token_id = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 256 if w.isdigit() else 0
                              for w in text.split()]}

    def decode(self, ids):
        return " ".join(map(str, ids))


def test_build_server_tp2_reports_its_parallel_block(tiny_checkpoint,
                                                     tmp_path):
    """``build_server(tensor_parallel_size=2, tp_backend="gloo")`` on the
    CPU: rank 0 starts rank 1, serves a completion, and ``/health``
    reports tp, backend, wire family and the rank's pool bytes; stopping
    the engine ends the follower."""
    health, done, procs_done = torch_tp_ranks.run_server_rank0(
        tmp_path, tiny_checkpoint, _Tok())
    par = health["parallel"]
    assert (par["tp"], par["rank"], par["backend"],
            par["collective_qtype"]) == (2, 0, "gloo", "int8")
    assert par["kv_pool_bytes_per_rank"] > 0
    assert par["collective_calls"]["all_reduce"] > 0
    assert len(done["choices"][0]["text"].split()) == 4
    assert procs_done


def test_main_passes_the_tensor_parallel_flags(monkeypatch):
    """``--tensor-parallel-size``, ``--collective-qtype``, ``--tp-backend``
    and ``--tp-timeout`` reach ``build_server`` (they are no longer
    refused)."""
    seen = {}

    class Srv:
        app = object()

    def fake_build(model, low_bit, ec, **kw):
        seen.update(ec=ec, **kw)
        return Srv()

    web = pytest.importorskip("aiohttp.web")
    monkeypatch.setattr(api_server, "build_server", fake_build)
    monkeypatch.setattr(web, "run_app", lambda app, host, port: None)
    api_server.main(["--model", "/ckpt", "--tensor-parallel-size", "4",
                     "--collective-qtype", "e5m2", "--tp-backend", "gloo",
                     "--tp-timeout", "12", "--device", "cpu"])
    assert (seen["tensor_parallel_size"], seen["tp_backend"],
            seen["tp_timeout_s"], seen["ec"].collective_qtype,
            seen["device"]) == (4, "gloo", 12.0, "e5m2", "cpu")
    with pytest.raises(SystemExit):
        api_server.main(["--model", "/ckpt", "--collective-qtype", "fp4"])


def test_engine_refuses_what_the_manual_layout_cannot_serve():
    """A sequential engine (step_token_budget 0) at tp raises
    NotImplementedError quoting the reason and ROADMAP item 15, before
    any collective."""
    import torch

    from ipex_llm_tpu_torch.parallel.mesh import TPGroup
    _, _, qcfg, qparams = tiny_pair("sym_int4", hidden_size=128,
                                    head_dim=32, intermediate_size=256)
    group = TPGroup(rank=0, size=2, backend="gloo",
                    device=torch.device("cpu"), pg=None, ctrl=None,
                    timeout_s=1.0)
    with pytest.raises(NotImplementedError,
                       match=r"sequential engine.*item 15"):
        ServingEngine(qcfg, qparams, EngineConfig(**EC, step_token_budget=0),
                      device="cpu", tp=group)
