"""The port's transactional tick against the JAX engine's under the same
scripted faults.

One greedy wave (the prompts and arrival ticks of
``tests/test_torch_engine.py``, on its margin-chosen ``GREEDY_SEED``) goes
through the JAX ``ServingEngine`` and the port's, each with its own
``FaultInjector`` holding the same script: a transient fault at each site
of the mixed engine, a transient fault that keeps firing for one request
(retries exhausted, then isolation), a poisoned request at mixed-step and
at decode-dispatch, and a one-shot deterministic fault that vanishes under
bisection.  Both engines are driven through ``_tick``, the reference with
its static planner, which plans where the port does: once a logical tick,
before the checkpoint.  So the two run the same ticks, and the per-site
hit counts of the two injectors are compared whole, probes included.

Equal on both sides: finish reasons, the quarantined request, ``retries``,
``errors_isolated``, ``errors``, the faults fired and the site hits;
tokens, token for token.  Logprobs agree within 0.2 nats, 0.05 on average:
the tolerance ``tests/test_torch_engine.py`` states for the two engines'
greedy streams.
"""

import numpy as np
import pytest

from ipex_llm_tpu.serving.engine import EngineConfig as RefEngineConfig
from ipex_llm_tpu.serving.engine import Request as RefRequest
from ipex_llm_tpu.serving.engine import ServingEngine as RefServingEngine
from ipex_llm_tpu.serving.faults import DeterministicFault as RefDet
from ipex_llm_tpu.serving.faults import FaultInjector as RefInjector
from ipex_llm_tpu.serving.faults import TransientFault as RefTransient
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine)
from ipex_llm_tpu_torch.serving.faults import (DeterministicFault,
                                               FaultInjector, TransientFault)
from tests.test_torch_decoder import tiny_pair
from tests.test_torch_engine import EC, _prompts

FAULT_EC = dict(EC, retry_backoff_s=0.001)
LOGPROB_ATOL, LOGPROB_MEAN = 0.2, 0.05

# (site, fault class, nth, times, index of the request it is bound to)
SCRIPTS = {
    "transient page-alloc": ("page-alloc", "transient", 2, 1, None),
    "transient mixed-step": ("mixed-step", "transient", 2, 1, None),
    "transient decode-dispatch": ("decode-dispatch", "transient", 2, 1,
                                  None),
    "transient sample": ("sample", "transient", 2, 1, None),
    "sticky transient": ("mixed-step", "transient", 1, None, 3),
    "poisoned mixed-step": ("mixed-step", "deterministic", 1, None, 2),
    "poisoned decode-dispatch": ("decode-dispatch", "deterministic", 1,
                                 None, 0),
    "vanished": ("decode-dispatch", "deterministic", 1, 1, None),
}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair("bf16")


def _run(make_engine, make_req, make_inj, transient, deterministic, script,
         vocab):
    site, kind, nth, times, bound = script
    prompts = _prompts(vocab)
    reqs = [make_req(prompt_ids=ids, max_new_tokens=6,
                     request_id=f"r{i}") for i, (ids, _) in
            enumerate(prompts)]
    inj = make_inj().inject(
        site, transient if kind == "transient" else deterministic, nth=nth,
        times=times, request_id=None if bound is None else f"r{bound}")
    eng = make_engine(inj)
    for t in range(2000):
        for r, (_, at) in zip(reqs, prompts):
            if at == t:
                eng.submit(r)
        eng._tick()
        if all(r.finish_reason is not None for r in reqs):
            break
    assert all(r.finish_reason is not None for r in reqs)
    m = eng.metrics
    return {"reasons": [r.finish_reason for r in reqs],
            "tokens": [list(r.output_ids) for r in reqs],
            "logprobs": [list(r.logprobs) for r in reqs],
            "quarantined": [r.request_id for r in reqs
                            if r.finish_reason == "error"],
            "retries": m["retries"],
            "errors_isolated": m.get("errors_isolated", 0),
            "errors": m.get("errors", 0),
            "fired": inj.fired, "site_hits": dict(inj.site_hits)}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_faulted_wave_matches_reference_engine(pair, name):
    cfg, params, port_cfg, port_params = pair
    script = SCRIPTS[name]
    ref = _run(lambda inj: RefServingEngine(
                   cfg, params, RefEngineConfig(planner="static",
                                                perfwatch=False, **FAULT_EC),
                   fault_injector=inj),
               RefRequest, RefInjector, RefTransient, RefDet, script,
               cfg.vocab_size)
    port = _run(lambda inj: ServingEngine(
                    port_cfg, port_params, EngineConfig(**FAULT_EC),
                    device="cpu", fault_injector=inj),
                Request, FaultInjector, TransientFault, DeterministicFault,
                script, cfg.vocab_size)
    assert ref["fired"] > 0
    for key in ("reasons", "quarantined", "retries", "errors_isolated",
                "errors", "fired", "site_hits", "tokens"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    for a, b in zip(port["logprobs"], ref["logprobs"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGPROB_ATOL)
        if a:
            assert np.abs(np.subtract(a, b)).mean() < LOGPROB_MEAN
    _, kind, _, times, bound = script
    if bound is not None:
        assert port["quarantined"] == [f"r{bound}"]
        assert port["tokens"][bound] == []
    elif kind == "transient":
        assert port["retries"] == 1 and port["errors_isolated"] == 0
    else:
        assert port["quarantined"] == [] and port["errors"] == 0
