"""The port's ``build_server`` and ``main`` on tiny checkpoints written
here (``tests/test_torch_loader.py``'s writer), on the CPU:

- an HF checkpoint directory serves a completion whose tokens equal the
  same request sent straight to an engine over ``from_pretrained``'s tree,
  and ``/health`` reports the width it was loaded at; a ``save_low_bit``
  directory keeps its recorded width over ``low_bit``; a pinned
  ``EngineConfig.weight_qtype`` drives the load itself;
- a windowed mistral checkpoint serves its completion over the paged
  pool (the gathered route), the engine's tokens, as the llama one does;
- ``main`` maps its flags onto ``EngineConfig`` and ``build_server`` and
  refuses the flags of machinery not ported, naming the ROADMAP item.
"""

import asyncio
import pathlib
import tomllib

import pytest

from ipex_llm_tpu_torch.serving import api_server
from ipex_llm_tpu_torch.serving.api_server import build_server, main
from ipex_llm_tpu_torch.serving.engine import (EngineConfig, Request,
                                               ServingEngine,
                                               default_weight_qtype,
                                               resolve_load_low_bit,
                                               stream_tokens)
from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
from tests.test_torch_loader import hf_weights, tiny_hf, write_checkpoint

EC = dict(max_rows=4, max_seq_len=256, page_size=16, prefill_bucket=32,
          decode_horizon=2)
PROMPT = [5, 17, 33, 101, 7, 250, 64, 12, 9, 88, 140, 3]


class Tok:
    """Id passthrough: a number is its id."""
    eos_token_id = None
    chat_template = None

    def __call__(self, text):
        return {"input_ids": [int(w) % 256 for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    hf = tiny_hf()
    return write_checkpoint(str(tmp_path_factory.mktemp("llama")), hf,
                            hf_weights(hf, seed=6), "port", shards=2)


def _call(srv, method, path, body=None):
    out = asyncio.run(srv.call(method, path, body))
    return out.status, out.body


def _serve(path, **kw):
    srv = build_server(path, tokenizer=Tok(), device="cpu", **kw)
    try:
        st, body = _call(srv, "POST", "/v1/completions", {
            "prompt": " ".join(map(str, PROMPT)), "max_tokens": 8,
            "temperature": 0.0})
        _, health = _call(srv, "GET", "/health")
        _, models = _call(srv, "GET", "/v1/models")
    finally:
        srv.engine.stop()
    assert st == 200, body
    return body, health, models


def test_build_server_serves_the_engines_tokens(ckpt):
    body, health, models = _serve(ckpt, low_bit="sym_int4",
                                  engine_config=EngineConfig(**EC))
    model = AutoModelForCausalLM.from_pretrained(
        ckpt, load_in_low_bit="sym_int4", device="cpu")
    eng = ServingEngine(model.config, model.params, EngineConfig(**EC),
                        default_eos=(2,), device="cpu").start()
    try:
        req = eng.submit(Request(prompt_ids=PROMPT, max_new_tokens=8,
                                 eos_token_id=(2,)))
        want = list(stream_tokens(req, timeout=120))
    finally:
        eng.stop()
    assert body["choices"][0]["text"] == " ".join(map(str, want))
    assert body["usage"]["completion_tokens"] == len(want)
    assert health["status"] == "ok"
    assert health["weights"]["qtype"] == "sym_int4"
    assert health["weights"]["requested_qtype"] == "sym_int4"
    assert models["data"][0]["id"] == ckpt


def test_build_server_keeps_a_low_bit_directorys_width(ckpt, tmp_path):
    """A ``save_low_bit`` directory in nf4 serves nf4 whatever ``low_bit``
    says; a pinned ``weight_qtype`` outranks ``low_bit`` for the load."""
    AutoModelForCausalLM.from_pretrained(
        ckpt, load_in_low_bit="nf4", device="cpu").save_low_bit(
            str(tmp_path))
    _, health, _ = _serve(str(tmp_path), low_bit="sym_int4",
                          engine_config=EngineConfig(**EC))
    assert health["weights"]["qtype"] == "nf4"
    _, health, _ = _serve(ckpt, low_bit="sym_int4",
                          engine_config=EngineConfig(weight_qtype="sym_int8",
                                                     **EC))
    assert health["weights"]["qtype"] == "sym_int8"
    assert health["weights"]["packed_qtypes"] == ["sym_int8"]


def test_width_rule():
    pinned = EngineConfig(weight_qtype="nf4")
    assert resolve_load_low_bit(pinned, "sym_int4") == "nf4"
    assert resolve_load_low_bit(None, "sym_int4") == "sym_int4"
    assert default_weight_qtype(None, "sym_int8").weight_qtype == "sym_int8"
    assert default_weight_qtype(pinned, "sym_int8") is pinned


def test_build_server_refuses_a_windowed_checkpoint(tmp_path):
    """Once refused, a windowed checkpoint now serves: the mistral's
    window of 16 cuts the 12-id prompt and its 8 new tokens, and the text
    equals the engine's over ``from_pretrained``'s tree."""
    hf = tiny_hf("mistral")
    path = write_checkpoint(str(tmp_path), hf, hf_weights(hf, seed=6))
    body, health, _ = _serve(path, low_bit="sym_int4",
                             engine_config=EngineConfig(**EC))
    model = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", device="cpu")
    assert model.config.sliding_window == 16
    eng = ServingEngine(model.config, model.params, EngineConfig(**EC),
                        default_eos=(2,), device="cpu").start()
    try:
        want = list(stream_tokens(eng.submit(Request(
            prompt_ids=PROMPT, max_new_tokens=8, eos_token_id=(2,))),
            timeout=120))
    finally:
        eng.stop()
    assert body["choices"][0]["text"] == " ".join(map(str, want))
    assert health["status"] == "ok"


def test_main_maps_its_flags(monkeypatch):
    seen = {}

    class Srv:
        app = object()

    def fake_build(model, low_bit, ec, drain_timeout_s, device):
        seen.update(model=model, low_bit=low_bit, ec=ec,
                    drain=drain_timeout_s, device=device)
        return Srv()

    web = pytest.importorskip("aiohttp.web")
    monkeypatch.setattr(api_server, "build_server", fake_build)
    monkeypatch.setattr(web, "run_app", lambda app, host, port: seen.update(
        app=app, host=host, port=port))
    main(["--model", "/ckpt", "--low-bit", "nf4", "--device", "cpu",
          "--port", "8123", "--max-rows", "3", "--max-seq-len", "512",
          "--spec-k", "2", "--decode-horizon", "4", "--step-token-budget",
          "64", "--weight-qtype", "sym_int8", "--kv-storage", "fp8",
          "--kv-pool-bytes", "1000000", "--max-queue", "9",
          "--request-deadline", "1.5", "--max-step-retries", "2",
          "--drain-timeout", "7", "--trace", "--planner", "static"])
    ec = seen["ec"]
    assert (seen["model"], seen["low_bit"], seen["device"], seen["drain"],
            seen["port"], seen["app"]) == ("/ckpt", "nf4", "cpu", 7.0, 8123,
                                           Srv.app)
    assert (ec.max_rows, ec.max_seq_len, ec.spec_k, ec.decode_horizon,
            ec.step_token_budget, ec.weight_qtype, ec.kv_storage,
            ec.kv_pool_bytes, ec.max_queue, ec.request_deadline_s,
            ec.max_step_retries, ec.trace_requests) == (
        3, 512, 2, 4, 64, "sym_int8", "fp8", 1000000, 9, 1.5, 2, True)


@pytest.mark.parametrize("flags,item", [
    (["--asr-model", "/whisper"], "14"),
    (["--kv-spill-bytes", "1024"], "11"),
    (["--kv-import-token", "t"], "11"),
    (["--profile-dir", "/p"], "10"),
    (["--planner", "mpc"], "10")], ids=lambda v: str(v))
def test_main_refuses_flags_not_ported(flags, item, capsys, monkeypatch):
    monkeypatch.setattr(api_server, "build_server", pytest.fail)
    with pytest.raises(SystemExit) as e:
        main(["--model", "/ckpt"] + flags)
    assert e.value.code == 2
    assert f"ROADMAP item {item}" in capsys.readouterr().err


def test_server_script_is_packaged():
    root = pathlib.Path(__file__).resolve().parents[1]
    meta = tomllib.loads((root / "pyproject.toml").read_text())
    assert meta["project"]["scripts"]["ipex-llm-tpu-torch-serve"] == \
        "ipex_llm_tpu_torch.serving.api_server:main"
