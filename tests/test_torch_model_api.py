"""The port's model API against the JAX package's, on tiny checkpoints
written here (``tests/test_torch_loader.py``'s writer):

- ``AutoModelForCausalLM.from_pretrained(dir, load_in_low_bit=...,
  device="cpu")``: its tree is ``build_params``'s, its greedy
  ``generate`` is token for token the reference's ``from_pretrained``
  model's (on prompt seeds chosen for their margin), and ``model(ids)``
  gives the reference's logits within the decoder tests' bf16 tolerance;
- ``save_low_bit``/``load_low_bit`` through the class, both ways across
  the packages; ``optimize_model`` of an HF ``LlamaForCausalLM`` equals
  ``from_pretrained`` of its saved directory;
- the loading kwargs and what the slice refuses, each naming its ROADMAP
  item; the HF parity helpers and the ``Auto*`` stubs.
"""

import warnings

import numpy as np
import pytest
import torch

from ipex_llm_tpu.transformers.model import \
    TPUModelForCausalLM as RefModelForCausalLM
from ipex_llm_tpu_torch import optimize
from ipex_llm_tpu_torch.transformers import (AutoModel, AutoModelForCausalLM,
                                             AutoModelForMaskedLM,
                                             AutoModelForSeq2SeqLM,
                                             AutoModelForSequenceClassification,
                                             AutoModelForSpeechSeq2Seq,
                                             AutoModelForVision2Seq,
                                             TPUModelForCausalLM)
from tests.test_torch_loader import (assert_trees_equal, hf_weights,
                                     port_build_tree, tiny_hf,
                                     write_checkpoint)

# Prompt seeds of the greedy check, one per (family, load_in_low_bit): the
# best of seeds 0-79, along whose streams the port's emitted token leads
# its runner-up (in the full-sequence logits) by at least the margin noted
# (a few bf16 ulps); the token check itself is exact.
GREEDY_SEEDS = {("llama", "sym_int4"): 75,       # margin 0.094
                ("mistral", "sym_int4"): 14,     # margin 0.125
                ("llama", "bf16"): 63}           # margin 0.078
PROMPT_LENS = {"llama": (21, 6, 13), "mistral": (40, 9, 27)}
NEW_TOKENS = 6


@pytest.fixture(scope="module", params=sorted(GREEDY_SEEDS),
                ids=lambda p: f"{p[0]}-{p[1]}")
def loaded(request, tmp_path_factory):
    """(family, qtype, checkpoint dir, the port model, the reference
    model), both loaded through ``from_pretrained``."""
    family, qtype = request.param
    hf = tiny_hf(family)
    path = write_checkpoint(str(tmp_path_factory.mktemp("ckpt")), hf,
                            hf_weights(hf, seed=3), "port", shards=2)
    port = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit=qtype, device="cpu")
    ref = RefModelForCausalLM.from_pretrained(path, load_in_low_bit=qtype)
    return family, qtype, path, port, ref


def _batch(family, qtype, vocab=256):
    rng = np.random.default_rng(GREEDY_SEEDS[(family, qtype)])
    prompts = [list(map(int, rng.integers(3, vocab, n)))
               for n in PROMPT_LENS[family]]
    mx = max(PROMPT_LENS[family])
    ids = np.zeros((len(prompts), mx), np.int64)
    mask = np.zeros_like(ids)
    for i, p in enumerate(prompts):
        ids[i, mx - len(p):] = p
        mask[i, mx - len(p):] = 1
    return ids, mask


def test_from_pretrained_tree_is_build_params(loaded):
    family, qtype, path, port, _ = loaded
    assert_trees_equal(port.params, port_build_tree(path, qtype))
    assert port.qtype == qtype and port.config.model_type == family
    assert port.device == torch.device("cpu")
    assert port.generation_config.eos_token_id == (2,)


def test_generate_matches_reference_from_pretrained(loaded):
    """Greedy, a ragged left-padded batch as a torch tensor (the mistral's
    window of 16 cuts its long prompts): token for token the reference
    model's output, returned as the input's type."""
    family, qtype, _, port, ref = loaded
    ids, mask = _batch(family, qtype)
    want = ref.generate(torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask),
                        max_new_tokens=NEW_TOKENS)
    got = port.generate(torch.from_numpy(ids),
                        attention_mask=torch.from_numpy(mask),
                        max_new_tokens=NEW_TOKENS)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.long
    assert got.shape == (3, ids.shape[1] + NEW_TOKENS)
    assert torch.equal(got, want)


def test_call_logits_match_reference(loaded):
    """``model(ids)`` [B, T, V] fp32 within the decoder tests' bf16
    tolerance (2.5% of the logit range at worst, 0.5% on average)."""
    family, qtype, _, port, ref = loaded
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 24)).astype(np.int64)
    want = np.asarray(ref(ids))
    got = port(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (
        2, 24, 256)
    span = want.max() - want.min()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.025 * span)
    assert np.abs(got.numpy() - want).mean() <= 0.005 * span


def test_low_bit_round_trips_through_the_class(loaded, tmp_path):
    """The port's save reloads in both classes, the reference's save in
    the port's, every tensor bitwise and the generate the same."""
    family, qtype, _, port, ref = loaded
    port.save_low_bit(str(tmp_path / "port"))
    again = AutoModelForCausalLM.load_low_bit(str(tmp_path / "port"),
                                              device="cpu")
    assert_trees_equal(again.params, port.params)
    assert (again.qtype, again.hf_config, again.config) == (
        port.qtype, port.hf_config, port.config)
    ref.save_low_bit(str(tmp_path / "ref"))
    from_ref = optimize.load_low_bit(None, str(tmp_path / "ref"),
                                     device="cpu")
    assert_trees_equal(from_ref.params, port.params)
    ref_again = RefModelForCausalLM.load_low_bit(str(tmp_path / "port"))
    ids, mask = _batch(family, qtype)
    want = ref_again.generate(ids, attention_mask=mask, max_new_tokens=3)
    np.testing.assert_array_equal(
        again.generate(ids, attention_mask=mask, max_new_tokens=3), want)


def test_optimize_model_equals_from_pretrained(tmp_path):
    """An HF ``LlamaForCausalLM`` (fp32 weights) through ``optimize_model``
    gives the tree ``from_pretrained`` builds from its saved directory;
    ``modules_to_not_convert=["lm_head"]`` keeps the head bf16 and warns
    about other entries; a port model passes through."""
    transformers = pytest.importorskip("transformers")
    hf = tiny_hf()
    cfg = transformers.LlamaConfig(**{k: v for k, v in hf.items()
                                      if k != "architectures"})
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    got = optimize.optimize_model(model, low_bit="sym_int4", device="cpu")
    want = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), load_in_low_bit="sym_int4", device="cpu")
    assert_trees_equal(got.params, want.params)
    assert optimize.optimize_model(got) is got
    with pytest.warns(UserWarning, match="per-module"):
        kept = optimize.optimize_model(
            model, "sym_int4", device="cpu",
            modules_to_not_convert=["lm_head", "mlp.down_proj"])
    assert kept.params["lm_head"].qtype == "bf16"
    assert kept.params["layers"]["down"].qtype == "sym_int4"
    with pytest.raises(TypeError):
        optimize.optimize_model(object())
    with optimize.low_memory_init():
        pass


def test_loading_kwargs(tmp_path):
    """``load_in_4bit`` is sym_int4, no width is bf16, ``mixed_precision``
    packs the head at sym_int8; accepted-and-dropped kwargs load; an
    unknown width lists the supported ones."""
    hf = tiny_hf()
    path = write_checkpoint(str(tmp_path), hf, hf_weights(hf, seed=4))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m4 = AutoModelForCausalLM.from_pretrained(
            path, load_in_4bit=True, device="cpu", optimize_model=True,
            torch_dtype="auto", trust_remote_code=True, model_hub="hf")
    assert m4.qtype == "sym_int4" and m4.params["lm_head"].qtype == "sym_int4"
    full = AutoModelForCausalLM.from_pretrained(path, device="cpu")
    assert full.qtype == "bf16"
    mixed = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="sym_int4", mixed_precision=True, device="cpu")
    assert mixed.params["lm_head"].qtype == "sym_int8"
    alias = AutoModelForCausalLM.from_pretrained(
        path, load_in_low_bit="woq_int4", device="cpu")
    assert alias.qtype == "woq_int4"
    assert_trees_equal(alias.params, m4.params)
    with pytest.raises(ValueError, match="sym_int4"):
        AutoModelForCausalLM.from_pretrained(path, load_in_low_bit="int3",
                                             device="cpu")
    with pytest.raises(NotImplementedError):
        AutoModelForCausalLM.from_pretrained(path, load_in_low_bit="q4_k",
                                             device="cpu")
    with pytest.raises(ValueError, match="local directory"):
        AutoModelForCausalLM.from_pretrained(str(tmp_path / "absent"),
                                             device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(imatrix="imatrix.dat"), "13"), (dict(embedding_qtype="sym_int8"),
                                          "12"),
    (dict(cpu_embedding=True), "12"), (dict(disk_embedding=True), "12"),
    (dict(speculative=True), "12"), (dict(mesh="tp=2"), "15")],
    ids=["imatrix", "embedding_qtype", "cpu_embedding", "disk_embedding",
         "speculative", "mesh"])
def test_from_pretrained_refuses_what_is_not_ported(tmp_path, kw, item):
    hf = tiny_hf()
    path = write_checkpoint(str(tmp_path), hf, hf_weights(hf, seed=4))
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        AutoModelForCausalLM.from_pretrained(path, device="cpu", **kw)


@pytest.mark.parametrize("over,item", [
    ({"model_type": "bert"}, "14"), ({"model_type": "rwkv"}, "14"),
    ({"model_type": "yuan"}, "14"), ({"model_type": "qwen3"}, "14"),
    ({"model_type": "aquila"}, "14"),
    ({"quantization_config": {"quant_method": "gptq"}}, "13"),
    ({"quantization_config": {"quant_method": "awq"}}, "13")],
    ids=["bert", "rwkv", "yuan", "qwen3", "aquila", "gptq", "awq"])
def test_from_pretrained_refuses_other_checkpoints(tmp_path, over, item):
    hf = {**tiny_hf(), **over}
    weights = hf_weights(tiny_hf(), seed=4)
    if hf["model_type"] == "qwen3":
        # qwen3 is served since its family was ported, with q/k norms a
        # head wide or as wide as the projections (olmo2's flat form);
        # norms two heads wide are neither
        hd = hf["hidden_size"] // hf["num_attention_heads"]
        for i in range(hf["num_hidden_layers"]):
            for proj in ("q", "k"):
                n = f"model.layers.{i}.self_attn.{proj}_norm.weight"
                weights[n] = torch.ones(2 * hd, dtype=torch.bfloat16)
    if hf["model_type"] == "aquila":
        # aquila is served since its family was ported (llama's row); a
        # q bias without the k and v biases is not
        for i in range(hf["num_hidden_layers"]):
            n = f"model.layers.{i}.self_attn.q_proj.weight"
            weights[n[:-len("weight")] + "bias"] = torch.zeros(
                weights[n].shape[0], dtype=torch.bfloat16)
    path = write_checkpoint(str(tmp_path), hf, weights)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        AutoModelForCausalLM.from_pretrained(path, device="cpu")


def test_parity_helpers_and_auto_classes(tmp_path):
    hf = tiny_hf()
    path = write_checkpoint(str(tmp_path), hf, hf_weights(hf, seed=4))
    m = AutoModelForCausalLM.from_pretrained(path, load_in_low_bit="sym_int4",
                                             device="cpu")
    assert AutoModelForCausalLM is TPUModelForCausalLM is AutoModel
    assert m.eval() is m and m.half() is m and m.to(torch.float16) is m
    assert m.to("cpu") is m and m.device == torch.device("cpu")
    assert m.params["layers"]["qkv"].data.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.to("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            AutoModelForCausalLM.from_pretrained(path)
    for cls in (AutoModelForMaskedLM, AutoModelForSeq2SeqLM,
                AutoModelForSequenceClassification,
                AutoModelForSpeechSeq2Seq, AutoModelForVision2Seq):
        with pytest.raises(NotImplementedError, match="item 14"):
            cls.from_pretrained(path)
        with pytest.raises(NotImplementedError, match="item 14"):
            cls.load_low_bit(path)
