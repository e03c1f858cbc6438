"""The port's checkpoint import against the JAX package, on tiny
checkpoints written here (2 layers, hidden 64, 4 heads over 2 kv heads,
vocab 256; random weights from a seed):

- the reader: every tensor of a checkpoint written four ways (the port's
  numpy safetensors writer, ``safetensors.numpy``, an HF
  ``save_pretrained``, ``pytorch_model.bin``), single-file and sharded, in
  bf16, f16 and f32, is bitwise what the reference's reader returns (its
  fp32 upcast is exact), with the stored dtype kept;
- ``build_params``: the port's tree equals ``convert(reference
  build_params)`` leaf for leaf, bitwise, in seven formats and with
  ``mixed_precision``, for llama and mistral, against the reference's
  jitted codec (with the port quantizing in column slices) and against
  its default load path, the C++ quantizer (there fp4 and asym_int4 differ
  only in codes where the reference's two paths differ from each other);
- low-bit files: port save -> reference load, reference save -> port
  load and port -> port, every tensor bitwise.
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from ipex_llm_tpu.models import serialize as ref_serialize
from ipex_llm_tpu.models.build import build_params as ref_build_params
from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.models.loader import CheckpointReader as RefReader
from ipex_llm_tpu.native import quantizer as ref_native
from ipex_llm_tpu_torch.models import build as port_build
from ipex_llm_tpu_torch.models import serialize
from ipex_llm_tpu_torch.models.build import build_params
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.families import get_family
from ipex_llm_tpu_torch.models.loader import (CheckpointReader, read_config,
                                              save_safetensors)
from ipex_llm_tpu_torch.quantize.core import QTensor
from tests.test_torch_quantize import reference_tree, to_bytes

WINDOW = 16


def tiny_hf(family: str = "llama") -> dict:
    """A tiny HF ``config.json`` of the family."""
    hf = {"model_type": family, "architectures": [
              "LlamaForCausalLM" if family == "llama"
              else "MistralForCausalLM"],
          "vocab_size": 256, "hidden_size": 64, "intermediate_size": 160,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_key_value_heads": 2, "max_position_embeddings": 512,
          "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "hidden_act": "silu",
          "tie_word_embeddings": False, "bos_token_id": 1,
          "eos_token_id": 2}
    if family == "mistral":
        hf["sliding_window"] = WINDOW
    return hf


def hf_weights(hf: dict, seed: int = 0,
               dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """HF-named weights ([out, in]) from a numpy seed: norms 1 + 0.05 N,
    the others N * 1.2 / sqrt(fan_in), rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    hd = h // hf["num_attention_heads"]
    q, kv = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (v, h), "model.norm.weight": (h,),
              "lm_head.weight": (v, h)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (q, h),
            p + "self_attn.k_proj.weight": (kv, h),
            p + "self_attn.v_proj.weight": (kv, h),
            p + "self_attn.o_proj.weight": (h, q),
            p + "mlp.gate_proj.weight": (f, h),
            p + "mlp.up_proj.weight": (f, h),
            p + "mlp.down_proj.weight": (h, f)})
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            w = 1.0 + 0.05 * rng.standard_normal(shape)
        else:
            w = rng.standard_normal(shape) * (1.2 / np.sqrt(shape[-1]))
        out[name] = torch.from_numpy(w.astype(np.float32)).to(dtype)
    return out


def _shard_names(names: list[str], shards: int) -> list[list[str]]:
    return [names[i::shards] for i in range(shards)]


def _write_index(path: str, groups: list[list[str]], files: list[str]):
    weight_map = {n: f for g, f in zip(groups, files) for n in g}
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def write_checkpoint(path: str, hf: dict, tensors: dict[str, torch.Tensor],
                     how: str = "port", shards: int = 1) -> str:
    """An HF checkpoint directory: ``config.json`` and ``tensors`` written
    by the port's writer (``port``), ``safetensors.numpy`` (``numpy``), an
    HF model's ``save_pretrained`` (``hf``) or ``torch.save`` (``bin``);
    ``shards`` > 1 splits it with an index."""
    os.makedirs(path, exist_ok=True)
    if how == "hf":
        transformers = pytest.importorskip("transformers")
        cls = (transformers.LlamaForCausalLM if hf["model_type"] == "llama"
               else transformers.MistralForCausalLM)
        ccls = (transformers.LlamaConfig if hf["model_type"] == "llama"
                else transformers.MistralConfig)
        model = cls(ccls(**{k: v for k, v in hf.items()
                            if k != "architectures"}))
        model = model.to(next(iter(tensors.values())).dtype)
        model.load_state_dict(tensors, strict=True)
        # the tiny model is ~0.3 MB a dtype byte: 150KB shards split it
        model.save_pretrained(path, safe_serialization=True,
                              max_shard_size="150KB" if shards > 1
                              else "10GB")
        return path
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    names = list(tensors)
    if how == "bin":
        torch.save(tensors, os.path.join(path, "pytorch_model.bin"))
        return path
    if how == "numpy":
        from safetensors.numpy import save_file

        def write(group, file):
            arrays = {}
            for n in group:
                t = tensors[n]
                if t.dtype == torch.bfloat16:
                    import ml_dtypes
                    arrays[n] = t.view(torch.int16).numpy().view(
                        ml_dtypes.bfloat16)
                else:
                    arrays[n] = t.numpy()
            save_file(arrays, os.path.join(path, file))
    else:
        def write(group, file):
            save_safetensors({n: tensors[n] for n in group},
                             os.path.join(path, file))
    if shards == 1:
        write(names, "model.safetensors")
        return path
    groups = _shard_names(names, shards)
    files = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
             for i in range(shards)]
    for g, f in zip(groups, files):
        write(g, f)
    _write_index(path, groups, files)
    return path


# -- the reader ---------------------------------------------------------------

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
READER_CASES = (
    [("port", s, d) for s in (1, 2) for d in DTYPES]
    + [("numpy", s, d) for s in (1, 2) for d in DTYPES]
    + [("hf", s, d) for s in (1, 2) for d in ("bf16", "f32")]
    + [("bin", 1, d) for d in DTYPES])


@pytest.mark.parametrize("how,shards,dtype", READER_CASES,
                         ids=lambda v: str(v))
def test_reader_is_bitwise_the_reference(tmp_path, how, shards, dtype):
    if how == "numpy":
        pytest.importorskip("safetensors")
    hf = tiny_hf()
    tensors = hf_weights(hf, seed=1, dtype=DTYPES[dtype])
    path = write_checkpoint(str(tmp_path / "ckpt"), hf, tensors, how, shards)
    if shards > 1:
        assert os.path.exists(os.path.join(path,
                                           "model.safetensors.index.json"))
    ref, port = RefReader(path), CheckpointReader(path)
    assert port.names() == ref.names() == sorted(tensors)
    for name in ref.names():
        assert port.has(name) and ref.has(name)
        got = port.get(name)
        assert got.dtype == DTYPES[dtype], name
        assert torch.equal(got, tensors[name]), name
        want = np.asarray(ref.get(name))
        assert want.dtype == np.float32
        assert to_bytes(got.float()) == to_bytes(want), name
    assert not port.has("model.layers.0.self_attn.q_proj.bias")
    assert read_config(path)["model_type"] == "llama"


def test_writer_output_reads_in_the_safetensors_package(tmp_path):
    """The port's writer makes files the format's own reader accepts, with
    the same dtypes, shapes and bytes (bf16, f16, f32, u8, u16, a scalar
    and an empty tensor), and keeps the metadata."""
    safe_open = pytest.importorskip("safetensors").safe_open
    tensors = {"a": torch.randn(3, 5).bfloat16(), "b": torch.randn(7).half(),
               "c": torch.randn(2, 2), "d": torch.arange(9, dtype=torch.uint8),
               "e": torch.arange(4).to(torch.int16).view(torch.uint16),
               "s": torch.tensor(2.5), "z": torch.zeros(0, 3)}
    f = str(tmp_path / "x.safetensors")
    save_safetensors(tensors, f, metadata={"format": "pt"})
    with safe_open(f, framework="pt") as g:
        assert sorted(g.keys()) == sorted(tensors)
        assert g.metadata() == {"format": "pt"}
        for k, t in tensors.items():
            got = g.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape, k
            assert to_bytes(got) == to_bytes(t) if t.dtype != torch.uint16 \
                else torch.equal(got.view(torch.int16), t.view(torch.int16))


# -- build_params -------------------------------------------------------------

FORMATS = ("sym_int4", "nf4", "fp4", "sym_int8", "asym_int4", "sym_int5",
           "bf16")
BUILD_CASES = [(q, False) for q in FORMATS] + [("sym_int4", True)]


@pytest.fixture(scope="module", params=["llama", "mistral"])
def ckpt(request, tmp_path_factory):
    """A bf16 checkpoint of the family, sharded in two."""
    hf = tiny_hf(request.param)
    return write_checkpoint(str(tmp_path_factory.mktemp(request.param)), hf,
                            hf_weights(hf, seed=2), "port", shards=2)


def reference_build(path: str, qtype: str, mixed: bool = False):
    """(the reference tree carried into the port, the reference tree)."""
    hf = read_config(path)
    fam = ref_get_family(hf["model_type"], hf)
    r = RefReader(path)
    tree = ref_build_params(fam.to_config(hf), fam.scheme, r.get, r.has,
                            qtype=qtype, mixed_precision=mixed)
    return params_from_reference(reference_tree(tree), device="cpu"), tree


def port_build_tree(path: str, qtype: str, mixed: bool = False) -> dict:
    hf = read_config(path)
    fam = get_family(hf["model_type"], hf)
    r = CheckpointReader(path)
    return build_params(fam.to_config(hf), fam.scheme, r.get, r.has,
                        qtype=qtype, mixed_precision=mixed, device="cpu")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _ulps_off(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in fp16 ulps (adjacent bit patterns of same-sign values)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return (ia - ib).abs()


def assert_trees_equal(got: dict, want: dict, scale_ulp_share=None):
    """Same keys, QTensor metadata, dtypes, shapes and bytes.  With
    ``scale_ulp_share``, fp16 scales and minima may differ by one ulp in
    at most that share of their elements over the whole tree."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    off = total = 0
    for path in w:
        a, b = g[path], w[path]
        if isinstance(b, QTensor):
            assert isinstance(a, QTensor), path
            assert (a.qtype, a.shape, a.block_size) == (
                b.qtype, b.shape, b.block_size), path
            pairs = [("data", a.data, b.data), ("scales", a.scales, b.scales),
                     ("zeros", a.zeros, b.zeros)]
        elif isinstance(b, float):
            assert a == b and isinstance(a, float), path
            continue
        else:
            pairs = [("", a, b)]
        for what, x, y in pairs:
            if y is None:
                assert x is None, (path, what)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (path, what)
            if scale_ulp_share is not None and what in ("scales", "zeros"):
                d = _ulps_off(x, y)
                assert int(d.max()) <= 1, (path, what)
                off += int((d > 0).sum())
                total += d.numel()
                continue
            assert to_bytes(x) == to_bytes(y), (path, what)
    if scale_ulp_share is not None:
        assert off <= scale_ulp_share * total, (off, total)
    return off, total


@pytest.mark.parametrize("qtype,mixed", BUILD_CASES,
                         ids=lambda v: str(v))
def test_build_params_is_bitwise_the_reference_jitted_codec(
        ckpt, qtype, mixed, monkeypatch):
    """Against the reference's jitted codec (its C++ quantizer switched
    off), with the port quantizing each weight in slices of 7 rows of the
    HF layout: packed columns do not depend on their neighbours."""
    monkeypatch.setattr(ref_native, "available", lambda: False)
    monkeypatch.setattr(port_build, "_CHUNK_ELEMS", 7 * 64)
    want, _ = reference_build(ckpt, qtype, mixed)
    got = port_build_tree(ckpt, qtype, mixed)
    assert_trees_equal(got, want)
    if mixed:
        assert got["lm_head"].qtype == "sym_int8"
        assert got["layers"]["qkv"].qtype == "sym_int4"


# Formats in which the reference's C++ quantizer and its jitted codec pack
# some codes differently on these checkpoints (ROADMAP queue 3, "Two
# quantize paths"): fp4 91 and asym_int4 79 code bytes of ~51k, scales and
# minima equal.
CPP_DIVERGES = ("fp4", "asym_int4")


def _planes(tree):
    for path, leaf in _leaves(tree):
        if isinstance(leaf, QTensor):
            for key in ("data", "scales", "zeros"):
                if getattr(leaf, key) is not None:
                    yield (path, key), getattr(leaf, key)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@functools.lru_cache(maxsize=None)
def _native_loaded(tries: int = 30, wait_s: float = 2.0) -> bool:
    """Whether the reference's C++ quantizer is loaded in this process.
    The reference builds it at first use into one file that every test
    worker of a run shares; a worker that loads it while another is still
    writing it fails and keeps that answer (its loader's ``_LIB`` stays
    False), so the load is tried again, a few times, once the file may be
    whole.  Once a process: the answer is cached."""
    for _ in range(tries):
        if ref_native.available():
            return True
        if os.environ.get("IPEX_LLM_TPU_DISABLE_NATIVE", "0") == "1":
            return False
        ref_native._LIB = None
        time.sleep(wait_s)
    return False


@pytest.mark.parametrize("qtype,mixed", BUILD_CASES,
                         ids=lambda v: str(v))
def test_build_params_against_the_reference_default_path(
        ckpt, qtype, mixed, monkeypatch):
    """Against the reference's own load path (numpy input: its C++
    quantizer for the 4- and 8-bit int and codebook formats, where it
    loads; else its jitted codec).  Bitwise in every format but those of
    ``CPP_DIVERGES``; there the port differs from the C++ path only in
    bytes where the reference's two paths differ from each other (the port
    is its jitted codec), and asym_int4's fp16 scales and minima are at
    most one ulp off in at most 0.1% of them.  Where the C++ quantizer
    cannot load, the default path is the jitted codec, and the trees are
    bitwise in every format."""
    native = _native_loaded()
    cpp, _ = reference_build(ckpt, qtype, mixed)
    got = port_build_tree(ckpt, qtype, mixed)
    if qtype not in CPP_DIVERGES or not native:
        assert_trees_equal(got, cpp)
        return
    share = 1e-3 if qtype == "asym_int4" else None
    with pytest.raises(AssertionError, match="data"):
        assert_trees_equal(got, cpp, scale_ulp_share=share)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    jit, _ = reference_build(ckpt, qtype, mixed)
    off = 0
    for ((key, a), (_, b), (_, c)) in zip(_planes(got), _planes(cpp),
                                          _planes(jit)):
        a, b, c = _bytes(a), _bytes(b), _bytes(c)
        assert not ((a != b) & (c == b)).any(), key
        if key[1] != "data":
            assert int((_ulps_off(a, b)).max()) <= 1, key
        off += int((a != b).sum())
    assert off > 0


def test_build_params_refuses_what_is_not_ported(ckpt):
    hf = read_config(ckpt)
    fam = get_family(hf["model_type"])
    cfg = fam.to_config(hf)
    r = CheckpointReader(ckpt)
    for kw in (dict(imatrix_data={"0_qkv": [1.0]}),
               dict(embedding_qtype="sym_int8"),
               dict(qkv_transform=lambda w, c: w),
               dict(transpose_weights=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP item"):
            build_params(cfg, fam.scheme, r.get, r.has, device="cpu", **kw)

    def has_bias(n):
        return r.has(n) or n == "model.layers.0.self_attn.q_proj.bias"
    with pytest.raises(NotImplementedError, match="bias"):
        build_params(cfg, fam.scheme, r.get, has_bias, device="cpu")
    for q in ("mixed_fp4", "mixed_fp8"):
        with pytest.raises(NotImplementedError):
            port_build.quantize_weight(torch.zeros(64, 64), q)
    for other in ("bloom", "mpt", "gpt_bigcode", "deci_lm"):
        with pytest.raises(NotImplementedError, match="item 14"):
            get_family(other)


def test_stack_layer_trees_matches_torch_stack():
    a = {"n": torch.randn(4), "q": port_build.quantize_weight(
        torch.randn(96, 64), "asym_int4")}
    b = {"n": torch.randn(4), "q": port_build.quantize_weight(
        torch.randn(96, 64), "asym_int4")}
    st = port_build.stack_layer_trees([a, b])
    assert torch.equal(st["n"], torch.stack([a["n"], b["n"]]))
    for key in ("data", "scales", "zeros"):
        assert torch.equal(getattr(st["q"], key), torch.stack(
            [getattr(a["q"], key), getattr(b["q"], key)]))
    assert st["q"].shape == (64, 96)


# -- low-bit files ------------------------------------------------------------

LOWBIT = ("sym_int4", "asym_int4", "bf16")


def _file_tensors(path: str) -> dict:
    from ipex_llm_tpu_torch.models.loader import SafetensorsFile
    f = SafetensorsFile(os.path.join(path, serialize.WEIGHTS_NAME))
    return {k: f.get(k) for k in f.keys()}


@pytest.mark.parametrize("qtype", LOWBIT)
def test_port_save_loads_in_the_reference(ckpt, tmp_path, qtype,
                                          monkeypatch):
    """The port's files load in the reference with every tensor bitwise,
    the same manifest and the same tensor names and dtypes as the
    reference's own save of the same tree."""
    monkeypatch.setattr(ref_native, "available", lambda: False)
    ref_tree_port, ref_tree = reference_build(ckpt, qtype)
    tree = port_build_tree(ckpt, qtype)
    hf = read_config(ckpt)
    serialize.save_low_bit(str(tmp_path / "port"), tree, hf, qtype)
    params, hf2, q2 = ref_serialize.load_low_bit(str(tmp_path / "port"))
    assert (hf2, q2) == (hf, qtype)
    assert_trees_equal(params_from_reference(reference_tree(params),
                                             device="cpu"), ref_tree_port)
    ref_serialize.save_low_bit(str(tmp_path / "ref"), ref_tree, hf, qtype)
    metas = [json.load(open(tmp_path / d / serialize.CONFIG_NAME))
             for d in ("port", "ref")]
    assert metas[0]["load_in_low_bit"] == metas[1]["load_in_low_bit"]
    assert metas[0]["manifest"]["qtensors"] == metas[1]["manifest"][
        "qtensors"]
    assert sorted(metas[0]["manifest"]["bf16"]) == sorted(
        metas[1]["manifest"]["bf16"])
    assert metas[0]["manifest"]["scalars"] == metas[1]["manifest"]["scalars"]
    files = [_file_tensors(str(tmp_path / d)) for d in ("port", "ref")]
    assert sorted(files[0]) == sorted(files[1])
    for k in files[1]:
        assert files[0][k].dtype == files[1][k].dtype, k
        assert to_bytes(files[0][k]) == to_bytes(files[1][k]) \
            if files[0][k].dtype != torch.uint16 else torch.equal(
                files[0][k].view(torch.int16), files[1][k].view(torch.int16))


@pytest.mark.parametrize("qtype", LOWBIT)
def test_reference_save_loads_in_the_port(ckpt, tmp_path, qtype,
                                          monkeypatch):
    monkeypatch.setattr(ref_native, "available", lambda: False)
    want, ref_tree = reference_build(ckpt, qtype)
    hf = read_config(ckpt)
    ref_serialize.save_low_bit(str(tmp_path), ref_tree, hf, qtype)
    params, hf2, q2 = serialize.load_low_bit(str(tmp_path), device="cpu")
    assert (hf2, q2) == (hf, qtype)
    assert_trees_equal(params, want)


@pytest.mark.parametrize("qtype", LOWBIT)
def test_port_save_loads_in_the_port(ckpt, tmp_path, qtype):
    tree = port_build_tree(ckpt, qtype)
    serialize.save_low_bit(str(tmp_path), tree, {"model_type": "llama"},
                           qtype)
    params, hf, q = serialize.load_low_bit(str(tmp_path), device="cpu")
    assert (hf, q) == ({"model_type": "llama"}, qtype)
    assert_trees_equal(params, tree)
