"""The port's codecs of the ten block formats and its weight carry-over
against the JAX package.

Both are integer or byte-moving work, so both are held bitwise: packed
planes, fp16 scales and zeros and dequantized values must be the same
bytes.  The JAX side always gets a jnp array, so that it runs its jitted
codec (a numpy array takes its C++ quantizer for some formats).
``reference_tree`` (the flattening of a JAX parameter tree into numpy
dicts that ``params_from_reference`` takes) lives here and is shared by the
other ``test_torch_*`` modules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.models.random_init import llama_config as ref_llama_config
from ipex_llm_tpu.models.random_init import random_params as ref_random_params
from ipex_llm_tpu.quantize import core as ref_core
from ipex_llm_tpu.quantize.core import QTensor as RefQTensor
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu.quantize import qtypes as ref_qtypes
from ipex_llm_tpu_torch.models.build import requantize_params
from ipex_llm_tpu_torch.quantize import core as port_core
from ipex_llm_tpu_torch.quantize import qtypes as port_qtypes
from ipex_llm_tpu_torch.quantize.core import QTensor

FORMATS = ("sym_int4", "asym_int4", "nf4", "fp4", "sym_int5", "asym_int5",
           "sym_int8", "fp6", "fp8_e4m3", "fp8_e5m2")


def reference_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays, QTensor leaves
    flattened to ``{data, scales, zeros, qtype, shape, block_size}``."""
    if isinstance(tree, dict):
        return {k: reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, RefQTensor):
        return {"data": np.asarray(tree.data),
                "scales": (None if tree.scales is None
                           else np.asarray(tree.scales)),
                "zeros": (None if tree.zeros is None
                          else np.asarray(tree.zeros)),
                "qtype": tree.qtype, "shape": tuple(tree.shape),
                "block_size": tree.block_size}
    if isinstance(tree, (float, int)):
        return tree
    return np.asarray(tree)


def to_bytes(x) -> bytes:
    """Raw bytes of a numpy array or a CPU tensor (bf16 through int16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.view(torch.int16)
        elif x.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
            x = x.view(torch.uint8)
        return x.contiguous().numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    elif x.dtype.name in ("float8_e5m2", "float8_e4m3fn"):
        x = x.view(np.uint8)
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("qtype", (None,) + FORMATS)
def test_params_from_reference_keeps_every_byte(qtype):
    """Every leaf of a reference tree (bf16 weights or weights packed in
    any of the ten formats, fp32 norms, the bf16 embedding, rope buffers)
    lands in the port with the same bytes, dtype width and shape."""
    cfg = ref_llama_config(hidden_size=64, intermediate_size=160,
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=16, vocab_size=256)
    ref = reference_tree(ref_random_params(cfg, qtype=qtype or "bf16",
                                           seed=3))
    port = params_from_reference(ref, device="cpu")

    def check(r, p, path):
        if isinstance(r, dict) and "qtype" in r:
            assert isinstance(p, QTensor), path
            assert (p.qtype, p.shape, p.block_size) == (
                r["qtype"], tuple(r["shape"]), r["block_size"]), path
            check(r["data"], p.data, path + ".data")
            for key in ("scales", "zeros"):
                if r[key] is None:
                    assert getattr(p, key) is None, path
                else:
                    check(r[key], getattr(p, key), f"{path}.{key}")
        elif isinstance(r, dict):
            assert set(r) == set(p), path
            for k in r:
                check(r[k], p[k], f"{path}.{k}")
        elif isinstance(r, float):
            assert p == r, path
        else:
            assert tuple(p.shape) == r.shape, path
            assert p.element_size() == r.dtype.itemsize, path
            assert to_bytes(p) == to_bytes(r), path

    check(ref, port, "params")
    assert isinstance(port["lm_head"], QTensor)
    assert port["layers"]["qkv"].data.dim() == 3       # stacked [L, ...]


def _codec_inputs():
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((200, 72)) * 0.07).astype(np.float32)
    w[:32, 0] = 0.0                         # an all-zero block: scale 0
    w[32:64, 1] = 0.25
    w[40, 1] = -0.25                        # |max| tie of opposite signs
    w[64:96, 2] = rng.integers(-8, 8, 32) * 0.5   # exact grid, .5 rounds
    return w


@pytest.mark.parametrize("shape", [(200, 72), (64, 40)])
def test_sym_int4_codec_is_bitwise_the_reference(shape):
    """quantize/dequantize agree with the JAX codec byte for byte: the
    block-local halves nibble layout, round-half-even codes, the signed
    absmax scale (first occurrence on ties), fp16 scales, the zero-padded
    trailing block (200 rows = 6 blocks + 8), and the f32 and bf16
    reconstructions.  The JAX side gets a jnp array so that it runs its
    own jnp codec, not the C++ quantizer."""
    w = _codec_inputs()[: shape[0], : shape[1]]
    ref = ref_core.quantize(jnp.asarray(w), "sym_int4")
    port = port_core.quantize(torch.from_numpy(w.copy()), "sym_int4")
    assert port.shape == tuple(ref.shape) and port.block_size == 32
    assert to_bytes(port.data) == to_bytes(ref.data)
    assert to_bytes(port.scales) == to_bytes(ref.scales)
    for ref_dt, port_dt in ((jnp.float32, torch.float32),
                            (jnp.bfloat16, torch.bfloat16)):
        assert to_bytes(port_core.dequantize(port, port_dt)) == to_bytes(
            ref_core.dequantize(ref, ref_dt))


def test_halves_layout_pairs_row_j_with_row_j_plus_16():
    """Byte j of a 32-row block holds row j (low nibble) and row j+16
    (high nibble), not adjacent rows."""
    codes = torch.arange(64, dtype=torch.uint8).reshape(64, 1) % 16
    packed = port_core._pack_nibbles(codes, 32)
    assert packed.shape == (32, 1)
    assert int(packed[0, 0]) == (0 | (0 << 4))          # rows 0 and 16
    assert int(packed[1, 0]) == (1 | (1 << 4))          # rows 1 and 17
    codes[16, 0] = 9
    codes[1, 0] = 3
    packed = port_core._pack_nibbles(codes, 32)
    assert int(packed[0, 0]) == (0 | (9 << 4))
    assert int(packed[1, 0]) == (3 | (1 << 4))
    assert torch.equal(port_core._unpack_nibbles(packed, 32), codes)


@pytest.mark.parametrize("qtype", ["nf3", "q4_k", "gguf_iq2_xxs", "fp16"])
def test_formats_outside_the_slice_raise(qtype):
    """Reference formats the port has not reached raise
    NotImplementedError; a name the reference does not know either raises
    its ValueError."""
    with pytest.raises(NotImplementedError):
        port_core.quantize(torch.zeros(64, 8), qtype)
    ref_qtypes.resolve(qtype)                      # a real reference name
    with pytest.raises(ValueError, match="load_in_low_bit"):
        port_qtypes.resolve(qtype + "_x")


@pytest.mark.parametrize("qtype", FORMATS[1:])
@pytest.mark.parametrize("shape", [(200, 72), (64, 40), (384, 24)])
def test_codec_is_bitwise_the_reference(qtype, shape):
    """The nine formats besides sym_int4: data, scales, zeros and the f32
    and bf16 reconstructions are the reference's bytes.  200 rows is a
    partial trailing block for every block size (32, 64 and 128), so the
    zero-padding path runs; 384 rows are whole blocks of every size.  The
    inputs hold an all-zero block, a constant block (asym: zero range),
    a |max| tie of opposite signs and exact grid points."""
    w = _codec_inputs()
    if shape[0] > w.shape[0]:
        w = np.concatenate([w, w[: shape[0] - w.shape[0]] * 3.0])
    w = np.ascontiguousarray(w[: shape[0], : shape[1]])
    w[64:128, 3] = 0.125                    # a constant block
    ref = ref_core.quantize(jnp.asarray(w), qtype)
    port = port_core.quantize(torch.from_numpy(w.copy()), qtype)
    info = port_qtypes.resolve(qtype)
    assert port.shape == tuple(ref.shape)
    assert port.block_size == ref.block_size == info.block_size
    assert to_bytes(port.data) == to_bytes(ref.data)
    assert to_bytes(port.scales) == to_bytes(ref.scales)
    assert (port.zeros is None) == (ref.zeros is None) == (
        info.kind != "int_asym")
    if port.zeros is not None:
        assert to_bytes(port.zeros) == to_bytes(ref.zeros)
    for ref_dt, port_dt in ((jnp.float32, torch.float32),
                            (jnp.bfloat16, torch.bfloat16)):
        assert to_bytes(port_core.dequantize(port, port_dt)) == to_bytes(
            ref_core.dequantize(ref, ref_dt))


@pytest.mark.parametrize("qtype,top", [("fp8_e4m3", 0x7E),
                                       ("fp8_e5m2", 0x7B)])
def test_fp8_block_maximum_takes_the_largest_finite_code(qtype, top):
    """The division by the scale can leave a block's maximum a hair above
    the format's largest value (448 or 57344); the cast must round it back
    to the largest finite code (never a NaN or inf code), as JAX's does.
    Checked for every block of a weight of 256 blocks, bitwise against the
    reference."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((1024, 32)) * 0.07).astype(np.float32)
    ref = ref_core.quantize(jnp.asarray(w), qtype)
    port = port_core.quantize(torch.from_numpy(w.copy()), qtype)
    assert to_bytes(port.data) == to_bytes(ref.data)
    codes = port.data.reshape(-1, 128, 32)
    at_max = codes.gather(
        1, torch.from_numpy(np.abs(w).reshape(-1, 128, 32).argmax(axis=1))
        [:, None, :]) & 0x7F
    assert bool((at_max == top).all())


def test_5bit_layout_puts_row_r_in_byte_r_over_8():
    """Low nibbles in the halves layout ([K/2] rows), then the fifth bits:
    row r's bit is bit r % 8 of bit-plane row r / 8."""
    codes = torch.zeros(64, 2, dtype=torch.uint8)
    codes[0, 0] = 16            # fifth bit of row 0
    codes[13, 0] = 16 + 5       # row 13: bit-plane byte 1, bit 5
    codes[40, 1] = 31           # row 40: second block, byte 5, bit 0
    packed = port_core._pack_5bit(codes, 32)
    assert packed.shape == (64 // 2 + 64 // 8, 2)
    high = packed[32:]
    assert int(high[0, 0]) == 1 and int(high[1, 0]) == 1 << 5
    assert int(high[5, 1]) == 1
    assert int(packed[13, 0]) == 5            # row 13, low nibble
    assert int(packed[32 // 2 + 8, 1]) == 15  # row 40 = block 1, j 8
    assert torch.equal(port_core._unpack_5bit(packed, 32), codes)
    ref = np.asarray(ref_core._pack_5bit(jnp.asarray(codes.numpy()), 32))
    assert to_bytes(packed) == to_bytes(ref)


@pytest.mark.parametrize("alias,target", [
    ("woq_int4", "sym_int4"), ("sym_int4_rtn", "sym_int4"),
    ("asym_int4_rtn", "asym_int4"), ("sym_int8_rtn", "sym_int8"),
    ("mixed_fp4", "fp4"), ("fp6_k", "fp6"), ("fp8", "fp8_e5m2"),
    ("torch_fp8", "fp8_e5m2"), ("torch_fp8_e5m2", "fp8_e5m2"),
    ("mixed_fp8", "fp8_e4m3"), ("torch_fp8_e4m3", "fp8_e4m3")])
def test_aliases_resolve_to_the_reference_format(alias, target):
    info = port_qtypes.resolve(alias)
    ref = ref_qtypes.resolve(alias)
    assert info.name == ref.name == target
    assert (info.qid, info.kind, info.bits, info.block_size) == (
        ref.qid, ref.kind, ref.bits, ref.block_size)
    assert port_core.quantize(torch.ones(64, 4), alias).qtype == target


@pytest.mark.parametrize("qtype", FORMATS)
def test_requantize_params_is_bitwise_the_reference(qtype):
    """The engine's ``weight_qtype`` repack of a bf16 tree (per stacked
    layer matrix and the lm head) gives the JAX package's planes."""
    from ipex_llm_tpu.models.build import requantize_params as ref_requant

    cfg = ref_llama_config(hidden_size=64, intermediate_size=160,
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=16, vocab_size=256)
    tree = ref_random_params(cfg, qtype="bf16", seed=4)
    ref = ref_requant(tree, qtype)
    port = requantize_params(
        params_from_reference(reference_tree(tree), device="cpu"), qtype)
    for name in ("qkv", "o", "gate_up", "down"):
        r, p = ref["layers"][name], port["layers"][name]
        assert p.qtype == qtype and p.shape == tuple(r.shape)
        assert p.data.shape == r.data.shape, name
        for key in ("data", "scales", "zeros"):
            rk, pk = getattr(r, key), getattr(p, key)
            assert (rk is None) == (pk is None), (name, key)
            if rk is not None:
                assert to_bytes(pk) == to_bytes(rk), (name, key)
    for key in ("data", "scales", "zeros"):
        rk, pk = getattr(ref["lm_head"], key), getattr(port["lm_head"], key)
        assert (rk is None) == (pk is None)
        if rk is not None:
            assert to_bytes(pk) == to_bytes(rk), key
    assert to_bytes(port["embed"]) == to_bytes(ref["embed"])
