"""The port's sym_int4 codec and weight carry-over against the JAX package.

Both are integer or byte-moving work, so both are held bitwise: packed
planes, fp16 scales and dequantized values must be the same bytes.
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
from ipex_llm_tpu_torch.quantize import core as port_core
from ipex_llm_tpu_torch.quantize.core import QTensor


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
        elif x.dtype == torch.float8_e5m2:
            x = x.view(torch.uint8)
        return x.contiguous().numpy().tobytes()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    elif x.dtype.name == "float8_e5m2":
        x = x.view(np.uint8)
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("qtype", [None, "sym_int4"])
def test_params_from_reference_keeps_every_byte(qtype):
    """Every leaf of a reference tree (bf16 or packed sym_int4 weights,
    fp32 norms, the bf16 embedding, rope buffers) lands in the port with
    the same bytes, dtype width and shape."""
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
            if r["scales"] is None:
                assert p.scales is None, path
            else:
                check(r["scales"], p.scales, path + ".scales")
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


def test_formats_outside_the_slice_raise():
    with pytest.raises(NotImplementedError):
        port_core.quantize(torch.zeros(32, 8), "nf4")


def test_requantize_params_is_bitwise_the_reference():
    """The engine's ``weight_qtype`` repack of a bf16 tree (per stacked
    layer matrix and the lm head) gives the JAX package's planes."""
    from ipex_llm_tpu.models.build import requantize_params as ref_requant
    from ipex_llm_tpu_torch.serving.engine import requantize_params

    cfg = ref_llama_config(hidden_size=64, intermediate_size=160,
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=16, vocab_size=256)
    tree = ref_random_params(cfg, qtype="bf16", seed=4)
    ref = ref_requant(tree, "sym_int4")
    port = requantize_params(
        params_from_reference(reference_tree(tree), device="cpu"),
        "sym_int4")
    for name in ("qkv", "o", "gate_up", "down"):
        r, p = ref["layers"][name], port["layers"][name]
        assert p.qtype == "sym_int4" and p.shape == tuple(r.shape)
        assert to_bytes(p.data) == to_bytes(r.data), name
        assert to_bytes(p.scales) == to_bytes(r.scales), name
    assert to_bytes(port["lm_head"].data) == to_bytes(ref["lm_head"].data)
    assert to_bytes(port["embed"]) == to_bytes(ref["embed"])
