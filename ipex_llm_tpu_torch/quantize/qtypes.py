"""Quantization type registry (port of ``ipex_llm_tpu/quantize/qtypes.py``).

The ten block formats of the fused dequant-matmul (B2) and ``bf16`` are
registered with the reference's names, ids, kinds, bits and block sizes,
and so are the reference's aliases whose target is one of them.  A name of
another reference format (nf3, fp16, the k-quants, the iq codecs) raises
``NotImplementedError``: a real format the port has not reached yet.  A
name the reference does not know either raises ``ValueError``, as there.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QTypeInfo:
    """Static description of one quantization format.

    kind: ``int_sym`` (signed ints, per-block absmax scale), ``int_asym``
    (unsigned ints, per-block scale and minimum), ``codebook`` (nearest
    entry of a table, absmax scale), ``minifloat`` (small float codes,
    absmax scale), ``native`` (a plain dtype) or ``alias``.
    """

    name: str
    qid: int
    kind: str
    bits: float = 0.0
    block_size: int = 0
    alias_of: str | None = None


_REGISTRY: dict[str, QTypeInfo] = {}


def _reg(info: QTypeInfo) -> None:
    _REGISTRY[info.name] = info


_reg(QTypeInfo("sym_int4", 2, "int_sym", bits=4, block_size=32))
_reg(QTypeInfo("asym_int4", 3, "int_asym", bits=4, block_size=32))
_reg(QTypeInfo("sym_int5", 6, "int_sym", bits=5, block_size=32))
_reg(QTypeInfo("asym_int5", 7, "int_asym", bits=5, block_size=32))
_reg(QTypeInfo("sym_int8", 8, "int_sym", bits=8, block_size=32))
_reg(QTypeInfo("nf4", 10, "codebook", bits=4, block_size=64))
_reg(QTypeInfo("fp8_e4m3", 15, "minifloat", bits=8, block_size=128))
_reg(QTypeInfo("fp4", 16, "codebook", bits=4, block_size=64))
_reg(QTypeInfo("mixed_fp4", 17, "alias", alias_of="fp4"))
_reg(QTypeInfo("mixed_fp8", 18, "alias", alias_of="fp8_e4m3"))
_reg(QTypeInfo("fp8_e5m2", 19, "minifloat", bits=8, block_size=128))
_reg(QTypeInfo("fp8", 19, "alias", alias_of="fp8_e5m2"))
_reg(QTypeInfo("bf16", 20, "native", bits=16))
_reg(QTypeInfo("fp6", 29, "minifloat", bits=6, block_size=64))
_reg(QTypeInfo("fp6_k", 30, "alias", alias_of="fp6"))
_reg(QTypeInfo("sym_int4_rtn", 31, "alias", alias_of="sym_int4"))
_reg(QTypeInfo("sym_int8_rtn", 32, "alias", alias_of="sym_int8"))
_reg(QTypeInfo("asym_int4_rtn", 33, "alias", alias_of="asym_int4"))
_reg(QTypeInfo("woq_int4", 34, "alias", alias_of="sym_int4"))
_reg(QTypeInfo("torch_fp8_e5m2", 35, "alias", alias_of="fp8_e5m2"))
_reg(QTypeInfo("torch_fp8", 35, "alias", alias_of="fp8_e5m2"))
_reg(QTypeInfo("torch_fp8_e4m3", 36, "alias", alias_of="fp8_e4m3"))

#: the reference's other names (formats and their aliases), not ported yet
NOT_PORTED = frozenset({
    "nf3", "fp16", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k", "q8_k",
    "gguf_iq2_xxs", "gguf_iq2_xs", "gguf_iq1_s", "gguf_iq1_m"})


def resolve(qtype: str) -> QTypeInfo:
    """Name (following aliases) -> info of the format it names."""
    info = _REGISTRY.get(qtype)
    if info is None:
        if qtype in NOT_PORTED:
            raise NotImplementedError(
                f"qtype {qtype!r} is not ported yet; supported: "
                f"{sorted(_REGISTRY)}")
        raise ValueError(f"Unknown load_in_low_bit qtype {qtype!r}. "
                         f"Supported: {all_qtypes()}")
    while info.kind == "alias":
        info = _REGISTRY[info.alias_of]
    return info


def all_qtypes() -> list[str]:
    """Every name ``resolve`` accepts (formats and aliases), sorted."""
    return sorted(_REGISTRY)
