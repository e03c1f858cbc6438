"""Quantization type registry (port of ``ipex_llm_tpu/quantize/qtypes.py``).

Only the two widths of this slice are registered, with the reference's
names and ids: ``sym_int4`` (q4_0-style, 32-row blocks) and ``bf16``.  Any
other name raises ``NotImplementedError``: it is a real format of the
reference that the port has not reached yet, not an unknown name.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QTypeInfo:
    """Static description of one quantization format (see the reference's
    docstring for the ``kind`` vocabulary)."""

    name: str
    qid: int
    kind: str
    bits: float = 0.0
    block_size: int = 0


_REGISTRY: dict[str, QTypeInfo] = {
    "sym_int4": QTypeInfo("sym_int4", 2, "int_sym", bits=4, block_size=32),
    "bf16": QTypeInfo("bf16", 20, "native", bits=16),
}


def resolve(qtype: str) -> QTypeInfo:
    """Name -> info; formats outside the slice raise NotImplementedError."""
    try:
        return _REGISTRY[qtype]
    except KeyError:
        raise NotImplementedError(
            f"qtype {qtype!r} is not ported yet; supported: "
            f"{sorted(_REGISTRY)}") from None
