"""Cross-rank collectives with a wire family (port of
``ipex_llm_tpu/ops/collectives.py``).

Tensor-parallel serving has two kinds of cross-rank traffic: the two
row-parallel combines of every layer (the o and down projections' fp32
partial products, summed by :func:`all_reduce`) and the all-gather of a
column-parallel lm head's logits (:func:`all_gather_last`).  The ranks are
processes of one ``torch.distributed`` group (``parallel/mesh.py``'s
``TPGroup``), one per card under NCCL, or any number on one card under
gloo, whose collectives go through the host.

Families of the all-reduce (``ALLREDUCE_QTYPES``), as in the reference:

- ``"bf16"``, the exact family and the default: the fp32 partials are
  summed in fp32, so tp = 2 is bitwise a sum of two fp32 partials;
- ``"e5m2"``: each rank codes its partial to fp8 e5m2 (saturating at the
  format's largest finite value) and decodes it, then the sum in fp32;
- ``"int8"``: blockwise symmetric int8 over 64-wide blocks of the last
  axis, with fp16 scales saturating at 65504, then the sum in fp32.

The coded values travel as fp32, as on the reference's CPU meshes: the
error model is the real one, the wire width is not narrowed.

Every collective counts its calls and host seconds (:data:`COUNTS`).  A
collective that raises or times out raises :class:`CollectiveError`,
which the engine treats as sticky.  gloo may refuse a CUDA tensor for an
op; that op then goes through a host copy, counted in
``COUNTS.staged_copies`` and never silently: it happens only on gloo.
"""

from __future__ import annotations

import collections
import os
import time

import torch

ALLREDUCE_QTYPES = ("bf16", "e5m2", "int8")

# int8 family: the width of a block that shares one scale
_INT8_BLOCK = 64
# e5m2's largest finite value: beyond it a cast gives inf, which a sum
# would spread over the whole hidden state
_E5M2_MAX = 57344.0


class CollectiveError(RuntimeError):
    """A collective that failed or timed out: the group is unusable, so
    the engine fails every request and ends (``serving/faults.py``
    classifies it as sticky)."""


class _Counts:
    """Calls and host seconds of each collective op, and the host copies
    of ops staged through the host (gloo refusing a CUDA tensor)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = collections.Counter()
        self.seconds = collections.Counter()
        self.staged_copies = collections.Counter()


COUNTS = _Counts()
# ops gloo refused on a CUDA tensor in this process: staged from then on
_STAGED: set[str] = set()


def psum_exact(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group with fp32 accumulation, at ``x``'s dtype."""
    if x.dtype in (torch.float32, torch.float64):
        return _sum(x.clone(), group)
    return _sum(x.to(torch.float32), group).to(x.dtype)


def _e5m2_code(x32: torch.Tensor) -> torch.Tensor:
    """fp8 e5m2 codes of ``x32`` decoded back to fp32, saturating at the
    format's largest finite value."""
    x32 = x32.clamp(-_E5M2_MAX, _E5M2_MAX)
    return x32.to(torch.float8_e5m2).to(torch.float32)


def _int8_code(x32: torch.Tensor) -> torch.Tensor:
    """Blockwise symmetric int8 code and decode along the last axis: each
    ``_INT8_BLOCK``-wide block (the whole axis when it does not divide)
    shares one fp16 scale, amax / 127, saturating at fp16's largest finite
    value so that an outlier clips instead of decoding the block to NaN."""
    shape = x32.shape
    n = shape[-1]
    bs = _INT8_BLOCK if n % _INT8_BLOCK == 0 else n
    blocks = x32.reshape(*shape[:-1], n // bs, bs)
    amax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).clamp(0.0, 65504.0)
    scale = scale.to(torch.float16).to(torch.float32)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    codes = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return (codes.to(torch.float32) * scale).reshape(shape)


def all_reduce(x: torch.Tensor, group, qtype: str = "bf16",
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Sum ``x`` (a rank's partial sum, any float dtype) over ``group``
    under the ``qtype`` wire family; accumulation is fp32 in every
    family.  Returns ``out_dtype`` (default ``x``'s)."""
    out_dtype = out_dtype or x.dtype
    x32 = x.to(torch.float32)
    if qtype == "bf16":
        y = x32.clone() if x32 is x else x32
    elif qtype == "e5m2":
        y = _e5m2_code(x32)
    elif qtype == "int8":
        y = _int8_code(x32)
    else:
        raise ValueError(f"unknown collective qtype {qtype!r}: valid "
                         f"families are {ALLREDUCE_QTYPES}")
    return _sum(y, group).to(out_dtype)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last axis in rank order: the
    column-parallel lm head's logits back at full width.  Exact (it moves
    bits)."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    _run("all_gather", group, x,
         lambda t, outs: dist.all_gather(outs, t, group=group.pg),
         outs=parts)
    return torch.cat(parts, dim=-1)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over the group (``x`` is the call's own
    buffer); returns it."""
    import torch.distributed as dist

    x = x.contiguous()
    _run("all_reduce", group, x,
         lambda t, outs: dist.all_reduce(t, group=group.pg))
    return x


def _run(op: str, group, x: torch.Tensor, fn, outs=None):
    """Run collective ``fn(t, outs)`` on ``x`` (and the output list
    ``outs``), counting it; on gloo a CUDA tensor it refuses is staged
    through the host from then on."""
    t0 = time.perf_counter()
    staged = group.backend == "gloo" and x.is_cuda and op in _STAGED
    try:
        if not staged:
            try:
                fn(x, outs)
            except RuntimeError as exc:
                if not (group.backend == "gloo" and x.is_cuda
                        and _refused(exc)):
                    raise
                _STAGED.add(op)
                staged = True
        if staged:
            _staged(op, x, fn, outs)
    except CollectiveError:
        raise
    except Exception as exc:  # noqa: BLE001 -- every failure is sticky
        raise CollectiveError(
            f"{op} over {group.backend} (rank {group.rank} of {group.size}) "
            f"failed: {type(exc).__name__}: {exc}") from exc
    COUNTS.calls[op] += 1
    COUNTS.seconds[op] += time.perf_counter() - t0


def _refused(exc: BaseException) -> bool:
    msg = str(exc).lower()
    return any(m in msg for m in ("not supported", "unsupported",
                                  "only supports", "expected cpu"))


def _staged(op: str, x: torch.Tensor, fn, outs):
    """The collective on host copies: ``x`` to a pinned host buffer, the
    op, the results back into the CUDA buffers (each copy counted)."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    host_outs = (None if outs is None else
                 [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                  for o in outs])
    fn(host, host_outs)
    if outs is None:
        x.copy_(host)
        COUNTS.staged_copies[op] += 2
    else:
        for o, h in zip(outs, host_outs):
            o.copy_(h)
        COUNTS.staged_copies[op] += 1 + len(outs)


def ladder() -> dict[str, float]:
    """Measured per-call microseconds of each all-reduce family on this
    backend.  Nothing is recorded: the card runs measured gloo through the
    host on one card (PERF.md), which says nothing of a family's cost over
    NCCL, so no measurement is offered here."""
    return {}


def resolve_qtype(requested: str | None = None) -> str:
    """The family an op uses: the argument, then the
    ``IPEX_LLM_TPU_COLLECTIVE_QTYPE`` environment variable, then the exact
    ``"bf16"``."""
    q = requested or os.environ.get("IPEX_LLM_TPU_COLLECTIVE_QTYPE") or "bf16"
    if q not in ALLREDUCE_QTYPES:
        raise ValueError(f"unknown collective qtype {q!r}: valid families "
                         f"are {ALLREDUCE_QTYPES}")
    return q
