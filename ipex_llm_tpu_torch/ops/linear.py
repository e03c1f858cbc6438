"""Quantized linear (port of ``ipex_llm_tpu/ops/linear.py``).

Weights in the ten block formats go to the fused dequant-matmul kernel
(B2, the reference's ``_PALLAS_QTYPES``), and rows sorted by expert
against an ``[E, ...]`` expert stack to its expert-grouped form (B2e,
:func:`qmatmul_experts`); ``bf16`` weights are a plain product (the
reference leaves those to XLA).  A bias (fp32, as the reference keeps it)
is cast to the output's dtype and added, as the reference adds it.  A
``training.qlora.LoraWeight`` adds ``(x A) B alpha/r`` to its frozen
base's output, in the adapters' fp32, a plain product outside any kernel
as in the reference.  Other formats raise.  The reference's oracle,
``qmatmul_reference``, is B2's plain version here:
``ops/cuda/qmatmul.py::qmatmul_plain``, which the wrapper runs for CPU
tensors.

Under a gradient (``torch.is_grad_enabled()`` and an x that requires
grad) B2 runs inside :class:`_QMatmul`, whose backward is B2's input
gradient (B2^T, ``ops/cuda/qmatmul_dx.py``); the planes get none, as the
reference's ``MatMulLowBit.backward`` gives none.  Otherwise the kernel is
called as it is, with no autograd node.  ``generate()``, the model's
``__call__`` and the engine's ticks run under ``torch.no_grad()``, so they
never enter the Function, even over params that a training step left
requiring grad.  B2e under a gradient raises (MoE
training is ROADMAP item 16's remainder).

Tensor-parallel serving passes the rank's group (``parallel/mesh.py``'s
``TPGroup``) and the weight's split: ``mode="col"`` (qkv, gate_up, the lm
head: the rank's output columns, no collective) or ``"row"`` (o, down:
the rank's fp32 partial, summed over the group by
``ops/collectives.py::all_reduce`` under the group's wire family, then
rounded to bf16; the reference's ``ops/linear.py:49-70``).  A block
format goes through B2's sharded wrapper (``qmatmul_sharded``), a bf16
weight through a plain product summed the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.quantize.core import QTensor


class _QMatmul(torch.autograd.Function):
    """B2 forward, B2^T backward: the gradient reaches x only."""

    @staticmethod
    def forward(ctx, x, qt):
        ctx.qt, ctx.k, ctx.dtype = qt, x.shape[-1], x.dtype
        return _qmatmul(x, qt)

    @staticmethod
    def backward(ctx, dy):
        lead = dy.shape[:-1]
        dy2 = dy.reshape(-1, dy.shape[-1]).to(torch.bfloat16).contiguous()
        dx = b2t.qmatmul_dx(dy2, ctx.qt)[:, :ctx.k]
        return dx.reshape(*lead, ctx.k).to(ctx.dtype), None


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [..., in] @ dequant(qt) -> [..., out] through the B2 wrapper (the
    kernel on a CUDA tensor, its plain version on a CPU one); under a
    gradient through :class:`_QMatmul`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _QMatmul.apply(x, qt)
    return _qmatmul(x, qt)


def _qmatmul(x: torch.Tensor, qt: QTensor, tp=None,
             mode: str | None = None) -> torch.Tensor:
    if qt.qtype not in b2.FORMATS:
        raise NotImplementedError(f"qmatmul for {qt.qtype!r} is not ported")
    lead = x.shape[:-1]
    k = x.shape[-1]
    num, den = b2.data_row_factor(qt.qtype)
    k_pad = qt.data.shape[0] * num // den
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if k_pad != k:   # quantization block padding (core._to_blocks)
        x2 = F.pad(x2, (0, k_pad - k))
    if mode is None:
        out = b2.qmatmul(x2.contiguous(), qt)
    else:
        out = b2.qmatmul_sharded(x2.contiguous(), qt, mode, tp,
                                 qtype=tp.collective_qtype)
    return out.reshape(*lead, qt.out_features).to(x.dtype)


def qmatmul_experts(x_sorted: torch.Tensor, seg: torch.Tensor, qt: QTensor,
                    out_dtype: torch.dtype = torch.bfloat16, *,
                    max_rows: int | None = None) -> torch.Tensor:
    """x_sorted [P, in] (rows sorted by expert, ``seg`` [E + 1] their
    offsets) against the ``[E, ...]`` expert stack ``qt`` -> [P, out] in
    ``out_dtype`` (bf16 or fp32) through the B2e wrapper (the kernel on a
    CUDA tensor, its plain version on a CPU one); ``max_rows``, a static
    bound on the rows any expert holds, picks the kernel's instance."""
    if qt.qtype not in b2.FORMATS:
        raise NotImplementedError(
            f"qmatmul_experts for {qt.qtype!r} is not ported")
    if torch.is_grad_enabled() and x_sorted.requires_grad:
        raise NotImplementedError(
            "B2e under a gradient (MoE training) is not ported (ROADMAP "
            "item 16's remainder)")
    k = x_sorted.shape[-1]
    num, den = b2.data_row_factor(qt.qtype)
    k_pad = qt.data.shape[-2] * num // den
    x2 = x_sorted.to(torch.bfloat16)
    if k_pad != k:   # quantization block padding (core._to_blocks)
        x2 = F.pad(x2, (0, k_pad - k))
    return b2e.qmatmul_experts(x2.contiguous(), seg, qt,
                               keep_f32=out_dtype == torch.float32,
                               max_rows=max_rows)


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None, *,
           tp=None, mode: str | None = None) -> torch.Tensor:
    """Linear over a QTensor (a block format or bf16), a plain bf16
    matrix or a LoraWeight, plus ``bias`` in the output's dtype; with a
    ``tp`` group, ``mode`` ("col" or "row") is the rank's split of ``w``
    (module docstring)."""
    if tp is not None and mode is not None:
        y = _linear_sharded(x, w, tp, mode)
    elif isinstance(w, QTensor) and w.qtype != "bf16":
        y = qmatmul(x, w)
    elif isinstance(w, (QTensor, torch.Tensor)):
        if isinstance(w, QTensor):
            w = w.data
        if x.is_cuda:
            # a plain bf16 product outside any kernel (fp32 accumulation)
            y = torch.matmul(x.to(w.dtype), w).to(x.dtype)
        else:
            y = torch.matmul(x.to(w.dtype).to(torch.float64),
                             w.to(torch.float64)).to(x.dtype)
    else:
        from ipex_llm_tpu_torch.training.qlora import LoraWeight
        if not isinstance(w, LoraWeight):
            raise TypeError(f"linear over a {type(w).__name__}")
        y = linear(x, w.base)
        lora = torch.matmul(torch.matmul(x.to(w.a.dtype), w.a), w.b) * w.scale
        y = y + lora.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _linear_sharded(x: torch.Tensor, w, tp, mode: str) -> torch.Tensor:
    """One rank's share of a tensor-parallel linear (module docstring)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "tensor-parallel linear under a gradient is not ported "
            "(ROADMAP item 15)")
    if mode not in ("col", "row"):
        raise ValueError(f"tp mode {mode!r}")
    if isinstance(w, QTensor) and w.qtype != "bf16":
        return _qmatmul(x, w, tp, mode)
    from ipex_llm_tpu_torch.ops.collectives import all_reduce

    w = w.data if isinstance(w, QTensor) else w
    if mode == "col":
        return linear(x, w)
    if x.is_cuda:    # the fp32 partial of a plain bf16 product
        y = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w,
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = torch.matmul(x.to(w.dtype).to(torch.float64),
                         w.to(torch.float64)).to(torch.float32)
    return all_reduce(y, tp, tp.collective_qtype, out_dtype=x.dtype)
