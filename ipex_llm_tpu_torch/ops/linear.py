"""Quantized linear (port of ``ipex_llm_tpu/ops/linear.py``).

Weights in the ten block formats go to the fused dequant-matmul kernel
(B2, the reference's ``_PALLAS_QTYPES``), and rows sorted by expert
against an ``[E, ...]`` expert stack to its expert-grouped form (B2e,
:func:`qmatmul_experts`); ``bf16`` weights are a plain product (the
reference leaves those to XLA).  A bias (fp32, as the reference keeps it)
is cast to the output's dtype and added, as the reference adds it.  Other
formats and LoRA weights raise.  The reference's oracle,
``qmatmul_reference``, is B2's plain version here:
``ops/cuda/qmatmul.py::qmatmul_plain``, which the wrapper runs for CPU
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.quantize.core import QTensor


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [..., in] @ dequant(qt) -> [..., out] through the B2 wrapper (the
    kernel on a CUDA tensor, its plain version on a CPU one)."""
    if qt.qtype not in b2.FORMATS:
        raise NotImplementedError(f"qmatmul for {qt.qtype!r} is not ported")
    lead = x.shape[:-1]
    k = x.shape[-1]
    num, den = b2.data_row_factor(qt.qtype)
    k_pad = qt.data.shape[0] * num // den
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if k_pad != k:   # quantization block padding (core._to_blocks)
        x2 = F.pad(x2, (0, k_pad - k))
    out = b2.qmatmul(x2.contiguous(), qt)
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
    k = x_sorted.shape[-1]
    num, den = b2.data_row_factor(qt.qtype)
    k_pad = qt.data.shape[-2] * num // den
    x2 = x_sorted.to(torch.bfloat16)
    if k_pad != k:   # quantization block padding (core._to_blocks)
        x2 = F.pad(x2, (0, k_pad - k))
    return b2e.qmatmul_experts(x2.contiguous(), seg, qt,
                               keep_f32=out_dtype == torch.float32,
                               max_rows=max_rows)


def linear(x: torch.Tensor, w, bias: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Linear over a QTensor (a block format or bf16) or a plain bf16
    matrix, plus ``bias`` in the output's dtype."""
    if isinstance(w, QTensor) and w.qtype != "bf16":
        y = qmatmul(x, w)
    else:
        if isinstance(w, QTensor):
            w = w.data
        if x.is_cuda:
            # a plain bf16 product outside any kernel (fp32 accumulation)
            y = torch.matmul(x.to(w.dtype), w).to(x.dtype)
        else:
            y = torch.matmul(x.to(w.dtype).to(torch.float64),
                             w.to(torch.float64)).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
