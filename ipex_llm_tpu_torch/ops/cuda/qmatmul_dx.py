"""The dequant-matmul's input gradient (B2^T): ``dx = dy @ dequant(W)^T``
in the ten block formats, for the backward of B2
(``ops/cuda/qmatmul.py``).

The JAX package has no backward kernel: its gradient of B2 is XLA's
autodiff of the oracle, the straight-through dequant gradient of the
reference's ``MatMulLowBit.backward``; the planes get none (the base is
frozen).  ``csrc/qmatmul_dx.cu`` holds the port's kernel (B2's tiled
tile read transposed, decoding through the same ``decode_step``) and the
note on its design and bound; :func:`plan` is its launch.  The wrapper is
a module of its own so that its launches count apart from B2's.
:func:`qmatmul_dx` launches it for CUDA tensors and runs
:func:`qmatmul_dx_plain` for CPU tensors.  It returns the padded
contraction width ``K``; the caller slices it to ``in_features``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize_padded

NAME = "qmatmul_dx"
COUNTS = _build.Counts()
ROWS = 128                   # rows of dy and dx per block (csrc kDxBM)
COLS = 64                    # dx columns per block (csrc kTK)
STEP = 128                   # dy columns (N) a step (csrc kTN)
THREADS = 256                # 8 warps of 32 x 32
STAGES = 2


class Plan(NamedTuple):
    """The launch: grid (row blocks, column blocks), threads, N steps a
    block walks, and the block's shared memory."""
    grid: tuple[int, int]
    threads: int
    steps: int
    smem: int


def stage_plane_bytes(qtype: str) -> int:
    """Bytes of one step's packed planes (csrc ``StagePlanes``): 64
    contraction rows x 128 columns of data, fifth bits, scales, zeros."""
    spec = b2._SPECS[qtype]
    bs, asym = spec[1], spec[4]
    layout = ("nib4" if qtype in b2._NIB4 else
              "bit5" if qtype in b2._BIT5 else "byte")
    data = (COLS if layout == "byte" else COLS // 2) * STEP
    hbits = COLS // 8 * STEP if layout == "bit5" else 0
    scale_rows = 1 if bs >= COLS else COLS // bs
    scales = scale_rows * STEP * 2
    return data + hbits + scales + (scales if asym else 0)


def plan(m: int, n: int, k: int, qtype: str) -> Plan:
    stage = ROWS * STEP * 2 + stage_plane_bytes(qtype)
    smem = STAGES * stage + COLS * STEP * 2 + 16 * 4
    return Plan((-(-m // ROWS), -(-k // COLS)), THREADS, -(-n // STEP), smem)


def qmatmul_dx_plain(dy: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain version: ``dy @ dequant(W)^T`` with the weights rounded
    to bf16 as B2's plain version rounds them, summed in float64 and
    rounded once to ``dy``'s dtype; ``[M, K_pad]``."""
    COUNTS.plain_calls += 1
    w = dequantize_padded(qt).to(torch.bfloat16)
    return torch.matmul(dy.to(torch.bfloat16).to(torch.float64),
                        w.to(torch.float64).t()).to(dy.dtype)


def _launch(dy: torch.Tensor, qt: QTensor) -> torch.Tensor:
    spec = b2._SPECS.get(qt.qtype)
    if spec is None:
        raise NotImplementedError(f"B2^T has no kernel for {qt.qtype!r}")
    fid, bs, num, den, asym = spec
    data, scales, zeros = qt.data, qt.scales, qt.zeros
    m, n = dy.shape
    k = data.shape[0] * num // den
    dev = dy.device
    if dy.dtype != torch.bfloat16:
        raise TypeError(f"{NAME} kernel takes bf16 dy, got {dy.dtype}")
    if data.dtype != torch.uint8 or scales.dtype != torch.float16:
        raise TypeError(f"{NAME} kernel takes uint8 data and fp16 scales")
    if data.device != dev or scales.device != dev:
        raise ValueError("dy and the weight planes must be on one device")
    if qt.block_size != bs or k % bs or data.shape[1] != n \
            or scales.shape != (k // bs, n):
        raise ValueError(f"shape mismatch: dy {tuple(dy.shape)}, "
                         f"{qt.qtype} data {tuple(data.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if n % 8:
        raise ValueError(f"{NAME} kernel needs out_features % 8 == 0")
    if not (dy.is_contiguous() and data.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError(f"{NAME} kernel needs contiguous tensors")
    if data.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError(f"{NAME} kernel needs 4-byte aligned data and "
                         "8-byte aligned scales")
    if (zeros is not None) != asym or (zeros is not None and (
            zeros.dtype != torch.float16 or zeros.device != dev
            or zeros.shape != scales.shape or not zeros.is_contiguous()
            or zeros.data_ptr() % 8)):
        raise ValueError(f"{qt.qtype}: zeros plane missing or not shaped, "
                         "placed and aligned as the scales")
    if -(-k // COLS) > 65535:
        raise ValueError("grid too large for one launch")
    lib = _build.load(NAME, _declare)
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return dx
    if dy.data_ptr() % 16:
        dy = dy.clone()
    vec16 = n % 16 == 0 and all(
        t is None or t.data_ptr() % 16 == 0 for t in (data, scales, zeros))
    table = b2._table(qt.qtype, dev) if qt.qtype in b2._TABLES else None
    err = lib.qmatmul_dx(
        fid, dy.data_ptr(), data.data_ptr(), scales.data_ptr(),
        0 if zeros is None else zeros.data_ptr(),
        0 if table is None else table.data_ptr(), dx.data_ptr(), m, n, k,
        int(vec16), _build.stream_handle(dy))
    COUNTS.launches += 1
    _build.check(err, NAME)
    return dx


def qmatmul_dx(dy: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """dy [M, N] @ dequant(qt)^T -> [M, K_pad] in dy's dtype (bf16 on the
    card)."""
    if dy.is_cuda:
        return _launch(dy, qt)
    return qmatmul_dx_plain(dy, qt)


def _declare(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul_dx.argtypes = [i, p, p, p, p, p, p, i, i, i, i, p]
    lib.qmatmul_dx.restype = ctypes.c_int
