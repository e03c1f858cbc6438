"""Sparse mixture-of-experts dispatch (port of ``ipex_llm_tpu/ops/moe.py``).

The route follows the reference's rule: the *static* pair count
``B * T * k`` (pads and idle rows included) at or below
:data:`GATHER_PAIR_LIMIT` takes the gather route, anything larger the
ragged route.  Both sort the (token, expert) pairs stably by expert and
run each projection as one expert-grouped dequant-matmul over the sorted
rows (B2e, ``ops/linear.py::qmatmul_experts``), which reads each touched
expert's packed planes in place and takes the forward's token count
``B * T`` as its static bound on an expert's rows (a token's k experts
are distinct), which picks its instance; the reference instead runs one B2
product per pair under ``jax.vmap`` (gather) or dequantizes the whole
stack for ``lax.ragged_dot`` (ragged).  The rounding of each route is the
reference's:

- gather (:func:`moe_gather`): each pair's ``gate_up`` output rounds to
  bf16, the gated activation runs in bf16, the ``down`` output is bf16 and
  is multiplied by the bf16 routing weight, and a token's k pair outputs
  are summed in bf16 in top-k order;
- ragged (:func:`moe_ragged`): the ``gate_up`` output stays fp32 through
  the activation, then rounds to bf16; the ``down`` output is fp32, times
  the fp32 weight, summed in fp32 in expert-sorted order, then rounded to
  bf16.

Ungated experts (``gated=False``, phixtral's fc1 -> act -> fc2) hold fc1
alone in ``gate_up`` (``I`` columns, not ``2I``) and run the plain
activation (``ops.mlp.act``) where gated ones run ``act(gate) * up``.
Their biases, ``up_bias`` ``[E, I]`` and ``down_bias`` ``[E, H]``, are
gathered by each pair's expert and added where the reference adds them:
in bf16 to the bf16 projection outputs on the gather route (and in the
dense scan), in fp32 to the fp32 outputs on the ragged route.

Every sum runs in a fixed order with no atomics, so a retried tick is
bitwise the first.  bf16 expert stacks take the reference's plain forms
(gathered weights and a batched product at the gather route, one product
per expert over its sorted rows at the ragged route).  :func:`moe_dense`
is the reference decoder's all-experts scan, the tests' oracle, selected
by ``IPEX_LLM_TPU_DENSE_MOE=1`` (:func:`use_sparse`, read once a forward
by :func:`dispatch`).  The capacity route serves only an ``ep``-sharded
mesh and is not ported (ROADMAP item 15).
"""

from __future__ import annotations

import os

import torch

from ipex_llm_tpu_torch.ops import linear as linear_ops
from ipex_llm_tpu_torch.ops import mlp as mlp_ops
from ipex_llm_tpu_torch.ops.cuda.qmatmul_experts import segments
from ipex_llm_tpu_torch.quantize.core import QTensor

# pairs at or below this take the gather route (decode-shaped batches)
GATHER_PAIR_LIMIT = 32


def use_sparse() -> bool:
    return os.environ.get("IPEX_LLM_TPU_DENSE_MOE", "0") != "1"


def dispatch():
    """The experts' function a forward runs, chosen once a forward:
    :func:`moe_ffn`, or the all-experts scan :func:`moe_dense` under
    ``IPEX_LLM_TPU_DENSE_MOE=1``."""
    return moe_ffn if use_sparse() else moe_dense


def _packed(stack: QTensor) -> bool:
    return stack.qtype != "bf16"


def _bmm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [P, K] against per-pair weights w [P, K, N] -> bf16 [P, N] with
    fp32 sums (float64 on the CPU, each output exactly rounded)."""
    if x.is_cuda:
        return torch.bmm(x[:, None].to(torch.bfloat16), w)[:, 0]
    return torch.bmm(x[:, None].to(torch.bfloat16).double(),
                     w.double())[:, 0].to(torch.bfloat16)


def _grouped(x: torch.Tensor, seg: torch.Tensor, stack,
             out_dtype: torch.dtype, max_rows: int) -> torch.Tensor:
    """Rows of x sorted by expert against the stack: B2e for a packed
    stack (``max_rows`` bounds an expert's rows); for a bf16 stack one
    plain product per expert over its rows (the host reads ``seg``), as
    the reference's ``ragged_dot``."""
    if _packed(stack):
        return linear_ops.qmatmul_experts(x, seg, stack, out_dtype,
                                          max_rows=max_rows)
    w = stack.data
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=out_dtype,
                      device=x.device)
    xb = x.to(torch.bfloat16)
    bounds = seg.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi == lo:
            continue
        if x.is_cuda:
            out[lo:hi] = torch.mm(xb[lo:hi], w[e], out_dtype=torch.float32
                                  ).to(out_dtype)
        else:
            out[lo:hi] = (xb[lo:hi].double() @ w[e].double()).to(out_dtype)
    return out


def _sort_pairs(idx: torch.Tensor, n_experts: int):
    """(order, seg): the pairs' stable expert-sorted order and the
    experts' row offsets in it."""
    ids, order = torch.sort(idx.reshape(-1), stable=True)
    return order, segments(ids, n_experts)


def _activate(inner: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """act(gate) * up of a gated expert's gate||up output, or act(fc1) of
    an ungated one's (in ``inner``'s dtype)."""
    if gated:
        gate, up = mlp_ops.split_gate_up(inner)
        return mlp_ops.gated_act_mul(gate, up, act)
    return mlp_ops.act(inner, act)


def _plus(y: torch.Tensor, bias: torch.Tensor | None,
          experts: torch.Tensor) -> torch.Tensor:
    """y [P, N] plus each row's expert's bias (``bias`` [E, N]) in y's
    dtype; y unchanged without a bias."""
    return y if bias is None else y + bias[experts].to(y.dtype)


def moe_gather(h, w, idx, gate_up, down, act: str, n_experts: int,
               gated: bool = True, up_bias=None, down_bias=None):
    """The gather route: h [B, T, H], w / idx [B, T, k] -> bf16 [B, T, H]."""
    b, t, hidden = h.shape
    k = idx.shape[-1]
    n = b * t
    hf = h.reshape(n, hidden).to(torch.bfloat16)
    e_f = idx.reshape(n * k)
    tok_f = torch.div(torch.arange(n * k, device=h.device), k,
                      rounding_mode="floor")
    if _packed(gate_up):
        order, seg = _sort_pairs(idx, n_experts)
        e_s = e_f[order]
        inner = _plus(linear_ops.qmatmul_experts(hf[tok_f[order]], seg,
                                                 gate_up, max_rows=n),
                      up_bias, e_s)
        y_s = _plus(linear_ops.qmatmul_experts(
            _activate(inner, act, gated), seg, down, max_rows=n),
            down_bias, e_s)
        y = torch.empty_like(y_s)
        y[order] = y_s                      # back to pair order
    else:
        inner = _plus(_bmm_bf16(hf[tok_f], gate_up.data[e_f]), up_bias, e_f)
        y = _plus(_bmm_bf16(_activate(inner, act, gated), down.data[e_f]),
                  down_bias, e_f)
    y = (y * w.reshape(n * k, 1).to(torch.bfloat16)).reshape(n, k, hidden)
    out = y[:, 0]
    for j in range(1, k):                   # bf16, in top-k order
        out = out + y[:, j]
    return out.reshape(b, t, hidden)


def moe_ragged(h, w, idx, gate_up, down, act: str, n_experts: int,
               gated: bool = True, up_bias=None, down_bias=None):
    """The ragged route: h [B, T, H], w / idx [B, T, k] -> [B, T, H] in
    h's dtype."""
    b, t, hidden = h.shape
    k = idx.shape[-1]
    n = b * t
    hf = h.reshape(n, hidden).to(torch.bfloat16)
    order, seg = _sort_pairs(idx, n_experts)
    e_s = idx.reshape(n * k)[order]
    tok_s = torch.div(order, k, rounding_mode="floor")
    w_s = w.reshape(n * k)[order]
    inner = _plus(_grouped(hf[tok_s], seg, gate_up, torch.float32, n),
                  up_bias, e_s)
    act_x = _activate(inner, act, gated).to(torch.bfloat16)
    y = _plus(_grouped(act_x, seg, down, torch.float32, n), down_bias, e_s)
    y = y * w_s[:, None].to(torch.float32)
    # each token's k sorted positions, ascending: its fp32 sum runs in
    # expert-sorted order, as the reference's scatter-add does
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n * k, device=h.device)
    pos = pos.reshape(n, k).sort(dim=1).values
    ys = y[pos]                             # [n, k, H]
    out = ys[:, 0]
    for j in range(1, k):
        out = out + ys[:, j]
    return out.reshape(b, t, hidden).to(h.dtype)


def moe_ffn(h, w, idx, gate_up, down, act: str, n_experts: int,
            gated: bool = True, up_bias=None, down_bias=None):
    """Route by the static pair count: gather for decode-shaped batches,
    ragged above :data:`GATHER_PAIR_LIMIT`."""
    kw = dict(gated=gated, up_bias=up_bias, down_bias=down_bias)
    n_pairs = h.shape[0] * h.shape[1] * idx.shape[-1]
    if n_pairs <= GATHER_PAIR_LIMIT:
        return moe_gather(h, w, idx, gate_up, down, act, n_experts, **kw)
    return moe_ragged(h, w, idx, gate_up, down, act, n_experts, **kw)


def moe_dense(h, w, idx, gate_up, down, act: str, n_experts: int,
              gated: bool = True, up_bias=None, down_bias=None):
    """Every expert on every token, gated by the dense map of the top-k
    weights (zeros elsewhere) and summed over the experts in order in h's
    dtype: the reference decoder's scan (``decoder.py:268-293``)."""
    gates = torch.zeros(*idx.shape[:-1], n_experts, dtype=w.dtype,
                        device=w.device)
    for j in range(idx.shape[-1]):
        gates = gates + w[..., j, None] * torch.nn.functional.one_hot(
            idx[..., j].long(), n_experts).to(w.dtype)
    acc = torch.zeros_like(h)
    for e in range(n_experts):
        inner = linear_ops.linear(h, gate_up.planes(lambda t: t[e]),
                                  None if up_bias is None else up_bias[e])
        y = linear_ops.linear(_activate(inner, act, gated),
                              down.planes(lambda t: t[e]),
                              None if down_bias is None else down_bias[e])
        acc = acc + y * gates[..., e, None].to(y.dtype)
    return acc
