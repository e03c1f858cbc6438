"""The port's operators against the JAX package on the same inputs.

The two kernels of the serving path are held through their plain PyTorch
versions (the wrappers take them for CPU tensors): B2, the dequant-matmul
in each of its ten block formats, against the JAX Pallas kernel
(interpreted on the CPU) and its XLA reference; B1, ragged paged
attention, against the JAX Pallas kernel.  The paged KV scatter and the e5m2 encode are byte moves and are
held bitwise; the leaf ops and greedy sampling to the reference's results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.ops import mlp as ref_mlp
from ipex_llm_tpu.ops import norms as ref_norms
from ipex_llm_tpu.ops import rope as ref_rope
from ipex_llm_tpu.ops import sampling as ref_sampling
from ipex_llm_tpu.ops.linear import qmatmul_reference as ref_qmatmul_reference
from ipex_llm_tpu.ops.pallas.qmatmul import qmatmul_pallas
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged_paged_sdpa
from ipex_llm_tpu.quantize import core as ref_core
from ipex_llm_tpu_torch.kv import PagedKVCache
from ipex_llm_tpu_torch.ops import mlp, norms, rope, sampling
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.ops.linear import linear, qmatmul
from ipex_llm_tpu_torch.quantize.core import QTensor
from tests.test_torch_quantize import to_bytes


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides: (jnp array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def _port_qtensor(ref) -> QTensor:
    def plane(a):
        return None if a is None else torch.from_numpy(np.asarray(a).copy())
    return QTensor(plane(ref.data), plane(ref.scales), plane(ref.zeros),
                   ref.qtype, tuple(ref.shape), ref.block_size)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- B2: the dequant-matmul ---------------------------------------------------

B2_FORMATS = ("sym_int4", "asym_int4", "nf4", "fp4", "sym_int5",
              "asym_int5", "sym_int8", "fp6", "fp8_e4m3", "fp8_e5m2")


@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("k,n", [(320, 200), (200, 72)])
def test_qmatmul_plain_matches_reference(m, k, n):
    """x[M, K] @ dequant(W) for M in {1, 8, 40}, K of several blocks that
    is not a multiple of the JAX kernel's 2048 tile (200 is not even a
    whole number of 32-row blocks: the zero-padded tail), N not a multiple
    of 128.  Tolerance: both sides form the same exact bf16 products; the
    JAX sides sum them in fp32 and the port's plain version in float64,
    then both round to bf16, so they differ by at most about one bf16 ulp
    (2^-8 relative) of the output scale."""
    rng = np.random.default_rng(100 + m + k)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    xj, xt = _bf16(rng.standard_normal((m, k)))
    ref_qt = ref_core.quantize(jnp.asarray(w), "sym_int4")
    want_pallas = _f32(qmatmul_pallas(xj, ref_qt))
    want_xla = _f32(ref_qmatmul_reference(xj, ref_qt))
    b2.COUNTS.reset()
    got_t = qmatmul(xt, _port_qtensor(ref_qt))
    got = _f32(got_t)
    assert got_t.dtype == torch.bfloat16 and got.shape == (m, n)
    assert b2.COUNTS.plain_calls == 1 and b2.COUNTS.launches == 0
    tol = 2.0 ** -7 * np.abs(want_xla).max(axis=1, keepdims=True)
    assert (np.abs(got - want_xla) <= tol).all()
    assert (np.abs(got - want_pallas) <= tol).all()


@pytest.mark.parametrize("qtype", B2_FORMATS)
@pytest.mark.parametrize("k", ["whole blocks", 200])
def test_qmatmul_formats_match_reference(qtype, k):
    """Every format at the reference test's shapes (tests/test_pallas.py:
    K=160, or 256 for fp8's 128-row blocks; N=200, M=3), and at K=200, a
    partial trailing block for every block size (the padding path).  The
    weights come from the reference's jitted codec.  Tolerance: one bf16
    ulp of each row's largest output (2^-7 of it; the reasoning of the
    sym_int4 test above, held per row), against the Pallas kernel and
    against ``qmatmul_reference``."""
    if k == "whole blocks":
        k = 256 if qtype.startswith("fp8") else 160
    n, m = 200, 3
    rng = np.random.default_rng(7 + k)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    xj, xt = _bf16(rng.standard_normal((m, k)) * 0.5)
    ref_qt = ref_core.quantize(jnp.asarray(w), qtype)
    want_pallas = _f32(qmatmul_pallas(xj, ref_qt))
    want_xla = _f32(ref_qmatmul_reference(xj, ref_qt))
    b2.COUNTS.reset()
    got = _f32(qmatmul(xt, _port_qtensor(ref_qt)))
    assert got.shape == (m, n)
    assert b2.COUNTS.plain_calls == 1 and b2.COUNTS.launches == 0
    tol = 2.0 ** -7 * np.abs(want_xla).max(axis=1, keepdims=True)
    assert (np.abs(got - want_xla) <= tol).all()
    assert (np.abs(got - want_pallas) <= tol).all()


@pytest.mark.parametrize("qtype", B2_FORMATS)
def test_qmatmul_keep_f32_and_leading_dims(qtype):
    """Leading batch dims pass through, and ``keep_f32`` returns the fp32
    accumulator whose bf16 rounding is the default output (K=64: a partial
    block for the 64- and 128-row formats)."""
    rng = np.random.default_rng(9)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    qt = _port_qtensor(ref_core.quantize(jnp.asarray(w), qtype))
    _, x = _bf16(rng.standard_normal((2, 3, 64)))
    y = qmatmul(x, qt)
    assert y.shape == (2, 3, 48) and y.dtype == torch.bfloat16
    num, den = b2.data_row_factor(qtype)
    k_pad = qt.data.shape[0] * num // den
    x2 = torch.nn.functional.pad(x.reshape(6, 64), (0, k_pad - 64))
    y32 = b2.qmatmul(x2, qt, keep_f32=True)
    assert y32.dtype == torch.float32 and y32.shape == (6, 48)
    torch.testing.assert_close(y.reshape(6, 48), y32.to(torch.bfloat16),
                               rtol=0, atol=0)


def test_qmatmul_split_plan_holds_whole_blocks():
    """Every K split of the kernel holds whole quantization blocks of the
    format (32, 64 or 128 rows) and at least 128 rows, and the splits
    cover K exactly once."""
    for bs in (32, 64, 128):
        for m, n, k in ((1, 4096, 4096), (8, 22016, 4096), (8, 4096, 11008),
                        (128, 12288, 4096), (3, 200, 256)):
            splits, per = b2.split_plan(m, n, k, bs)
            nqb = k // bs
            assert per * bs >= 128 or splits == 1
            assert (splits - 1) * per < nqb <= splits * per


def test_linear_raises_outside_the_slice():
    qt = QTensor(torch.zeros(24, 8, dtype=torch.uint8),
                 torch.zeros(1, 8, dtype=torch.float16), None, "nf3",
                 (64, 8), 64)
    with pytest.raises(NotImplementedError):
        linear(torch.zeros(2, 64, dtype=torch.bfloat16), qt)
    # a bias is in the slice now (qwen2's qkv): an fp32 leaf cast to the
    # output's dtype and added there, as the reference adds it
    x = torch.randn(2, 32).to(torch.bfloat16)
    w = torch.randn(32, 8).to(torch.bfloat16)
    b = torch.randn(8)
    got = linear(x, w, bias=b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, linear(x, w) + b.to(torch.bfloat16))


# -- B1: ragged paged attention ----------------------------------------------

B1_ULP = 2.0 ** -7      # one bf16 ulp, relative to the largest output

def _ragged_case(pool_dtype, r=8, hq=4, hkv=2, ps=16, maxp=4, d=16, c=8):
    """The row mix of benchmark/microbench.py::bench_ragged_attn (even
    rows decode at full history, odd rows take a ragged chunk), with -1
    table tails, plus two idle rows whose kv_len is the engine's sentinel
    past the table width.  Returns (jax args, torch args)."""
    rng = np.random.default_rng(21)
    n_pages = 1 + r * maxp
    kf = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    vf = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    kj = jnp.asarray(kf, pool_dtype)
    vj = jnp.asarray(vf, pool_dtype)
    tdt = torch.bfloat16 if pool_dtype == jnp.bfloat16 else torch.float8_e5m2
    iv = np.int16 if tdt == torch.bfloat16 else np.uint8
    tint = torch.int16 if tdt == torch.bfloat16 else torch.uint8
    kt = torch.from_numpy(np.asarray(kj).view(iv).copy()).view(
        tint).view(tdt)
    vt = torch.from_numpy(np.asarray(vj).view(iv).copy()).view(
        tint).view(tdt)
    pages = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = pages[: r * maxp].reshape(r, maxp).copy()
    chunk = np.where(np.arange(r) % 2 == 0, 1,
                     1 + np.arange(r) % c).astype(np.int32)
    hist = np.array([40, 9, 64, 23, 17, 50, 0, 0], np.int32)[:r]
    kv_len = np.maximum(hist, chunk).astype(np.int32)
    for i in range(r):                      # unallocated tails
        tables[i, -(-int(kv_len[i]) // ps):] = -1
    chunk[-2:] = 0                          # idle rows: sentinel kv_len
    kv_len[-2:] = maxp * ps
    tables[-2:] = -1
    qj, qt = _bf16(rng.standard_normal((r, c, hq, d)))
    jax_args = (qj, kj, vj, jnp.asarray(tables), jnp.asarray(kv_len),
                jnp.asarray(chunk))
    torch_args = (qt, kt, vt, torch.from_numpy(tables),
                  torch.from_numpy(kv_len), torch.from_numpy(chunk))
    return jax_args, torch_args, chunk


@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
def test_ragged_attention_plain_matches_pallas(pool):
    """Valid queries agree with the JAX kernel; idle rows are exact zeros
    on both sides.  Tolerance: one bf16 ulp of the row's largest output,
    2^-7 * max|want[i]|.  Both sides round the output to bf16 and the JAX
    kernel also rounds the probabilities to bf16 before the PV product;
    the plain version works in float64.  The worst row here differs by one
    ulp of an output in [1, 2) against a row maximum of 1.37."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt)
    want = _f32(ref_ragged_paged_sdpa(*jax_args))
    b1.COUNTS.reset()
    got_t = b1.ragged_paged_sdpa(*torch_args)
    assert b1.COUNTS.plain_calls == 1 and b1.COUNTS.launches == 0
    assert got_t.dtype == torch.bfloat16
    got = _f32(got_t)
    for i, n in enumerate(chunk):
        if n == 0:
            assert not got[i].any() and not want[i].any()
            continue
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0,
                                   atol=B1_ULP * np.abs(want[i, :n]).max())
        assert np.isfinite(got[i]).all()    # pad queries: bounded garbage


def test_ragged_attention_decode_shape_and_default_chunk():
    """C = 1 with chunk_len None is the plain decode step; each row within
    one bf16 ulp of its largest output, as above."""
    jax_args, torch_args, _ = _ragged_case(jnp.bfloat16, c=1)
    q, k, v, tables, kv_len, _ = torch_args
    kv_len = torch.clamp(kv_len, max=40)
    tables = tables.clone()
    tables[-2:, :3] = 5                    # revive the idle rows
    got = _f32(b1.ragged_paged_sdpa(q, k, v, tables, kv_len))
    qj, kj, vj, _, _, _ = jax_args
    want = _f32(ref_ragged_paged_sdpa(qj, kj, vj, jnp.asarray(tables.numpy()),
                                      jnp.asarray(kv_len.numpy())))
    for i in range(got.shape[0]):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=B1_ULP * np.abs(want[i]).max())


# -- paged KV -----------------------------------------------------------------

@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_paged_update_layer_is_bitwise_the_reference(storage):
    """update_layer scatters the same bytes to the same pages: ragged
    per-row offsets, a row whose tail runs past the table width and one
    into an unallocated (-1) page (both routed to scratch page 0), and a
    pad row at the sentinel offset.  Page 0 may take several writes of one
    slot, in an order neither side fixes, so it is compared as "written"
    only; no live page reads it."""
    rng = np.random.default_rng(33)
    l, p, h, ps, d, r, maxp, t = 2, 10, 2, 8, 4, 4, 3, 6
    ref = RefPagedKVCache.init(l, p, r, maxp, h, ps, d, storage=storage)
    port = PagedKVCache.init(l, p, r, maxp, h, ps, d, storage=storage,
                             device="cpu")
    tables = np.array([[3, 5, -1], [7, 1, 2], [4, 6, 8], [-1, -1, -1]],
                      np.int32)
    ref = ref.with_tables(jnp.asarray(tables))
    port.tables.copy_(torch.from_numpy(tables))
    pos = np.array([2, 19, 9, maxp * ps], np.int32)   # row 1 runs off
    new = rng.standard_normal((2, r, t, h, d)).astype(np.float32)
    nkj, nkt = _bf16(new[0])
    nvj, nvt = _bf16(new[1])
    kj, vj = ref.update_layer(ref.k[0], ref.v[0], nkj, nvj, jnp.asarray(pos))
    kt, vt = port.update_layer(port.k[0], port.v[0], nkt, nvt,
                               torch.from_numpy(pos))
    for a, b in ((kj, kt), (vj, vt)):
        assert to_bytes(b[1:]) == to_bytes(np.asarray(a)[1:])
        assert (to_bytes(b[0]) != to_bytes(torch.zeros_like(b[0]))) and (
            np.asarray(a)[0].astype(np.float32).any())
    assert to_bytes(port.k[0]) == to_bytes(kt)         # written in place
    gathered = port.gather_layer(port.k[0])
    assert to_bytes(gathered) == to_bytes(ref.gather_layer(kj))


def test_e5m2_encode_is_bitwise_the_reference():
    """bf16 -> float8_e5m2 rounds identically on values in e5m2's range
    (normals, subnormals, signed zero)."""
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.standard_normal(4096) * 10.0 ** e
                           for e in range(-6, 5)])
    vals = vals[np.abs(vals) < 57344.0].astype(np.float32)
    vals = np.concatenate([vals, [0.0, -0.0, 1.5e-5, -3e-5, 57344.0]])
    xj, xt = _bf16(vals.astype(np.float32))
    ref = np.asarray(xj.astype(jnp.float8_e5m2)).view(np.uint8)
    port = PagedKVCache.init(1, 2, 1, 1, 1, 8, 4, storage="fp8",
                             device="cpu").encode(xt).view(torch.uint8)
    np.testing.assert_array_equal(port.numpy(), ref)


# -- leaf ops -----------------------------------------------------------------

def test_leaf_ops_match_reference():
    """rms_norm, rope ("half", fp32 inside) and silu-gated product keep the
    reference's rounding points: results agree to within one bf16 ulp
    (the transcendental functions of the two libraries differ in the last
    fp32 bits)."""
    rng = np.random.default_rng(8)
    xj, xt = _bf16(rng.standard_normal((2, 5, 4, 16)))
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    ulp = 2.0 ** -7
    np.testing.assert_allclose(
        _f32(norms.rms_norm(xt, torch.from_numpy(w), 1e-5)),
        _f32(ref_norms.rms_norm(xj, jnp.asarray(w), 1e-5)), rtol=ulp,
        atol=1e-6)
    inv = ref_rope.RopeScaling(head_dim=16).inv_freq()
    np.testing.assert_array_equal(rope.RopeScaling(head_dim=16).inv_freq(),
                                  inv)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    cj, sj = ref_rope.cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    ct, st = rope.cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(
        _f32(rope.apply_rope(xt, ct, st)),
        _f32(ref_rope.apply_rope(xj, cj, sj, "half")), rtol=ulp, atol=1e-2)
    gj, gt = _bf16(rng.standard_normal((3, 64)))
    np.testing.assert_allclose(
        _f32(mlp.gated_act_mul(*mlp.split_gate_up(gt))),
        _f32(ref_mlp.gated_act_mul(*ref_mlp.split_gate_up(gj))), rtol=ulp,
        atol=1e-2)


# -- sampling -----------------------------------------------------------------

def _logits(r=6, v=50, seed=12):
    return (np.random.default_rng(seed).standard_normal((r, v)) * 3
            ).astype(np.float32)


def test_greedy_tokens_and_logprobs_match_reference():
    lg = _logits()
    r = lg.shape[0]
    active = np.array([1, 1, 0, 1, 1, 0], bool)
    tj, lpj = ref_sampling.sample_rows_with_logprobs(
        jnp.asarray(lg), jnp.zeros(r), jnp.ones(r), jax.random.PRNGKey(0),
        seeds=jnp.full((r,), -1, jnp.int32), steps=jnp.zeros(r, jnp.int32),
        active=jnp.asarray(active))
    tt, lpt = sampling.sample_rows_with_logprobs(
        torch.from_numpy(lg), torch.zeros(r), torch.ones(r),
        torch.zeros(r, dtype=torch.int64), torch.zeros(r, dtype=torch.int32),
        active=torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # log-softmax in fp32 on both sides, summed in different orders
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=1e-6,
                               atol=1e-5)


def test_top_k_and_top_p_masks_match_reference():
    lg = _logits(seed=13)
    ks = np.array([0, 1, 5, 17, 50, 3], np.int32)
    np.testing.assert_array_equal(
        sampling._top_k_mask_rows(torch.from_numpy(lg),
                                  torch.from_numpy(ks)).numpy(),
        np.asarray(ref_sampling._top_k_mask_rows(jnp.asarray(lg),
                                                 jnp.asarray(ks))))
    ps = np.array([1.0, 0.9, 0.5, 0.1, 0.95, 0.7], np.float32)
    np.testing.assert_array_equal(
        sampling._top_p_mask(torch.from_numpy(lg),
                             torch.from_numpy(ps)).numpy(),
        np.asarray(ref_sampling._top_p_mask(jnp.asarray(lg),
                                            jnp.asarray(ps))))


def test_seeded_rows_depend_only_on_seed_and_output_index():
    """The port cannot reproduce the reference's seeded draws: those come
    from JAX's threefry keys, fold_in(PRNGKey(seed), step).  It draws by
    Gumbel-max over a counter-based hash of (seed, step, vocab index)
    instead, which keeps the property the engine rests on: a row's token
    depends only on its logits, seed and output index, never on its batch
    mates.  And the draws follow the softmax distribution."""
    lg = torch.from_numpy(_logits(r=4, v=50))
    temps = torch.full((4,), 0.8)
    top_ps = torch.tensor([1.0, 0.9, 1.0, 0.9])
    seeds = torch.tensor([5, 5, 123456789, 7], dtype=torch.int64)
    steps = torch.tensor([3, 3, 0, 11], dtype=torch.int32)
    full, _ = sampling.sample_rows_with_logprobs(lg, temps, top_ps, seeds,
                                                 steps)
    for i in range(4):
        alone, _ = sampling.sample_rows_with_logprobs(
            lg[i:i + 1], temps[i:i + 1], top_ps[i:i + 1], seeds[i:i + 1],
            steps[i:i + 1])
        assert int(alone[0]) == int(full[i])
    # frequencies over 4000 seeds approach softmax(logits / T)
    v = 8
    row = torch.from_numpy(_logits(r=1, v=v, seed=2)).repeat(4000, 1)
    n = row.shape[0]
    toks, _ = sampling.sample_rows_with_logprobs(
        row, torch.full((n,), 1.0), torch.ones(n),
        torch.arange(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int32))
    freq = np.bincount(toks.numpy(), minlength=v) / n
    prob = torch.softmax(row[0], -1).numpy()
    np.testing.assert_allclose(freq, prob, atol=0.03)
